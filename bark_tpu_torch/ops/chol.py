"""Batched Cholesky with inverse: the CUDA kernel K2 and its plain version.

Counterpart of ``bark_tpu/ops/pallas_chol.py`` (``chol_inv_blocks``): for a
batch of SPD matrices A (..., BK, BK) it returns ``(L, E)`` with
``A = L L^T`` and ``E = L^-1``, both lower-triangular. The kernel is
``csrc/chol_inv.cu`` (see its header for the design); this module validates
the arguments, allocates the outputs and launches it on the current stream.
The kernel takes any BK <= 256 in one launch, so every dense-tier
factorization is one call; ``ops.linalg.blocked_cholesky`` builds larger
ones from 256-blocks.

A matrix that is not positive definite (a pivot <= 0 or NaN) yields NaN over
all of its L and E on both paths, and leaves the other matrices of the batch
alone (the reference's ``jnp.linalg.cholesky`` gives NaN too), so a sampler
MLL through it is NaN and the MH step rejects.

A tensor on the CPU takes :func:`chol_inv_plain`; a CUDA tensor always takes
the kernel, and a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import torch

from bark_tpu_torch.ops import _build

MAX_BLOCK = 256  # largest BK the kernel takes (its shared-memory budget)


def chol_inv_plain(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``torch.linalg.cholesky`` + a triangular solve on I."""
    L, info = torch.linalg.cholesky_ex(a)
    L = torch.where((info != 0)[..., None, None], torch.nan, L)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device).expand_as(a)
    E = torch.linalg.solve_triangular(L, eye, upper=False)
    return L, E


def chol_inv_cuda(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/chol_inv.cu`` on a (G, BK, BK) float32 CUDA tensor."""
    if not a.is_cuda:
        raise ValueError("chol_inv_cuda: input must be a CUDA tensor")
    if a.dtype != torch.float32:
        raise ValueError(f"chol_inv_cuda: input must be float32, got {a.dtype}")
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"chol_inv_cuda: expected (G, BK, BK), got {tuple(a.shape)}")
    if not a.is_contiguous():
        raise ValueError("chol_inv_cuda: input must be contiguous")
    g, bk, _ = a.shape
    if not 1 <= bk <= MAX_BLOCK:
        raise ValueError(f"chol_inv_cuda: BK={bk} outside [1, {MAX_BLOCK}]")
    lib = _build.load_library()
    L = torch.empty_like(a)
    E = torch.empty_like(a)
    stream, device = _build.stream_and_device(a)
    code = lib.lib.bark_chol_inv(
        a.data_ptr(), L.data_ptr(), E.data_ptr(), g, bk, device, stream
    )
    lib.check(code, "chol_inv")
    chol_inv_cuda.launches += 1
    return L, E


chol_inv_cuda.launches = 0  # kernel launches, for the chip check of the main path


def chol_inv(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(L, L^-1)`` of SPD matrices ``a`` (..., BK, BK), BK <= 256 on CUDA.

    CUDA tensors go through the kernel, CPU tensors through
    :func:`chol_inv_plain`.
    """
    if not a.is_cuda:
        return chol_inv_plain(a)
    bk = a.shape[-1]
    flat = a.to(torch.float32).reshape(-1, bk, bk).contiguous()
    L, E = chol_inv_cuda(flat)
    return L.reshape(a.shape), E.reshape(a.shape)
