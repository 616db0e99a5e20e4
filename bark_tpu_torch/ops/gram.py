"""Leaf-agreement Gram: the CUDA kernel K1 and its plain PyTorch version.

Counterpart of ``bark_tpu/ops/pallas_gram.py`` (``counts_from_leaves_pallas``
/ ``gram_from_leaves_pallas``). For leaf assignments ``l1`` (B, N, m) and
``l2`` (B, M, m) it returns

    counts[b, i, j] / m * mask1[i] * mask2[j],
    counts[b, i, j] = #{t : l1[b, i, t] == l2[b, j, t]},

the agreement Gram the sampler factors at every refresh. The kernel is
``csrc/gram.cu`` (see its header for the design); this module validates the
arguments, allocates the output and launches it on the current stream.

A tensor on the CPU takes :func:`gram_plain`; a CUDA tensor always takes the
kernel, and a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import torch

from bark_tpu_torch.ops import _build


def gram_plain(
    l1: torch.Tensor,
    l2: torch.Tensor,
    mask1: torch.Tensor | None = None,
    mask2: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version: a broadcast compare, summed over trees.

    ``l1`` (..., N, m), ``l2`` (..., M, m) -> (..., N, M) float32. The
    division is a true IEEE division by m (a tensor divisor: a CPU-scalar
    divisor would let the CUDA backend multiply by 1/m instead), followed by
    the row and column masks -- the kernel's order of operations, so the
    two agree bit for bit.
    """
    m = l1.shape[-1]
    counts = (l1.unsqueeze(-2) == l2.unsqueeze(-3)).sum(-1, dtype=torch.int32)
    sim = counts.to(torch.float32) / torch.tensor(
        float(m), dtype=torch.float32, device=l1.device
    )
    if mask1 is not None:
        sim = sim * mask1.to(torch.float32).unsqueeze(-1)
    if mask2 is not None:
        sim = sim * mask2.to(torch.float32).unsqueeze(-2)
    return sim


def _mask_arg(mask, batch: int, n: int, device) -> tuple[torch.Tensor | None, int]:
    """Validate a mask for the kernel; returns (tensor, batch stride)."""
    if mask is None:
        return None, 0
    if mask.device != device or mask.dtype != torch.float32:
        raise ValueError(
            f"mask must be float32 on {device}, got {mask.dtype} on {mask.device}"
        )
    if not mask.is_contiguous():
        raise ValueError("mask must be contiguous")
    if mask.shape == (n,):
        return mask, 0
    if mask.shape == (batch, n):
        return mask, n
    raise ValueError(f"mask shape {tuple(mask.shape)}: expected ({n},) or ({batch}, {n})")


def gram_cuda(
    l1: torch.Tensor,
    l2: torch.Tensor,
    mask1: torch.Tensor | None = None,
    mask2: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch ``csrc/gram.cu`` on (B, N, m) / (B, M, m) int32 CUDA tensors."""
    if not (l1.is_cuda and l2.is_cuda and l1.device == l2.device):
        raise ValueError("gram_cuda: leaves must be CUDA tensors on one device")
    if l1.dtype != torch.int32 or l2.dtype != torch.int32:
        raise ValueError(f"gram_cuda: leaves must be int32, got {l1.dtype}/{l2.dtype}")
    if l1.dim() != 3 or l2.dim() != 3:
        raise ValueError("gram_cuda: leaves must be (B, N, m) and (B, M, m)")
    b, n, m = l1.shape
    if l2.shape[0] != b or l2.shape[2] != m:
        raise ValueError(f"gram_cuda: shapes {tuple(l1.shape)} vs {tuple(l2.shape)}")
    if not (l1.is_contiguous() and l2.is_contiguous()):
        raise ValueError("gram_cuda: leaves must be contiguous")
    if b > 65535:
        raise ValueError(f"gram_cuda: batch {b} exceeds the grid's z limit 65535")
    mcols = l2.shape[1]
    m1, s1 = _mask_arg(mask1, b, n, l1.device)
    m2, s2 = _mask_arg(mask2, b, mcols, l1.device)
    lib = _build.load_library()
    out = torch.empty((b, n, mcols), dtype=torch.float32, device=l1.device)
    stream, device = _build.stream_and_device(l1)
    code = lib.lib.bark_gram(
        l1.data_ptr(), l2.data_ptr(),
        None if m1 is None else m1.data_ptr(), s1,
        None if m2 is None else m2.data_ptr(), s2,
        out.data_ptr(), b, n, mcols, m, device, stream,
    )
    lib.check(code, "gram")
    gram_cuda.launches += 1
    return out


gram_cuda.launches = 0  # kernel launches, for the chip check of the main path


def gram_from_leaves(
    leaves1: torch.Tensor,
    leaves2: torch.Tensor,
    mask1: torch.Tensor | None = None,
    mask2: torch.Tensor | None = None,
) -> torch.Tensor:
    """Agreement Gram of ``leaves1`` (..., N, m) and ``leaves2`` (..., M, m).

    Masks are (N,)/(M,) or carry the same leading dims. CUDA tensors go
    through the kernel, CPU tensors through :func:`gram_plain`.
    """
    if not leaves1.is_cuda:
        return gram_plain(leaves1, leaves2, mask1, mask2)
    lead = leaves1.shape[:-2]
    if leaves2.shape[:-2] != lead:
        raise ValueError(
            f"leading dims differ: {tuple(leaves1.shape)} vs {tuple(leaves2.shape)}"
        )
    n, m = leaves1.shape[-2:]
    mcols = leaves2.shape[-2]
    b = 1
    for d in lead:
        b *= d

    def flat_mask(mask, rows):
        if mask is None:
            return None
        mask = mask.to(torch.float32)
        shape = (rows,) if mask.dim() == 1 else (b, rows)
        return mask.reshape(shape).contiguous()

    out = gram_cuda(
        leaves1.to(torch.int32).reshape(b, n, m).contiguous(),
        leaves2.to(torch.int32).reshape(b, mcols, m).contiguous(),
        flat_mask(mask1, n),
        flat_mask(mask2, mcols),
    )
    return out.reshape(*lead, n, mcols)
