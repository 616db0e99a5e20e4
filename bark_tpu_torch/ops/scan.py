"""The dense move scan as one CUDA kernel (K3): every chain's m moves in one launch.

The plain move scan of the dense tier (``fitting/sampler._scan_plain``)
runs m rank-2 Woodbury moves on the carried K^-1, one after the other. Its
torch loop is the twin: the CPU path and this kernel's oracle. On CUDA
tensors ``_scan_plain`` always takes the kernel ``csrc/move_scan.cu`` (see
its header for the design): one thread block per chain holds K^-1 in
shared memory for all m moves and returns each move's accept and log MH
ratio. This module validates the arguments, allocates the outputs and
launches it on the current stream; a kernel that fails to build or launch
raises. One launch covers every padded N of the dense tier, 1 to 255.
"""

from __future__ import annotations

import torch

from bark_tpu_torch.ops import _build

MAX_N = 255  # largest N the kernel takes (the packed K^-1 in shared memory)


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if not t.is_cuda:
        raise ValueError(f"move_scan_cuda: {name} must be a CUDA tensor")
    if t.device != device:
        raise ValueError(f"move_scan_cuda: {name} is on {t.device}, K_inv on {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"move_scan_cuda: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"move_scan_cuda: {name} must be {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"move_scan_cuda: {name} must be contiguous")


def move_scan_cuda(K_inv, y, W_pat, h, K_logdet, mll_corr, log_q_prior, u_accept, beta):
    """Launch ``csrc/move_scan.cu``: ``(accepts (C, m) bool, log_alpha (C, m))``.

    K_inv (C, N, N), of which the lower triangle is read; y (N,); the 0/±1
    update patterns W_pat (C, m, N, 2) and their scale h = sqrt(scale/2m)
    (C,); K_logdet, the pads' log-det correction mll_corr and the inverse
    temperature beta, each (C,); log_q_prior and u_accept (C, m). All
    float32 CUDA tensors on one device, contiguous, with 1 <= N <= 255.
    """
    if K_inv.dim() != 3 or W_pat.dim() != 4:
        raise ValueError(f"move_scan_cuda: expected K_inv (C, N, N) and W_pat (C, m, N, 2), "
                         f"got {tuple(K_inv.shape)} and {tuple(W_pat.shape)}")
    c, n, m = K_inv.shape[0], K_inv.shape[1], W_pat.shape[1]
    device = K_inv.device
    for name, t, shape in (
        ("K_inv", K_inv, (c, n, n)), ("y", y, (n,)), ("W_pat", W_pat, (c, m, n, 2)),
        ("h", h, (c,)), ("K_logdet", K_logdet, (c,)), ("mll_corr", mll_corr, (c,)),
        ("log_q_prior", log_q_prior, (c, m)), ("u_accept", u_accept, (c, m)),
        ("beta", beta, (c,)),
    ):
        _check(name, t, shape, device)
    if not 1 <= n <= MAX_N:
        raise ValueError(f"move_scan_cuda: N={n} outside [1, {MAX_N}]")
    lib = _build.load_library()
    accepts = torch.empty((c, m), dtype=torch.bool, device=device)
    log_alpha = torch.empty((c, m), dtype=torch.float32, device=device)
    stream, index = _build.stream_and_device(K_inv)
    code = lib.lib.bark_move_scan(
        K_inv.data_ptr(), y.data_ptr(), W_pat.data_ptr(), h.data_ptr(), K_logdet.data_ptr(),
        mll_corr.data_ptr(), log_q_prior.data_ptr(), u_accept.data_ptr(), beta.data_ptr(),
        accepts.data_ptr(), log_alpha.data_ptr(), c, n, m, index, stream,
    )
    lib.check(code, "move_scan")
    move_scan_cuda.launches += 1
    return accepts, log_alpha


move_scan_cuda.launches = 0  # kernel launches, for the chip check of the main path
