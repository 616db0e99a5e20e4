"""The proposal batch as one CUDA kernel (K4): every (chain, tree) proposal and its leaves.

A sampler step proposes one grow/prune/change for every tree of every
chain before its move scan (``fitting/sampler._propose_all_trees``). Under
``subspace_mode="walk"`` the batch is the twin
``fitting/sampler._propose_torch`` (``proposals.propose_tree_packed``,
then ``_incremental_leaves``): the CPU path and this kernel's oracle. On
CUDA tensors the sampler always takes the kernel ``csrc/propose.cu`` (see
its header for the design): one warp per (chain, tree) pair, the tree in
shared memory, writing the proposed trees, the log proposal-and-prior
ratios, the moves and nodes, and the current and proposed leaves. The
constants of the batch (the normalised move cdf, alpha, log alpha, beta,
``max_depth``) are launch arguments, so nothing crosses to the host. This
module validates the arguments, allocates the outputs and launches it on
the current stream; a kernel that fails to build or launch raises.
``subspace_mode="carry"`` is a separate lowering and stays in torch.
"""

from __future__ import annotations

import functools

import torch

from bark_tpu_torch.ops import _build

MAX_NODES = 1024  # largest node_limit the kernel takes (the tree in shared memory)


@functools.lru_cache(maxsize=None)
def _constants(weights: tuple, alpha: float) -> tuple[float, float, float]:
    """The twin's float32 constants: the move cdf's first two entries
    (``cumsum(w) / sum(w)``) and ``log(float32(alpha))``."""
    w = torch.tensor(weights, dtype=torch.float32)
    cdf = torch.cumsum(w, 0) / w.sum()
    log_alpha = torch.log(torch.tensor(alpha, dtype=torch.float32))
    return float(cdf[0]), float(cdf[1]), float(log_alpha)


def _check(name, t, shape, dtypes, device, contiguous=True):
    if not t.is_cuda:
        raise ValueError(f"propose_batch_cuda: {name} must be a CUDA tensor")
    if t.device != device:
        raise ValueError(f"propose_batch_cuda: {name} is on {t.device}, packed on {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"propose_batch_cuda: {name} must be {' or '.join(map(str, dtypes))}, "
                         f"got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"propose_batch_cuda: {name} must be {shape}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"propose_batch_cuda: {name} must be contiguous")


_F32, _FLOATS, _I32 = (torch.float32,), (torch.float32, torch.float64), (torch.int32,)


def propose_batch_cuda(packed, u_move, g_node, u_feat, u_cat, u_int, u_cont, bounds,
                       feat_types, X, leaves, proposal_weights, alpha, beta, max_depth):
    """Launch ``csrc/propose.cu``: ``(new_packed, cur_leavesT, new_leavesT,
    log_q_prior, move, node)``, the fields of the sampler's proposal batch.

    ``packed`` (C, m, node_limit, 8) int32, the packed trees
    (``forest.pack_forest``), node_limit <= 1,024; the ProposalNoise fields
    u_move, u_feat, u_cat, u_int, u_cont (C, m) and g_node (C, m,
    node_limit), float32; ``bounds`` (D, 2) and ``X`` (N, D), float32 or
    float64; ``feat_types`` (D,) int32; ``leaves`` (C, N, m) int32, any
    strides. Every tensor but ``leaves`` contiguous, all on one CUDA device.
    ``proposal_weights``, ``alpha``, ``beta`` and ``max_depth`` are the
    SamplerParams values. Returns new_packed (C, m, node_limit, 8), the
    current and proposed leaves (C, m, N) int32, log_q_prior (C, m)
    float32, move and node (C, m) int32.
    """
    if packed.dim() != 4 or X.dim() != 2 or bounds.dim() != 2 or leaves.dim() != 3:
        raise ValueError(
            f"propose_batch_cuda: expected packed (C, m, node_limit, 8), X (N, D), bounds "
            f"(D, 2) and leaves (C, N, m), got {tuple(packed.shape)}, {tuple(X.shape)}, "
            f"{tuple(bounds.shape)} and {tuple(leaves.shape)}")
    c, m, nl, _ = packed.shape
    n, d = X.shape
    device = packed.device
    per_tree = (c, m)
    for name, t, shape, dtypes in (
        ("packed", packed, (c, m, nl, 8), _I32), ("u_move", u_move, per_tree, _F32),
        ("g_node", g_node, (c, m, nl), _F32), ("u_feat", u_feat, per_tree, _F32),
        ("u_cat", u_cat, per_tree, _F32), ("u_int", u_int, per_tree, _F32),
        ("u_cont", u_cont, per_tree, _F32), ("bounds", bounds, (d, 2), _FLOATS),
        ("feat_types", feat_types, (d,), _I32), ("X", X, (n, d), _FLOATS),
    ):
        _check(name, t, shape, dtypes, device)
    _check("leaves", leaves, (c, n, m), _I32, device, contiguous=False)
    if not 1 <= nl <= MAX_NODES:
        raise ValueError(f"propose_batch_cuda: node_limit={nl} outside [1, {MAX_NODES}]")
    if m < 1 or d < 1 or max_depth < 0:
        raise ValueError(f"propose_batch_cuda: needs m >= 1 trees, D >= 1 features and "
                         f"max_depth >= 0, got m={m}, D={d}, max_depth={max_depth}")
    if packed.data_ptr() % 16:
        raise ValueError("propose_batch_cuda: packed must be 16-byte aligned")
    cdf0, cdf1, log_alpha = _constants(tuple(proposal_weights), float(alpha))
    lib = _build.load_library()
    new_packed = torch.empty_like(packed)
    cur_leavesT = torch.empty((c, m, n), dtype=torch.int32, device=device)
    new_leavesT = torch.empty((c, m, n), dtype=torch.int32, device=device)
    log_q_prior = torch.empty(per_tree, dtype=torch.float32, device=device)
    move = torch.empty(per_tree, dtype=torch.int32, device=device)
    node = torch.empty(per_tree, dtype=torch.int32, device=device)
    stream, index = _build.stream_and_device(packed)
    ls_c, ls_n, ls_m = leaves.stride()
    code = lib.lib.bark_propose(
        packed.data_ptr(), u_move.data_ptr(), g_node.data_ptr(), u_feat.data_ptr(),
        u_cat.data_ptr(), u_int.data_ptr(), u_cont.data_ptr(), bounds.data_ptr(),
        feat_types.data_ptr(), X.data_ptr(), leaves.data_ptr(), ls_c, ls_n, ls_m,
        new_packed.data_ptr(), log_q_prior.data_ptr(), move.data_ptr(), node.data_ptr(),
        cur_leavesT.data_ptr(), new_leavesT.data_ptr(), c, m, nl, d, n, max_depth, cdf0, cdf1,
        alpha, log_alpha, beta, int(bounds.dtype == torch.float64),
        int(X.dtype == torch.float64), index, stream,
    )
    lib.check(code, "propose")
    propose_batch_cuda.launches += 1
    return new_packed, cur_leavesT, new_leavesT, log_q_prior, move, node


propose_batch_cuda.launches = 0  # kernel launches, for the chip check of the main path
