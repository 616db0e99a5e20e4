"""Leaf-agreement Gram: the CUDA kernel K1 and its plain PyTorch version.

Counterpart of ``bark_tpu/ops/pallas_gram.py`` (``counts_from_leaves_pallas``
/ ``gram_from_leaves_pallas``). For leaf assignments ``l1`` (B, N, m) and
``l2`` (B, M, m) it returns

    counts[b, i, j] / m * mask1[i] * mask2[j],
    counts[b, i, j] = #{t : l1[b, i, t] == l2[b, j, t]},

the agreement Gram the sampler factors at every refresh. The kernel is
``csrc/gram.cu`` (see its header for the design): it slices the leaf ids,
node slots in [0, node_limit), into bit planes of 32 trees and compares 32
trees with one instruction per plane. :func:`launch_plan` fixes the plane
count, tile and jobs; this module validates the arguments, allocates the
output and launches the kernel on the current stream.

A tensor on the CPU takes :func:`gram_plain`; a CUDA tensor always takes the
kernel, and a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from bark_tpu_torch.ops import _build

DEFAULT_NODE_LIMIT = 64  # node slots per tree (the forest's default)
PLANES = (6, 16)  # bit planes instantiated in csrc/gram.cu
MAX_NODE_LIMIT = 2 ** PLANES[-1]
MIN_JOBS = 256  # about two tiles per SM before a tile is chosen for efficiency
# (tile edge, micro-tile edge) as instantiated in csrc/gram.cu, largest first
TILES = ((32, 4), (16, 2))
ROW_PAD = 64  # the plane scratch pads rows to a pass block (csrc/gram.cu kRowPad)


def gram_plain(
    l1: torch.Tensor,
    l2: torch.Tensor,
    mask1: torch.Tensor | None = None,
    mask2: torch.Tensor | None = None,
    node_limit: int = DEFAULT_NODE_LIMIT,
) -> torch.Tensor:
    """Plain PyTorch version: a broadcast compare, summed over trees.

    ``l1`` (..., N, m), ``l2`` (..., M, m) -> (..., N, M) float32. The
    division is a true IEEE division by m (a tensor divisor: a CPU-scalar
    divisor would let the CUDA backend multiply by 1/m instead), followed by
    the row and column masks -- the kernel's order of operations, so the
    two agree bit for bit. ``node_limit`` is accepted for the kernel's
    signature; the compare does not need it.
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


class LaunchPlan(NamedTuple):
    """How ``csrc/gram.cu`` is launched for one call: one block per job, an
    output tile of ``tile`` x ``tile``."""

    planes: int  # bits per leaf id: 2 ** planes >= node_limit
    words: int  # 32-tree words per row, ceil(m / 32)
    tile: int  # output tile edge of a job
    micro: int  # output micro-tile edge of a thread
    tiles: int  # jobs per chain
    cols: int  # column tiles (symmetric: tiles along the edge)
    jobs: int  # batch x tiles
    symmetric: bool  # only tile pairs ti <= tj, each mirrored

    @property
    def threads(self) -> int:
        return (self.tile // self.micro) ** 2


def planes_for(node_limit: int) -> int:
    """Bit planes that hold ids in [0, node_limit)."""
    if not 1 <= node_limit <= MAX_NODE_LIMIT:
        raise ValueError(
            f"node_limit {node_limit} outside [1, {MAX_NODE_LIMIT}]: leaf ids "
            f"must fit {PLANES[-1]} bit planes"
        )
    need = max(node_limit - 1, 1).bit_length()
    return next(p for p in PLANES if p >= need)


def _tiles(n: int, mcols: int, tile: int, symmetric: bool) -> tuple[int, int]:
    """(tiles per chain, column tiles)."""
    if symmetric:
        nt = -(-n // tile)
        return nt * (nt + 1) // 2, nt
    cols = -(-mcols // tile)
    return -(-n // tile) * cols, cols


@functools.lru_cache(maxsize=256)
def launch_plan(
    batch: int,
    n: int,
    mcols: int,
    m: int,
    node_limit: int = DEFAULT_NODE_LIMIT,
    symmetric: bool = False,
    tile: int | None = None,
) -> LaunchPlan:
    """The launch of one (batch, n, mcols, m) call.

    The tile is the one with the fewest compare instructions over its padded
    tiles (a plane's LOP3 and its share of the micro-tile's loads, then a
    popc and an add a pair) among those that give at least ``MIN_JOBS`` jobs
    (the smallest tile when none does); ``tile`` pins it instead.
    """
    planes = planes_for(node_limit)
    if symmetric and n != mcols:
        raise ValueError(f"a symmetric call needs N == M, got {n} and {mcols}")
    words = -(-m // 32)

    def cost(t: int, r: int) -> float:
        return _tiles(n, mcols, t, symmetric)[0] * t * t * (planes * (1.0 + 2.0 / r**2) + 2.0)

    if tile is None:
        enough = [
            (t, r) for t, r in TILES if batch * _tiles(n, mcols, t, symmetric)[0] >= MIN_JOBS
        ]
        tile, micro = min(enough, key=lambda tr: cost(*tr)) if enough else TILES[-1]
    else:
        micro = dict(TILES).get(tile)
        if micro is None:
            raise ValueError(f"tile {tile} not one of {[t for t, _ in TILES]}")
    tiles, cols = _tiles(n, mcols, tile, symmetric)
    if batch * tiles >= 2**31:
        raise ValueError(f"gram: {batch} x {tiles} tiles exceed the launch limits")
    return LaunchPlan(planes, words, tile, micro, tiles, cols, batch * tiles, symmetric)


def plane_words(plan: LaunchPlan, batch: int, rows: int) -> int:
    """Scratch the plane pass writes for one operand: (batch, words, planes,
    rows padded to a multiple of ROW_PAD) 32-bit words."""
    return batch * plan.words * plan.planes * (-(-rows // ROW_PAD) * ROW_PAD)


def is_symmetric_call(l1, l2, mask1, mask2) -> bool:
    """The symmetric path is taken only for the same leaves tensor twice
    and the same mask tensor twice (or no masks)."""
    return l1 is l2 and mask1 is mask2


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
    node_limit: int = DEFAULT_NODE_LIMIT,
) -> torch.Tensor:
    """Launch ``csrc/gram.cu`` on (B, N, m) / (B, M, m) int32 CUDA tensors.

    The leaves may have any batch and row strides (a layout whose trees are
    not adjacent is copied first); their ids must lie in [0, node_limit).
    The same leaves and mask tensors passed twice take the symmetric path.
    """
    if not (l1.is_cuda and l2.is_cuda and l1.device == l2.device):
        raise ValueError("gram_cuda: leaves must be CUDA tensors on one device")
    if l1.dtype != torch.int32 or l2.dtype != torch.int32:
        raise ValueError(f"gram_cuda: leaves must be int32, got {l1.dtype}/{l2.dtype}")
    if l1.dim() != 3 or l2.dim() != 3:
        raise ValueError("gram_cuda: leaves must be (B, N, m) and (B, M, m)")
    b, n, m = l1.shape
    if l2.shape[0] != b or l2.shape[2] != m:
        raise ValueError(f"gram_cuda: shapes {tuple(l1.shape)} vs {tuple(l2.shape)}")
    if m < 1:
        raise ValueError(f"gram_cuda: m={m}: no trees")
    symmetric = is_symmetric_call(l1, l2, mask1, mask2)
    l1 = _adjacent_trees(l1)
    l2 = l1 if symmetric else _adjacent_trees(l2)
    plan = launch_plan(b, n, l2.shape[1], m, node_limit, symmetric)
    return launch(plan, l1, l2, mask1, mask2)


def _adjacent_trees(leaves: torch.Tensor) -> torch.Tensor:
    """The kernel reads a row's trees as adjacent ids and indexes within a
    chain in 32 bits; other layouts (the sampler's tree-major views) are
    copied first."""
    n, m = leaves.shape[1:]
    if m > 1 and leaves.stride(2) != 1:
        leaves = leaves.contiguous()
    if (n - 1) * leaves.stride(1) + m >= 2**31:
        raise ValueError(f"gram_cuda: a chain of {tuple(leaves.shape)} leaves spans 2^31 ids")
    return leaves


def launch(plan: LaunchPlan, l1, l2, mask1=None, mask2=None) -> torch.Tensor:
    """Launch ``csrc/gram.cu`` by ``plan`` on arguments :func:`gram_cuda`
    has checked (a pinned plan serves the tile sweep of the timing script)."""
    b, n, m = l1.shape
    mcols = l2.shape[1]
    if plan.symmetric and not is_symmetric_call(l1, l2, mask1, mask2):
        raise ValueError("gram: a symmetric plan needs the same leaves and masks twice")
    m1, s1 = _mask_arg(mask1, b, n, l1.device)
    m2, s2 = _mask_arg(mask2, b, mcols, l1.device)
    lib = _build.load_library()
    out = torch.empty((b, n, mcols), dtype=torch.float32, device=l1.device)
    # scratch, 32-bit words: the planes of l1, of l2 (none for a symmetric
    # call), then c / m for c <= m
    words1 = plane_words(plan, b, n)
    words2 = 0 if plan.symmetric else plane_words(plan, b, mcols)
    scratch = torch.empty(words1 + words2 + m + 1, dtype=torch.int32, device=l1.device)
    planes1 = scratch.data_ptr()
    planes2 = planes1 + 4 * words1
    stream, device = _build.stream_and_device(l1)
    code = lib.lib.bark_gram(
        l1.data_ptr(), l1.stride(0), l1.stride(1), l2.data_ptr(), l2.stride(0), l2.stride(1),
        planes1, planes1 if plan.symmetric else planes2, planes2 + 4 * words2,
        None if m1 is None else m1.data_ptr(), s1,
        None if m2 is None else m2.data_ptr(), s2,
        out.data_ptr(), b, n, mcols, m, plan.planes, plan.tile, int(plan.symmetric),
        plan.jobs, plan.tiles, plan.cols, device, stream,
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
    node_limit: int = DEFAULT_NODE_LIMIT,
) -> torch.Tensor:
    """Agreement Gram of ``leaves1`` (..., N, m) and ``leaves2`` (..., M, m).

    Leaf ids lie in [0, node_limit), as in the reference's
    ``forest.gram_from_leaves``. Masks are (N,)/(M,) or carry the same
    leading dims. CUDA tensors go through the kernel (the symmetric path
    when the same leaves and masks come twice), CPU tensors through
    :func:`gram_plain`.
    """
    if not leaves1.is_cuda:
        return gram_plain(leaves1, leaves2, mask1, mask2, node_limit)
    lead = leaves1.shape[:-2]
    if leaves2.shape[:-2] != lead:
        raise ValueError(
            f"leading dims differ: {tuple(leaves1.shape)} vs {tuple(leaves2.shape)}"
        )
    n, m = leaves1.shape[-2:]
    mcols = leaves2.shape[-2]
    b = math.prod(lead)

    def flat_mask(mask, rows):
        if mask is None:
            return None
        mask = mask.to(torch.float32)
        shape = (rows,) if mask.dim() == 1 else (b, rows)
        return mask.reshape(shape).contiguous()

    l1 = leaves1.to(torch.int32).reshape(b, n, m)
    m1 = flat_mask(mask1, n)
    out = gram_cuda(
        l1,
        l1 if leaves2 is leaves1 else leaves2.to(torch.int32).reshape(b, mcols, m),
        m1,
        m1 if mask2 is mask1 else flat_mask(mask2, mcols),
        node_limit,
    )
    return out.reshape(*lead, n, mcols)
