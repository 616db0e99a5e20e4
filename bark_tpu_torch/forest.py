"""Fixed-shape forest encoding, leaf routing and the agreement Gram.

Counterpart of ``bark_tpu/forest.py``. A forest is a struct of
``(..., m, node_limit)`` tensors (:class:`Forest`); leading dimensions are
batch (chains, samples). Node records mirror the reference:

  - categorical splits test ``(1 << x) & threshold`` (the threshold is a
    bitmask, exact in float32 up to ``MAX_CATEGORIES``); numeric splits
    test ``x <= threshold``;
  - routing is the fixed-trip gather walk (``max_depth`` trips), the walk
    the reference names as the CPU/GPU choice (``route_forest_auto``);
    ``route_forest_select`` is the reference's TPU lowering of the same
    walk, as one-hot transition products, with identical results;
  - the agreement Gram counts, for each pair of points, the trees in which
    they share a leaf, divided by ``m``. It runs through the hand-written
    CUDA kernel of :mod:`bark_tpu_torch.ops.gram` on the card;
  - the compact leaf indicator Z (:func:`indicator_from_targets`) packs
    each tree's active leaves into columns, so that ``Z Z^T`` is ``m``
    times that Gram; the sampler's leaf tier works with Z instead.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# the reference's forest.gram_from_leaves; it compares leaf ids directly (no
# one-hot over node slots is built); node_limit sets its bit-plane count
from bark_tpu_torch.ops.gram import DEFAULT_NODE_LIMIT, gram_from_leaves  # noqa: F401

# Feature type codes (Cat=0, Int=1, Cont=2), as in the reference.
FEAT_CAT = 0
FEAT_INT = 1
FEAT_CONT = 2

DEFAULT_MAX_DEPTH = 16
MAX_CATEGORIES = 24

FOREST_FIELDS = (
    "is_leaf", "feature", "threshold", "left", "right", "parent", "depth",
    "active",
)


class Forest(NamedTuple):
    """Struct-of-tensors forest with leading shape ``(..., m, node_limit)``.

    ``is_leaf``/``active`` are bool, ``threshold`` float32, the rest int32.
    ``parent`` of the root is 0.
    """

    is_leaf: torch.Tensor
    feature: torch.Tensor
    threshold: torch.Tensor
    left: torch.Tensor
    right: torch.Tensor
    parent: torch.Tensor
    depth: torch.Tensor
    active: torch.Tensor

    @property
    def num_trees(self) -> int:
        return self.is_leaf.shape[-2]

    @property
    def node_limit(self) -> int:
        return self.is_leaf.shape[-1]

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return tuple(self.is_leaf.shape[:-2])

    def to(self, device) -> "Forest":
        return Forest(*(t.to(device) for t in self))


def create_empty_forest(
    m: int,
    node_limit: int = DEFAULT_NODE_LIMIT,
    batch_shape: tuple[int, ...] = (),
    device=None,
) -> Forest:
    """All-stump forest: each tree is a single active root leaf."""
    shape = (*batch_shape, m, node_limit)
    zeros_i = torch.zeros(shape, dtype=torch.int32, device=device)
    root = torch.zeros(shape, dtype=torch.bool, device=device)
    root[..., 0] = True
    return Forest(
        is_leaf=root,
        feature=zeros_i,
        threshold=torch.zeros(shape, dtype=torch.float32, device=device),
        left=zeros_i.clone(),
        right=zeros_i.clone(),
        parent=zeros_i.clone(),
        depth=zeros_i.clone(),
        active=root.clone(),
    )


def forest_from_numpy(arrays: dict, device=None) -> Forest:
    """Build a Forest from a dict of numpy arrays (one per field)."""
    dtypes = {
        "is_leaf": torch.bool, "active": torch.bool, "threshold": torch.float32,
    }
    return Forest(
        **{
            k: torch.as_tensor(
                np.array(arrays[k]), dtype=dtypes.get(k, torch.int32)
            ).to(device)
            for k in FOREST_FIELDS
        }
    )


def _split_decision(
    x_feat: torch.Tensor, threshold: torch.Tensor, is_cat: torch.Tensor
) -> torch.Tensor:
    """Per-node split decision; True -> go left.

    Categorical: ``(1 << x) & mask``; numeric: ``x <= threshold``. The
    shift amount is clamped to [0, 31] so the bit test is defined for every
    input (a categorical value is an index below ``MAX_CATEGORIES``; the
    clamp only touches entries whose categorical branch is not selected).
    """
    shift = x_feat.to(torch.int32).clamp(0, 31)
    bit = torch.bitwise_left_shift(torch.ones_like(shift), shift)
    cat_cond = (bit & threshold.to(torch.int32)) != 0
    num_cond = x_feat <= threshold
    return torch.where(is_cat, cat_cond, num_cond)


def route_tree(
    tree: Forest,
    X: torch.Tensor,
    feat_types: torch.Tensor,
    max_depth: int = DEFAULT_MAX_DEPTH,
) -> torch.Tensor:
    """Route ``X`` (N, D) through trees with fields ``(..., node_limit)``.

    Returns leaf node indices ``(..., N)`` (int32): a ``max_depth``-trip
    gather walk that stays put once a leaf is reached.
    """
    batch = tree.feature.shape[:-1]
    n = X.shape[0]
    is_cat = feat_types == FEAT_CAT
    rows = torch.arange(n, device=X.device)
    node = torch.zeros((*batch, n), dtype=torch.int64, device=X.device)
    for _ in range(max_depth):
        feat = torch.gather(tree.feature, -1, node).long()
        thr = torch.gather(tree.threshold, -1, node)
        x_val = X[rows, feat]
        go_left = _split_decision(x_val, thr, is_cat[feat])
        child = torch.where(
            go_left,
            torch.gather(tree.left, -1, node),
            torch.gather(tree.right, -1, node),
        ).long()
        node = torch.where(torch.gather(tree.is_leaf, -1, node), node, child)
    return node.to(torch.int32)


def route_forest(
    forest: Forest,
    X: torch.Tensor,
    feat_types: torch.Tensor,
    max_depth: int = DEFAULT_MAX_DEPTH,
) -> torch.Tensor:
    """Route data through every tree: fields ``(..., m, node_limit)`` ->
    leaf indices ``(..., N, m)`` (int32)."""
    return route_tree(forest, X, feat_types, max_depth).transpose(-1, -2)


def route_forest_select(
    forest: Forest,
    X: torch.Tensor,
    feat_types: torch.Tensor,
    max_depth: int = DEFAULT_MAX_DEPTH,
) -> torch.Tensor:
    """:func:`route_forest` as one-hot transition products, identical results.

    Every split decision of every node is taken at once (the feature values
    by one gather: a data value never goes through a product, where a
    reduced-precision multiply could round it across a threshold), and the
    walk advances a one-hot node distribution through each tree's left and
    right transition matrices:
    ``next = oh * is_leaf + (oh * dec) @ Lmat + (oh * (1 - dec)) @ Rmat``,
    exact on 0/1 operands. Fields (..., m, node_limit); returns leaf indices
    (..., N, m) (int32). Rows are walked in blocks of 1024 past 2048, so the
    (rows, ..., m, node_limit) transients stay one block's.
    """
    nl = forest.node_limit
    lead = forest.feature.shape[:-1]  # (..., m)
    feat = forest.feature.long()
    is_cat = (feat_types == FEAT_CAT)[feat]  # (..., m, L)
    stay = forest.is_leaf.to(torch.float32).reshape(-1, nl)  # (P, L), P trees
    Lmat = torch.nn.functional.one_hot(forest.left.long(), nl).to(torch.float32).reshape(-1, nl, nl)
    Rmat = torch.nn.functional.one_hot(forest.right.long(), nl).to(torch.float32).reshape(-1, nl, nl)

    def walk(Xb):
        dec = _split_decision(Xb[:, feat], forest.threshold, is_cat).to(torch.float32)
        dec = dec.reshape(Xb.shape[0], -1, nl)  # (Bb, P, L)
        oh = torch.zeros_like(dec)
        oh[..., 0] = 1.0
        for _ in range(max_depth):
            go = oh * (1.0 - stay)
            oh = (oh * stay + torch.einsum("bpl,pln->bpn", go * dec, Lmat)
                  + torch.einsum("bpl,pln->bpn", go * (1.0 - dec), Rmat))
        return torch.argmax(oh, dim=-1).to(torch.int32).reshape(Xb.shape[0], *lead)

    b = X.shape[0]
    blocks = [X] if b <= 2048 else torch.split(X, 1024)
    return torch.cat([walk(xb) for xb in blocks]).movedim(0, -2)


def route_forest_auto(
    forest: Forest,
    X: torch.Tensor,
    feat_types: torch.Tensor,
    max_depth: int = DEFAULT_MAX_DEPTH,
) -> torch.Tensor:
    """The routing of the device: the gather walk (:func:`route_forest`), as
    the reference chooses off a TPU, on the card and on the CPU alike (the
    one-hot products of :func:`route_forest_select` do O(node_limit) times
    the work). Same results either way."""
    return route_forest(forest, X, feat_types, max_depth)


def leaf_rank_targets(
    forest: Forest,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-tree dense leaf ranks ``(tmask, ranks, counts)``.

    ``tmask`` (..., m, node_limit) marks the active leaves; ``ranks`` is each
    slot's node-order rank among its tree's active leaves (junk at other
    slots: mask with ``tmask``); ``counts`` (..., m) is each tree's leaf
    count. The first stage of every compact-indicator packing.
    """
    tmask = forest.active & forest.is_leaf
    ranks = torch.cumsum(tmask, dim=-1, dtype=torch.int32) - 1
    counts = tmask.sum(-1, dtype=torch.int32)
    return tmask, ranks, counts


def indicator_from_targets(
    leaves: torch.Tensor, target: torch.Tensor, out_dim: int
) -> torch.Tensor:
    """(..., B, out_dim) float32 0/1 indicators: row i lights, for each tree
    j, column ``target[..., j, leaves[..., i, j]]``.

    ``leaves`` is (..., B, m), ``target`` (..., m, node_limit). Targets >=
    ``out_dim`` project to nothing. Built by direct indexing, one write per
    (row, tree); the (B, m * node_limit) one-hot is never formed. Live
    targets of one row are distinct (each tree owns its own columns), so the
    accumulation only ever adds one 1 to a column; an out-of-range target
    is clamped onto the last column and adds 0 there.
    """
    *batch, b, m = leaves.shape
    node_limit = target.shape[-1]
    slot = leaves.long() + node_limit * torch.arange(m, device=leaves.device)
    flat = target.reshape(*batch, 1, m * node_limit).expand(*batch, b, m * node_limit)
    t = torch.gather(flat, -1, slot)  # (..., B, m)
    out = torch.zeros((*batch, b, out_dim), dtype=torch.float32, device=leaves.device)
    live = (t < out_dim).to(torch.float32)
    return out.scatter_add_(-1, t.clamp(max=out_dim - 1).long(), live)


def compact_leaf_indicator(
    forest: Forest, leaves: torch.Tensor, max_leaves: int
) -> torch.Tensor:
    """(..., B, m * max_leaves) 0/1 leaf indicators with per-tree dense ranks.

    Tree j's active leaves take ranks 0..L_j-1 in node order inside the
    block ``[j * max_leaves, (j + 1) * max_leaves)``. With ``max_leaves =
    (node_limit + 1) // 2`` (a binary tree's leaf cap) the packing is
    injective for any forest, so ``Z Z^T`` is ``m`` times the agreement Gram.
    """
    m = forest.num_trees
    r = m * max_leaves
    tmask, ranks, _ = leaf_rank_targets(forest)
    base = max_leaves * torch.arange(m, dtype=torch.int32, device=ranks.device)[:, None]
    target = torch.where(tmask, base + ranks, r)
    return indicator_from_targets(leaves, target, r)


def num_null_trees(forest: Forest) -> torch.Tensor:
    """Number of single-leaf ("null") trees per forest in the batch (int32)."""
    return forest.is_leaf[..., 0].sum(-1, dtype=torch.int32)


def forest_gram_matrix(
    forest: Forest,
    x1: torch.Tensor,
    x2: torch.Tensor,
    feat_types: torch.Tensor,
    max_depth: int = DEFAULT_MAX_DEPTH,
) -> torch.Tensor:
    """Agreement Gram between two data sets under a forest, fields
    ``(..., m, node_limit)`` -> ``(..., N1, N2)``: routing, then the Gram
    (the kernel on the card). The same ``x1`` and ``x2`` tensor is routed
    once and takes the kernel's symmetric path."""
    l1 = route_forest(forest, x1, feat_types, max_depth)
    l2 = l1 if x2 is x1 else route_forest(forest, x2, feat_types, max_depth)
    return gram_from_leaves(l1, l2, node_limit=forest.node_limit)


def batched_forest_gram_matrix(
    forest: Forest,
    x1: torch.Tensor,
    x2: torch.Tensor,
    feat_types: torch.Tensor,
    max_depth: int = DEFAULT_MAX_DEPTH,
) -> torch.Tensor:
    """Gram matrices for a batch of forests, fields ``(B, m, node_limit)``
    -> ``(B, N1, N2)``, in one kernel launch."""
    if forest.is_leaf.dim() != 3:
        raise ValueError(f"a batch of forests has fields (B, m, node_limit), got "
                         f"{tuple(forest.is_leaf.shape)}")
    return forest_gram_matrix(forest, x1, x2, feat_types, max_depth)


def batched_forest_gram_matrix_no_null(
    forest: Forest,
    x1: torch.Tensor,
    x2: torch.Tensor,
    feat_types: torch.Tensor,
    max_depth: int = DEFAULT_MAX_DEPTH,
) -> torch.Tensor:
    """:func:`batched_forest_gram_matrix` with the single-leaf trees taken
    out: their constant n_null / m is subtracted and the rest rescaled by
    ``m / max(m - n_null, 1)``."""
    sim = batched_forest_gram_matrix(forest, x1, x2, feat_types, max_depth)
    m = forest.num_trees
    n_null = num_null_trees(forest).to(sim.dtype)[..., None, None]
    scale = m / torch.clamp_min(m - n_null, 1.0)
    return (sim - n_null / m) * scale


def flatten_batch(forest: Forest) -> Forest:
    """Fields (..., m, node_limit) -> (S, m, node_limit), S the product of
    the batch dims (chains x samples)."""
    m, node_limit = forest.num_trees, forest.node_limit
    return Forest(*(t.reshape(-1, m, node_limit) for t in forest))


def pack_forest(forest: Forest) -> torch.Tensor:
    """Pack the 8 fields into one int32 tensor ``(..., m, node_limit, 8)``.

    ``threshold`` keeps its exact bits through an int32 bitcast.
    """
    return torch.stack(
        [
            forest.is_leaf.to(torch.int32),
            forest.feature,
            forest.threshold.contiguous().view(torch.int32),
            forest.left,
            forest.right,
            forest.parent,
            forest.depth,
            forest.active.to(torch.int32),
        ],
        dim=-1,
    )


def unpack_forest(packed: torch.Tensor) -> Forest:
    """Inverse of :func:`pack_forest`."""
    return Forest(
        is_leaf=packed[..., 0].to(torch.bool),
        feature=packed[..., 1].contiguous(),
        threshold=packed[..., 2].contiguous().view(torch.float32),
        left=packed[..., 3].contiguous(),
        right=packed[..., 4].contiguous(),
        parent=packed[..., 5].contiguous(),
        depth=packed[..., 6].contiguous(),
        active=packed[..., 7].to(torch.bool),
    )
