"""Fixed-shape tree traversal: node masks and node subspaces.

Counterpart of ``bark_tpu/fitting/traversal.py``, batched over any leading
dims (chains x trees). A proposal's chosen node takes its subspace from
the packed walk (:func:`node_subspace_packed`); ``subspace_mode="carry"``
starts from :func:`all_node_subspaces` (the walk on unpacked fields with
scatter writes, bit-identical) and keeps it current with
:func:`child_subspaces`.
"""

from __future__ import annotations

import torch

from bark_tpu_torch.fitting.bits import next_power_of_2
from bark_tpu_torch.forest import FEAT_CAT, FEAT_INT, Forest, pack_forest


def terminal_mask(tree: Forest) -> torch.Tensor:
    """Boolean mask of active leaves, ``(..., node_limit)``."""
    return tree.active & tree.is_leaf


def singly_internal_mask(tree: Forest) -> torch.Tensor:
    """Active decision nodes whose both children are leaves."""
    both_children_leaves = torch.gather(
        tree.is_leaf, -1, tree.left.long()
    ) & torch.gather(tree.is_leaf, -1, tree.right.long())
    return tree.active & (~tree.is_leaf) & both_children_leaves


def _walk_bounds(upper, lower, f, thr, is_left, feat_types):
    """One walk trip's new (ub, lb) of feature ``f`` from the current bounds
    and the parent's split (categorical complement against the next power
    of two of the current upper bound)."""
    ub_f = torch.gather(upper, -1, f[..., None])[..., 0]
    lb_f = torch.gather(lower, -1, f[..., None])[..., 0]
    ftype = feat_types[f]
    thr_i = thr.to(torch.int32)
    ub_i = ub_f.to(torch.int32)
    neg_thr = next_power_of_2(ub_i) - 1 - thr_i
    cat_ub = torch.where(is_left, thr_i & ub_i, neg_thr & ub_i).to(upper.dtype)
    int_delta = (ftype == FEAT_INT).to(lower.dtype)
    num_ub = torch.where(is_left, torch.minimum(thr, ub_f), ub_f)
    num_lb = torch.where(is_left, lb_f, torch.maximum(thr + int_delta, lb_f))
    f_is_cat = ftype == FEAT_CAT
    return torch.where(f_is_cat, cat_ub, num_ub), torch.where(f_is_cat, lb_f, num_lb)


def node_subspace_packed(
    packed: torch.Tensor,
    node_idx: torch.Tensor,
    bounds: torch.Tensor,
    feat_types: torch.Tensor,
    max_depth: int,
) -> torch.Tensor:
    """Sub-domain ``(B, D, 2)`` of the points reaching ``node_idx`` (B,).

    ``packed`` is (B, node_limit, 8). Walks the parent chain for
    ``max_depth`` trips, intersecting the bounds at every split: the bitmask
    AND for categoricals (complement against the next power of two of the
    current upper bound), min/max for numerics with +1 on the lower bound of
    integer right children. The reference's ``hot_style="walk_select"``
    walk, with each trip's reads as gathers.
    """
    b = packed.shape[0]
    rows = torch.arange(b, device=packed.device)
    lower = bounds[:, 0].expand(b, -1).clone()
    upper = bounds[:, 1].expand(b, -1).clone()
    iota_d = torch.arange(bounds.shape[0], device=packed.device)
    node = node_idx.long()
    for _ in range(max_depth):
        at_root = node == 0
        parent = packed[rows, node, 5].long()
        prow = packed[rows, parent]  # (B, 8)
        f = prow[:, 1].long()
        thr = prow[:, 2].contiguous().view(torch.float32)
        is_left = node == prow[:, 3]
        new_ub, new_lb = _walk_bounds(upper, lower, f, thr, is_left, feat_types)

        upd = (iota_d == f[:, None]) & ~at_root[:, None]
        upper = torch.where(upd, new_ub[:, None], upper)
        lower = torch.where(upd, new_lb[:, None], lower)
        node = torch.where(at_root, node, parent)
    return torch.stack([lower, upper], dim=-1)


def node_subspace(
    tree: Forest,
    node_idx: torch.Tensor,
    bounds: torch.Tensor,
    feat_types: torch.Tensor,
    max_depth: int,
) -> torch.Tensor:
    """Sub-domain ``(..., D, 2)`` of the points reaching ``node_idx`` (...).

    ``tree`` fields are (..., node_limit), one tree per leading index. The
    reference's ``node_subspace`` walk is the packed walk's arithmetic on
    unpacked fields, so this packs the trees and runs
    :func:`node_subspace_packed` over the flattened leading dims.
    """
    lead = node_idx.shape
    packed = pack_forest(tree).reshape(-1, tree.is_leaf.shape[-1], 8)
    box = node_subspace_packed(packed, node_idx.reshape(-1), bounds, feat_types, max_depth)
    return box.reshape(*lead, *box.shape[-2:])


def node_subspace_scatter(
    tree: Forest,
    node_idx: torch.Tensor,
    bounds: torch.Tensor,
    feat_types: torch.Tensor,
    max_depth: int,
) -> torch.Tensor:
    """Sub-domains ``(B, K, D, 2)`` of nodes ``node_idx`` (B, K) of trees
    with fields (B, node_limit): the reference's ``node_subspace`` walk
    (``hot_style="scatter"``), reading the unpacked fields by gathers and
    writing each trip's bound with a scatter, masked once the root is
    reached."""
    b, k = node_idx.shape
    d = bounds.shape[0]
    lower = bounds[:, 0].expand(b, k, d).clone()
    upper = bounds[:, 1].expand(b, k, d).clone()
    node = node_idx.long()
    for _ in range(max_depth):
        at_root = (node == 0)[..., None]
        parent = torch.gather(tree.parent, 1, node).long()
        f = torch.gather(tree.feature, 1, parent).long()
        thr = torch.gather(tree.threshold, 1, parent)
        is_left = node == torch.gather(tree.left, 1, parent)
        new_ub, new_lb = _walk_bounds(upper, lower, f, thr, is_left, feat_types)
        upper = torch.where(at_root, upper, upper.scatter(2, f[..., None], new_ub[..., None]))
        lower = torch.where(at_root, lower, lower.scatter(2, f[..., None], new_lb[..., None]))
        node = torch.where(at_root[..., 0], node, parent)
    return torch.stack([lower, upper], dim=-1)


def child_subspaces(
    subspace: torch.Tensor,
    feat: torch.Tensor,
    thr: torch.Tensor,
    feat_types: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Left and right child subspaces (B, D, 2) of nodes with subspaces
    ``subspace`` (B, D, 2) split by ``(feat, thr)`` (B,): one walk trip,
    top-down. Bit-identical with the walk from the root, which is what lets
    the sampler carry the subspaces: min and max are exact, and the
    intersections do not depend on their order, since the categorical
    complement ``(M - thr) & U == U & ~thr`` for any power-of-two ceiling
    ``M`` covering ``U``."""
    rows = torch.arange(subspace.shape[0], device=subspace.device)
    feat = feat.long()
    lower, upper = subspace[..., 0], subspace[..., 1]
    thr = thr.to(subspace.dtype)
    left = torch.ones_like(feat, dtype=torch.bool)
    left_ub, _ = _walk_bounds(upper, lower, feat, thr, left, feat_types)
    right_ub, right_lb = _walk_bounds(upper, lower, feat, thr, ~left, feat_types)
    left = subspace.clone()
    left[rows, feat, 1] = left_ub
    right = subspace.clone()
    right[rows, feat, 0] = right_lb
    right[rows, feat, 1] = right_ub
    return left, right


def all_node_subspaces(
    tree: Forest,
    bounds: torch.Tensor,
    feat_types: torch.Tensor,
    max_depth: int,
) -> torch.Tensor:
    """Subspaces of every node slot, ``(..., node_limit, D, 2)`` for trees
    with fields (..., node_limit): the start of the sampler's subspace
    carry. Rows of inactive slots hold whatever the walk gives and are
    never read (proposals target active nodes, and a grow writes the rows
    of the slots it activates)."""
    lead = tree.is_leaf.shape[:-1]
    nl = tree.is_leaf.shape[-1]
    flat = Forest(*(t.reshape(-1, nl) for t in tree))
    nodes = torch.arange(nl, device=bounds.device).expand(flat.is_leaf.shape[0], nl)
    subs = node_subspace_scatter(flat, nodes, bounds, feat_types, max_depth)
    return subs.reshape(*lead, *subs.shape[1:])
