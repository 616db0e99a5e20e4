"""Fixed-shape tree traversal: node masks and node subspaces.

Counterpart of the parts of ``bark_tpu/fitting/traversal.py`` the sampler's
default proposals and the acquisition search's leaf boxes use, batched over
any leading dims (chains x trees).
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

        ub_f = torch.gather(upper, 1, f[:, None])[:, 0]
        lb_f = torch.gather(lower, 1, f[:, None])[:, 0]
        ftype = feat_types[f]
        f_is_cat = ftype == FEAT_CAT
        f_is_int = ftype == FEAT_INT

        thr_i = thr.to(torch.int32)
        ub_i = ub_f.to(torch.int32)
        max_thr = next_power_of_2(ub_i) - 1
        neg_thr = max_thr - thr_i
        cat_ub = torch.where(is_left, thr_i & ub_i, neg_thr & ub_i).to(upper.dtype)

        int_delta = f_is_int.to(lower.dtype)
        num_ub = torch.where(is_left, torch.minimum(thr, ub_f), ub_f)
        num_lb = torch.where(is_left, lb_f, torch.maximum(thr + int_delta, lb_f))

        new_ub = torch.where(f_is_cat, cat_ub, num_ub)
        new_lb = torch.where(f_is_cat, lb_f, num_lb)

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
