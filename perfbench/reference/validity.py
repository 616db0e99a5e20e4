"""Plain reference of a forest's validity, with categorical splits judged
as bitmasks.

A categorical split sends a row left when bit x of its threshold is set, so
its threshold is a set of categories, not a number on the ordinal axis.
:func:`invalid_nodes` here counts what ``forest.invalid_nodes`` counts, and
judges such a split against the categories that reach its node: the mask
must be an integer, non-zero, hold no category that an ancestor's split on
the same input sent the other way, and not be the whole of what reaches
the node. On a forest with no categorical split the two functions give the
same counts. ``forest.invalid_nodes`` holds a mask to the ordinal bounds
[0, k - 1] instead, which is right for no categorical forest.

Plain PyTorch on any device; it imports nothing of the program.
"""

from __future__ import annotations

import torch

from perfbench.reference.forest import FEAT_CAT


def invalid_nodes(forest: dict, bounds: torch.Tensor, feat_types: torch.Tensor,
                  max_depth: int = 16) -> torch.Tensor:
    """Count, per forest ``(C,)``, the nodes that break the tree structure
    or the domain: the root inactive; an active split whose children are not
    two distinct active nodes of it one level deeper, or whose feature is
    out of range; an active node deeper than ``max_depth`` or unreachable
    from the root; a numeric threshold outside the interval its ancestors
    leave to it (bounds ``(D, 2)``, ordinal). A categorical split's
    threshold is a bitmask over the feature's k = hi + 1 categories: it is
    bad unless it is an integer, non-zero, has no bit outside the set of
    categories that reaches its node, and is not the whole of that set. The
    set at the root is all k; a split on the feature gives its left child
    ``reach & mask`` and its right child ``reach & ~mask``."""
    active = forest["active"]
    is_leaf = forest["is_leaf"]
    c, m, nl = active.shape
    split = active & ~is_leaf
    left, right = forest["left"].long(), forest["right"].long()
    feat = forest["feature"].long()
    depth = forest["depth"].long()
    bad = (~active[..., 0]).long().sum(-1)
    in_range = lambda t: (t > 0) & (t < nl)  # noqa: E731
    for child in (left, right):
        ok = in_range(child)
        cc = child.clamp(0, nl - 1)
        ok &= torch.gather(active, 2, cc)
        ok &= torch.gather(forest["parent"].long(), 2, cc) == torch.arange(nl, device=cc.device)
        ok &= torch.gather(depth, 2, cc) == depth + 1
        bad += (split & ~ok).long().sum((-2, -1))
    bad += (split & (left == right)).long().sum((-2, -1))
    d = bounds.shape[0]
    bad += (split & ((feat < 0) | (feat >= d))).long().sum((-2, -1))
    bad += (active & (depth > max_depth)).long().sum((-2, -1))

    # walk from the root: reachability, each node's interval and the
    # categories that reach it
    lo = bounds[:, 0].to(torch.float64).expand(c, m, nl, d).clone()
    hi = bounds[:, 1].to(torch.float64).expand(c, m, nl, d).clone()
    full = ((1 << (bounds[:, 1].long() + 1).clamp(0, 62)) - 1).to(active.device)
    reach = full.expand(c, m, nl, d).clone()
    reached = torch.zeros_like(active)
    reached[..., 0] = active[..., 0]
    thr = forest["threshold"].to(torch.float64)
    fcl = feat.clamp(0, d - 1)
    is_cat = (feat_types.to(fcl.device) == FEAT_CAT)[fcl]
    onehot = torch.nn.functional.one_hot(fcl, d).bool()
    numeric = onehot & ~is_cat[..., None]
    categorical = onehot & is_cat[..., None]
    mask = thr.clamp(0, 2.0**62).long()
    for _ in range(max_depth + 1):
        grow = reached & split
        for child, side in ((left, "left"), (right, "right")):
            cc = child.clamp(0, nl - 1)
            src = grow & in_range(child)
            reached = reached | torch.zeros_like(reached).scatter_(2, torch.where(src, cc, 0), src)
            reached[..., 0] = active[..., 0]
            # the child's interval: the parent's, cut at the threshold
            plo = lo.clone()
            phi = hi.clone()
            if side == "left":
                phi = torch.where(numeric, torch.minimum(phi, thr[..., None]), phi)
                preach = torch.where(categorical, reach & mask[..., None], reach)
            else:
                plo = torch.where(numeric, torch.maximum(plo, thr[..., None]), plo)
                preach = torch.where(categorical, reach & ~mask[..., None], reach)
            idx = torch.where(src, cc, 0)[..., None].expand(c, m, nl, d)
            keep = src[..., None].expand(c, m, nl, d)
            lo = lo.scatter(2, idx, torch.where(keep, plo, torch.gather(lo, 2, idx)))
            hi = hi.scatter(2, idx, torch.where(keep, phi, torch.gather(hi, 2, idx)))
            reach = reach.scatter(2, idx, torch.where(keep, preach, torch.gather(reach, 2, idx)))
    bad += (active & ~reached).long().sum((-2, -1))
    node_lo = torch.gather(lo, 3, fcl[..., None])[..., 0]
    node_hi = torch.gather(hi, 3, fcl[..., None])[..., 0]
    numeric_bad = split & ~is_cat & ((thr < node_lo) | (thr > node_hi))
    node_reach = torch.gather(reach, 3, fcl[..., None])[..., 0]
    cat_ok = ((thr == torch.round(thr)) & (thr > 0) & ((mask & ~node_reach) == 0)
              & (mask != node_reach))
    cat_bad = split & is_cat & ~cat_ok
    bad += (numeric_bad | cat_bad).long().sum((-2, -1))
    return bad
