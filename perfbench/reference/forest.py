"""Plain reference of the forest: routing, validity and the agreement Gram.

Written from the model's definition, in plain PyTorch on any device; it
imports nothing of the program. A forest is a dict of tensors with the
fields ``is_leaf, feature, threshold, left, right, parent, depth, active``,
each ``(C, m, node_limit)`` for C forests of m trees.
"""

from __future__ import annotations

import torch

FEAT_CAT = 0


def route(forest: dict, X: torch.Tensor, feat_types: torch.Tensor,
          max_depth: int = 16) -> torch.Tensor:
    """Leaf of every row in every tree, ``(C, N, m)`` int64: from the root,
    a numeric split sends ``x <= threshold`` left, a categorical one sends x
    left when bit x of the threshold's mask is set; a leaf stays put."""
    c, m, _ = forest["feature"].shape
    n = X.shape[0]
    node = torch.zeros((c, m, n), dtype=torch.int64, device=X.device)
    rows = torch.arange(n, device=X.device)
    is_cat = feat_types.to(X.device) == FEAT_CAT
    take = lambda name: torch.gather(forest[name], 2, node)  # noqa: E731
    for _ in range(max_depth):
        feat = take("feature").long()
        thr = take("threshold")
        x = X[rows, feat]
        bit = torch.bitwise_left_shift(torch.ones_like(feat), x.long().clamp(0, 31))
        left = torch.where(is_cat[feat], (bit & thr.long()) != 0, x <= thr)
        child = torch.where(left, take("left"), take("right")).long()
        node = torch.where(take("is_leaf"), node, child)
    return node.transpose(1, 2)


def invalid_nodes(forest: dict, bounds: torch.Tensor, feat_types: torch.Tensor,
                  max_depth: int = 16) -> torch.Tensor:
    """Count, per forest ``(C,)``, the nodes that break the tree structure
    or the domain: the root inactive; an active split whose children are not
    two distinct active nodes of it one level deeper, or whose feature is
    out of range; an active node deeper than ``max_depth`` or unreachable
    from the root; a numeric threshold outside the interval its ancestors
    leave to it (bounds ``(D, 2)``, ordinal), a categorical mask outside the
    feature's categories."""
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

    # walk from the root: reachability and each node's interval
    lo = bounds[:, 0].to(torch.float64).expand(c, m, nl, d).clone()
    hi = bounds[:, 1].to(torch.float64).expand(c, m, nl, d).clone()
    reached = torch.zeros_like(active)
    reached[..., 0] = active[..., 0]
    thr = forest["threshold"].to(torch.float64)
    fcl = feat.clamp(0, d - 1)
    is_cat = (feat_types.to(fcl.device) == FEAT_CAT)[fcl]
    numeric = torch.nn.functional.one_hot(fcl, d).bool() & ~is_cat[..., None]
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
            else:
                plo = torch.where(numeric, torch.maximum(plo, thr[..., None]), plo)
            idx = torch.where(src, cc, 0)[..., None].expand(c, m, nl, d)
            keep = src[..., None].expand(c, m, nl, d)
            lo = lo.scatter(2, idx, torch.where(keep, plo, torch.gather(lo, 2, idx)))
            hi = hi.scatter(2, idx, torch.where(keep, phi, torch.gather(hi, 2, idx)))
    bad += (active & ~reached).long().sum((-2, -1))
    node_lo = torch.gather(lo, 3, fcl[..., None])[..., 0]
    node_hi = torch.gather(hi, 3, fcl[..., None])[..., 0]
    numeric_bad = split & ~is_cat & ((thr < node_lo) | (thr > node_hi))
    cat_hi = bounds[:, 1].to(torch.float64)[fcl]
    cat_bad = split & is_cat & ((thr < 0) | (thr > cat_hi) | (thr != torch.round(thr)))
    bad += (numeric_bad | cat_bad).long().sum((-2, -1))
    return bad


def agreement(leaves_a: torch.Tensor, leaves_b: torch.Tensor, trees: torch.Tensor | None = None,
              dtype=torch.float64) -> torch.Tensor:
    """The number of trees in which two rows share a leaf, ``(C, A, B)``,
    from leaves ``(C, A, m)`` and ``(C, B, m)``; ``trees`` ``(C, m)`` bool
    keeps only those trees. One product of the rows' one-hot leaf
    indicators (a column per tree and leaf), so the counts are exact in any
    float type."""
    m = leaves_a.shape[-1]
    width = int(max(leaves_a.max(), leaves_b.max())) + 1
    offset = torch.arange(m, device=leaves_a.device) * width

    def indicator(leaves):
        z = torch.zeros((*leaves.shape[:2], m * width), dtype=dtype, device=leaves.device)
        return z.scatter_(2, leaves.long() + offset, 1.0)

    za = indicator(leaves_a)
    if trees is not None:
        za = za * trees.to(dtype).repeat_interleave(width, dim=1)[:, None, :]
    return za @ indicator(leaves_b).transpose(1, 2)
