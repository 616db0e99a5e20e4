"""Vectorized grow/prune/change proposals over packed fixed-shape trees.

Counterpart of ``bark_tpu/fitting/proposals.py`` for the sampler's default
path (``hot_style="walk_select"``, ``subspace_mode="walk"``), batched over
any number of trees at once (the sampler passes chains x trees). All the
randomness a proposal consumes is pre-drawn in a :class:`ProposalNoise`, so
the same noise gives the same proposal in both packages.

Invalid proposals (empty valid set, degenerate categorical/integer split,
tree at node capacity, node at the depth cap) give ``log_q_prior = -inf``
and leave the tree unchanged.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bark_tpu_torch.fitting.bits import popcount, scatter_bits
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.fitting.traversal import (
    node_subspace_packed,
    singly_internal_mask,
    terminal_mask,
)
from bark_tpu_torch.forest import FEAT_CAT, FEAT_INT, unpack_forest

GROW, PRUNE, CHANGE = 0, 1, 2


class ProposalNoise(NamedTuple):
    """All randomness one tree proposal consumes; fields share leading dims."""

    u_move: torch.Tensor  # uniform [0,1) -- move-type cdf draw
    g_node: torch.Tensor  # (..., node_limit) gumbel -- masked categorical
    u_feat: torch.Tensor  # uniform -- feature index
    u_cat: torch.Tensor  # uniform -- categorical subset rank
    u_int: torch.Tensor  # uniform -- integer threshold
    u_cont: torch.Tensor  # uniform -- continuous threshold
    u_accept: torch.Tensor  # uniform -- MH accept draw (used by the sampler)

    def to(self, device) -> "ProposalNoise":
        return ProposalNoise(*(t.to(device) for t in self))


def make_proposal_noise(
    generator: torch.Generator,
    num_moves: int,
    node_limit: int,
    batch_shape: tuple[int, ...] = (),
) -> ProposalNoise:
    """Draw the noise for ``(*batch_shape, num_moves)`` proposals.

    Same distributions as the reference: uniforms on [0, 1) and standard
    Gumbel noise ``-log(-log(u))`` with u on [tiny, 1). Tensors live on the
    generator's device.
    """
    shape = (*batch_shape, num_moves)
    dev = generator.device

    def uniform(*s):
        return torch.rand(s, generator=generator, device=dev)

    tiny = torch.finfo(torch.float32).tiny
    g_node = -torch.log(-torch.log(uniform(*shape, node_limit).clamp_min(tiny)))
    return ProposalNoise(
        u_move=uniform(*shape),
        g_node=g_node,
        u_feat=uniform(*shape),
        u_cat=uniform(*shape),
        u_int=uniform(*shape),
        u_cont=uniform(*shape),
        u_accept=uniform(*shape),
    )


def masked_choice_gumbel(gumbel: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Uniform draw from the True entries of ``mask`` along the last dim by
    the Gumbel-argmax trick; the first index wins ties (0 if mask is empty)."""
    return torch.argmax(torch.where(mask, gumbel, -torch.inf), dim=-1)


def _sample_split_from_bounds(
    noise: ProposalNoise,
    lb: torch.Tensor,
    ub: torch.Tensor,
    ftype: torch.Tensor,
) -> torch.Tensor:
    """Threshold draw from the chosen feature's (lb, ub, type)."""
    # categorical: uniform proper non-empty subset of the available mask,
    # rank r uniform in [1, 2^c - 2]
    ub_mask = ub.to(torch.int32)
    c = popcount(ub_mask)
    max_sample = (torch.ones_like(c) << c) - 1
    span = torch.clamp_min(max_sample - 1, 1)
    r = 1 + torch.minimum(
        (noise.u_cat * span.to(torch.float32)).to(torch.int32), span - 1
    )
    cat_thr = scatter_bits(r, ub_mask, c).to(lb.dtype)

    lb_i = lb.to(torch.int32)
    ub_i = ub.to(torch.int32)
    ispan = (ub_i - lb_i).to(torch.float32)
    int_draw = lb_i + torch.minimum(
        (noise.u_int * ispan).to(torch.int32), torch.clamp_min(ub_i - lb_i - 1, 0)
    )
    int_thr = torch.where(lb_i == ub_i, ub_i, int_draw).to(lb.dtype)

    # lb + u (ub - lb) rounded once, as a fused multiply-add (the
    # reference's XLA lowering contracts it): float64 holds u (ub - lb)
    # exactly, so the sum rounds to float32 once
    span_f = (ub - lb).to(torch.float64)
    cont_thr = (lb.to(torch.float64) + noise.u_cont.to(torch.float64) * span_f).to(lb.dtype)

    return torch.where(
        ftype == FEAT_CAT,
        cat_thr,
        torch.where(ftype == FEAT_INT, int_thr, cont_thr),
    )


def _first_two_inactive(
    active: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Indices of the first two inactive slots along the last dim, and
    whether two exist."""
    inactive = (~active).to(torch.int32)
    i1 = torch.argmax(inactive, dim=-1)
    inactive2 = inactive.scatter(-1, i1[..., None], 0)
    i2 = torch.argmax(inactive2, dim=-1)
    has_two = inactive.sum(-1) >= 2
    return i1, i2, has_two


def _log_f32(x: float) -> torch.Tensor:
    return torch.log(torch.tensor(x, dtype=torch.float32))


def propose_tree_packed(
    packed: torch.Tensor,
    bounds: torch.Tensor,
    feat_types: torch.Tensor,
    params: SamplerParams,
    noise: ProposalNoise,
):
    """One grow/prune/change proposal for each of a batch of packed trees.

    ``packed`` is ``(B, node_limit, 8)`` int32 and ``noise`` fields have
    leading dim B. Returns ``(new_packed, log_q_prior, move, node)`` with
    ``log_q_prior = log q-ratio + log depth-prior-ratio`` (-inf on
    rejection, in which case the tree is returned unchanged).
    """
    b, node_limit, _ = packed.shape
    device = packed.device
    rows = torch.arange(b, device=device)
    tree = unpack_forest(packed)

    weights = torch.tensor(params.proposal_weights, dtype=torch.float32, device=device)
    cdf = torch.cumsum(weights, 0) / weights.sum()
    move = (noise.u_move[:, None] >= cdf[:2]).sum(-1, dtype=torch.int32)

    term = terminal_mask(tree)
    si = singly_internal_mask(tree)
    is_grow = move == GROW
    is_prune = move == PRUNE

    valid = torch.where(is_grow[:, None], term, si)
    n_valid = valid.sum(-1)
    n = masked_choice_gumbel(noise.g_node, valid)

    subspace = node_subspace_packed(packed, n, bounds, feat_types, params.max_depth)

    d = bounds.shape[0]
    feat = torch.clamp_max((noise.u_feat * d).to(torch.int32), d - 1).long()
    lb = subspace[rows, feat, 0]
    ub = subspace[rows, feat, 1]
    ftype = feat_types[feat]
    thr = _sample_split_from_bounds(noise, lb, ub, ftype)

    invalid_split = ((ftype == FEAT_CAT) & (thr == 0)) | (
        (ftype == FEAT_INT) & (thr == ub)
    )

    row_n = packed[rows, n]  # (B, 8)
    parent_n, depth_n = row_n[:, 5], row_n[:, 6]
    l, r = row_n[:, 3].long(), row_n[:, 4].long()
    i1, i2, has_two = _first_two_inactive(tree.active)
    depth_ok = depth_n + 1 <= params.max_depth

    reject = (
        (n_valid == 0)
        | ((~is_prune) & invalid_split)
        | (is_grow & (~has_two | ~depth_ok))
    )

    # --- transition ratio ----------------------------------------------------
    w0 = term.to(torch.float32).sum(-1)
    w1 = si.to(torch.float32).sum(-1)
    parent_si = si[rows, parent_n.long()]
    parent_was_si = (n != 0) & parent_si
    w1_star = w1 + 1.0 - parent_was_si.to(torch.float32)
    grow_q = torch.log(w0) - torch.log(w1_star)
    prune_q = torch.log(w1) - torch.log(torch.clamp_min(w0 - 1.0, 1.0))
    zero_f = torch.zeros_like(w0)
    log_q_ratio = torch.where(is_grow, grow_q, torch.where(is_prune, prune_q, zero_f))

    # --- depth-prior ratio ---------------------------------------------------
    alpha, beta = params.alpha, params.beta
    d_f = depth_n.to(torch.float32)
    pr = (
        _log_f32(alpha).to(device)
        + 2.0 * torch.log(1.0 - alpha / (2.0 + d_f) ** beta)
        - torch.log((1.0 + d_f) ** beta - alpha)
    )
    log_prior_ratio = torch.where(is_grow, pr, torch.where(is_prune, -pr, zero_f))

    # --- structural edit: whole-row writes on copies of the packed trees ------
    thr_bits = thr.to(torch.float32).contiguous().view(torch.int32)
    zero = torch.zeros_like(depth_n)
    one = torch.ones_like(depth_n)
    n32 = n.to(torch.int32)
    d1 = depth_n + 1
    child_row = torch.stack([one, zero, zero, zero, zero, n32, d1, one], -1)
    parent_row = torch.stack(
        [zero, feat.to(torch.int32), thr_bits, i1.to(torch.int32),
         i2.to(torch.int32), parent_n, depth_n, one],
        -1,
    )
    grown = packed.clone()
    grown[rows, i1] = child_row
    grown[rows, i2] = child_row
    grown[rows, n] = parent_row
    pruned = packed.clone()
    pruned[rows, l, 7] = 0
    pruned[rows, r, 7] = 0
    pruned[rows, n, 0] = 1
    changed = packed.clone()
    changed[rows, n, 1] = feat.to(torch.int32)
    changed[rows, n, 2] = thr_bits

    sel = lambda mask: mask[:, None, None]  # noqa: E731
    proposed = torch.where(
        sel(is_grow), grown, torch.where(sel(is_prune), pruned, changed)
    )
    new_packed = torch.where(sel(reject), packed, proposed)
    log_q_prior = torch.where(
        reject, torch.full_like(w0, -math.inf), log_q_ratio + log_prior_ratio
    )
    return new_packed, log_q_prior, move, n.to(torch.int32)
