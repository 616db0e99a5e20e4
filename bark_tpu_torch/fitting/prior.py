"""Ancestral sampling from the BARK forest prior, fixed-shape.

Counterpart of ``bark_tpu/fitting/prior.py``. Each tree grows by the
pending-slot scan of the reference: ``node_limit`` trips, each resolving the
lowest pending slot, which splits with probability alpha (1 + depth)^-beta
into a rule drawn inside the node's subspace; an invalid categorical or
integer split, a tree without two free slots and a node at ``max_depth``
stay leaves. The scan runs over every (sample, tree) pair at once.

All randomness is one :class:`PriorDraws` record (:func:`draw_prior`). The
split rule is drawn by the uniform form of the proposals
(``proposals._sample_split_from_bounds``), which gives the distributions of
the reference's keyed ``sample_splitting_rule`` but not its draws one for
one; the noise prior takes its standard-gamma draws as a tensor, so it can
replay the reference's exactly.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import torch

from bark_tpu_torch.fitting.bits import next_power_of_2
from bark_tpu_torch.fitting.proposals import _first_two_inactive, _sample_split_from_bounds
from bark_tpu_torch.forest import (
    DEFAULT_MAX_DEPTH,
    DEFAULT_NODE_LIMIT,
    FEAT_CAT,
    FEAT_INT,
    Forest,
    create_empty_forest,
    pack_forest,
    unpack_forest,
)


class PriorDraws(NamedTuple):
    """All randomness of ``S`` prior samples of ``m`` trees.

    The first five fields are (S, m, node_limit) uniforms on [0, 1), one per
    trip of the scan; ``gamma`` is (S,) standard-gamma draws of the noise
    prior's shape.
    """

    u_grow: torch.Tensor  # grow decision
    u_feat: torch.Tensor  # split feature
    u_cat: torch.Tensor  # categorical subset rank
    u_int: torch.Tensor  # integer threshold
    u_cont: torch.Tensor  # continuous threshold
    gamma: torch.Tensor  # (S,) Gamma(shape, 1)

    def to(self, device) -> "PriorDraws":
        return PriorDraws(*(t.to(device) for t in self))


def draw_prior(
    generator: torch.Generator,
    num_samples: int,
    m: int,
    node_limit: int = DEFAULT_NODE_LIMIT,
    gamma_shape: float = 1.5,
    device=None,
) -> PriorDraws:
    """Draw the randomness of ``num_samples`` prior forests and noises on
    the generator's device, moved to ``device``."""
    dev = generator.device
    shape = (num_samples, m, node_limit)
    uniforms = [torch.rand(shape, generator=generator, device=dev) for _ in range(5)]
    alpha = torch.full((num_samples,), float(gamma_shape), dtype=torch.float32, device=dev)
    draws = PriorDraws(*uniforms, torch._standard_gamma(alpha, generator=generator))
    return draws if device is None else draws.to(device)


def sample_forest_prior(
    draws: PriorDraws,
    m: int,
    bounds: torch.Tensor,
    feat_types: torch.Tensor,
    alpha: float = 0.95,
    beta: float = 2.0,
    node_limit: int = DEFAULT_NODE_LIMIT,
    max_depth: int = DEFAULT_MAX_DEPTH,
) -> Forest:
    """``S`` forests from the prior, fields ``(S, m, node_limit)``, on the
    device of ``bounds`` (``S`` from ``draws``)."""
    s = draws.u_grow.shape[0]
    packed, _ = _grow_trees(draws, m, bounds, feat_types, alpha, beta, node_limit, max_depth)
    return unpack_forest(packed.reshape(s, m, node_limit, 8))


def _grow_trees(draws, m, bounds, feat_types, alpha, beta, node_limit, max_depth):
    """The pending-slot scan over every (sample, tree) pair: ``(packed
    (S * m, node_limit, 8), the sub-domain of each slot (S * m, node_limit,
    D, 2))``.

    A slot's sub-domain is the one ``traversal.node_subspace_packed`` finds
    by walking up from it. It is carried down instead: a child's is its
    parent's narrowed at the split, with the walk's arithmetic. The
    narrowings are min, max and a bitmask AND (the walk's categorical
    complement is the complement within the bits of a bound it exceeds), so
    their order does not change the result.
    """
    s = draws.u_grow.shape[0]
    if draws.u_grow.shape[1:] != (m, node_limit):
        raise ValueError(
            f"draws are for (m, node_limit) = {tuple(draws.u_grow.shape[1:])}, "
            f"not ({m}, {node_limit})"
        )
    b, d = s * m, bounds.shape[0]
    dev = bounds.device
    draws = draws.to(dev)
    packed = pack_forest(create_empty_forest(m, node_limit, (s,), dev)).reshape(b, node_limit, 8)
    sub = bounds.to(torch.float32).expand(b, node_limit, d, 2).clone()
    rows = torch.arange(b, device=dev)
    slots = torch.arange(node_limit, device=dev)
    iota_d = torch.arange(d, device=dev)
    pending = slots == 0
    pending = pending.expand(b, node_limit)
    u_grow, u_feat, u_cat, u_int, u_cont = (t.reshape(b, node_limit) for t in draws[:5])
    one = torch.ones(b, dtype=torch.int32, device=dev)
    zero = torch.zeros_like(one)
    for trip in range(node_limit):
        any_pending = pending.any(-1)
        n = torch.argmax(pending.to(torch.int32), -1)
        pending = pending & (slots != n[:, None])
        row_n = packed[rows, n]  # (B, 8)
        depth_n = row_n[:, 6]
        grow_prob = alpha * (1.0 + depth_n.to(torch.float32)) ** (-beta)
        want_grow = u_grow[:, trip] <= grow_prob

        subspace = sub[rows, n]  # (B, D, 2)
        feat = torch.clamp_max((u_feat[:, trip] * d).to(torch.int32), d - 1).long()
        lb, ub = subspace[rows, feat, 0], subspace[rows, feat, 1]
        ftype = feat_types[feat]
        split = SimpleNamespace(u_cat=u_cat[:, trip], u_int=u_int[:, trip], u_cont=u_cont[:, trip])
        thr = _sample_split_from_bounds(split, lb, ub, ftype)
        is_cat = ftype == FEAT_CAT
        invalid = (is_cat & (thr == 0)) | ((ftype == FEAT_INT) & (thr == ub))

        i1, i2, has_two = _first_two_inactive(packed[..., 7] != 0)
        depth_ok = depth_n + 1 <= max_depth
        keep = ~(any_pending & want_grow & ~invalid & has_two & depth_ok)[:, None]

        child_row = torch.stack([one, zero, zero, zero, zero, n.to(torch.int32), depth_n + 1, one], -1)
        parent_row = torch.stack(
            [zero, feat.to(torch.int32), thr.contiguous().view(torch.int32),
             i1.to(torch.int32), i2.to(torch.int32), row_n[:, 5], depth_n, one],
            -1,
        )
        packed[rows, i1] = torch.where(keep, packed[rows, i1], child_row)
        packed[rows, i2] = torch.where(keep, packed[rows, i2], child_row)
        packed[rows, n] = torch.where(keep, row_n, parent_row)

        # the children's sub-domains: i1 left, i2 right (the walk's formulas)
        thr_i, ub_i = thr.to(torch.int32), ub.to(torch.int32)
        complement = next_power_of_2(ub_i) - 1 - thr_i
        left_ub = torch.where(is_cat, (thr_i & ub_i).to(ub.dtype), torch.minimum(thr, ub))
        right_ub = torch.where(is_cat, (complement & ub_i).to(ub.dtype), ub)
        right_lb = torch.where(
            is_cat, lb, torch.maximum(thr + (ftype == FEAT_INT).to(lb.dtype), lb))
        at_feat = (iota_d == feat[:, None])[..., None]  # (B, D, 1)
        left = torch.where(at_feat, torch.stack([lb, left_ub], -1)[:, None], subspace)
        right = torch.where(at_feat, torch.stack([right_lb, right_ub], -1)[:, None], subspace)
        keep3 = keep[..., None]
        sub[rows, i1] = torch.where(keep3, sub[rows, i1], left)
        sub[rows, i2] = torch.where(keep3, sub[rows, i2], right)
        fresh = (slots == i1[:, None]) | (slots == i2[:, None])
        pending = pending | (~keep & fresh)
    return packed, sub


def sample_noise_prior(gamma_draws: torch.Tensor, gamma_rate: float) -> torch.Tensor:
    """Gamma(shape, rate) noise from standard-gamma draws of that shape."""
    return (gamma_draws / gamma_rate).to(torch.float32)
