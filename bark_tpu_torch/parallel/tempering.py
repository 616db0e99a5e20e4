"""Parallel tempering over forest posteriors, on one device.

Counterpart of ``bark_tpu/parallel/tempering.py`` (its single-device part).
A ladder of R replicas runs the BARK step at inverse temperatures
1 = beta_0 > ... > beta_{R-1} (likelihood tempering), with even-odd adjacent
swaps between rounds. Swaps move the temperatures, not the states
(:func:`swap_move`): the states stay where they are and the beta labels
move, so a swap costs O(R) whatever the forest size. Samples come from the
replica that holds beta = 1.

C independent ladders run together: their C * R replicas are the chain rows
of one :class:`ChainState` (ladder-major, row ``c * R + r``), and a round is
one :func:`step_with_info` call over all of them with a (C * R,) beta, then
one swap per ladder. A round is a pure function of its draws
(:class:`PTDraws`, :func:`pt_round`), so a test can replay the reference.

:func:`pt_swap_states` is the fixed-position swap of the reference's
sharded sampler (temperatures stay with positions, accepted pairs exchange
their states), kept as the single-device oracle of that scheme.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.fitting.sampler import (
    BARKModel,
    ChainState,
    StepDraws,
    StepInfo,
    draw_step,
    init_chain_state,
    step_with_info,
)
from bark_tpu_torch.forest import Forest
from bark_tpu_torch.ops.linalg import check_matmul_precision


class PTState(NamedTuple):
    chains: ChainState  # C * R chain rows, ladder-major
    betas: torch.Tensor  # (C, R) inverse temperatures, each row a permutation of the ladder


class PTDraws(NamedTuple):
    """All randomness of one round of C ladders of R replicas."""

    step: StepDraws  # C * R rows
    u_swap: torch.Tensor  # (C, R) uniforms, by rank on the ladder

    def to(self, device) -> "PTDraws":
        return PTDraws(self.step.to(device), self.u_swap.to(device))


def geometric_ladder(num_replicas: int, beta_min: float = 0.05, device=None) -> torch.Tensor:
    """Geometric inverse-temperature ladder from 1 down to ``beta_min``, (R,)."""
    if num_replicas == 1:
        return torch.ones(1, dtype=torch.float32, device=device)
    exponent = torch.arange(num_replicas, device=device) / (num_replicas - 1)
    return (beta_min ** exponent).to(torch.float32)


def draw_pt_round(
    generator: torch.Generator,
    num_ladders: int,
    num_replicas: int,
    params: SamplerParams,
    device=None,
) -> PTDraws:
    """Draw one round's randomness (see :func:`draw_step`)."""
    step = draw_step(generator, num_ladders * num_replicas, params)
    u_swap = torch.rand(
        (num_ladders, num_replicas), generator=generator, device=generator.device
    )
    draws = PTDraws(step, u_swap)
    return draws if device is None else draws.to(device)


def swap_move(
    u: torch.Tensor, betas: torch.Tensor, mlls: torch.Tensor, parity: int
) -> torch.Tensor:
    """Even-odd adjacent swap of temperatures, by rank on the ladder.

    ``betas``/``mlls``/``u`` are (..., R): any leading ladder dims. Replicas
    are ranked by beta, descending; pairs (0,1), (2,3), ... on even parity,
    (1,2), (3,4), ... on odd. A pair swaps its betas with probability
    min(1, exp((beta_i - beta_j) (mll_j - mll_i))), decided by the left
    member's uniform ``u[rank]`` for both. A NaN MLL (a chain over its leaf
    budget) never swaps: the comparison is False on NaN. Returns the new
    betas, a permutation of the old along the last dim.
    """
    r = betas.shape[-1]
    order = torch.argsort(-betas, dim=-1, stable=True)
    ranked_betas = betas.gather(-1, order)
    ranked_mlls = mlls.gather(-1, order)
    idx = torch.arange(r, device=betas.device)
    is_left = (idx % 2) == (int(parity) % 2)
    partner = torch.where(is_left, idx + 1, idx - 1)
    valid = (partner >= 0) & (partner < r)
    partner = partner.clamp(0, r - 1)
    partner_betas = ranked_betas[..., partner]
    delta = (ranked_betas - partner_betas) * (ranked_mlls[..., partner] - ranked_mlls)
    pair_u = torch.where(is_left, u, u[..., partner])
    pair_delta = torch.where(is_left, delta, delta[..., partner])
    accept = valid & (torch.log(pair_u) <= torch.clamp_max(pair_delta, 0.0))
    new_ranked = torch.where(accept, partner_betas, ranked_betas)
    return torch.empty_like(betas).scatter_(-1, order, new_ranked)


def pt_swap_states(
    u: torch.Tensor, chains: ChainState, betas: torch.Tensor, mlls: torch.Tensor, parity: int
) -> tuple[ChainState, torch.Tensor]:
    """Fixed-position even-odd swap of one ladder of R rows: the betas stay
    with their positions and accepted pairs exchange their whole chain
    states. Pairs are positions (parity, parity + 1), (parity + 2, ...), and
    a pair decides by the uniform of its left position, ``u[left]`` (R,).
    Returns (chains, accept (R,) bool, True on both members of a pair)."""
    r = betas.shape[0]
    idx = torch.arange(r, device=betas.device)
    is_left = ((idx - int(parity)) % 2) == 0
    partner = torch.where(is_left, idx + 1, idx - 1)
    valid = (partner >= 0) & (partner < r)
    partner = partner.clamp(0, r - 1)
    left = torch.minimum(idx, partner)
    delta = (betas - betas[partner]) * (mlls[partner] - mlls)
    accept = valid & (torch.log(u[left]) <= torch.clamp_max(delta, 0.0))
    return chains.take(torch.where(accept, partner, idx)), accept


def pt_round(
    state: PTState,
    parity: int,
    draws: PTDraws,
    X: torch.Tensor,
    y: torch.Tensor,
    bounds: torch.Tensor,
    feat_types: torch.Tensor,
    params: SamplerParams,
    mask: torch.Tensor | None = None,
) -> tuple[PTState, StepInfo]:
    """One round: a tempered step of every replica of every ladder (one
    :func:`step_with_info` call), then :func:`swap_move` on each ladder."""
    c, r = state.betas.shape
    chains, info = step_with_info(
        state.chains, X, y, bounds, feat_types, params, draws.step, mask,
        beta=state.betas.reshape(-1),
    )
    betas = swap_move(draws.u_swap, state.betas, chains.mll.reshape(c, r), parity)
    return PTState(chains, betas), info


class PTRun(NamedTuple):
    """What :func:`run_parallel_tempering` returns: the reference's four
    results, then the final state; leading dims as the input's, C or none."""

    samples: BARKModel  # cold samples at the kept rounds, ([C,] K) lead
    betas: torch.Tensor  # (T, [C,] R) beta trace
    swap_rate: torch.Tensor  # ([C],) mean share of replicas whose beta changed per round
    cold_mll: torch.Tensor  # ([C,] T) MLL of the beta = 1 replica after each round
    state: PTState  # the final state, C * R chain rows


def run_parallel_tempering(
    generator: torch.Generator,
    forest: Forest,
    noise: torch.Tensor,
    scale: torch.Tensor,
    X: torch.Tensor,
    y: torch.Tensor,
    bounds: torch.Tensor,
    feat_types: torch.Tensor,
    params: SamplerParams,
    num_replicas: int = 8,
    num_steps: int = 100,
    beta_min: float = 0.05,
    mask: torch.Tensor | None = None,
    keep: slice | None = None,
    draws: Sequence[PTDraws] | None = None,
) -> PTRun:
    """Run C ladders of ``num_replicas`` replicas for ``num_steps`` rounds.

    ``forest`` fields are (C, R, m, node_limit), ``noise``/``scale`` (C, R),
    or without the C dim as in the reference. The cold samples are the
    beta = 1 replica's forest, noise and scale at each round in
    ``range(num_steps)[keep]`` (every round when None); only those rounds
    are kept on the device. Draws come from ``generator``, or round t takes
    ``draws[t]``.
    """
    check_matmul_precision()
    lead = forest.batch_shape
    if lead[-1] != num_replicas:
        raise ValueError(f"forest has {lead[-1]} replicas, not num_replicas={num_replicas}")
    c = lead[0] if len(lead) == 2 else 1
    rows = c * num_replicas
    flat = Forest(*(t.reshape(rows, *t.shape[-2:]) for t in forest))
    dev = X.device
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev).expand(lead).reshape(-1)  # noqa: E731
    chains = init_chain_state(flat, f32(noise), f32(scale), X, y, feat_types, params, mask, bounds)
    betas = geometric_ladder(num_replicas, beta_min, dev).expand(c, num_replicas).clone()
    state = PTState(chains, betas)
    kept = set(range(num_steps)[keep if keep is not None else slice(None)])
    if not kept:
        raise ValueError(f"keep={keep!r} selects none of the {num_steps} rounds")
    ladder_rows = torch.arange(c, device=dev) * num_replicas
    samples, beta_trace, cold_mlls = [], [], []
    swapped = torch.zeros(c, device=dev)
    for t in range(num_steps):
        round_draws = (
            draw_pt_round(generator, c, num_replicas, params, dev) if draws is None
            else draws[t].to(dev)
        )
        old = state.betas
        state, _ = pt_round(state, t, round_draws, X, y, bounds, feat_types, params, mask)
        swapped = swapped + (state.betas != old).to(torch.float32).mean(-1)
        cold = ladder_rows + torch.argmax(state.betas, -1)
        beta_trace.append(state.betas)
        cold_mlls.append(state.chains.mll[cold])
        if t in kept:
            ch = state.chains
            samples.append((Forest(*(f[cold] for f in ch.forest)), ch.noise[cold], ch.scale[cold]))
    forests, noises, scales = zip(*samples)
    model = BARKModel(
        Forest(*(torch.stack(f, 1) for f in zip(*forests))),
        torch.stack(noises, 1), torch.stack(scales, 1),
    )
    beta_trace = torch.stack(beta_trace)  # (T, C, R)
    cold_mlls = torch.stack(cold_mlls, 1)  # (C, T)
    swap_rate = swapped / max(num_steps, 1)
    if len(lead) == 1:
        model = BARKModel(Forest(*(t[0] for t in model.forest)), model.noise[0], model.scale[0])
        return PTRun(model, beta_trace[:, 0], swap_rate[0], cold_mlls[0], state)
    return PTRun(model, beta_trace, swap_rate, cold_mlls, state)

