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
their states), the single-device oracle of :func:`sharded_pt_swap` and
:func:`run_parallel_tempering_sharded`: one replica per rank of a mesh,
rank r always at beta_r, deterministic even-odd phases. A pair exchanges its
(beta, MLL) scalars and, when it swaps, its whole chain states by
``batch_isend_irecv`` (the reference's ``ppermute``); both partners decide
by the uniform of the left position, so no accept bit travels.
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
from bark_tpu_torch.parallel.distributed import all_reduce, exchange_tree, mesh_rank
from bark_tpu_torch.parallel.sharding import rank_generator


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



# --- one replica per rank: the fixed-position (DEO) ladder over a mesh -------


class ShardedPTDraws(NamedTuple):
    """The randomness of one round on one rank."""

    step: StepDraws  # this rank's replica, one row
    u_even: torch.Tensor  # (R,) uniforms by left position, equal on every rank
    u_odd: torch.Tensor  # (R,)

    def to(self, device) -> "ShardedPTDraws":
        return ShardedPTDraws(self.step.to(device), self.u_even.to(device), self.u_odd.to(device))


def draw_sharded_pt_round(
    step_generator: torch.Generator,
    swap_generator: torch.Generator,
    num_replicas: int,
    params: SamplerParams,
    device=None,
) -> ShardedPTDraws:
    """One round's draws: the step's from this rank's generator, both
    phases' uniforms from the generator every rank shares."""
    step = draw_step(step_generator, 1, params)
    u = torch.rand((2, num_replicas), generator=swap_generator, device=swap_generator.device)
    draws = ShardedPTDraws(step, u[0], u[1])
    return draws if device is None else draws.to(device)


def sharded_pt_swap(u: torch.Tensor, chains, beta: torch.Tensor, mll: torch.Tensor,
                    parity: int, mesh):
    """One even-odd swap phase with one replica per rank of ``mesh``.

    Positions (parity, parity + 1), (parity + 2, ...) pair up; a rank
    exchanges (beta, mll) with its partner and decides by ``u[left]`` (u is
    (R,), by left position, equal on every rank), which gives both partners
    the same decision; on a swap the partners exchange ``chains`` (any
    pytree of tensors, None fields kept). An unpaired edge rank keeps its
    state. Bit-equal to :func:`pt_swap_states` from the same uniforms.
    Returns (chains, accept), accept shaped like ``mll``.
    """
    i, r = mesh_rank(mesh)
    partner = i + 1 if (i - int(parity)) % 2 == 0 else i - 1
    if not 0 <= partner < r:
        return chains, torch.zeros_like(mll, dtype=torch.bool)
    nbr_beta, nbr_mll = exchange_tree((beta, mll), partner, mesh)
    delta = (beta - nbr_beta) * (nbr_mll - mll)
    accept = torch.log(u[min(i, partner)]) <= torch.clamp_max(delta, 0.0)
    if bool(accept.all()):
        chains = exchange_tree(chains, partner, mesh)
    return chains, accept


class ShardedPTRun(NamedTuple):
    """What :func:`run_parallel_tempering_sharded` returns on one rank; on
    rank 0 (beta = 1) the trace is the cold chain's."""

    samples: BARKModel  # this rank's state after each round, (T,) leading
    mll: torch.Tensor  # (T,) this rank's MLL after each round
    swap_rate: torch.Tensor  # (T,) share of the R - 1 pairs that swapped, per round
    beta: torch.Tensor  # () this rank's inverse temperature
    state: ChainState  # this rank's final state, one row


def run_parallel_tempering_sharded(
    seed: int,
    forest: Forest,
    noise: torch.Tensor,
    scale: torch.Tensor,
    X: torch.Tensor,
    y: torch.Tensor,
    bounds: torch.Tensor,
    feat_types: torch.Tensor,
    params: SamplerParams,
    mesh,
    num_steps: int = 100,
    beta_min: float = 0.05,
    mask: torch.Tensor | None = None,
    draws: Sequence[ShardedPTDraws] | None = None,
) -> ShardedPTRun:
    """PT with one replica per rank: rank r holds beta_r of the geometric
    ladder for the whole run, and states move between ranks.

    ``forest``/``noise``/``scale`` are this rank's replica, with a leading
    dim of 1 (``sharding.shard_model`` of an (R,)-batched model). A round is
    one tempered step, then an even and an odd :func:`sharded_pt_swap`
    phase. Each rank keeps its own trace; no state is reduced across ranks,
    and the only collective besides the pairs' exchanges is one
    ``all_reduce`` of the (T,) accept counts at the end. Round t's draws
    come from :func:`draw_sharded_pt_round` with this rank's generator
    (:func:`~bark_tpu_torch.parallel.sharding.rank_generator`) and one
    seeded by ``seed`` on every rank, or from ``draws[t]``.
    """
    check_matmul_precision()
    i, r = mesh_rank(mesh)
    if forest.batch_shape != (1,):
        raise ValueError(f"one replica per rank, got a forest of batch {forest.batch_shape}")
    dev = X.device
    beta = geometric_ladder(r, beta_min, dev)[i]
    state = init_chain_state(forest, noise, scale, X, y, feat_types, params, mask, bounds)
    step_gen = rank_generator(seed, i, dev)
    swap_gen = torch.Generator(device=dev).manual_seed(seed)
    trace, mlls, accepts = [], [], []
    for t in range(num_steps):
        round_draws = (
            draw_sharded_pt_round(step_gen, swap_gen, r, params, dev) if draws is None
            else draws[t].to(dev)
        )
        state, _ = step_with_info(
            state, X, y, bounds, feat_types, params, round_draws.step, mask, beta=beta
        )
        state, acc_e = sharded_pt_swap(round_draws.u_even, state, beta, state.mll, 0, mesh)
        state, acc_o = sharded_pt_swap(round_draws.u_odd, state, beta, state.mll, 1, mesh)
        trace.append((state.forest, state.noise, state.scale))
        mlls.append(state.mll)
        accepts.append((acc_e.to(torch.float32) + acc_o.to(torch.float32)).sum())
    # each swap sets the accept bit on both partners: R - 1 pairs over the
    # two phases count twice
    swap_rate = all_reduce(torch.stack(accepts), mesh) / (2.0 * max(r - 1, 1))
    forests, noises, scales = zip(*trace)
    samples = BARKModel(
        Forest(*(torch.cat(f) for f in zip(*forests))), torch.cat(noises), torch.cat(scales)
    )
    return ShardedPTRun(samples, torch.cat(mlls), swap_rate, beta, state)
