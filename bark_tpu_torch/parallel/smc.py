"""Sequential Monte Carlo over forest posteriors, on one device.

Counterpart of ``bark_tpu/parallel/smc.py`` (its single-device part): an
adaptive-tempering SMC sampler. A population of P particles starts at the
BARK prior (beta = 0), and each round

  1. raises beta so that the effective sample size of the incremental
     weights (beta' - beta) * MLL keeps ``target_ess`` of P (30 bisection
     trips on the ESS equation), and adds the log-mean incremental weight to
     the log-evidence;
  2. resamples systematically when the ESS falls under
     ``resample_threshold`` of P: one index of every field of the chain
     state, the kernel carry included (without a host sync: the identity
     index is taken otherwise);
  3. mutates every particle by ``mutation_steps`` BARK steps at the new
     beta, all P particles in one :func:`step_with_info` call per step.

At beta = 1 the weighted population is a posterior sample and the
log-evidence estimates the marginal likelihood. Everything runs in float32,
as the reference does. A round is a pure function of its draws
(:class:`SMCDraws`, :func:`smc_round`), so a test can replay the reference.

:func:`run_smc_sharded` splits the particles over the ranks of a mesh. Each
round gathers the (P,) MLLs, so that every rank takes the same beta, weights
and resample decision; the particle states are gathered only in a round that
resamples. Every rank draws the whole round from a generator seeded alike
and keeps its rows, so a sharded run takes :func:`run_smc`'s draws.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch.utils import _pytree as pytree

from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.fitting.prior import draw_prior, sample_forest_prior, sample_noise_prior
from bark_tpu_torch.fitting.sampler import (
    BARKModel,
    ChainState,
    StepDraws,
    StepInfo,
    draw_step,
    init_chain_state,
    step_with_info,
)
from bark_tpu_torch.ops.linalg import check_matmul_precision
from bark_tpu_torch.parallel.distributed import all_gather, all_gather_tree, mesh_rank


class SMCResult(NamedTuple):
    model: BARKModel  # final particle population, (P,) leading
    log_weights: torch.Tensor  # (P,) normalised log-weights
    log_evidence: torch.Tensor  # () accumulated log marginal likelihood
    betas: torch.Tensor  # (T,) tempering schedule taken
    ess_trace: torch.Tensor  # (T,) ESS after each round


class SMCDraws(NamedTuple):
    """All randomness of one round of P particles."""

    u_resample: torch.Tensor  # () uniform offset of the systematic resample
    steps: tuple[StepDraws, ...]  # one per mutation step, P rows each

    def to(self, device) -> "SMCDraws":
        return SMCDraws(self.u_resample.to(device), tuple(s.to(device) for s in self.steps))


def _prior_particles(generator, num_particles, bounds, feat_types, params,
                     rows: slice = slice(None)) -> BARKModel:
    """Particles ``rows`` of ``num_particles`` drawn from the BARK prior:
    forests by :func:`sample_forest_prior`, noise from its Gamma prior,
    scale 1 (every row's draws are made, the forests only for ``rows``)."""
    prior = draw_prior(
        generator, num_particles, params.num_trees, params.node_limit,
        params.gamma_prior_shape, bounds.device,
    )
    prior = pytree.tree_map(lambda t: t[rows], prior)
    forest = sample_forest_prior(
        prior, params.num_trees, bounds, feat_types, params.alpha, params.beta,
        params.node_limit, params.max_depth,
    )
    noise = sample_noise_prior(prior.gamma, params.gamma_prior_rate)
    return BARKModel(forest, noise, torch.ones_like(noise))


class SMCRound(NamedTuple):
    chains: ChainState
    beta: torch.Tensor  # () the round's new beta
    log_w: torch.Tensor  # (P,) unnormalised log-weights after the round
    log_evidence: torch.Tensor  # ()
    ess: torch.Tensor  # () ESS of log_w
    ancestors: torch.Tensor  # (P,) the index applied (the identity without a resample)
    infos: tuple[StepInfo, ...]  # the mutation steps' decisions


def _softmax(x: torch.Tensor) -> torch.Tensor:
    e = torch.exp(x - x.max())
    return e / e.sum()


def _ess(log_w: torch.Tensor) -> torch.Tensor:
    w = _softmax(log_w)
    return 1.0 / (w * w).sum()


def _logsumexp_weighted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log sum_i b_i exp(a_i), shifted by the largest a_i with b_i != 0."""
    a = torch.where(b != 0, a, -torch.inf)
    amax = a.max()
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    return torch.log((torch.exp(a - amax) * b).sum().abs()) + amax


def _next_beta(beta: torch.Tensor, mll: torch.Tensor, target_ess: float, n_iter: int = 30):
    """The largest beta' in (beta, 1] whose incremental weights keep
    ESS >= target_ess * P, by ``n_iter`` bisection trips (1 when the ESS at
    1 is already enough)."""
    n = mll.shape[0]
    need = target_ess * n

    def ess_at(b):
        return _ess((b - beta) * mll)

    one = torch.ones_like(beta)
    lo, hi = beta, one
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        ok = ess_at(mid) >= need
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return torch.where(ess_at(one) >= need, one, lo)


def systematic_resample(u: torch.Tensor, log_w: torch.Tensor) -> torch.Tensor:
    """Systematic resampling: ancestor indices (N,) from log-weights, with
    ``u`` the () uniform offset; positions are looked up on the left side of
    the cumulative weights."""
    n = log_w.shape[0]
    w = _softmax(log_w)
    positions = (torch.arange(n, device=log_w.device) + u) / n
    cum = torch.cumsum(w, 0)
    return torch.searchsorted(cum, positions).clamp(0, n - 1)


def draw_smc_round(
    generator: torch.Generator,
    num_particles: int,
    mutation_steps: int,
    params: SamplerParams,
    device=None,
) -> SMCDraws:
    """Draw one round's randomness (see :func:`draw_step`)."""
    u = torch.rand((), generator=generator, device=generator.device)
    steps = tuple(draw_step(generator, num_particles, params) for _ in range(mutation_steps))
    draws = SMCDraws(u, steps)
    return draws if device is None else draws.to(device)


def smc_round(
    chains: ChainState,
    beta: torch.Tensor,
    log_w: torch.Tensor,
    log_evidence: torch.Tensor,
    draws: SMCDraws,
    X: torch.Tensor,
    y: torch.Tensor,
    bounds: torch.Tensor,
    feat_types: torch.Tensor,
    params: SamplerParams,
    target_ess: float = 0.6,
    resample_threshold: float = 0.5,
    mask: torch.Tensor | None = None,
) -> SMCRound:
    """One round: reweight at the next beta, resample if degenerate, mutate."""
    p = log_w.shape[0]
    new_beta = _next_beta(beta, chains.mll, target_ess)
    inc = (new_beta - beta) * chains.mll
    log_evidence = log_evidence + _logsumexp_weighted(inc, _softmax(log_w))
    log_w = log_w + inc

    do_resample = _ess(log_w) < resample_threshold * p
    ancestors = systematic_resample(draws.u_resample, log_w)
    idx = torch.where(do_resample, ancestors, torch.arange(p, device=log_w.device))
    chains = chains.take(idx)
    log_w = torch.where(do_resample, torch.zeros_like(log_w), log_w)

    infos = []
    beta_rows = new_beta.expand(p)
    for step_draws in draws.steps:
        chains, info = step_with_info(
            chains, X, y, bounds, feat_types, params, step_draws, mask, beta=beta_rows
        )
        infos.append(info)
    return SMCRound(chains, new_beta, log_w, log_evidence, _ess(log_w), idx, tuple(infos))


def run_smc(
    generator: torch.Generator,
    X: torch.Tensor,
    y: torch.Tensor,
    bounds: torch.Tensor,
    feat_types: torch.Tensor,
    params: SamplerParams,
    num_particles: int = 64,
    num_rounds: int = 16,
    mutation_steps: int = 2,
    target_ess: float = 0.6,
    resample_threshold: float = 0.5,
    mask: torch.Tensor | None = None,
    particles: BARKModel | None = None,
    draws: Sequence[SMCDraws] | None = None,
) -> SMCResult:
    """Adaptive-tempering SMC from the BARK prior to the posterior.

    ``num_rounds`` caps the tempering rounds; once beta reaches 1 the
    remaining rounds only mutate. The initial particles are drawn from the
    prior (forests by :func:`sample_forest_prior`, noise from the
    Gamma(``gamma_prior_shape``, ``gamma_prior_rate``) prior, scale 1)
    unless ``particles`` gives them; round t's randomness comes from
    ``generator`` unless ``draws[t]`` gives it.
    """
    check_matmul_precision()
    dev = X.device
    if particles is None:
        particles = _prior_particles(generator, num_particles, bounds, feat_types, params)
    chains = init_chain_state(
        particles.forest, particles.noise, particles.scale, X, y, feat_types, params, mask,
        bounds,
    )
    beta = torch.zeros((), device=dev)
    log_w = torch.zeros(num_particles, device=dev)
    log_evidence = torch.zeros((), device=dev)
    betas, ess = [], []
    for t in range(num_rounds):
        round_draws = (
            draw_smc_round(generator, num_particles, mutation_steps, params, dev)
            if draws is None else draws[t].to(dev)
        )
        out = smc_round(
            chains, beta, log_w, log_evidence, round_draws, X, y, bounds, feat_types,
            params, target_ess, resample_threshold, mask,
        )
        chains, beta, log_w, log_evidence = out.chains, out.beta, out.log_w, out.log_evidence
        betas.append(beta)
        ess.append(out.ess)
    shifted = log_w - log_w.max()
    return SMCResult(
        model=BARKModel(chains.forest, chains.noise, chains.scale),
        log_weights=shifted - torch.log(torch.exp(shifted).sum()),
        log_evidence=log_evidence,
        betas=torch.stack(betas),
        ess_trace=torch.stack(ess),
    )


def run_smc_sharded(
    generator: torch.Generator,
    X: torch.Tensor,
    y: torch.Tensor,
    bounds: torch.Tensor,
    feat_types: torch.Tensor,
    params: SamplerParams,
    mesh,
    num_particles: int = 64,
    num_rounds: int = 16,
    mutation_steps: int = 2,
    target_ess: float = 0.6,
    resample_threshold: float = 0.5,
    mask: torch.Tensor | None = None,
    particles: BARKModel | None = None,
    draws: Sequence[SMCDraws] | None = None,
) -> SMCResult:
    """:func:`run_smc` with the particles split over the ranks of ``mesh``.

    Rank r holds particles ``[r P/n, (r + 1) P/n)`` (``num_particles`` must
    divide by the number of ranks n). ``generator`` must be seeded alike on
    every rank: each rank draws what :func:`run_smc` would draw from it (the
    whole prior population, the whole round) and keeps its rows, or takes
    its rows of ``particles`` and ``draws[t]``. Each round gathers the (P,)
    MLLs; the log-weights, beta, the log-evidence and the resample decision
    are then computed alike on every rank, and a resample gathers the
    particle states (all fields, the kernel carry included) and takes this
    rank's ancestors. Returns this rank's particles and their log-weights
    (normalised over all P), and the log-evidence, betas and ESS trace,
    equal on every rank.
    """
    check_matmul_precision()
    rank, size = mesh_rank(mesh)
    if num_particles % size:
        raise ValueError(f"{num_particles} particles do not divide over {size} ranks")
    local = num_particles // size
    mine = slice(rank * local, (rank + 1) * local)
    dev = X.device
    if particles is None:
        particles = _prior_particles(generator, num_particles, bounds, feat_types, params, mine)
    else:
        particles = pytree.tree_map(lambda t: t[mine], particles)
    chains = init_chain_state(
        particles.forest, particles.noise, particles.scale, X, y, feat_types, params, mask,
        bounds,
    )
    beta = torch.zeros((), device=dev)
    log_w = torch.zeros(num_particles, device=dev)  # every rank holds all P
    log_evidence = torch.zeros((), device=dev)
    betas, ess = [], []
    for t in range(num_rounds):
        round_draws = (
            draw_smc_round(generator, num_particles, mutation_steps, params, dev)
            if draws is None else draws[t].to(dev)
        )
        mll = all_gather(chains.mll, mesh)
        new_beta = _next_beta(beta, mll, target_ess)
        inc = (new_beta - beta) * mll
        log_evidence = log_evidence + _logsumexp_weighted(inc, _softmax(log_w))
        log_w = log_w + inc
        if bool(_ess(log_w) < resample_threshold * num_particles):
            ancestors = systematic_resample(round_draws.u_resample, log_w)
            chains = all_gather_tree(chains, mesh).take(ancestors[mine])
            log_w = torch.zeros_like(log_w)
        beta_rows = new_beta.expand(local)
        for step_draws in round_draws.steps:
            step_draws = pytree.tree_map(lambda d: d[mine], step_draws)
            chains, _ = step_with_info(
                chains, X, y, bounds, feat_types, params, step_draws, mask, beta=beta_rows
            )
        beta = new_beta
        betas.append(beta)
        ess.append(_ess(log_w))
    shifted = log_w - log_w.max()
    return SMCResult(
        model=BARKModel(chains.forest, chains.noise, chains.scale),
        log_weights=(shifted - torch.log(torch.exp(shifted).sum()))[mine],
        log_evidence=log_evidence,
        betas=torch.stack(betas),
        ess_trace=torch.stack(ess),
    )
