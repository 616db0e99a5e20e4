"""Bayesian Additive Regression Trees by Gibbs backfitting.

Counterpart of ``bark_tpu/fitting/bart.py``: a sum-of-trees sampler in the
Chipman-George-McCulloch form on the port's fixed-shape trees.

Model:  y = sum_j g(x; T_j, mu_j) + eps,   eps ~ N(0, sigma2)
        mu_jl ~ N(0, sigma_mu^2) iid,      sigma2 ~ InvGamma(a, b)
        T_j ~ the alpha (1 + d)^-beta branching prior of BARK.

One Gibbs sweep visits the m trees in order: an MH structure move
(grow/prune/change, :func:`~bark_tpu_torch.fitting.proposals.propose_tree_packed`)
scored by the marginal likelihood of the partial residual with the leaf
values integrated out, then a conjugate normal draw of all leaf values; then
an exact inverse-gamma draw of sigma2. Nothing is N x N.

Integrated leaf likelihood (per tree, residual R, leaf counts n_l and
residual sums s_l): summing over leaves of
    0.5*log(sigma2/(sigma2 + n_l*sigma_mu^2))
    + sigma_mu^2 * s_l^2 / (2*sigma2*(sigma2 + n_l*sigma_mu^2))
equals log N(R | 0, sigma2*I + sigma_mu^2*Z Z^T) up to a term constant in
the tree. Empty node slots have n_l = s_l = 0 and contribute exactly 0, so
padded rows (mask 0) are inert.

How the sweep is laid out. Chains are the leading batch dimension of every
tensor (the reference ``vmap``-s them). A tree's proposal depends only on
that tree, which no other tree's visit changes, so the m proposals of a
sweep are one batched call over chains x trees, and so are their leaf
assignments: a move touches one node, so the proposed leaves follow from
the cached ones (:func:`_moved_leaves`) with no routing walk. The visits
themselves are a Python loop over the trees, as the residual carries from
one to the next; a visit is a few dozen small launches with no host sync.
The residual sums are a product with 0/1 one-hot columns (``torch.bmm``),
whose float32 sums run in a fixed order, so two runs from one seed are
equal on the card (no float atomics); it needs full-float32 matmuls, which
:func:`run_bart_sampler` checks.

Every random draw of a run is a tensor of :class:`BARTDraws`
(:func:`draw_bart` makes them from a ``torch.Generator``), so a test can
replay the reference's ``jax.random`` draws.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import torch

from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.fitting.proposals import (
    GROW,
    PRUNE,
    ProposalNoise,
    make_proposal_noise,
    propose_tree_packed,
)
from bark_tpu_torch.forest import (
    DEFAULT_MAX_DEPTH,
    DEFAULT_NODE_LIMIT,
    FEAT_CAT,
    _split_decision,
    create_empty_forest,
    pack_forest,
    route_tree,
    unpack_forest,
)
from bark_tpu_torch.ops.linalg import check_matmul_precision

#: routed (sample, tree, point) entries per chunk of :func:`bart_predict_samples`
PREDICT_CHUNK = 1 << 25


@dataclass(frozen=True)
class BARTParams:
    """Static BART configuration, with the reference's defaults: 50 trees,
    y scaled to [-0.5, 0.5] by the surrogate, ``sigma_mu = 0.5 / (k sqrt(m))``
    with k = 2, and the noise prior InvGamma(nu/2, nu lam/2) with nu = 3
    (its rate is calibrated per dataset and passed to the sampler)."""

    warmup_steps: int = 100
    num_samples: int = 50
    steps_per_sample: int = 1
    num_chains: int = 1

    alpha: float = 0.95
    beta: float = 2.0
    num_trees: int = 50
    k: float = 2.0  # leaf-value prior: sigma_mu = 0.5 / (k * sqrt(m))

    noise_prior_shape: float = 1.5  # nu/2 with nu=3

    grow_prune_weight: float = 0.5
    change_weight: float = 1.0

    node_limit: int = DEFAULT_NODE_LIMIT
    max_depth: int = DEFAULT_MAX_DEPTH

    @property
    def sigma_mu(self) -> float:
        return 0.5 / (self.k * self.num_trees**0.5)

    @property
    def num_steps(self) -> int:
        """Sweeps of one run: warmup, then ``steps_per_sample`` per sample."""
        return self.warmup_steps + self.num_samples * self.steps_per_sample

    def proposal_params(self) -> SamplerParams:
        """The SamplerParams view consumed by ``propose_tree_packed``."""
        return SamplerParams(
            alpha=self.alpha,
            beta=self.beta,
            num_trees=self.num_trees,
            grow_prune_weight=self.grow_prune_weight,
            change_weight=self.change_weight,
            node_limit=self.node_limit,
            max_depth=self.max_depth,
        )

    def with_(self, **kwargs) -> "BARTParams":
        return replace(self, **kwargs)


class BARTState(NamedTuple):
    """Chain states, chains leading.

    packed: (C, m, node_limit, 8) int32 packed trees
    leaf_values: (C, m, node_limit) f32; zero on non-leaf slots
    leaves: (C, m, N) int32 cached leaf of every training row
    f_total: (C, N) f32 current sum-of-trees fit
    sigma2: (C,) f32
    """

    packed: torch.Tensor
    leaf_values: torch.Tensor
    leaves: torch.Tensor
    f_total: torch.Tensor
    sigma2: torch.Tensor

    def to(self, device) -> "BARTState":
        return BARTState(*(t.to(device) for t in self))


class BARTSamples(NamedTuple):
    """Posterior draws with leading (num_chains, num_samples) axes."""

    packed: torch.Tensor  # (C, S, m, node_limit, 8)
    leaf_values: torch.Tensor  # (C, S, m, node_limit)
    sigma2: torch.Tensor  # (C, S)


class BARTDraws(NamedTuple):
    """The randomness of sweeps, with leading dims ``(..., C)`` (a run adds a
    leading steps dim).

    noise: the ProposalNoise of every tree's move, fields (..., C, m) (its
      ``u_accept`` field is not read: ``u_accept`` below is)
    u_accept: (..., C, m) uniform of each tree's MH accept
    leaf_normal: (..., C, m, node_limit) standard normals of the leaf draws
    gamma: (..., C) standard-gamma draw of shape a + n/2 for sigma2
    """

    noise: ProposalNoise
    u_accept: torch.Tensor
    leaf_normal: torch.Tensor
    gamma: torch.Tensor

    def step(self, t: int) -> "BARTDraws":
        """The draws of sweep ``t`` of a run."""
        return BARTDraws(ProposalNoise(*(f[t] for f in self.noise)),
                         self.u_accept[t], self.leaf_normal[t], self.gamma[t])

    def to(self, device) -> "BARTDraws":
        return BARTDraws(self.noise.to(device), self.u_accept.to(device),
                         self.leaf_normal.to(device), self.gamma.to(device))


def draw_bart(
    generator: torch.Generator,
    num_steps: int,
    num_chains: int,
    num_trees: int,
    node_limit: int,
    gamma_shape: float,
) -> BARTDraws:
    """Draws of ``num_steps`` sweeps of ``num_chains`` chains on the
    generator's device. ``gamma_shape`` is the posterior shape a + n/2 of
    sigma2, fixed for a fit by its row mask."""
    dev = generator.device
    noise = make_proposal_noise(generator, num_trees, node_limit, (num_steps, num_chains))
    leaf_normal = torch.randn((num_steps, num_chains, num_trees, node_limit),
                              generator=generator, device=dev)
    shape = torch.full((num_steps, num_chains), float(gamma_shape), dtype=torch.float32,
                       device=dev)
    gamma = torch._standard_gamma(shape, generator=generator)
    return BARTDraws(noise, noise.u_accept, leaf_normal, gamma)


def leaf_suff_stats(
    leaves: torch.Tensor,
    resid: torch.Tensor,
    node_limit: int,
    mask: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-node-slot counts and residual sums ``n_l, s_l`` of shape
    ``(..., node_limit)`` from leaves and residuals ``(..., N)``: the
    residual times the (N, node_limit) one-hot of the leaves (rows of
    ``mask`` 0 zeroed), exactly zero on slots no row reaches."""
    z = _one_hot(leaves, node_limit, mask)
    return z.sum(-2), (resid[..., None, :] @ z)[..., 0, :]


def _one_hot(leaves: torch.Tensor, node_limit: int, mask: torch.Tensor | None) -> torch.Tensor:
    """(..., N, node_limit) float32 0/1 one-hot of the leaves, masked rows 0."""
    slots = torch.arange(node_limit, device=leaves.device, dtype=leaves.dtype)
    z = (leaves[..., None] == slots).to(torch.float32)
    return z if mask is None else z * mask[:, None].to(torch.float32)


def tree_marginal_loglik(
    n_l: torch.Tensor, s_l: torch.Tensor, sigma2: torch.Tensor, sigma_mu2: float
) -> torch.Tensor:
    """Leaf-integrated log-likelihood of a tree, up to tree-independent
    terms: log N(R | 0, sigma2 I + sigma_mu2 Z Z^T) + ||R||^2/(2 sigma2)
    + (N/2) log(2 pi sigma2). Sums over the last dim; ``sigma2`` broadcasts
    against the leading dims."""
    sigma2 = torch.as_tensor(sigma2, dtype=torch.float32, device=n_l.device)[..., None]
    denom = sigma2 + n_l * sigma_mu2
    return torch.sum(
        0.5 * torch.log(sigma2 / denom) + sigma_mu2 * s_l**2 / (2.0 * sigma2 * denom), dim=-1
    )


def sample_leaf_values(
    normal: torch.Tensor,
    n_l: torch.Tensor,
    s_l: torch.Tensor,
    sigma2: torch.Tensor,
    sigma_mu2: float,
    is_leaf_slot: torch.Tensor,
) -> torch.Tensor:
    """Conjugate posterior draw of every leaf value from standard normals:
    mu_l | R ~ N(sigma_mu2 s_l / (sigma2 + n_l sigma_mu2),
                 sigma2 sigma_mu2 / (sigma2 + n_l sigma_mu2));
    slots that are not active leaves are 0, so a stale value never leaks
    into a prediction through a later structural change."""
    sigma2 = torch.as_tensor(sigma2, dtype=torch.float32, device=n_l.device)[..., None]
    denom = sigma2 + n_l * sigma_mu2
    post_mean = sigma_mu2 * s_l / denom
    post_sd = torch.sqrt(sigma2 * sigma_mu2 / denom)
    return torch.where(is_leaf_slot, post_mean + post_sd * normal, 0.0)


def _leaf_slot_mask(packed: torch.Tensor) -> torch.Tensor:
    """(..., node_limit) bool: slot is an active leaf (packed cols 0 = is_leaf,
    7 = active)."""
    return (packed[..., 0] == 1) & (packed[..., 7] == 1)


def _moved_leaves(
    leaves: torch.Tensor,
    new_packed: torch.Tensor,
    node: torch.Tensor,
    move: torch.Tensor,
    reject: torch.Tensor,
    XT: torch.Tensor,
    feat_types: torch.Tensor,
) -> torch.Tensor:
    """The leaves ``(..., N)`` of proposed trees, from the leaves before the
    move: a grow sends the rows of leaf ``node`` to its new children by the
    new split; a change re-splits the rows of the two children of ``node``
    (a change and a prune act on a node whose children are both leaves); a
    prune sends those rows to ``node``. Equal to routing the proposed tree
    (:func:`~bark_tpu_torch.forest.route_tree`). ``XT`` is X transposed,
    (D, N)."""
    row = torch.gather(
        new_packed, -2, node.long()[..., None, None].expand(*node.shape, 1, 8)
    )[..., 0, :]
    feat = row[..., 1].long()
    thr = row[..., 2].contiguous().view(torch.float32)[..., None]
    left, right = row[..., 3, None], row[..., 4, None]
    go_left = _split_decision(XT[feat], thr, (feat_types == FEAT_CAT)[feat][..., None])
    at = node[..., None]
    affected = torch.where(
        (move == GROW)[..., None], leaves == at, (leaves == left) | (leaves == right)
    )
    dest = torch.where(
        (move == PRUNE)[..., None], at, torch.where(go_left, left, right)
    )
    return torch.where(affected & ~reject[..., None], dest, leaves)


class BARTStepInfo(NamedTuple):
    """Per tree move of a sweep, (C, m): the MH decision, log alpha, and the
    distance ``log u - min(log alpha, 0)`` of the decision from its tie."""

    accept: torch.Tensor
    log_alpha: torch.Tensor
    margin: torch.Tensor


def bart_step_with_info(
    draws: BARTDraws,
    state: BARTState,
    X: torch.Tensor,
    y: torch.Tensor,
    bounds: torch.Tensor,
    feat_types: torch.Tensor,
    params: BARTParams,
    noise_prior_rate,
    mask: torch.Tensor | None = None,
) -> tuple[BARTState, BARTStepInfo]:
    """One Gibbs sweep of every chain: m tree moves with leaf draws, then
    sigma2. ``draws`` has leading dim C (:meth:`BARTDraws.step`)."""
    c, m, node_limit = state.leaf_values.shape
    sigma_mu2 = params.sigma_mu**2
    sigma2 = state.sigma2

    # --- the m proposals of every chain, batched ------------------------------
    flat = ProposalNoise(*(t.reshape(c * m, *t.shape[2:]) for t in draws.noise))
    new_packed, log_q, move, node = propose_tree_packed(
        state.packed.reshape(c * m, node_limit, 8), bounds, feat_types,
        params.proposal_params(), flat,
    )
    new_packed = new_packed.reshape(c, m, node_limit, 8)
    log_q, move, node = (t.reshape(c, m) for t in (log_q, move, node))
    new_leaves = _moved_leaves(state.leaves, new_packed, node, move, torch.isneginf(log_q),
                               X.t().contiguous(), feat_types)

    # --- what does not depend on the residual, for both branches ---------------
    both = torch.stack([state.leaves, new_leaves], dim=2)  # (C, m, 2, N)
    z = _one_hot(both, node_limit, mask)  # (C, m, 2, N, node_limit)
    counts = z.sum(-2)  # (C, m, 2, node_limit)
    z = z.permute(0, 1, 3, 2, 4).reshape(c, m, -1, 2 * node_limit)  # [cur | new] columns
    s2 = sigma2[:, None, None, None]
    denom = s2 + counts * sigma_mu2
    half_log = 0.5 * torch.log(s2 / denom)
    den2 = 2.0 * s2 * denom
    post_sd = torch.sqrt(s2 * sigma_mu2 / denom)
    slot = torch.stack([_leaf_slot_mask(state.packed), _leaf_slot_mask(new_packed)], dim=2)
    log_u = torch.log(draws.u_accept)
    leaves_long = both.long()

    # --- the visits -------------------------------------------------------------
    f_total = state.f_total
    values, accepts, log_alphas = [], [], []
    for j in range(m):
        g_j = torch.gather(state.leaf_values[:, j], 1, leaves_long[:, j, 0])
        resid = y - (f_total - g_j)
        s = torch.bmm(resid[:, None, :], z[:, j]).view(c, 2, node_limit)
        ll = torch.sum(half_log[:, j] + sigma_mu2 * s**2 / den2[:, j], dim=-1)  # (C, 2)
        log_alpha = ll[:, 1] - ll[:, 0] + log_q[:, j]
        accept = log_u[:, j] <= torch.clamp_max(log_alpha, 0.0)
        drawn = sigma_mu2 * s / denom[:, j] + post_sd[:, j] * draws.leaf_normal[:, j, None]
        both_values = torch.where(slot[:, j], drawn, 0.0)  # (C, 2, node_limit)
        values_j = torch.where(accept[:, None], both_values[:, 1], both_values[:, 0])
        leaves_j = torch.where(accept[:, None], leaves_long[:, j, 1], leaves_long[:, j, 0])
        f_total = f_total - g_j + torch.gather(values_j, 1, leaves_j)
        values.append(values_j)
        accepts.append(accept)
        log_alphas.append(log_alpha)
    accept = torch.stack(accepts, dim=1)
    log_alpha = torch.stack(log_alphas, dim=1)
    packed = torch.where(accept[..., None, None], new_packed, state.packed)
    leaves = torch.where(accept[..., None], new_leaves, state.leaves)

    # --- sigma2 | f ~ InvGamma(shape + n/2, rate + SSR/2), exact Gibbs draw ---
    err2 = (y - f_total) ** 2
    if mask is not None:
        err2 = torch.where(mask != 0, err2, 0.0)
    post_rate = noise_prior_rate + 0.5 * err2.sum(-1)
    new_state = BARTState(packed, torch.stack(values, dim=1), leaves, f_total,
                          post_rate / draws.gamma)
    margin = log_u - torch.clamp_max(log_alpha, 0.0)
    return new_state, BARTStepInfo(accept, log_alpha, margin)


def bart_step(draws, state, X, y, bounds, feat_types, params, noise_prior_rate,
              mask=None) -> BARTState:
    """One Gibbs sweep (:func:`bart_step_with_info` without the info)."""
    return bart_step_with_info(draws, state, X, y, bounds, feat_types, params,
                               noise_prior_rate, mask)[0]


def init_bart_state(
    X: torch.Tensor, params: BARTParams, sigma2_init: float = 1.0
) -> BARTState:
    """``params.num_chains`` all-stump forests, zero leaf values, every row
    routed to the root."""
    c, m, node_limit = params.num_chains, params.num_trees, params.node_limit
    dev = X.device
    packed = pack_forest(create_empty_forest(m, node_limit, (c,), dev))
    return BARTState(
        packed=packed,
        leaf_values=torch.zeros((c, m, node_limit), dtype=torch.float32, device=dev),
        leaves=torch.zeros((c, m, X.shape[0]), dtype=torch.int32, device=dev),
        f_total=torch.zeros((c, X.shape[0]), dtype=torch.float32, device=dev),
        sigma2=torch.full((c,), float(sigma2_init), dtype=torch.float32, device=dev),
    )


def run_bart_chain(
    draws: BARTDraws,
    state: BARTState,
    X: torch.Tensor,
    y: torch.Tensor,
    bounds: torch.Tensor,
    feat_types: torch.Tensor,
    params: BARTParams,
    noise_prior_rate,
    mask: torch.Tensor | None = None,
) -> tuple[BARTSamples, BARTState]:
    """Warmup, then ``num_samples`` draws ``steps_per_sample`` sweeps apart,
    of every chain. ``draws`` holds ``params.num_steps`` sweeps."""
    t = 0
    for _ in range(params.warmup_steps):
        state = bart_step(draws.step(t), state, X, y, bounds, feat_types, params,
                          noise_prior_rate, mask)
        t += 1
    kept = []
    for _ in range(params.num_samples):
        for _ in range(params.steps_per_sample):
            state = bart_step(draws.step(t), state, X, y, bounds, feat_types, params,
                              noise_prior_rate, mask)
            t += 1
        kept.append((state.packed, state.leaf_values, state.sigma2))
    packed, leaf_values, sigma2 = (torch.stack(f, dim=1) for f in zip(*kept))
    return BARTSamples(packed, leaf_values, sigma2), state


def posterior_gamma_shape(params: BARTParams, n_real: float) -> float:
    """The shape a + n/2 of sigma2's inverse-gamma posterior, in float32 as
    the reference computes it."""
    a = torch.tensor(params.noise_prior_shape, dtype=torch.float32)
    return float(a + 0.5 * torch.tensor(float(n_real), dtype=torch.float32))


def run_bart_sampler(
    generator: torch.Generator,
    X: torch.Tensor,
    y: torch.Tensor,
    bounds: torch.Tensor,
    feat_types: torch.Tensor,
    params: BARTParams,
    noise_prior_rate,
    mask: torch.Tensor | None = None,
    init_state: BARTState | None = None,
    draws: BARTDraws | None = None,
) -> tuple[BARTSamples, BARTState]:
    """``params.num_chains`` chains from stumps (or ``init_state``); returns
    samples with leading (num_chains, num_samples) axes and the final
    states (the warm start of the next fit). The draws come from
    ``generator`` unless given."""
    check_matmul_precision()
    if init_state is None:
        init_state = init_bart_state(X, params)
    if draws is None:
        n_real = float(mask.sum()) if mask is not None else X.shape[0]
        draws = draw_bart(generator, params.num_steps, init_state.sigma2.shape[0],
                          params.num_trees, params.node_limit,
                          posterior_gamma_shape(params, n_real))
    return run_bart_chain(draws, init_state, X, y, bounds, feat_types, params,
                          noise_prior_rate, mask)


def bart_predict_samples(
    packed: torch.Tensor,
    leaf_values: torch.Tensor,
    X: torch.Tensor,
    feat_types: torch.Tensor,
    max_depth: int = DEFAULT_MAX_DEPTH,
) -> torch.Tensor:
    """Per-sample sum-of-trees evaluation f_s(x): packed
    (S, m, node_limit, 8), leaf_values (S, m, node_limit), X (M, D) ->
    (S, M), routed in chunks of samples."""
    s, m = leaf_values.shape[:2]
    step = max(1, PREDICT_CHUNK // max(1, m * X.shape[0]))
    out = []
    for i in range(0, s, step):
        leaves = route_tree(unpack_forest(packed[i:i + step]), X, feat_types, max_depth)
        out.append(torch.gather(leaf_values[i:i + step], -1, leaves.long()).sum(-2))
    return torch.cat(out)
