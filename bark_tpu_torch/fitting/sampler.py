"""The BARK forest-MCMC transition kernel and multi-chain sampler (dense tier).

Counterpart of ``bark_tpu/fitting/sampler.py`` for padded N < 256 with the
shipped default lowering (``kernel_backend="rank1"``, ``scan_style="plain"``,
``refresh_style="onesolve"``, ``hot_style="walk_select"``,
``subspace_mode="walk"``). Every tensor carries a leading chain dimension
(the reference ``vmap``-ed over chains) and the sequential move scan is a
Python loop over the m trees, all chains in lockstep.

One step (:func:`step`):

  1. the noise/scale proposal (:mod:`.noise_scale`);
  2. the hoisted proposal batch: one grow/prune/change proposal for every
     (chain, tree) at once, with the incremental leaf update of each
     (proposals only touch terminal or singly-internal nodes);
  3. the move scan: per tree, a rank-2 Woodbury update of the carried
     K^-1 (the move's kernel delta is exactly rank 2) and an MH accept on
     the MLL ratio, seeded from the scan's own quantities;
  4. the exact refresh: the agreement Gram of the new leaves (kernel K1,
     ``ops.gram``), both MH branches of the noise move factored at once
     by the Cholesky-with-inverse kernel K2 (``ops.chol`` through
     ``ops.linalg.blocked_cholesky``), both MLLs from the factors, the
     accept, and K^-1 = E^T E from the selected branch's inverse factor E.

All randomness of a step is one :class:`StepDraws` record (made by
:func:`draw_step` from a ``torch.Generator``), so a step is a pure function
of (state, draws) -- the seam the parity tests use to replay the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bark_tpu_torch.fitting.noise_scale import get_noise_scale_proposal
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.fitting.proposals import (
    GROW,
    PRUNE,
    ProposalNoise,
    make_proposal_noise,
    propose_tree_packed,
)
from bark_tpu_torch.forest import (
    FEAT_CAT,
    Forest,
    _split_decision,
    gram_from_leaves,
    pack_forest,
    route_forest,
    unpack_forest,
)
from bark_tpu_torch.ops.linalg import (
    JITTER,
    blocked_cholesky,
    check_matmul_precision,
    chol_inv_logdet,
    kernel_matrix,
    masked_mll,
)

#: first padded N of the reference's leaf tier, which the port does not run
LEAF_TIER_N = 256

_DENSE_DEFAULTS = {
    "kernel_backend": ("rank1",),
    "scan_style": ("auto", "plain"),
    "refresh_style": ("auto", "onesolve"),
    "hot_style": ("walk_select",),
    "subspace_mode": ("walk",),
}


def _resolve_styles(params: SamplerParams, n: int) -> SamplerParams:
    """Resolve the lowering for padded N, as the reference does at N < 256.

    The reference resolves ``auto`` to the dense tier (plain scan +
    onesolve refresh) below N = 256 and to the leaf tier above; the port
    runs the dense tier with the shipped defaults only, and raises
    ``NotImplementedError`` for anything else rather than run another
    lowering. ``chol_block``/``chol_impl``/``gram_dtype``/``scan_unroll``/
    ``leaf_budget`` choose among the reference's lowerings of the same
    arithmetic; the port has one lowering for each (kernels K1 and K2, a
    Python loop) and does not read them.
    """
    if n >= LEAF_TIER_N:
        raise NotImplementedError(
            f"padded N={n} >= {LEAF_TIER_N} is the reference's leaf tier, "
            "which the port does not run yet"
        )
    for name, allowed in _DENSE_DEFAULTS.items():
        value = getattr(params, name)
        if value not in allowed:
            raise NotImplementedError(
                f"SamplerParams.{name}={value!r}: the port runs only "
                f"{allowed} (the dense tier's shipped default)"
            )
    if (params.scan_style, params.refresh_style) == ("plain", "onesolve"):
        return params
    return params.with_(scan_style="plain", refresh_style="onesolve")


class KernState(NamedTuple):
    """Kernel carry of the dense tier: K^-1 (C, N, N) and logdet K (C,)."""

    K_inv: torch.Tensor
    K_logdet: torch.Tensor

    def to(self, device) -> "KernState":
        return KernState(self.K_inv.to(device), self.K_logdet.to(device))


class ChainState(NamedTuple):
    forest: Forest  # fields (C, m, node_limit)
    leaves: torch.Tensor  # (C, N, m) int32 -- leaf of each training row per tree
    noise: torch.Tensor  # (C,) float32
    scale: torch.Tensor  # (C,) float32
    kern: KernState
    mll: torch.Tensor  # (C,) float32

    def to(self, device) -> "ChainState":
        return ChainState(
            self.forest.to(device), self.leaves.to(device), self.noise.to(device),
            self.scale.to(device), self.kern.to(device), self.mll.to(device),
        )


class BARKModel(NamedTuple):
    """(forest, noise, scale); batch dims (chains, samples) lead each field."""

    forest: Forest
    noise: torch.Tensor
    scale: torch.Tensor


class StepDraws(NamedTuple):
    """All randomness of one step for C chains."""

    proposal: ProposalNoise  # fields (C, m), g_node (C, m, node_limit)
    z_noise: torch.Tensor  # (C,) standard normal -- noise walk
    z_scale: torch.Tensor  # (C,) standard normal -- scale walk
    u_hyper: torch.Tensor  # (C,) uniform -- MH accept of the noise move

    def to(self, device) -> "StepDraws":
        return StepDraws(
            self.proposal.to(device), self.z_noise.to(device),
            self.z_scale.to(device), self.u_hyper.to(device),
        )


class StepInfo(NamedTuple):
    """What a step decided, per chain."""

    tree_accepts: torch.Tensor  # (C, m) bool
    tree_log_alpha: torch.Tensor  # (C, m) log MH ratio of each tree move
    hyper_accept: torch.Tensor  # (C,) bool
    hyper_log_alpha: torch.Tensor  # (C,)


def draw_step(
    generator: torch.Generator,
    num_chains: int,
    params: SamplerParams,
    device=None,
) -> StepDraws:
    """Draw one step's randomness on the generator's device, moved to
    ``device`` (same distributions as the reference's keyed draws)."""
    proposal = make_proposal_noise(
        generator, params.num_trees, params.node_limit, (num_chains,)
    )
    dev = generator.device
    draws = StepDraws(
        proposal=proposal,
        z_noise=torch.randn(num_chains, generator=generator, device=dev),
        z_scale=torch.randn(num_chains, generator=generator, device=dev),
        u_hyper=torch.rand(num_chains, generator=generator, device=dev),
    )
    return draws if device is None else draws.to(device)


def _incremental_leaves(
    row_old: torch.Tensor,
    row_new: torch.Tensor,
    cur_leaves: torch.Tensor,
    move: torch.Tensor,
    node: torch.Tensor,
    X: torch.Tensor,
    feat_types: torch.Tensor,
) -> torch.Tensor:
    """Leaf assignment (B, N) under each proposed tree, as masked updates.

    ``row_old``/``row_new`` (B, 8) are the packed records of the proposal's
    node before/after the edit. Grow at leaf n: points at n re-split to the
    two fresh children. Prune at n: points at either child merge back to n.
    Change at n: points at either child re-split by the new rule.
    """
    is_cat = feat_types == FEAT_CAT
    f = row_new[:, 1].long()
    thr = row_new[:, 2].contiguous().view(torch.float32)
    x_val = X[:, f].transpose(0, 1)  # (B, N)
    go_left = _split_decision(x_val, thr[:, None], is_cat[f][:, None])
    split_to = torch.where(go_left, row_new[:, 3:4], row_new[:, 4:5])

    node = node[:, None]
    at_node = cur_leaves == node
    at_children = (cur_leaves == row_old[:, 3:4]) | (cur_leaves == row_old[:, 4:5])
    grown = torch.where(at_node, split_to, cur_leaves)
    pruned = torch.where(at_children, node, cur_leaves)
    changed = torch.where(at_children, split_to, cur_leaves)
    move = move[:, None]
    return torch.where(
        move == GROW, grown, torch.where(move == PRUNE, pruned, changed)
    ).to(torch.int32)


def _chol_mll(
    L: torch.Tensor, y: torch.Tensor, noise: torch.Tensor, pad_count: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """MLL and logdet from Cholesky factors L (..., N, N) of K.

    The quadratic form comes from the factor, ``||L^-1 y||^2`` by a
    single-right-hand-side triangular solve (the reference measured the
    explicit-inverse form losing accuracy at small noise). A failed
    factorization carries NaN into the MLL, and the MH step rejects.
    """
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    yb = y.reshape(-1, 1).expand(*L.shape[:-2], -1, 1)
    z = torch.linalg.solve_triangular(L, yb, upper=False)[..., 0]
    correction = pad_count * torch.log(JITTER + noise)
    return 0.5 * (-(z * z).sum(-1) - logdet + correction), logdet


def _default_mask(X: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return torch.ones(X.shape[0], dtype=torch.float32, device=X.device)
    return mask.to(torch.float32)


def init_chain_state(
    forest: Forest,
    noise: torch.Tensor,
    scale: torch.Tensor,
    X: torch.Tensor,
    y: torch.Tensor,
    feat_types: torch.Tensor,
    params: SamplerParams,
    mask: torch.Tensor | None = None,
    bounds: torch.Tensor | None = None,
) -> ChainState:
    """Route the data, build the kernel and factor it, for C chains.

    ``forest`` fields are (C, m, node_limit); ``noise``/``scale`` (C,) (or
    scalars, broadcast); ``X`` (N, D), ``y`` (N,), ``mask`` (N,) marks real
    rows (padded rows are inert). The Gram goes through K1, the
    factorization through K2.
    """
    if bounds is None:
        raise ValueError("init_chain_state requires the domain bounds array")
    params = _resolve_styles(params, X.shape[0])
    check_matmul_precision()
    if (forest.num_trees, forest.node_limit) != (params.num_trees, params.node_limit):
        raise ValueError(
            f"forest (m={forest.num_trees}, node_limit={forest.node_limit}) "
            f"does not match params (m={params.num_trees}, "
            f"node_limit={params.node_limit})"
        )
    (c,) = forest.batch_shape
    mask = _default_mask(X, mask)
    pad_count = X.shape[0] - mask.sum()
    noise = torch.as_tensor(noise, dtype=torch.float32, device=X.device).expand(c).clone()
    scale = torch.as_tensor(scale, dtype=torch.float32, device=X.device).expand(c).clone()
    leaves = route_forest(forest, X, feat_types, params.max_depth)
    gram = gram_from_leaves(leaves, leaves, mask, mask)
    K_inv, K_logdet = chol_inv_logdet(kernel_matrix(gram, noise, scale))
    mll = masked_mll(K_inv, K_logdet, y, noise, pad_count)
    return ChainState(
        forest=forest, leaves=leaves, noise=noise, scale=scale,
        kern=KernState(K_inv=K_inv, K_logdet=K_logdet), mll=mll,
    )


class _ProposalBatch(NamedTuple):
    """Every (chain, tree) proposal of one step; leading dims (C, m). Each
    tree is visited once per step, so its proposal depends only on its own
    pre-step state and the whole batch is computed before the move scan."""

    new_packed: torch.Tensor  # (C, m, node_limit, 8)
    cur_leavesT: torch.Tensor  # (C, m, N)
    new_leavesT: torch.Tensor  # (C, m, N)
    log_q_prior: torch.Tensor  # (C, m)
    move: torch.Tensor  # (C, m)
    node: torch.Tensor  # (C, m)
    u_accept: torch.Tensor  # (C, m)


def _propose_all_trees(state, X, feat_types, bounds, params, noise):
    """The hoisted proposal batch over all chains and trees."""
    c, m, node_limit = state.forest.is_leaf.shape
    n = X.shape[0]
    packed0 = pack_forest(state.forest)  # (C, m, node_limit, 8)
    flat = packed0.reshape(c * m, node_limit, 8)
    flat_noise = ProposalNoise(*(t.reshape(c * m, *t.shape[2:]) for t in noise))
    new_packed, log_q_prior, move, node = propose_tree_packed(
        flat, bounds, feat_types, params, flat_noise
    )
    rows = torch.arange(c * m, device=X.device)
    nodes = node.long()
    cur_leavesT = state.leaves.transpose(1, 2).reshape(c * m, n)
    new_leavesT = _incremental_leaves(
        flat[rows, nodes], new_packed[rows, nodes], cur_leavesT, move, node, X,
        feat_types,
    )
    batch = _ProposalBatch(
        new_packed=new_packed.reshape(c, m, node_limit, 8),
        cur_leavesT=cur_leavesT.reshape(c, m, n),
        new_leavesT=new_leavesT.reshape(c, m, n),
        log_q_prior=log_q_prior.reshape(c, m),
        move=move.reshape(c, m),
        node=node.reshape(c, m),
        u_accept=noise.u_accept,
    )
    return packed0, batch


def _merge_accepted(packed0, batch, accepts):
    """Select the accepted per-tree state after the move scan."""
    packed = torch.where(accepts[..., None, None], batch.new_packed, packed0)
    leavesT = torch.where(accepts[..., None], batch.new_leavesT, batch.cur_leavesT)
    return unpack_forest(packed), leavesT.transpose(1, 2).contiguous()


def _tree_moves_rank1(state, X, y, mask, pad_count, bounds, feat_types, params, noise):
    """m tree moves with rank-2 Woodbury maintenance of K^-1 (plain scan).

    Every move's kernel delta is exactly rank 2, ``w_add w_add^T - w_sub
    w_sub^T`` with w built from leaf-membership indicators (grow at n:
    w_add = 1_L - 1_R, w_sub = 1_n; prune the reverse; change the old and
    new child indicators), each scaled by sqrt(scale / 2m). Per move:
    V = K^-1 W, the 2x2 capacitance M, and K^-1, logdet K, K^-1 y and
    y^T K^-1 y updated in O(N^2). A ``denom <= eps`` guard turns round-off
    broken updates into rejections.

    The scan's starting MLL comes from the scan's own quantities (K^-1 y
    and logdet of the carried state), not from ``state.mll``, so every MH
    ratio compares two values of one program (the reference measured a
    posterior bias when it seeded from the refresh's MLL).

    Returns (forest, leaves, accepts (C, m), log_alpha (C, m)); the
    refresh rebuilds K^-1 exactly, so the scan's own carry is dropped.
    """
    m = params.num_trees
    half_s_over_m = torch.sqrt(state.scale / (2.0 * m))  # (C,)
    eps = 1e-6
    packed0, batch = _propose_all_trees(state, X, feat_types, bounds, params, noise)

    node = batch.node.long()
    gather_rows = lambda p: torch.gather(  # noqa: E731
        p, 2, node[..., None, None].expand(*node.shape, 1, 8)
    )[:, :, 0]
    rows_new = gather_rows(batch.new_packed)  # (C, m, 8)
    rows_old = gather_rows(packed0)
    a_l, a_r = rows_new[..., 3:4], rows_new[..., 4:5]
    l_old, r_old = rows_old[..., 3:4], rows_old[..., 4:5]
    is_grow = (batch.move == GROW)[..., None]
    is_prune = (batch.move == PRUNE)[..., None]
    node_col = batch.node[..., None]

    def ind(lv, i):
        return (lv == i).to(torch.float32)

    new_lT, cur_lT = batch.new_leavesT, batch.cur_leavesT
    w_add = torch.where(is_prune, ind(new_lT, node_col), ind(new_lT, a_l) - ind(new_lT, a_r))
    w_sub = torch.where(is_grow, ind(cur_lT, node_col), ind(cur_lT, l_old) - ind(cur_lT, r_old))
    W_all = half_s_over_m[:, None, None, None] * torch.stack(
        [mask * w_add, mask * w_sub], dim=-1
    )  # (C, m, N, 2)

    y_flat = y.reshape(-1)
    mll_corr = pad_count * torch.log(JITTER + state.noise)
    K_inv, K_logdet = state.kern.K_inv, state.kern.K_logdet
    v_y = K_inv @ y_flat  # (C, N)
    quad = v_y @ y_flat  # (C,)
    cur_mll = 0.5 * (-quad - K_logdet + mll_corr)  # scan-consistent seed
    log_u = torch.log(batch.u_accept)
    zero = torch.zeros_like(cur_mll)

    accepts, log_alphas = [], []
    for j in range(m):
        W = W_all[:, j]  # (C, N, 2)
        Wt = W.transpose(-1, -2)
        V = K_inv @ W  # (C, N, 2)
        G = Wt @ V  # (C, 2, 2)
        t = (Wt @ v_y[..., None])[..., 0]  # (C, 2)
        A, B, Cc = G[:, 0, 0], G[:, 1, 1], G[:, 0, 1]
        denom1 = 1.0 + A
        detM = denom1 * (B - 1.0) - Cc * Cc
        denom2 = -detM / denom1
        Minv = torch.stack(
            [torch.stack([B - 1.0, -Cc], -1), torch.stack([-Cc, denom1], -1)], -2
        ) / detM[:, None, None]
        P = V @ Minv
        K_inv2 = K_inv - P @ V.transpose(-1, -2)
        K_logdet2 = K_logdet + torch.log(-detM)
        u = (Minv @ t[..., None])[..., 0]
        v_y2 = v_y - (V @ u[..., None])[..., 0]
        quad2 = quad - (t * u).sum(-1)

        new_mll = 0.5 * (-quad2 - K_logdet2 + mll_corr)
        new_mll = torch.where(denom2 > eps, new_mll, -torch.inf)
        log_alpha = batch.log_q_prior[:, j] + new_mll - cur_mll
        acc = log_u[:, j] <= torch.minimum(log_alpha, zero)

        K_inv = torch.where(acc[:, None, None], K_inv2, K_inv)
        K_logdet = torch.where(acc, K_logdet2, K_logdet)
        v_y = torch.where(acc[:, None], v_y2, v_y)
        quad = torch.where(acc, quad2, quad)
        cur_mll = torch.where(acc, new_mll, cur_mll)
        accepts.append(acc)
        log_alphas.append(log_alpha)

    accepts = torch.stack(accepts, 1)
    forest, leaves = _merge_accepted(packed0, batch, accepts)
    return forest, leaves, accepts, torch.stack(log_alphas, 1)


def step_with_info(
    state: ChainState,
    X: torch.Tensor,
    y: torch.Tensor,
    bounds: torch.Tensor,
    feat_types: torch.Tensor,
    params: SamplerParams,
    draws: StepDraws,
    mask: torch.Tensor | None = None,
) -> tuple[ChainState, StepInfo]:
    """One full MCMC step for C chains: m tree moves + one noise/scale move.

    Returns the new state and the step's accept decisions.
    """
    params = _resolve_styles(params, X.shape[0])
    check_matmul_precision()
    mask = _default_mask(X, mask)
    pad_count = X.shape[0] - mask.sum()
    y_flat = y.reshape(-1)

    (new_noise, new_scale), log_q_hyper = get_noise_scale_proposal(
        draws.z_noise, draws.z_scale, state.noise, state.scale, params
    )
    forest, leaves, accepts, tree_log_alpha = _tree_moves_rank1(
        state, X, y, mask, pad_count, bounds, feat_types, params, draws.proposal
    )

    # exact refresh (onesolve): rebuild the Gram from the new leaves and
    # factor both MH branches of the noise move at once; both MLLs come
    # from the factors (z = L^-1 y), and the selected branch's inverse
    # factor gives the carried K^-1 without an N-right-hand-side solve
    gram = gram_from_leaves(leaves, leaves, mask, mask)
    noise2 = torch.stack([state.noise, new_noise], 1)  # (C, 2)
    scale2 = torch.stack([state.scale, new_scale], 1)
    K2 = kernel_matrix(gram[:, None], noise2, scale2)  # (C, 2, N, N)
    L2, E2 = blocked_cholesky(K2)
    mll2, logdet2 = _chol_mll(L2, y_flat, noise2, pad_count)
    cur_mll, new_mll = mll2[:, 0], mll2[:, 1]

    log_alpha = log_q_hyper + new_mll - cur_mll
    accept = torch.log(draws.u_hyper) <= torch.minimum(
        log_alpha, torch.zeros_like(log_alpha)
    )
    E_sel = torch.where(accept[:, None, None], E2[:, 1], E2[:, 0])
    kern = KernState(
        K_inv=E_sel.transpose(-1, -2) @ E_sel,
        K_logdet=torch.where(accept, logdet2[:, 1], logdet2[:, 0]),
    )
    new_state = ChainState(
        forest=forest,
        leaves=leaves,
        noise=torch.where(accept, new_noise, state.noise),
        scale=torch.where(accept, new_scale, state.scale),
        kern=kern,
        mll=torch.where(accept, new_mll, cur_mll),
    )
    info = StepInfo(
        tree_accepts=accepts, tree_log_alpha=tree_log_alpha,
        hyper_accept=accept, hyper_log_alpha=log_alpha,
    )
    return new_state, info


def step(
    state: ChainState,
    X: torch.Tensor,
    y: torch.Tensor,
    bounds: torch.Tensor,
    feat_types: torch.Tensor,
    params: SamplerParams,
    draws: StepDraws,
    mask: torch.Tensor | None = None,
) -> ChainState:
    """One full MCMC step (see :func:`step_with_info`)."""
    return step_with_info(state, X, y, bounds, feat_types, params, draws, mask)[0]


class ChainRun(NamedTuple):
    samples: BARKModel  # fields (C, num_samples, ...)
    state: ChainState  # final state
    mll: torch.Tensor  # (C, num_samples) MLL at each sample
    tree_accept_rate: torch.Tensor  # (C,) accepted tree moves / proposed
    hyper_accept_rate: torch.Tensor  # (C,) accepted noise moves / proposed


def run_chain(
    generator: torch.Generator,
    model: BARKModel,
    X: torch.Tensor,
    y: torch.Tensor,
    bounds: torch.Tensor,
    feat_types: torch.Tensor,
    params: SamplerParams,
    mask: torch.Tensor | None = None,
) -> ChainRun:
    """Run C chains from ``model`` (fields with leading dim C): warmup, then
    ``num_samples`` samples thinned by ``steps_per_sample``.

    Draws come from ``generator`` (on the data's device for speed).
    """
    state = init_chain_state(
        model.forest, model.noise, model.scale, X, y, feat_types, params, mask,
        bounds=bounds,
    )
    c = state.noise.shape[0]
    tree_acc = torch.zeros(c, device=X.device)
    hyper_acc = torch.zeros(c, device=X.device)
    n_steps = 0

    def advance(state):
        nonlocal tree_acc, hyper_acc, n_steps
        draws = draw_step(generator, c, params, X.device)
        state, info = step_with_info(
            state, X, y, bounds, feat_types, params, draws, mask
        )
        tree_acc = tree_acc + info.tree_accepts.sum(1)
        hyper_acc = hyper_acc + info.hyper_accept
        n_steps += 1
        return state

    for _ in range(params.warmup_steps):
        state = advance(state)
    forests, noises, scales, mlls = [], [], [], []
    for _ in range(params.num_samples):
        for _ in range(params.steps_per_sample):
            state = advance(state)
        forests.append(state.forest)
        noises.append(state.noise)
        scales.append(state.scale)
        mlls.append(state.mll)
    samples = BARKModel(
        forest=Forest(*(torch.stack(f, 1) for f in zip(*forests))),
        noise=torch.stack(noises, 1),
        scale=torch.stack(scales, 1),
    )
    steps = max(n_steps, 1)
    return ChainRun(
        samples=samples,
        state=state,
        mll=torch.stack(mlls, 1),
        tree_accept_rate=tree_acc / (steps * params.num_trees),
        hyper_accept_rate=hyper_acc / steps,
    )


def run_bark_sampler(
    generator: torch.Generator,
    model: BARKModel,
    X: torch.Tensor,
    y: torch.Tensor,
    bounds: torch.Tensor,
    feat_types: torch.Tensor,
    params: SamplerParams,
    mask: torch.Tensor | None = None,
) -> BARKModel:
    """Multi-chain driver: returns samples with leading (chains, samples)
    dims. ``mask`` marks real training rows when X/y are padded."""
    return run_chain(generator, model, X, y, bounds, feat_types, params, mask).samples
