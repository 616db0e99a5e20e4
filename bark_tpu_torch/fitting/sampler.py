"""The BARK forest-MCMC transition kernel and multi-chain sampler.

Counterpart of ``bark_tpu/fitting/sampler.py`` with the shipped default
lowering (``kernel_backend="rank1"``, ``hot_style="walk_select"``,
``subspace_mode="walk"``) in both of its tiers, which ``_resolve_styles``
picks by padded N as the reference does:

  - the dense tier (N < 256: ``scan_style="plain"``,
    ``refresh_style="onesolve"``) carries K^-1 (N, N);
  - the leaf tier (N >= 256: ``scan_style="coeff"``,
    ``refresh_style="leaf"``) carries the Cholesky factor of the (R, R)
    leaf-space matrix A = (nu/gamma) I + Z^T Z, where Z (N, R) is the
    compact leaf indicator of the forest (``K = gamma Z Z^T + nu I``,
    nu = jitter + noise, gamma = scale/m) and R the leaf budget.

Beside them, ``kernel_backend="chol"`` is the reference's drift-free
oracle at any N: it carries K (C, N, N) itself, adds each move's exact
kernel delta and factors K by K2 (through ``blocked_cholesky``) once per
move and once for the noise move. It is slow, and it is what the shipped
tiers are judged against at stationarity
(``bark_tpu_torch/benchmarks/stationary.py``).

Every tensor carries a leading chain dimension (the reference ``vmap``-ed
over chains) and the sequential move scan is a Python loop over the m
trees, all chains in lockstep.

One step (:func:`step`):

  1. the noise/scale proposal (:mod:`.noise_scale`);
  2. the hoisted proposal batch: one grow/prune/change proposal for every
     (chain, tree) at once, with the incremental leaf update of each
     (proposals only touch terminal or singly-internal nodes);
  3. the move scan, an MH accept per tree on the MLL ratio, seeded from the
     scan's own quantities. Dense tier: a rank-2 Woodbury update of the
     carried K^-1 per move (the move's kernel delta is exactly rank 2).
     Leaf tier: the same Woodbury algebra in the span of the m moves'
     update vectors, on (2m, 2m) tensors, with the leaf-capacity guard;
  4. the exact refresh: both MH branches of the noise move factored at once
     by the Cholesky-with-inverse kernel K2 (``ops.chol`` through
     ``ops.linalg.blocked_cholesky``), both MLLs from the factors, and the
     accept. Dense tier: of the kernel matrices built from the agreement
     Gram (kernel K1, ``ops.gram``), carrying K^-1 = E^T E from the selected
     branch's inverse factor E. Leaf tier: of the two A, carrying the
     selected branch's factor.

All randomness of a step is one :class:`StepDraws` record (made by
:func:`draw_step` from a ``torch.Generator``), so a step is a pure function
of (state, draws) -- the seam the parity tests use to replay the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

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
    indicator_from_targets,
    leaf_rank_targets,
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

#: the lowerings the port runs: the dense tier and the leaf tier
_TIERS = (("plain", "onesolve"), ("coeff", "leaf"))
#: the kernel backends: the shipped one and the drift-free oracle
_BACKENDS = ("rank1", "chol")
_SHIPPED = {"hot_style": "walk_select", "subspace_mode": "walk"}


def _leaf_budget(params: SamplerParams, n: int) -> int:
    """Compact leaf-slot count R of the leaf tier, as the reference's.

    An explicit ``leaf_budget`` wins. Auto: 5 leaves per tree up to padded
    N = 2048, 7.5 up to 8192, 10 beyond (the reference measured posterior
    leaf totals growing with N and keeps R about 5 sigma above their mean,
    so the capacity guard almost never fires); doubled under a deeper-tree
    prior (alpha > 0.95 or beta < 2), capped at the per-tree structural
    maximum, and rounded up to a multiple of 128 (at least 128).
    """
    if params.leaf_budget > 0:
        return params.leaf_budget
    per_tree = 10.0 if n > 8192 else (7.5 if n > 2048 else 5.0)
    if params.alpha > 0.95 or params.beta < 2.0:
        per_tree *= 2.0
    slots = min(
        int(per_tree * params.num_trees),
        params.num_trees * ((params.node_limit + 1) // 2),
    )
    return max(128, -(-slots // 128) * 128)


def _resolve_styles(params: SamplerParams, n: int) -> SamplerParams:
    """Resolve the lowering for padded N exactly as the reference does.

    ``auto`` resolves to the leaf tier (coeff scan + leaf refresh) at
    N >= 256 and to the dense tier (plain scan + onesolve refresh) below;
    an explicit ``refresh_style="leaf"`` or ``scan_style="coeff"`` selects
    the leaf tier at any N, an explicit ``scan_style="plain"`` the dense
    tier at any N. The port runs those two lowerings with the shipped
    proposal and backend defaults, and raises ``NotImplementedError`` for
    every other one rather than run something else. ``chol_block``/
    ``chol_impl``/``gram_dtype``/``scan_unroll`` choose among the
    reference's lowerings of the same arithmetic; the port has one lowering
    for each (kernels K1 and K2, a Python loop) and does not read them.

    ``kernel_backend="chol"`` returns the params unchanged: the scan and
    refresh styles do not apply to it (as in the reference). The
    ``woodbury`` backend raises.
    """
    for name, value in _SHIPPED.items():
        if getattr(params, name) != value:
            raise NotImplementedError(
                f"SamplerParams.{name}={getattr(params, name)!r}: the port "
                f"runs only {value!r} (the shipped default)"
            )
    if params.kernel_backend not in _BACKENDS:
        raise NotImplementedError(
            f"SamplerParams.kernel_backend={params.kernel_backend!r}: the port "
            f"runs only {_BACKENDS}"
        )
    if params.kernel_backend == "chol":
        return params
    scan, refresh = params.scan_style, params.refresh_style
    if refresh == "auto":
        refresh = "leaf" if n >= 256 and scan in ("auto", "coeff") else "onesolve"
    if refresh in ("factor", "leaf"):
        scan = "coeff"
    elif scan == "auto":
        scan = "coeff" if n >= 1024 else ("lowrank" if n >= 256 else "plain")
    if (scan, refresh) not in _TIERS:
        raise NotImplementedError(
            f"padded N={n} resolves to scan_style={scan!r}, refresh_style="
            f"{refresh!r}: the port runs only {_TIERS}"
        )
    if (scan, refresh) == (params.scan_style, params.refresh_style):
        return params
    return params.with_(scan_style=scan, refresh_style=refresh)


def _leaf_Z(
    forest: Forest, leaves: torch.Tensor, budget: int, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Budget-packed leaf indicator Z (C, N, R) and each chain's leaf total (C,).

    Tree j's active leaves are ranked in node order and packed from column
    ``sum_{j' < j} num_leaves(j')``, so ``Z Z^T == m * gram`` exactly while
    the total is at most R (the move scan's capacity guard keeps it there;
    slots past the budget project to nothing and the callers poison the MLL
    with NaN on overflow). Padded rows are zeroed.
    """
    tmask, ranks, counts = leaf_rank_targets(forest)
    base = torch.cumsum(counts, -1, dtype=torch.int32) - counts  # exclusive prefix
    target = torch.where(tmask, base[..., None] + ranks, budget)
    Z = indicator_from_targets(leaves, target, budget)
    return Z * mask[:, None], counts.sum(-1)


def _leaf_factor_mll(
    Z: torch.Tensor,
    G: torch.Tensor,
    y: torch.Tensor,
    nu: torch.Tensor,
    gamma: torch.Tensor,
    pad_count: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Factor A_b = (nu_b/gamma_b) I + G for every branch b and give the MLLs.

    ``Z`` (C, N, R), ``G = Z^T Z`` (C, R, R), ``nu``/``gamma`` (C, B). One
    (C * B, R, R) factorization through K2 (``blocked_cholesky``). By the
    determinant lemma, logdet K_b = N log nu_b + R log(gamma_b/nu_b) +
    logdet A_b (zero columns of Z add log(nu/gamma) to logdet A and cancel
    against the R term, so an unfilled budget is inert). The quadratic is in
    residual form, y^T (y - Z w_b) / nu_b with w_b = A_b^-1 Z^T y: the
    reference measured (y^T y - ||L^-1 Z^T y||^2) / nu, a difference of
    O(N) float32 sums, biasing the noise posterior at small noise.

    Returns the factors L (C, B, R, R), logdet K (C, B) and MLL (C, B).
    """
    n, r = Z.shape[-2:]
    eye = torch.eye(r, dtype=G.dtype, device=G.device)
    L, _ = blocked_cholesky(G[:, None] + (nu / gamma)[..., None, None] * eye)
    logdet_A = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    K_logdet = n * torch.log(nu) + r * torch.log(gamma / nu) + logdet_A
    uz = (Z.transpose(1, 2) @ y)[:, None, :, None].expand(*L.shape[:-1], 1)
    w = torch.cholesky_solve(uz, L)[..., 0]  # (C, B, R)
    resid = y - w @ Z.transpose(1, 2)  # (C, B, N)
    quad = (resid @ y) / nu
    mll = 0.5 * (-quad - K_logdet + pad_count * torch.log(nu))
    return L, K_logdet, mll


class KernState(NamedTuple):
    """Kernel carry: logdet K (C,) and the tier's factor of K.

    Dense tier: ``K_inv`` (C, N, N), ``L`` None. Leaf tier: ``L`` (C, R, R),
    the Cholesky factor of A = (nu/gamma) I + Z^T Z, ``K_inv`` None. The
    chol backend carries the kernel matrix itself, ``K`` (C, N, N), and
    nothing else (``K_inv``, ``K_logdet`` and ``L`` None): every move
    factors it afresh.
    """

    K_inv: torch.Tensor | None
    K_logdet: torch.Tensor | None
    L: torch.Tensor | None = None
    K: torch.Tensor | None = None

    def to(self, device) -> "KernState":
        return KernState(*(None if t is None else t.to(device) for t in self))


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

    def take(self, rows: torch.Tensor) -> "ChainState":
        """The chain rows ``rows`` (an index tensor) of every field, the
        kernel carry included."""
        return ChainState(
            Forest(*(t[rows] for t in self.forest)), self.leaves[rows],
            self.noise[rows], self.scale[rows],
            KernState(*(None if t is None else t[rows] for t in self.kern)),
            self.mll[rows],
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


def _leaf_agreement(leaves_j: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(C, N, N) 0/1 matrix of the rows sharing a leaf of one tree, from its
    leaves (C, N); padded rows and columns masked out."""
    eq = (leaves_j[:, :, None] == leaves_j[:, None, :]).to(torch.float32)
    return eq * (mask[:, None] * mask[None, :])


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
    rows (padded rows are inert). Dense tier: the Gram goes through K1, the
    factorization of K through K2. Leaf tier: the factorization of A
    through K2, and no (N, N) object is built; an initial forest with more
    leaves than the budget R cannot be packed, and its chain's MLL is NaN,
    as in the reference, so its noise moves reject and the fault shows in
    the outputs (the move scan's capacity guard lets only moves that do not
    raise the total through, and the MLL stays NaN while it exceeds R).
    The chol backend builds K from the Gram (K1) and takes the MLL from its
    factor (K2).
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
    if params.kernel_backend == "chol":
        gram = gram_from_leaves(leaves, leaves, mask, mask, params.node_limit)
        K = kernel_matrix(gram, noise, scale)
        mll, _ = _chol_mll(blocked_cholesky(K)[0], y.reshape(-1), noise, pad_count)
        kern = KernState(K_inv=None, K_logdet=None, K=K)
    elif params.refresh_style == "leaf":
        budget = _leaf_budget(params, X.shape[0])
        Z, total = _leaf_Z(forest, leaves, budget, mask)
        L, K_logdet, mll = _leaf_factor_mll(
            Z, Z.transpose(1, 2) @ Z, y.reshape(-1), (JITTER + noise)[:, None],
            (scale / params.num_trees)[:, None], pad_count,
        )
        mll = torch.where(total <= budget, mll[:, 0], torch.nan)
        kern = KernState(K_inv=None, K_logdet=K_logdet[:, 0], L=L[:, 0])
    else:
        gram = gram_from_leaves(leaves, leaves, mask, mask, params.node_limit)
        K_inv, K_logdet = chol_inv_logdet(kernel_matrix(gram, noise, scale))
        mll = masked_mll(K_inv, K_logdet, y, noise, pad_count)
        kern = KernState(K_inv=K_inv, K_logdet=K_logdet)
    return ChainState(
        forest=forest, leaves=leaves, noise=noise, scale=scale, kern=kern, mll=mll,
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


def _update_patterns(packed0, batch, mask):
    """The 0/±1 update patterns W_pat (C, m, N, 2) of every move.

    Every move's kernel delta is exactly rank 2, ``scale/2m (w_add w_add^T
    - w_sub w_sub^T)`` with w built from leaf-membership indicators (grow at
    n: w_add = 1_L - 1_R, w_sub = 1_n; prune the reverse; change the old
    and new child indicators). The sqrt(scale/2m) factor is applied by the
    consumers.
    """
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
    return torch.stack([mask * w_add, mask * w_sub], dim=-1)


def _tempered(beta, delta_mll: torch.Tensor) -> torch.Tensor:
    """``beta * delta_mll``: the likelihood-tempered MLL difference of an MH
    ratio. ``beta`` is an inverse temperature, a float or a (C,) tensor with
    one per chain row. A float 1.0 returns the difference itself: the
    product would be exact, and the plain step, bound by the host's launch
    rate, is spared a launch per move."""
    if isinstance(beta, (int, float)) and beta == 1.0:
        return delta_mll
    return beta * delta_mll


def _capacitance_inverse(G):
    """Inverse of the 2x2 capacitance M = diag(1, -1) + G of a rank-2
    Woodbury update (G = W^T K^-1 W, (C, 2, 2)): ``(Minv, detM, denom2)``.
    ``denom2 = -det(M) / (1 + G00)`` is the second Sherman-Morrison
    denominator; the update is sound only where it is positive."""
    A, B, Cc = G[:, 0, 0], G[:, 1, 1], G[:, 0, 1]
    denom1 = 1.0 + A
    detM = denom1 * (B - 1.0) - Cc * Cc
    denom2 = -detM / denom1
    Minv = torch.stack(
        [torch.stack([B - 1.0, -Cc], -1), torch.stack([-Cc, denom1], -1)], -2
    ) / detM[:, None, None]
    return Minv, detM, denom2


def _tree_moves_rank1(
    state, X, y, mask, pad_count, bounds, feat_types, params, noise, beta=1.0
):
    """m tree moves with rank-2 Woodbury maintenance of K^-1 (plain scan).

    Per move, with W the scaled update patterns (:func:`_update_patterns`):
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
    W_all = half_s_over_m[:, None, None, None] * _update_patterns(packed0, batch, mask)

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
        Minv, detM, denom2 = _capacitance_inverse(G)
        P = V @ Minv
        K_inv2 = K_inv - P @ V.transpose(-1, -2)
        K_logdet2 = K_logdet + torch.log(-detM)
        u = (Minv @ t[..., None])[..., 0]
        v_y2 = v_y - (V @ u[..., None])[..., 0]
        quad2 = quad - (t * u).sum(-1)

        new_mll = 0.5 * (-quad2 - K_logdet2 + mll_corr)
        new_mll = torch.where(denom2 > eps, new_mll, -torch.inf)
        log_alpha = batch.log_q_prior[:, j] + _tempered(beta, new_mll - cur_mll)
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


def _tree_moves_chol(
    state, X, y, mask, pad_count, bounds, feat_types, params, noise, beta=1.0
):
    """m tree moves on the exact kernel matrix, one factorization a move.

    Move j adds its exact delta ``(scale/m) (A_new - A_cur)``, the
    difference of tree j's masked 0/1 agreement under the proposed and the
    current leaves, to the carried K and factors ``K + delta`` for all
    chains at once through K2 (``blocked_cholesky``: one launch at N <= 256,
    host-blocked above); the MLL comes from the factor (:func:`_chol_mll`,
    with the padding correction). A failed factorization gives a NaN MLL,
    and the move rejects. Nothing drifts: no inverse is carried, so the
    scan's seed is the state's own MLL, as in the reference.

    Returns (forest, leaves, accepts (C, m), log_alpha (C, m), K, mll).
    """
    s_over_m = (state.scale / params.num_trees)[:, None, None]
    packed0, batch = _propose_all_trees(state, X, feat_types, bounds, params, noise)
    y_flat = y.reshape(-1)
    K, cur_mll = state.kern.K, state.mll
    log_u = torch.log(batch.u_accept)
    zero = torch.zeros_like(cur_mll)

    accepts, log_alphas = [], []
    for j in range(params.num_trees):
        delta = s_over_m * (
            _leaf_agreement(batch.new_leavesT[:, j], mask)
            - _leaf_agreement(batch.cur_leavesT[:, j], mask)
        )
        K_new = K + delta
        new_mll, _ = _chol_mll(blocked_cholesky(K_new)[0], y_flat, state.noise, pad_count)
        log_alpha = batch.log_q_prior[:, j] + _tempered(beta, new_mll - cur_mll)
        acc = log_u[:, j] <= torch.minimum(log_alpha, zero)
        K = torch.where(acc[:, None, None], K_new, K)
        cur_mll = torch.where(acc, new_mll, cur_mll)
        accepts.append(acc)
        log_alphas.append(log_alpha)

    accepts = torch.stack(accepts, 1)
    forest, leaves = _merge_accepted(packed0, batch, accepts)
    return forest, leaves, accepts, torch.stack(log_alphas, 1), K, cur_mll


def _tree_moves_coeff(
    state, X, y, mask, pad_count, bounds, feat_types, params, noise, beta=1.0
):
    """m tree moves in coefficient space with the leaf-capacity guard (leaf tier).

    The Woodbury algebra of :func:`_tree_moves_rank1` in the span of
    V0 = K0^-1 W (W = all 2m update vectors, columns [add_0, sub_0, add_1,
    ...]): with Hm = W^T K0^-1 W (2m, 2m), K^-1 = K0^-1 - V0 S V0^T and
    K^-1 y = K0^-1 y - V0 d, move j needs c = E_j - S Tv (Tv = Hm's two
    columns of the move, E_j the matching identity columns), G = Tv^T c and
    t = t0_j - Tv^T d, and an accept adds c Minv c^T to S and c u to d. The
    loop touches only (2m, 2m) tensors; N appears in the hoisted products.

    The hoist reads K0 through the carried factor L of A = (nu/gamma) I +
    Z^T Z (K0 = gamma Z Z^T + nu I): Hm = (h^2 W_p^T W_p - Sw^T Sw) / nu
    with Sw = L^-1 (h Z^T W_p), h = sqrt(scale/2m) and W_p the 0/±1
    patterns, symmetrised (its B - 1 ~ 1e-2 cancellation is why every
    product here runs at full float32); t0 and the seed's quadratic in
    residual form (see :func:`_leaf_factor_mll`).

    The capacity guard carries each chain's leaf total: a grow adds one
    leaf, a prune removes one, and a move that would take the total past
    the budget R gets MLL -inf, so the leaf packing of the refresh stays
    exact.

    Returns (forest, leaves, accepts (C, m), log_alpha (C, m)).
    """
    c_, m = state.noise.shape[0], params.num_trees
    m2 = 2 * m
    n = X.shape[0]
    h = torch.sqrt(state.scale / (2.0 * m))  # (C,)
    eps = 1e-6
    packed0, batch = _propose_all_trees(state, X, feat_types, bounds, params, noise)
    W_pat = _update_patterns(packed0, batch, mask)
    Wp = W_pat.permute(0, 2, 1, 3).reshape(c_, n, m2)  # (C, N, 2m)

    budget = _leaf_budget(params, n)
    y_flat = y.reshape(-1)
    nu = JITTER + state.noise
    L_A = state.kern.L
    Z, total = _leaf_Z(state.forest, state.leaves, budget, mask)
    Zt = Z.transpose(1, 2)
    CW = Zt @ Wp  # (C, R, 2m) integer counts
    WtW = Wp.transpose(1, 2) @ Wp  # (C, 2m, 2m) integers
    Sw = torch.linalg.solve_triangular(L_A, h[:, None, None] * CW, upper=False)
    w_y = torch.cholesky_solve((Zt @ y_flat)[..., None], L_A)  # (C, R, 1)
    resid_y = y_flat - (Z @ w_y)[..., 0]  # (C, N)
    Hm = ((h * h)[:, None, None] * WtW - Sw.transpose(1, 2) @ Sw) / nu[:, None, None]
    Hm = 0.5 * (Hm + Hm.transpose(1, 2))
    t0 = (h[:, None] * (Wp.transpose(1, 2) @ resid_y[..., None])[..., 0]) / nu[:, None]
    quad = (resid_y @ y_flat) / nu  # (C,)

    mll_corr = pad_count * torch.log(nu)
    K_logdet = state.kern.K_logdet
    cur_mll = 0.5 * (-quad - K_logdet + mll_corr)  # scan-consistent seed
    S = torch.zeros((c_, m2, m2), dtype=Hm.dtype, device=Hm.device)
    d = torch.zeros((c_, m2), dtype=Hm.dtype, device=Hm.device)
    E_all = torch.eye(m2, dtype=Hm.dtype, device=Hm.device).reshape(m2, m, 2)
    delta = (batch.move == GROW).to(torch.int32) - (batch.move == PRUNE).to(torch.int32)
    log_u = torch.log(batch.u_accept)
    zero = torch.zeros_like(cur_mll)

    accepts, log_alphas = [], []
    for j in range(m):
        Tv = Hm[:, :, 2 * j : 2 * j + 2]  # (C, 2m, 2)
        Tvt = Tv.transpose(1, 2)
        c = E_all[:, j] - S @ Tv  # (C, 2m, 2)
        G = Tvt @ c  # (C, 2, 2)
        t = t0[:, 2 * j : 2 * j + 2] - (Tvt @ d[..., None])[..., 0]  # (C, 2)
        Minv, detM, denom2 = _capacitance_inverse(G)
        K_logdet2 = K_logdet + torch.log(-detM)
        u = (Minv @ t[..., None])[..., 0]
        quad2 = quad - (t * u).sum(-1)

        new_mll = 0.5 * (-quad2 - K_logdet2 + mll_corr)
        new_mll = torch.where(denom2 > eps, new_mll, -torch.inf)
        new_mll = torch.where(total + delta[:, j] > budget, -torch.inf, new_mll)
        log_alpha = batch.log_q_prior[:, j] + _tempered(beta, new_mll - cur_mll)
        acc = log_u[:, j] <= torch.minimum(log_alpha, zero)

        S = torch.where(acc[:, None, None], S + (c @ Minv) @ c.transpose(1, 2), S)
        d = torch.where(acc[:, None], d + (c @ u[..., None])[..., 0], d)
        K_logdet = torch.where(acc, K_logdet2, K_logdet)
        quad = torch.where(acc, quad2, quad)
        cur_mll = torch.where(acc, new_mll, cur_mll)
        total = total + torch.where(acc, delta[:, j], 0)
        accepts.append(acc)
        log_alphas.append(log_alpha)

    accepts = torch.stack(accepts, 1)
    forest, leaves = _merge_accepted(packed0, batch, accepts)
    return forest, leaves, accepts, torch.stack(log_alphas, 1)


def _refresh(forest, leaves, state, new_noise, new_scale, X, y_flat, mask, pad_count,
             params, leaf_tier):
    """The exact refresh of the shipped tiers: both MH branches of the noise
    move (current and proposed noise/scale) factored at once from the
    post-scan leaves. Returns (cur_mll, new_mll, L2, E2, logdet2), the
    factors and logdets (C, 2, ...) of both branches (E2 None in the leaf
    tier)."""
    noise2 = torch.stack([state.noise, new_noise], 1)  # (C, 2)
    scale2 = torch.stack([state.scale, new_scale], 1)
    E2 = None
    if leaf_tier:
        # exact refresh in leaf space: Z of the new leaves, G = Z^T Z shared
        # by both MH branches, both A_b factored in one K2 call; no (N, N)
        # object. An over-budget packing (unreachable from a valid init, the
        # scan's guard rejects grows at capacity) keeps the NaN poison.
        budget = _leaf_budget(params, X.shape[0])
        Z, total = _leaf_Z(forest, leaves, budget, mask)
        L2, logdet2, mll2 = _leaf_factor_mll(
            Z, Z.transpose(1, 2) @ Z, y_flat, JITTER + noise2,
            scale2 / params.num_trees, pad_count,
        )
        mll2 = torch.where((total <= budget)[:, None], mll2, torch.nan)
    else:
        # exact refresh (onesolve): rebuild the Gram from the new leaves and
        # factor both MH branches of the noise move at once; both MLLs come
        # from the factors (z = L^-1 y), and the selected branch's inverse
        # factor gives the carried K^-1 without an N-right-hand-side solve
        gram = gram_from_leaves(leaves, leaves, mask, mask, params.node_limit)
        K2 = kernel_matrix(gram[:, None], noise2, scale2)  # (C, 2, N, N)
        L2, E2 = blocked_cholesky(K2)
        mll2, logdet2 = _chol_mll(L2, y_flat, noise2, pad_count)
    return mll2[:, 0], mll2[:, 1], L2, E2, logdet2


def step_with_info(
    state: ChainState,
    X: torch.Tensor,
    y: torch.Tensor,
    bounds: torch.Tensor,
    feat_types: torch.Tensor,
    params: SamplerParams,
    draws: StepDraws,
    mask: torch.Tensor | None = None,
    beta: float | torch.Tensor = 1.0,
) -> tuple[ChainState, StepInfo]:
    """One full MCMC step for C chains: m tree moves + one noise/scale move.

    ``beta`` is the inverse temperature of likelihood tempering (parallel
    tempering, SMC): a float, or a (C,) float32 tensor with one per chain
    row. It multiplies the MLL difference of every MH ratio, the tree moves'
    and the noise move's; the proposal ratios stay untempered, and beta = 1
    is the plain step. (It is not ``params.beta``, the tree prior's depth
    exponent.)

    With ``kernel_backend="chol"`` the tree moves are
    :func:`_tree_moves_chol`, and the noise move rescales the carried K
    exactly, ``(new_scale/scale) (K - (jitter + noise) I) + (jitter +
    new_noise) I``, with one more factorization and no refresh.

    Returns the new state and the step's accept decisions; the log ratios in
    :class:`StepInfo` are the tempered ones.
    """
    params = _resolve_styles(params, X.shape[0])
    check_matmul_precision()
    mask = _default_mask(X, mask)
    pad_count = X.shape[0] - mask.sum()
    y_flat = y.reshape(-1)

    (new_noise, new_scale), log_q_hyper = get_noise_scale_proposal(
        draws.z_noise, draws.z_scale, state.noise, state.scale, params
    )
    chol = params.kernel_backend == "chol"
    leaf_tier = not chol and params.refresh_style == "leaf"
    if chol:
        forest, leaves, accepts, tree_log_alpha, K, cur_mll = _tree_moves_chol(
            state, X, y, mask, pad_count, bounds, feat_types, params, draws.proposal, beta
        )
        # the noise move rescales the exact K elementwise: no Gram rebuild,
        # one more factorization
        eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
        gram_part = K - (JITTER + state.noise)[:, None, None] * eye
        K_hyp = (new_scale / state.scale)[:, None, None] * gram_part + (
            JITTER + new_noise
        )[:, None, None] * eye
        new_mll, _ = _chol_mll(blocked_cholesky(K_hyp)[0], y_flat, new_noise, pad_count)
    else:
        tree_moves = _tree_moves_coeff if leaf_tier else _tree_moves_rank1
        forest, leaves, accepts, tree_log_alpha = tree_moves(
            state, X, y, mask, pad_count, bounds, feat_types, params, draws.proposal, beta
        )
        cur_mll, new_mll, L2, E2, logdet2 = _refresh(
            forest, leaves, state, new_noise, new_scale, X, y_flat, mask, pad_count,
            params, leaf_tier,
        )

    log_alpha = log_q_hyper + _tempered(beta, new_mll - cur_mll)
    accept = torch.log(draws.u_hyper) <= torch.minimum(
        log_alpha, torch.zeros_like(log_alpha)
    )
    if chol:
        K_sel = torch.where(accept[:, None, None], K_hyp, K)
        kern = KernState(K_inv=None, K_logdet=None, K=K_sel)
    else:
        K_logdet = torch.where(accept, logdet2[:, 1], logdet2[:, 0])
        if leaf_tier:
            L_sel = torch.where(accept[:, None, None], L2[:, 1], L2[:, 0])
            kern = KernState(K_inv=None, K_logdet=K_logdet, L=L_sel)
        else:
            E_sel = torch.where(accept[:, None, None], E2[:, 1], E2[:, 0])
            kern = KernState(K_inv=E_sel.transpose(-1, -2) @ E_sel, K_logdet=K_logdet)
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
    beta: float | torch.Tensor = 1.0,
) -> ChainState:
    """One full MCMC step (see :func:`step_with_info`)."""
    return step_with_info(state, X, y, bounds, feat_types, params, draws, mask, beta)[0]


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
    draws: Sequence[StepDraws] | None = None,
) -> ChainRun:
    """Run C chains from ``model`` (fields with leading dim C): warmup, then
    ``num_samples`` samples thinned by ``steps_per_sample``.

    Draws come from ``generator`` (on the data's device for speed), or step
    t takes ``draws[t]``.
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
        step_draws = (
            draw_step(generator, c, params, X.device) if draws is None
            else draws[n_steps].to(X.device)
        )
        state, info = step_with_info(
            state, X, y, bounds, feat_types, params, step_draws, mask
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


def run_bark_sampler_with_trace(
    generator: torch.Generator,
    model: BARKModel,
    X: torch.Tensor,
    y: torch.Tensor,
    bounds: torch.Tensor,
    feat_types: torch.Tensor,
    params: SamplerParams,
    mask: torch.Tensor | None = None,
) -> tuple[BARKModel, torch.Tensor]:
    """:func:`run_bark_sampler` plus the MLL at every sample,
    ``(chains, num_samples)``: the diagnostics path (time to a target MLL)."""
    run = run_chain(generator, model, X, y, bounds, feat_types, params, mask)
    return run.samples, run.mll
