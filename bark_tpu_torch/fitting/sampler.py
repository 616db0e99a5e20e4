"""The BARK forest-MCMC transition kernel and multi-chain sampler.

Counterpart of ``bark_tpu/fitting/sampler.py``: every lowering the
reference's :class:`SamplerParams` selects runs here, each as its own code,
and ``_resolve_styles`` resolves ``auto`` by padded N as the reference does.
The shipped default (``kernel_backend="rank1"``) has two tiers:

  - the dense tier (N < 256: ``scan_style="plain"``,
    ``refresh_style="onesolve"``) carries K^-1 (N, N);
  - the leaf tier (N >= 256: ``scan_style="coeff"``,
    ``refresh_style="leaf"``) carries the Cholesky factor of the (R, R)
    leaf-space matrix A = (nu/gamma) I + Z^T Z, where Z (N, R) is the
    compact leaf indicator of the forest (``K = gamma Z Z^T + nu I``,
    nu = jitter + noise, gamma = scale/m) and R the leaf budget.

The other rank1 lowerings, each pinned by ``scan_style``/``refresh_style``:

  - move scans: ``aug`` carries [K^-1 | K^-1 y] (N, N+1) so one product
    updates both; ``lowrank`` never writes K^-1 in the loop, it keeps the
    accepted corrections as factors P, Q (N, 2m) against the step's K0^-1,
    with the base products K0^-1 W of all m moves in one product before the
    loop; ``coeff`` runs the loop on (2m, 2m) tensors, hoisting its
    N-sized products from K^-1 (dense refreshes), from the carried factor L
    of K (``factor``, one lower solve with 2m + 1 right-hand sides) or from
    the leaf-space factor (``leaf``);
  - refreshes: ``pair`` (two factorizations with inverse, one per MH branch
    of the noise move), ``batched`` (both in one), ``onesolve`` (both
    factored at once, MLLs from the factors, K^-1 from the selected
    branch's inverse factor), ``factor`` (as onesolve, carrying L of K
    instead of K^-1) and ``leaf``.

Beside rank1, ``kernel_backend="chol"`` is the drift-free oracle (it
carries K itself, adds each move's exact delta and factors K once per
move), and ``kernel_backend="woodbury"`` is the original BARK algorithm:
each move is two rank-L updates of K^-1, by the compact one-hot leaf
indicators of the tree before and after the move (L = node_limit // 2),
each through a Cholesky of the (L, L) capacitance, with the MLL from K^-1
per move, and a full rebuild of K at the noise move.

On the proposal side, ``subspace_mode="carry"`` keeps every node's
subspace in the state (``ChainState.subspaces``) instead of walking the
parent chain (:mod:`.proposals`); both give the same proposals bit for
bit.

Every factorization goes through the Cholesky-with-inverse kernel K2
(``ops.chol``, through ``ops.linalg.blocked_cholesky``/``chol_inv``), and
every Gram through the agreement kernel K1 (``ops.gram``); on the card the
plain move scan is one launch of the scan kernel K3 (``ops.scan``) and the
walk's proposal batch one launch of K4 (``ops.propose``). The
reference's ``hot_style``, ``gram_dtype``, ``chol_block``, ``chol_impl``
and ``scan_unroll`` choose among XLA lowerings of the same arithmetic;
they are accepted and not read here: the proposal batch has one form, K1's
counts are exact whatever the one-hot dtype, K2 factors any block, and the
move loop is a Python loop or K3.

Every tensor carries a leading chain dimension (the reference ``vmap``-ed
over chains) and the sequential move scan is a Python loop over the m
trees, all chains in lockstep (K3 runs each chain's loop in a block of
its own). The float dtype follows ``y``: float32 on
the card (the kernels are float32), float64 on the CPU for tests.

One step (:func:`step`):

  1. the noise/scale proposal (:mod:`.noise_scale`);
  2. the hoisted proposal batch: one grow/prune/change proposal for every
     (chain, tree) at once, with the incremental leaf update of each
     (proposals only touch terminal or singly-internal nodes);
  3. the move scan, an MH accept per tree on the MLL ratio. The rank1 scans
     seed it from their own quantities (the reference measured a posterior
     bias when seeding from the refresh's MLL); the chol and woodbury
     backends from ``state.mll``, as in the reference;
  4. the refresh (rank1) or the noise move's rebuild (chol, woodbury), and
     the noise move's accept.

All randomness of a step is one :class:`StepDraws` record (made by
:func:`draw_step` from a ``torch.Generator``), so a step is a pure function
of (state, draws) -- the seam the parity tests use to replay the reference.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

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
from bark_tpu_torch.fitting.traversal import all_node_subspaces
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
from bark_tpu_torch.ops.chol import chol_inv
from bark_tpu_torch.ops.linalg import (
    JITTER,
    blocked_cholesky,
    check_matmul_precision,
    chol_inv_logdet,
    kernel_matrix,
    masked_mll,
)
from bark_tpu_torch.ops.propose import propose_batch_cuda
from bark_tpu_torch.ops.scan import move_scan_cuda
from bark_tpu_torch.utils.profiling import annotate


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
    """Resolve the lowering for padded N, line for line as the reference.

    Only the rank1 backend has scan and refresh styles; the others come
    back unchanged. A refresh ``auto`` is ``leaf`` at N >= 256 unless the
    scan is pinned to something other than ``coeff`` (an explicit pin is
    never overridden), else ``onesolve``. The ``factor`` and ``leaf``
    refreshes take the coeff scan (the only scan that reads the kernel
    through symmetric products); otherwise a scan ``auto`` is ``coeff`` at
    N >= 1024, ``lowrank`` from 256 and ``plain`` below. Idempotent.
    """
    if params.kernel_backend != "rank1":
        return params
    scan, refresh = params.scan_style, params.refresh_style
    if refresh == "auto":
        refresh = "leaf" if n >= 256 and scan in ("auto", "coeff") else "onesolve"
    if refresh in ("factor", "leaf"):
        scan = "coeff"
    elif scan == "auto":
        scan = "coeff" if n >= 1024 else ("lowrank" if n >= 256 else "plain")
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
    """Kernel carry: logdet K (C,) and the lowering's factor of K.

    - ``K_inv`` (C, N, N), ``L`` None: the dense rank1 refreshes (``pair``,
      ``batched``, ``onesolve``) and the woodbury backend;
    - ``L`` (C, R, R), ``K_inv`` None: the leaf tier, the Cholesky factor
      of A = (nu/gamma) I + Z^T Z;
    - ``L`` (C, N, N), ``K_inv`` None: the ``factor`` refresh, the Cholesky
      factor of K itself (the slot holds an (N, N) factor here and an
      (R, R) one in the leaf tier; ``refresh_style`` says which);
    - ``K`` (C, N, N) alone (``K_inv``, ``K_logdet`` and ``L`` None): the
      chol backend, the kernel matrix, factored afresh at every move.
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
    # every node's subspace (C, m, node_limit, D, 2) under
    # subspace_mode="carry"; None under "walk", where a proposal walks the
    # chosen node's parent chain
    subspaces: torch.Tensor | None = None

    def to(self, device) -> "ChainState":
        return ChainState(
            self.forest.to(device), self.leaves.to(device), self.noise.to(device),
            self.scale.to(device), self.kern.to(device), self.mll.to(device),
            None if self.subspaces is None else self.subspaces.to(device),
        )

    def take(self, rows: torch.Tensor) -> "ChainState":
        """The chain rows ``rows`` (an index tensor) of every field, the
        kernel carry and the subspaces included."""
        return ChainState(
            Forest(*(t[rows] for t in self.forest)), self.leaves[rows],
            self.noise[rows], self.scale[rows],
            KernState(*(None if t is None else t[rows] for t in self.kern)),
            self.mll[rows],
            None if self.subspaces is None else self.subspaces[rows],
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
    eq = (leaves_j[:, :, None] == leaves_j[:, None, :]).to(mask.dtype)
    return eq * (mask[:, None] * mask[None, :])


def _default_mask(X: torch.Tensor, mask: torch.Tensor | None, dtype) -> torch.Tensor:
    if mask is None:
        return torch.ones(X.shape[0], dtype=dtype, device=X.device)
    return mask.to(dtype)


def _gram(leaves, mask, params):
    """The masked agreement Gram (C, N, N) of the leaves (kernel K1), in
    the mask's float dtype."""
    return gram_from_leaves(leaves, leaves, mask, mask, params.node_limit).to(mask.dtype)


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
    rows (padded rows are inert). The carry follows the lowering (see
    :class:`KernState`): K^-1 and logdet K from the Gram (K1) and a
    factorization (K2) for the dense refreshes and the woodbury backend;
    the factor L of K for ``factor``; the factor of A, with no (N, N)
    object, in the leaf tier, where an initial forest with more leaves than
    the budget R cannot be packed and its chain's MLL is NaN, as in the
    reference, so its noise moves reject and the fault shows in the
    outputs; K itself for chol. Under ``subspace_mode="carry"`` every
    node's subspace is computed once here.
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
    dtype = y.dtype
    mask = _default_mask(X, mask, dtype)
    pad_count = X.shape[0] - mask.sum()
    noise = torch.as_tensor(noise, dtype=dtype, device=X.device).expand(c).clone()
    scale = torch.as_tensor(scale, dtype=dtype, device=X.device).expand(c).clone()
    leaves = route_forest(forest, X, feat_types, params.max_depth)
    y_flat = y.reshape(-1)
    subspaces = None
    if params.subspace_mode == "carry":
        subspaces = all_node_subspaces(forest, bounds, feat_types, params.max_depth)
    if params.kernel_backend == "chol":
        K = kernel_matrix(_gram(leaves, mask, params), noise, scale)
        mll, _ = _chol_mll(blocked_cholesky(K)[0], y_flat, noise, pad_count)
        kern = KernState(K_inv=None, K_logdet=None, K=K)
    elif params.kernel_backend == "rank1" and params.refresh_style == "leaf":
        budget = _leaf_budget(params, X.shape[0])
        Z, total = _leaf_Z(forest, leaves, budget, mask)
        L, K_logdet, mll = _leaf_factor_mll(
            Z, Z.transpose(1, 2) @ Z, y_flat, (JITTER + noise)[:, None],
            (scale / params.num_trees)[:, None], pad_count,
        )
        mll = torch.where(total <= budget, mll[:, 0], torch.nan)
        kern = KernState(K_inv=None, K_logdet=K_logdet[:, 0], L=L[:, 0])
    elif params.kernel_backend == "rank1" and params.refresh_style == "factor":
        L, _ = blocked_cholesky(kernel_matrix(_gram(leaves, mask, params), noise, scale))
        mll, K_logdet = _chol_mll(L, y_flat, noise, pad_count)
        kern = KernState(K_inv=None, K_logdet=K_logdet, L=L)
    else:
        K_inv, K_logdet = chol_inv_logdet(kernel_matrix(_gram(leaves, mask, params), noise, scale))
        mll = masked_mll(K_inv, K_logdet, y, noise, pad_count)
        kern = KernState(K_inv=K_inv, K_logdet=K_logdet)
    return ChainState(
        forest=forest, leaves=leaves, noise=noise, scale=scale, kern=kern, mll=mll,
        subspaces=subspaces,
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
    new_subs: torch.Tensor | None  # (C, m, node_limit, D, 2) under "carry"


def _propose_torch(packed0, noise, leaves, X, feat_types, bounds, params, subspaces=None):
    """The proposal batch in torch: under ``subspace_mode="walk"``
    (``subspaces`` None) K4's twin and oracle and the path of CPU tensors,
    under "carry" the only path. ``packed0`` (C, m, node_limit, 8), the
    ProposalNoise fields with leading (C, m), ``leaves`` (C, N, m),
    ``subspaces`` (C, m, node_limit, D, 2). Returns the
    :class:`_ProposalBatch` fields but ``u_accept``."""
    c, m, node_limit, _ = packed0.shape
    n = X.shape[0]
    flat = packed0.reshape(c * m, node_limit, 8)
    flat_noise = ProposalNoise(*(t.reshape(c * m, *t.shape[2:]) for t in noise))
    new_subs = None
    if subspaces is None:
        new_packed, log_q_prior, move, node = propose_tree_packed(
            flat, bounds, feat_types, params, flat_noise
        )
    else:
        subs = subspaces.reshape(c * m, *subspaces.shape[2:])
        new_packed, new_subs, log_q_prior, move, node = propose_tree_packed(
            flat, bounds, feat_types, params, flat_noise, subspace_tree=subs
        )
        new_subs = new_subs.reshape(subspaces.shape)
    rows = torch.arange(c * m, device=X.device)
    nodes = node.long()
    cur_leavesT = leaves.transpose(1, 2).reshape(c * m, n)
    new_leavesT = _incremental_leaves(
        flat[rows, nodes], new_packed[rows, nodes], cur_leavesT, move, node, X,
        feat_types,
    )
    return (new_packed.reshape(c, m, node_limit, 8), cur_leavesT.reshape(c, m, n),
            new_leavesT.reshape(c, m, n), log_q_prior.reshape(c, m), move.reshape(c, m),
            node.reshape(c, m), new_subs)


def _propose_all_trees(state, X, feat_types, bounds, params, noise):
    """The hoisted proposal batch over all chains and trees.

    ``params.subspace_mode`` picks the walk or the carry, as the reference
    does; a state whose ``subspaces`` do not match the mode (None under
    "walk", a tensor under "carry") raises ValueError. On CUDA tensors the
    walk is one launch of the kernel K4 (``ops.propose``), which raises on
    what it does not take; the carry, and CPU tensors, take
    :func:`_propose_torch`."""
    carry_subs = params.subspace_mode == "carry"
    if carry_subs != (state.subspaces is not None):
        raise ValueError(
            f"subspace_mode={params.subspace_mode!r} needs a state "
            f"{'with' if carry_subs else 'without'} carried subspaces; build it "
            "with init_chain_state under the same params"
        )
    packed0 = pack_forest(state.forest)  # (C, m, node_limit, 8)
    if packed0.is_cuda and not carry_subs:
        fields = (*propose_batch_cuda(
            packed0, *(t.contiguous() for t in noise[:6]), bounds.contiguous(),
            feat_types.to(torch.int32).contiguous(), X.contiguous(), state.leaves,
            params.proposal_weights, params.alpha, params.beta, params.max_depth,
        ), None)
    else:
        fields = _propose_torch(packed0, noise, state.leaves, X, feat_types, bounds, params,
                                state.subspaces)
    new_packed, cur_leavesT, new_leavesT, log_q_prior, move, node, new_subs = fields
    return packed0, _ProposalBatch(
        new_packed=new_packed, cur_leavesT=cur_leavesT, new_leavesT=new_leavesT,
        log_q_prior=log_q_prior, move=move, node=node, u_accept=noise.u_accept,
        new_subs=new_subs,
    )


def _merge_accepted(packed0, state, batch, accepts):
    """Select the accepted per-tree state after the move scan: the forest,
    the leaves (C, N, m) and the carried subspaces (None under "walk")."""
    packed = torch.where(accepts[..., None, None], batch.new_packed, packed0)
    leavesT = torch.where(accepts[..., None], batch.new_leavesT, batch.cur_leavesT)
    subs = state.subspaces
    if subs is not None:
        subs = torch.where(accepts[..., None, None, None], batch.new_subs, subs)
    return unpack_forest(packed), leavesT.transpose(1, 2).contiguous(), subs


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
        return (lv == i).to(mask.dtype)

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


def _accept(log_q_prior, beta, new_mll, cur_mll, log_u, zero):
    """One MH accept per chain: ``(accept, log_alpha)``, only the MLL
    difference tempered by ``beta``."""
    log_alpha = log_q_prior + _tempered(beta, new_mll - cur_mll)
    return log_u <= torch.minimum(log_alpha, zero), log_alpha


def _scan_seed(quad, K_logdet, mll_corr):
    """A rank1 scan's starting MLL from its own quadratic and logdet, not
    ``state.mll``: every MH ratio then compares two values of one program
    (the reference measured a posterior bias when it seeded from the
    refresh's MLL)."""
    return 0.5 * (-quad - K_logdet + mll_corr)


def _rank2_terms(G, t, quad, K_logdet, mll_corr, eps=1e-6):
    """What every rank-2 move needs from G = W^T K^-1 W (C, 2, 2) and
    t = W^T K^-1 y (C, 2): ``(Minv, u = Minv t, quad', logdet', mll')``,
    the proposal's MLL -inf where round-off broke the update (denom2 <=
    eps), which rejects it."""
    Minv, detM, denom2 = _capacitance_inverse(G)
    K_logdet2 = K_logdet + torch.log(-detM)
    u = (Minv @ t[..., None])[..., 0]
    quad2 = quad - (t * u).sum(-1)
    new_mll = 0.5 * (-quad2 - K_logdet2 + mll_corr)
    new_mll = torch.where(denom2 > eps, new_mll, -torch.inf)
    return Minv, u, quad2, K_logdet2, new_mll


class _MoveBook:
    """The accepted per-chain quantities every rank1 move scan keeps, seeded
    from the scan's own quadratic and logdet (:func:`_scan_seed`): logdet
    K, y^T K^-1 y, the current MLL, and each move's accept and log alpha.
    A scan computes a move's G and t from its own carry, calls
    :meth:`move`, and updates that carry where the move was accepted."""

    def __init__(self, batch, beta, quad, K_logdet, mll_corr):
        self.log_q_prior, self.beta, self.mll_corr = batch.log_q_prior, beta, mll_corr
        self.quad, self.K_logdet = quad, K_logdet
        self.cur_mll = _scan_seed(quad, K_logdet, mll_corr)
        self.log_u = torch.log(batch.u_accept)
        self.zero = torch.zeros_like(self.cur_mll)
        self.accepts, self.log_alphas = [], []

    def move(self, j, G, t, veto=None):
        """Move j from G = W^T K^-1 W and t = W^T K^-1 y: ``(accept (C,),
        Minv, u)``, its proposal's MLL -inf where ``veto``."""
        Minv, u, quad2, K_logdet2, new_mll = _rank2_terms(
            G, t, self.quad, self.K_logdet, self.mll_corr
        )
        if veto is not None:
            new_mll = torch.where(veto, -torch.inf, new_mll)
        acc, log_alpha = _accept(self.log_q_prior[:, j], self.beta, new_mll, self.cur_mll,
                                 self.log_u[:, j], self.zero)
        self.K_logdet = torch.where(acc, K_logdet2, self.K_logdet)
        self.quad = torch.where(acc, quad2, self.quad)
        self.cur_mll = torch.where(acc, new_mll, self.cur_mll)
        self.accepts.append(acc)
        self.log_alphas.append(log_alpha)
        return acc, Minv, u


def _scan_scales(state, pad_count, params):
    """``(h, mll_corr)``: the patterns' scale sqrt(scale/2m) (C,) and the
    pads' log-det correction of the MLL (C,)."""
    h = torch.sqrt(state.scale / (2.0 * params.num_trees))
    return h, pad_count * torch.log(JITTER + state.noise)


def _scan_plain(state, batch, W_pat, y, mask, pad_count, params, beta):
    """``scan_style="plain"``: rank-2 Woodbury updates of the carried K^-1.

    Per move, with W the scaled update patterns: V = K^-1 W, the 2x2
    capacitance M, and K^-1, logdet K, K^-1 y and y^T K^-1 y updated in
    O(N^2). CUDA tensors take the kernel K3 (``ops.scan``: the whole scan
    of every chain in one launch, returning (C, m) tensors); CPU tensors
    its twin, :func:`_scan_plain_loop`.
    """
    if not W_pat.is_cuda:
        return _scan_plain_loop(state, batch, W_pat, y, mask, pad_count, params, beta)
    h, mll_corr = _scan_scales(state, pad_count, params)
    beta = beta.to(h.dtype).expand_as(h) if torch.is_tensor(beta) else torch.full_like(h, beta)
    args = (state.kern.K_inv, y, W_pat, h, state.kern.K_logdet, mll_corr, batch.log_q_prior,
            batch.u_accept, beta)
    return move_scan_cuda(*(t.contiguous() for t in args))  # SMC's beta is an expanded view


def _scan_plain_loop(state, batch, W_pat, y, mask, pad_count, params, beta):
    """The plain scan as a torch loop over the m moves, all chains in
    lockstep: K3's twin and oracle, and the path of CPU tensors. Returns
    one (C,) tensor of accepts and of log alphas a move."""
    h, mll_corr = _scan_scales(state, pad_count, params)
    W_all = h[:, None, None, None] * W_pat
    K_inv = state.kern.K_inv
    v_y = K_inv @ y  # (C, N)
    book = _MoveBook(batch, beta, v_y @ y, state.kern.K_logdet, mll_corr)
    for j in range(params.num_trees):
        W = W_all[:, j]  # (C, N, 2)
        Wt = W.transpose(-1, -2)
        V = K_inv @ W  # (C, N, 2)
        acc, Minv, u = book.move(j, Wt @ V, (Wt @ v_y[..., None])[..., 0])
        K_inv = torch.where(acc[:, None, None], K_inv - (V @ Minv) @ V.transpose(-1, -2), K_inv)
        v_y = torch.where(acc[:, None], v_y - (V @ u[..., None])[..., 0], v_y)
    return book.accepts, book.log_alphas


def _scan_aug(state, batch, W_pat, y, mask, pad_count, params, beta):
    """``scan_style="aug"``: the plain scan on the augmented carry
    A = [K^-1 | K^-1 y] (C, N, N+1). K^-1' y = K^-1 y - V Minv t, so one
    (N, 2) x (2, N+1) product updates both, and one select keeps them."""
    h, mll_corr = _scan_scales(state, pad_count, params)
    W_all = h[:, None, None, None] * W_pat
    K_inv = state.kern.K_inv
    v_y = K_inv @ y
    book = _MoveBook(batch, beta, v_y @ y, state.kern.K_logdet, mll_corr)
    A = torch.cat([K_inv, v_y[..., None]], -1)  # (C, N, N+1)
    for j in range(params.num_trees):
        W = W_all[:, j]
        Wt = W.transpose(-1, -2)
        V = A[..., :-1] @ W  # (C, N, 2)
        t = (Wt @ A[..., -1:])[..., 0]
        acc, Minv, _ = book.move(j, Wt @ V, t)  # G = W^T K^-1 W by symmetry
        VT_aug = torch.cat([V.transpose(-1, -2), t[..., None]], -1)  # (C, 2, N+1)
        A = torch.where(acc[:, None, None], A - (V @ Minv) @ VT_aug, A)
    return book.accepts, book.log_alphas


def _scan_lowrank(state, batch, W_pat, y, mask, pad_count, params, beta):
    """``scan_style="lowrank"``: K^-1 is never written in the loop.

    The refresh rebuilds K^-1 anyway, so a move needs only the current
    K^-1 times its own update pair. With the step's K0^-1 and the accepted
    corrections kept as factors, K^-1 = K0^-1 - P Q^T, move j's
    V = K0^-1 W_j - P (Q^T W_j), and an accept writes its two columns
    (P: V Minv, Q: V; unwritten columns are zero and inert). The base
    products K0^-1 W_j of all m moves are one batched product before the
    loop, so no move reads an (N, N) operand.
    """
    c, m = state.noise.shape[0], params.num_trees
    n = y.shape[0]
    h, mll_corr = _scan_scales(state, pad_count, params)
    W_all = h[:, None, None, None] * W_pat  # (C, m, N, 2)
    K0_inv = state.kern.K_inv
    W_flat = W_all.permute(0, 2, 1, 3).reshape(c, n, 2 * m)
    V0_all = (K0_inv @ W_flat).reshape(c, n, m, 2)  # [:, :, j] = K0^-1 W_j
    P = torch.zeros_like(W_flat)
    Q = torch.zeros_like(W_flat)
    v_y = K0_inv @ y
    book = _MoveBook(batch, beta, v_y @ y, state.kern.K_logdet, mll_corr)
    for j in range(m):
        W = W_all[:, j]
        Wt = W.transpose(-1, -2)
        V = V0_all[:, :, j] - P @ (Q.transpose(-1, -2) @ W)  # (C, N, 2)
        acc, Minv, u = book.move(j, Wt @ V, (Wt @ v_y[..., None])[..., 0])
        keep = acc[:, None, None]
        P[..., 2 * j : 2 * j + 2] = torch.where(keep, V @ Minv, 0.0)
        Q[..., 2 * j : 2 * j + 2] = torch.where(keep, V, 0.0)
        v_y = torch.where(acc[:, None], v_y - (V @ u[..., None])[..., 0], v_y)
    return book.accepts, book.log_alphas


def _hoist_leaf(state, Wp, h, y, mask, params):
    """The coeff scan's hoist from the leaf tier's factor L of
    A = (nu/gamma) I + Z^T Z (K0 = gamma Z Z^T + nu I).

    Hm = (h^2 W_p^T W_p - Sw^T Sw) / nu with Sw = L^-1 (h Z^T W_p), h =
    sqrt(scale/2m) and W_p the 0/±1 patterns, symmetrised (its B - 1 ~ 1e-2
    cancellation is why every product here runs at full float32); t0 and
    the seed's quadratic in residual form (see :func:`_leaf_factor_mll`).
    Returns (Hm, t0, quad, leaf totals, budget R).
    """
    n = y.shape[0]
    budget = _leaf_budget(params, n)
    nu = JITTER + state.noise
    L_A = state.kern.L
    Z, total = _leaf_Z(state.forest, state.leaves, budget, mask)
    Zt = Z.transpose(1, 2)
    CW = Zt @ Wp  # (C, R, 2m) integer counts
    WtW = Wp.transpose(1, 2) @ Wp  # (C, 2m, 2m) integers
    Sw = torch.linalg.solve_triangular(L_A, h[:, None, None] * CW, upper=False)
    w_y = torch.cholesky_solve((Zt @ y)[..., None], L_A)  # (C, R, 1)
    resid_y = y - (Z @ w_y)[..., 0]  # (C, N)
    Hm = ((h * h)[:, None, None] * WtW - Sw.transpose(1, 2) @ Sw) / nu[:, None, None]
    Hm = 0.5 * (Hm + Hm.transpose(1, 2))
    t0 = (h[:, None] * (Wp.transpose(1, 2) @ resid_y[..., None])[..., 0]) / nu[:, None]
    quad = (resid_y @ y) / nu  # (C,)
    return Hm, t0, quad, total, budget


def _hoist_factor(state, W_flat, y):
    """The coeff scan's hoist from the ``factor`` carry, L of K0 (never
    K0^-1): everything the scan needs is a symmetric product through
    K0^-1 = L^-T L^-1, so one lower solve with 2m + 1 right-hand sides,
    [W | y], gives Hm = Zw^T Zw, t0 = Zw^T zy and the quadratic zy^T zy.
    No N-right-hand-side solve anywhere in the step."""
    c, n, _ = W_flat.shape
    rhs = torch.cat([W_flat, y.expand(c, n)[..., None]], -1)  # (C, N, 2m+1)
    Zs = torch.linalg.solve_triangular(state.kern.L, rhs, upper=False)
    Zw, zy = Zs[..., :-1], Zs[..., -1]
    Hm = Zw.transpose(1, 2) @ Zw
    t0 = (Zw.transpose(1, 2) @ zy[..., None])[..., 0]
    return Hm, t0, (zy * zy).sum(-1)


def _hoist_dense(state, W_flat, y):
    """The coeff scan's hoist from a carried K0^-1 (the dense refreshes):
    KW = K0^-1 W, Hm = W^T KW, t0 = W^T K0^-1 y, and the quadratic."""
    K0_inv = state.kern.K_inv
    v_y = K0_inv @ y
    Wt = W_flat.transpose(1, 2)
    Hm = Wt @ (K0_inv @ W_flat)
    t0 = (Wt @ v_y[..., None])[..., 0]
    return Hm, t0, v_y @ y


def _scan_coeff(state, batch, W_pat, y, mask, pad_count, params, beta):
    """``scan_style="coeff"``: the Woodbury algebra of the plain scan in
    the span of V0 = K0^-1 W (W = all 2m update vectors, columns [add_0,
    sub_0, add_1, ...]).

    With Hm = W^T K0^-1 W (2m, 2m), K^-1 = K0^-1 - V0 S V0^T and K^-1 y =
    K0^-1 y - V0 d, move j needs c = E_j - S Tv (Tv = Hm's two columns of
    the move, E_j the matching identity columns), G = Tv^T c and t = t0_j -
    Tv^T d, and an accept adds c Minv c^T to S and c u to d. The loop
    touches only (2m, 2m) tensors; N appears in the hoist, which reads K0
    through the carry of the refresh: the leaf-space factor
    (:func:`_hoist_leaf`), the factor of K (:func:`_hoist_factor`) or
    K^-1 (:func:`_hoist_dense`).

    In the leaf tier a capacity guard carries each chain's leaf total: a
    grow adds one leaf, a prune removes one, and a move that would take the
    total past the budget R gets MLL -inf, so the leaf packing of the
    refresh stays exact. The other hoists have no budget and no guard.
    """
    c_, m = state.noise.shape[0], params.num_trees
    m2 = 2 * m
    n = y.shape[0]
    h, mll_corr = _scan_scales(state, pad_count, params)
    Wp = W_pat.permute(0, 2, 1, 3).reshape(c_, n, m2)  # (C, N, 2m) patterns
    guard = params.refresh_style == "leaf"
    if guard:
        Hm, t0, quad, total, budget = _hoist_leaf(state, Wp, h, y, mask, params)
        delta = (batch.move == GROW).to(torch.int32) - (batch.move == PRUNE).to(torch.int32)
    elif params.refresh_style == "factor":
        Hm, t0, quad = _hoist_factor(state, h[:, None, None] * Wp, y)
    else:
        Hm, t0, quad = _hoist_dense(state, h[:, None, None] * Wp, y)

    book = _MoveBook(batch, beta, quad, state.kern.K_logdet, mll_corr)
    S = torch.zeros((c_, m2, m2), dtype=Hm.dtype, device=Hm.device)
    d = torch.zeros((c_, m2), dtype=Hm.dtype, device=Hm.device)
    E_all = torch.eye(m2, dtype=Hm.dtype, device=Hm.device).reshape(m2, m, 2)
    for j in range(m):
        Tv = Hm[:, :, 2 * j : 2 * j + 2]  # (C, 2m, 2)
        Tvt = Tv.transpose(1, 2)
        c = E_all[:, j] - S @ Tv  # (C, 2m, 2)
        t = t0[:, 2 * j : 2 * j + 2] - (Tvt @ d[..., None])[..., 0]  # (C, 2)
        veto = total + delta[:, j] > budget if guard else None
        acc, Minv, u = book.move(j, Tvt @ c, t, veto)
        S = torch.where(acc[:, None, None], S + (c @ Minv) @ c.transpose(1, 2), S)
        d = torch.where(acc[:, None], d + (c @ u[..., None])[..., 0], d)
        if guard:
            total = total + torch.where(acc, delta[:, j], 0)
    return book.accepts, book.log_alphas


_SCANS = {"plain": _scan_plain, "aug": _scan_aug, "lowrank": _scan_lowrank,
          "coeff": _scan_coeff}


def _tree_moves_rank1(state, packed0, batch, y, mask, pad_count, params, beta=1.0):
    """m tree moves of the rank1 backend on the step's proposal batch
    (``packed0``, ``batch`` from :func:`_propose_all_trees`): the update
    patterns, then the move scan of ``params.scan_style`` (see
    :data:`_SCANS`). Every move's kernel delta is exactly rank 2 (see
    :func:`_update_patterns`); the refresh rebuilds the carry exactly, so
    the scan's own carry is dropped.

    Returns (forest, leaves, subspaces, accepts (C, m), log_alpha (C, m)).
    """
    W_pat = _update_patterns(packed0, batch, mask)
    scan = _SCANS[params.scan_style]
    accepts, log_alphas = scan(state, batch, W_pat, y.reshape(-1), mask, pad_count, params, beta)
    if isinstance(accepts, list):  # the torch loops: one (C,) tensor a move
        accepts, log_alphas = torch.stack(accepts, 1), torch.stack(log_alphas, 1)
    forest, leaves, subs = _merge_accepted(packed0, state, batch, accepts)
    return forest, leaves, subs, accepts, log_alphas


def _tree_moves_chol(state, packed0, batch, y, mask, pad_count, params, beta=1.0):
    """m tree moves on the exact kernel matrix, one factorization a move.

    Move j adds its exact delta ``(scale/m) (A_new - A_cur)``, the
    difference of tree j's masked 0/1 agreement under the proposed and the
    current leaves, to the carried K and factors ``K + delta`` for all
    chains at once through K2 (``blocked_cholesky``: one launch at N <= 256,
    host-blocked above); the MLL comes from the factor (:func:`_chol_mll`,
    with the padding correction). A failed factorization gives a NaN MLL,
    and the move rejects. Nothing drifts: no inverse is carried, so the
    scan's seed is the state's own MLL, as in the reference.

    Returns (forest, leaves, subspaces, accepts (C, m), log_alpha (C, m),
    K, mll).
    """
    s_over_m = (state.scale / params.num_trees)[:, None, None]
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
        acc, log_alpha = _accept(batch.log_q_prior[:, j], beta, new_mll, cur_mll, log_u[:, j],
                                 zero)
        K = torch.where(acc[:, None, None], K_new, K)
        cur_mll = torch.where(acc, new_mll, cur_mll)
        accepts.append(acc)
        log_alphas.append(log_alpha)

    accepts = torch.stack(accepts, 1)
    forest, leaves, subs = _merge_accepted(packed0, state, batch, accepts)
    return forest, leaves, subs, accepts, torch.stack(log_alphas, 1), K, cur_mll


def _woodbury_update(K_inv, K_logdet, U, eye, subtract):
    """``(K +- U U^T)^-1`` and its logdet from K^-1 (C, N, N) and U (C, N, L).

    Both through one Cholesky of the capacitance M = I -+ U^T K^-1 U (SPD
    either way while the update keeps K positive definite), factored by K2
    (:func:`~bark_tpu_torch.ops.chol.chol_inv`), which also returns Lm^-1:
    with W = Lm^-1 (K^-1 U)^T the correction is W^T W, and logdet K' =
    logdet K + logdet M. A failed factorization gives NaN, and the move
    rejects.
    """
    KU = K_inv @ U
    UKU = U.transpose(-1, -2) @ KU
    M = eye - UKU if subtract else eye + UKU
    Lm, Em = chol_inv(M)
    logdet_M = 2.0 * torch.log(torch.diagonal(Lm, dim1=-2, dim2=-1)).sum(-1)
    W = Em @ KU.transpose(-1, -2)  # (C, L, N)
    correction = W.transpose(-1, -2) @ W
    K_inv_new = K_inv + correction if subtract else K_inv - correction
    return K_inv_new, K_logdet + logdet_M


def _tree_moves_woodbury(state, packed0, batch, y, mask, pad_count, params, beta=1.0):
    """m tree moves of the woodbury backend, the original BARK algorithm.

    The kernel of tree j is (scale/m) U U^T with U the one-hot of each
    row's leaf among the tree's active leaves, ranked in node order
    (``node_limit // 2`` columns, enough for any tree; padded rows zero). A
    move takes the current tree's U out and the proposed tree's in, two
    rank-L updates of K^-1 and logdet K (:func:`_woodbury_update`), and the
    MLL from the new K^-1 (``masked_mll``). The scan starts from
    ``state.mll``, as in the reference. The indicators of all m moves are
    built before the loop (they depend only on the proposal batch).

    Returns (forest, leaves, subspaces, accepts (C, m), log_alpha (C, m),
    K^-1, logdet K, mll).
    """
    num_cols = params.node_limit // 2
    dtype = mask.dtype
    cols = torch.arange(num_cols, device=mask.device)
    row_scale = torch.sqrt(state.scale / params.num_trees)[:, None] * mask  # (C, N)

    def indicators(packed, leavesT):
        """(C, m, N, L): row i of tree j lights its leaf's rank."""
        is_leaf = (packed[..., 0] & packed[..., 7]) == 1  # (C, m, node_limit)
        ranks = torch.cumsum(is_leaf, -1) - 1
        r = torch.gather(ranks, 2, leavesT.long())  # (C, m, N)
        return (r[..., None] == cols).to(dtype) * row_scale[:, None, :, None]

    U_cur = indicators(packed0, batch.cur_leavesT)
    U_new = indicators(batch.new_packed, batch.new_leavesT)
    eye = torch.eye(num_cols, dtype=dtype, device=mask.device)
    y_flat = y.reshape(-1)
    K_inv, K_logdet, cur_mll = state.kern.K_inv, state.kern.K_logdet, state.mll
    log_u = torch.log(batch.u_accept)
    zero = torch.zeros_like(cur_mll)

    accepts, log_alphas = [], []
    for j in range(params.num_trees):
        K_inv1, K_logdet1 = _woodbury_update(K_inv, K_logdet, U_cur[:, j], eye, True)
        K_inv2, K_logdet2 = _woodbury_update(K_inv1, K_logdet1, U_new[:, j], eye, False)
        new_mll = masked_mll(K_inv2, K_logdet2, y_flat, state.noise, pad_count)
        acc, log_alpha = _accept(batch.log_q_prior[:, j], beta, new_mll, cur_mll, log_u[:, j],
                                 zero)
        K_inv = torch.where(acc[:, None, None], K_inv2, K_inv)
        K_logdet = torch.where(acc, K_logdet2, K_logdet)
        cur_mll = torch.where(acc, new_mll, cur_mll)
        accepts.append(acc)
        log_alphas.append(log_alpha)

    accepts = torch.stack(accepts, 1)
    forest, leaves, subs = _merge_accepted(packed0, state, batch, accepts)
    return (forest, leaves, subs, accepts, torch.stack(log_alphas, 1), K_inv, K_logdet,
            cur_mll)


def _pick(accept, pair):
    """Branch 1 of ``pair`` (C, 2, ...) where ``accept`` (C,), else branch 0."""
    sel = accept.reshape(-1, *([1] * (pair.dim() - 2)))
    return torch.where(sel, pair[:, 1], pair[:, 0])


def _refresh(forest, leaves, state, new_noise, new_scale, X, y_flat, mask, pad_count,
             params) -> tuple[torch.Tensor, torch.Tensor, Callable[[torch.Tensor], KernState]]:
    """The rank1 backend's exact refresh: both MH branches of the noise move
    (current and proposed noise/scale) from the post-scan leaves, by
    ``params.refresh_style``. Returns (cur_mll, new_mll, kern_of), where
    ``kern_of(accept)`` gives the carry of the selected branches.

      - ``leaf``: Z of the new leaves, G = Z^T Z shared by both branches,
        both A_b factored in one K2 call; no (N, N) object. An over-budget
        packing (unreachable from a valid init, the scan's guard rejects
        grows at capacity) keeps the NaN poison.
      - ``onesolve``/``factor``: the Gram of the new leaves (K1), both
        kernel matrices factored at once, both MLLs from the factors (z =
        L^-1 y); onesolve carries K^-1 = E^T E of the selected branch's
        inverse factor E, factor the selected branch's L.
      - ``batched``: both branches' inverse and logdet in one call, the
        MLLs from the inverses.
      - ``pair``: the same in two calls, one per branch.
    """
    noise2 = torch.stack([state.noise, new_noise], 1)  # (C, 2)
    scale2 = torch.stack([state.scale, new_scale], 1)
    style = params.refresh_style
    if style == "leaf":
        budget = _leaf_budget(params, X.shape[0])
        Z, total = _leaf_Z(forest, leaves, budget, mask)
        L2, logdet2, mll2 = _leaf_factor_mll(
            Z, Z.transpose(1, 2) @ Z, y_flat, JITTER + noise2,
            scale2 / params.num_trees, pad_count,
        )
        mll2 = torch.where((total <= budget)[:, None], mll2, torch.nan)
        return mll2[:, 0], mll2[:, 1], lambda acc: KernState(
            K_inv=None, K_logdet=_pick(acc, logdet2), L=_pick(acc, L2))
    gram = _gram(leaves, mask, params)
    if style in ("onesolve", "factor"):
        K2 = kernel_matrix(gram[:, None], noise2, scale2)  # (C, 2, N, N)
        L2, E2 = blocked_cholesky(K2)
        mll2, logdet2 = _chol_mll(L2, y_flat, noise2, pad_count)
        if style == "factor":
            kern_of = lambda acc: KernState(  # noqa: E731
                K_inv=None, K_logdet=_pick(acc, logdet2), L=_pick(acc, L2))
        else:
            def kern_of(acc):
                E_sel = _pick(acc, E2)
                return KernState(K_inv=E_sel.transpose(-1, -2) @ E_sel,
                                 K_logdet=_pick(acc, logdet2))
        return mll2[:, 0], mll2[:, 1], kern_of
    if style == "batched":
        inv2, logdet2 = chol_inv_logdet(kernel_matrix(gram[:, None], noise2, scale2))
    else:  # "pair"
        cur = chol_inv_logdet(kernel_matrix(gram, state.noise, state.scale))
        new = chol_inv_logdet(kernel_matrix(gram, new_noise, new_scale))
        inv2 = torch.stack([cur[0], new[0]], 1)
        logdet2 = torch.stack([cur[1], new[1]], 1)
    mll2 = masked_mll(inv2, logdet2, y_flat, noise2, pad_count)
    return mll2[:, 0], mll2[:, 1], lambda acc: KernState(
        K_inv=_pick(acc, inv2), K_logdet=_pick(acc, logdet2))


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
    tempering, SMC): a float, or a (C,) tensor with one per chain row. It
    multiplies the MLL difference of every MH ratio, the tree moves' and the
    noise move's; the proposal ratios stay untempered, and beta = 1 is the
    plain step. (It is not ``params.beta``, the tree prior's depth
    exponent.)

    The noise move: rank1 refreshes both branches exactly (:func:`_refresh`);
    chol rescales the carried K exactly, ``(new_scale/scale) (K - (jitter +
    noise) I) + (jitter + new_noise) I``, with one more factorization;
    woodbury rebuilds K at the proposed noise and scale from the Gram (K1)
    and factors it (K2), and keeps the scan's K^-1 if the move rejects.

    Returns the new state and the step's accept decisions; the log ratios in
    :class:`StepInfo` are the tempered ones.
    """
    params = _resolve_styles(params, X.shape[0])
    check_matmul_precision()
    mask = _default_mask(X, mask, y.dtype)
    pad_count = X.shape[0] - mask.sum()
    y_flat = y.reshape(-1)

    (new_noise, new_scale), log_q_hyper = get_noise_scale_proposal(
        draws.z_noise, draws.z_scale, state.noise, state.scale, params
    )
    backend = params.kernel_backend
    moves = {"chol": _tree_moves_chol, "woodbury": _tree_moves_woodbury}.get(
        backend, _tree_moves_rank1)
    with annotate("bark.step.propose"):
        packed0, batch = _propose_all_trees(state, X, feat_types, bounds, params, draws.proposal)
    with annotate("bark.step.scan"):
        forest, leaves, subs, accepts, tree_log_alpha, *carry = moves(
            state, packed0, batch, y, mask, pad_count, params, beta)
    with annotate("bark.step.refresh"):
        if backend == "chol":
            K, cur_mll = carry
            # the noise move rescales the exact K elementwise: no Gram rebuild,
            # one more factorization
            eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
            gram_part = K - (JITTER + state.noise)[:, None, None] * eye
            K_hyp = (new_scale / state.scale)[:, None, None] * gram_part + (
                JITTER + new_noise
            )[:, None, None] * eye
            new_mll, _ = _chol_mll(blocked_cholesky(K_hyp)[0], y_flat, new_noise, pad_count)
            kern_of = lambda acc: KernState(  # noqa: E731
                K_inv=None, K_logdet=None, K=torch.where(acc[:, None, None], K_hyp, K))
        elif backend == "woodbury":
            K_inv, K_logdet, cur_mll = carry
            new_inv, new_logdet = chol_inv_logdet(
                kernel_matrix(_gram(leaves, mask, params), new_noise, new_scale))
            new_mll = masked_mll(new_inv, new_logdet, y_flat, new_noise, pad_count)
            kern_of = lambda acc: KernState(  # noqa: E731
                K_inv=torch.where(acc[:, None, None], new_inv, K_inv),
                K_logdet=torch.where(acc, new_logdet, K_logdet))
        else:
            cur_mll, new_mll, kern_of = _refresh(
                forest, leaves, state, new_noise, new_scale, X, y_flat, mask, pad_count, params,
            )

        log_alpha = log_q_hyper + _tempered(beta, new_mll - cur_mll)
        accept = torch.log(draws.u_hyper) <= torch.minimum(
            log_alpha, torch.zeros_like(log_alpha)
        )
        new_state = ChainState(
            forest=forest,
            leaves=leaves,
            noise=torch.where(accept, new_noise, state.noise),
            scale=torch.where(accept, new_scale, state.scale),
            kern=kern_of(accept),
            mll=torch.where(accept, new_mll, cur_mll),
            subspaces=subs,
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
        with annotate("bark.step"):
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
