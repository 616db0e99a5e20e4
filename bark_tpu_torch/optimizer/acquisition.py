"""Acquisition function over the sampled BARK posterior.

Counterpart of ``bark_tpu/optimizer/acquisition.py``: minimize over x the
sample-average lower confidence bound

    (1/S) * sum_s [ mu_s(x) - kappa * sigma_s(x) ]

where, per posterior sample s (with the null-tree-free agreement kernel),

    mu_s(x)     = scale_s * k_s(x)^T K_s^-1 y
    sigma_s^2(x) = scale_s - scale_s^2 * k_s(x)^T K_s^-1 k_s(x)

``k_s(x)`` is the agreement vector between x and the training points and
K_s = scale_s * gram + (jitter + noise_s) I. It is evaluated exactly, in
batch, for thousands of candidates at once. Three states:

  - dense (:func:`build_acquisition`): the (S, N, N) kernels through K1 and
    K2, every candidate batch one more K1 call (S, B, N);
  - factored (:func:`build_acquisition_lr`): everything in the r-dimensional
    leaf space, so scoring does not depend on N;
  - Thompson (:func:`build_acquisition_ts`): one exact posterior function
    draw as leaf weights.

The reference ``vmap``-s one posterior sample; here every tensor carries the
leading dimension S = chains x samples. The Thompson build's randomness
(which sample, the normal vector) comes in as arguments
(:func:`draw_acquisition_ts`), so the same draws give the same state in both
packages.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bark_tpu_torch.fitting.sampler import BARKModel
from bark_tpu_torch.forest import (
    Forest,
    compact_leaf_indicator,
    flatten_batch,
    gram_from_leaves,
    num_null_trees,
    route_forest,
)
from bark_tpu_torch.ops.linalg import (
    JITTER,
    blocked_cholesky,
    check_matmul_precision,
    robust_chol_inv_logdet,
    robust_cholesky,
)

DEFAULT_KAPPA = 1.96

#: padded training-set size past which the strategy's ``acq_backend="auto"``
#: switches from the dense (S, N, N) build to the factored one: the same
#: wall as the surrogate's ``cg_threshold``.
LR_THRESHOLD = 2048

#: rows per block over which the factored build accumulates (Z^T Z, Z^T y):
#: bounds its peak memory to one block's (S, ROW_BLOCK, r) indicators
ROW_BLOCK = 4096


class AcquisitionState(NamedTuple):
    """Per-sample quantities computed once and reused across candidate
    batches."""

    forest: Forest  # (S, m, node_limit)
    noise: torch.Tensor  # (S,)
    scale: torch.Tensor  # (S,)
    train_leaves: torch.Tensor  # (S, N, m)
    K_inv: torch.Tensor  # (S, N, N)
    K_inv_y: torch.Tensor  # (S, N)
    n_null: torch.Tensor  # (S,)
    train_mask: torch.Tensor  # (N,)


def _flat_model(model: BARKModel):
    forest = flatten_batch(model.forest)
    noise = model.noise.reshape(-1).to(torch.float32)
    scale = model.scale.reshape(-1).to(torch.float32)
    return forest, noise, scale


def build_acquisition(
    model: BARKModel,
    train_x: torch.Tensor,
    train_y: torch.Tensor,
    feat_types: torch.Tensor,
    max_depth: int = 16,
    train_mask: torch.Tensor | None = None,
) -> AcquisitionState:
    """Flatten the posterior samples and factor their kernels once.

    One K1 call (S, N, N) on the symmetric path and one K2 call (more only
    when a sample's kernel needs a jitter escalation). The Gram is rescaled
    to leave out the null (single-leaf) trees, masked rows kept at zero.
    """
    check_matmul_precision()
    forest, noise, scale = _flat_model(model)
    m, node_limit = forest.num_trees, forest.node_limit
    n = train_x.shape[0]
    if train_mask is None:
        train_mask = torch.ones((n,), dtype=torch.float32, device=train_x.device)
    y = train_y.reshape(-1)
    n_null = num_null_trees(forest).to(torch.float32)

    leaves = route_forest(forest, train_x, feat_types, max_depth)
    gram = gram_from_leaves(leaves, leaves, train_mask, train_mask, node_limit)
    denom = torch.clamp_min(m - n_null, 1.0)
    outer = train_mask[:, None] * train_mask[None, :]
    gram = (gram - (n_null / m)[:, None, None] * outer) * (m / denom)[:, None, None]
    eye = torch.eye(n, dtype=gram.dtype, device=gram.device)
    K = scale[:, None, None] * gram + (JITTER + noise)[:, None, None] * eye
    K_inv, _ = robust_chol_inv_logdet(K)
    return AcquisitionState(
        forest=forest,
        noise=noise,
        scale=scale,
        train_leaves=leaves,
        K_inv=K_inv,
        K_inv_y=K_inv @ y,
        n_null=n_null,
        train_mask=train_mask,
    )


def _evaluate_acquisition_dense(
    acq: AcquisitionState,
    candidates: torch.Tensor,
    feat_types: torch.Tensor,
    max_depth: int = 16,
    kappa: float = DEFAULT_KAPPA,
) -> torch.Tensor:
    """Sample-average LCB for a ``(B, D)`` candidate batch; lower is better.

    One K1 call (S, B, N) with the column mask only.
    """
    m, node_limit = acq.forest.num_trees, acq.forest.node_limit
    cand_leaves = route_forest(acq.forest, candidates, feat_types, max_depth)
    k_vec = gram_from_leaves(cand_leaves, acq.train_leaves, None, acq.train_mask, node_limit)
    denom = torch.clamp_min(m - acq.n_null, 1.0)
    k_vec = (k_vec - (acq.n_null / m)[:, None, None] * acq.train_mask) * (
        m / denom
    )[:, None, None]
    scale = acq.scale[:, None]
    mu = scale * (k_vec @ acq.K_inv_y[..., None])[..., 0]
    quad = ((k_vec @ acq.K_inv) * k_vec).sum(-1)
    var = torch.clamp_min(scale - scale**2 * quad, 1e-12)
    return (mu - kappa * torch.sqrt(var)).mean(0)


# --- factored acquisition: the large-N path --------------------------------
#
# The agreement kernel factorizes: with Z the (N, r) leaf-indicator matrix
# (one column per (tree, leaf) pair, entry sigma_z = 1/sqrt(m - n_null) for
# non-null trees, null-tree columns zero, which is exactly the no-null
# rescaling), the no-null Gram is Z Z^T and
#
#     K = nu I + s Z Z^T,   nu = jitter + noise,  s = scale.
#
# Woodbury with M = I_r + (s/nu) Z^T Z collapses every acquisition term into
# r-space:
#
#     Z^T K^-1 y = (1/nu) M^-1 Z^T y           (the posterior-mean weights)
#     Z^T K^-1 Z = (1/s) (I - M^-1)            (since (s/nu) Z^T Z = M - I)
#
# and because every candidate's indicator z has ||z||^2 = 1 (one leaf per
# non-null tree), the variance telescopes to a sum of squares:
#
#     var(x) = s (1 - ||z||^2 + z^T M^-1 z) = s ||Lm^-1 z||^2,  Lm = chol(M).
#
# Scoring a candidate batch is one (B, r) x (r, r) product per sample,
# independent of N. N appears only in the build (G = Z^T Z and one (r, r)
# factorization), so ask() scales past the dense (S, N, N) memory wall.
# r = m * max_leaves with leaves compacted to dense ranks
# (max_leaves = (node_limit + 1) // 2).


class AcquisitionStateLR(NamedTuple):
    """Factored acquisition state: all that scoring needs, nothing O(N)."""

    forest: Forest  # (S, m, node_limit): candidate routing and leaf boxes
    beta: torch.Tensor  # (S, r): mu(x) = h(x) @ beta (scale, sigma_z folded in)
    V: torch.Tensor  # (S, r, r): var(x) = scale * ||V @ h(x)||^2 + var0
    scale: torch.Tensor  # (S,)
    var0: torch.Tensor  # (S,) residual variance when every tree is null


def _compact_indicator_nonull(
    forest: Forest, leaves: torch.Tensor, max_leaves: int
) -> torch.Tensor:
    """(S, B, r) compact 0/1 leaf indicators with null-tree blocks zeroed,
    matching the no-null Gram rescaling."""
    z = compact_leaf_indicator(forest, leaves, max_leaves)
    nonnull = ~forest.is_leaf[..., 0]  # (S, m)
    mask = torch.repeat_interleave(nonnull, max_leaves, dim=-1)
    return z * mask[..., None, :].to(z.dtype)


def _robust_cholesky_psd_plus_eye(M: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(L, L^-1)`` of ``M = I + PSD`` with diagonal escalation per matrix.

    Always PD in exact arithmetic; float32 round-off at condition numbers
    near 1/eps can still fail the factorization, and then a slightly damped
    M (+1e-4 I, then +1e-2 I) is factored instead, equivalent to a hair more
    noise. Through K2 (``blocked_cholesky``), so the inverse factor comes
    with it.
    """
    return robust_cholesky(M, (1e-4, 1e-2))


def build_acquisition_lr(
    model: BARKModel,
    train_x: torch.Tensor,
    train_y: torch.Tensor,
    feat_types: torch.Tensor,
    max_depth: int = 16,
    train_mask: torch.Tensor | None = None,
) -> AcquisitionStateLR:
    """Build the factored acquisition state; nothing N x N is formed.

    Equal (up to float32 factorization round-off) to the dense build's
    scores, with N-independent scoring. The sufficient statistics
    ``(G, u) = (Z^T Z, Z^T y)`` are accumulated over blocks of ``ROW_BLOCK``
    rows (the reference's ``row_block`` at its automatic value), so peak
    build memory is one block's indicators plus the (S, r, r) matrices.
    """
    check_matmul_precision()
    forest, noise, scale = _flat_model(model)
    m, node_limit = forest.num_trees, forest.node_limit
    max_leaves = (node_limit + 1) // 2
    r = m * max_leaves
    n = train_x.shape[0]
    if train_mask is None:
        train_mask = torch.ones((n,), dtype=torch.float32, device=train_x.device)
    y = train_y.reshape(-1).to(torch.float32)
    n_null = num_null_trees(forest).to(torch.float32)

    s = noise.shape[0]
    G = torch.zeros((s, r, r), dtype=torch.float32, device=train_x.device)
    u = torch.zeros((s, r), dtype=torch.float32, device=train_x.device)
    for lo in range(0, n, ROW_BLOCK):
        rows = slice(lo, lo + ROW_BLOCK)
        mb = train_mask[rows]
        leaves = route_forest(forest, train_x[rows], feat_types, max_depth)
        Z01 = _compact_indicator_nonull(forest, leaves, max_leaves) * mb[:, None]
        Zt = Z01.transpose(1, 2)
        G += Zt @ Z01  # exact counts
        u += Zt @ (y[rows] * mb)

    nn = torch.clamp_min(m - n_null, 1.0)
    sigma2 = 1.0 / nn  # sigma_z^2
    nu = JITTER + noise
    eye = torch.eye(r, dtype=torch.float32, device=G.device)
    M = eye + ((scale / nu) * sigma2)[:, None, None] * G
    # M >= I, so the factorization cannot meet a non-PD pivot; escalation
    # guards only float32 round-off at extreme scale/nu ratios
    _, V = _robust_cholesky_psd_plus_eye(M)  # V = Lm^-1
    live = torch.where(n_null >= m, 0.0, 1.0)
    sigma_z = torch.sqrt(sigma2) * live
    t = V @ (sigma_z[:, None] * u)[..., None]
    beta_raw = (V.transpose(1, 2) @ t)[..., 0] / nu[:, None]  # (1/nu) M^-1 Zs^T y

    # fold scale and sigma_z, so scoring is plain indicator contractions
    return AcquisitionStateLR(
        forest=forest,
        beta=(scale * sigma_z)[:, None] * beta_raw,
        V=sigma_z[:, None, None] * V,
        scale=scale,
        var0=scale * (1.0 - live),
    )


def _evaluate_acquisition_lr(
    acq: AcquisitionStateLR,
    candidates: torch.Tensor,
    feat_types: torch.Tensor,
    max_depth: int = 16,
    kappa: float = DEFAULT_KAPPA,
) -> torch.Tensor:
    """Sample-average LCB from the factored state; N never appears."""
    max_leaves = (acq.forest.node_limit + 1) // 2
    leaves = route_forest(acq.forest, candidates, feat_types, max_depth)
    h = _compact_indicator_nonull(acq.forest, leaves, max_leaves)  # (S, B, r)
    mu = (h @ acq.beta[..., None])[..., 0]
    proj = h @ acq.V.transpose(1, 2)  # (S, B, r): rows (Lm^-1 z)^T
    var = acq.scale[:, None] * (proj * proj).sum(-1) + acq.var0[:, None]
    var = torch.clamp_min(var, 1e-12)
    return (mu - kappa * torch.sqrt(var)).mean(0)


# --- Thompson-sampling acquisition ------------------------------------------


class AcquisitionStateTS(NamedTuple):
    """Thompson-sampling acquisition: one exact posterior function draw.

    The agreement GP is Bayesian linear regression over compact leaf
    indicators, so a Thompson draw is one leaf-weight vector
    theta ~ p(theta | y) for one uniformly chosen posterior (forest, noise,
    scale) sample, and score(x) = z_x^T theta: an exact full-joint draw,
    O(r) per candidate, N never appears at scoring time.
    """

    forest: Forest  # (1, m, node_limit): the chosen posterior forest
    theta: torch.Tensor  # (r,) leaf weights of the draw


def draw_acquisition_ts(
    generator: torch.Generator, num_samples: int, r: int, device=None
) -> tuple[int, torch.Tensor]:
    """The Thompson build's randomness: which of the ``num_samples``
    posterior samples, and the (r,) standard normal vector."""
    dev = generator.device
    pick = int(torch.randint(num_samples, (), generator=generator, device=dev))
    eps = torch.randn(r, generator=generator, device=dev)
    return pick, eps if device is None else eps.to(device)


def build_acquisition_ts(
    pick: int,
    eps: torch.Tensor,
    model: BARKModel,
    train_x: torch.Tensor,
    train_y: torch.Tensor,
    feat_types: torch.Tensor,
    max_depth: int = 16,
    train_mask: torch.Tensor | None = None,
) -> AcquisitionStateTS:
    """One exact posterior function draw as an acquisition state.

    theta | y ~ N(A^-1 Z^T y, nu A^-1) with A = (nu/gamma) I + Z^T Z (the
    closed form :func:`forest_predict_leaf` uses), for posterior sample
    ``pick`` and normal vector ``eps`` (:func:`draw_acquisition_ts`). With
    E = L_A^-1 from K2: theta = E^T (E Z^T y) + sqrt(nu) E^T eps.
    """
    check_matmul_precision()
    forest, noise, scale = _flat_model(model)
    m = forest.num_trees
    max_leaves = (forest.node_limit + 1) // 2
    y = train_y.reshape(-1).to(torch.float32)
    if train_mask is not None:
        y = y * train_mask
    chosen = Forest(*(t[pick : pick + 1] for t in forest))
    train_leaves = route_forest(chosen, train_x, feat_types, max_depth)
    Z = compact_leaf_indicator(chosen, train_leaves, max_leaves)[0]  # (N, r)
    if train_mask is not None:
        Z = Z * train_mask[:, None]
    nu = JITTER + noise[pick]
    gamma = scale[pick] / m
    eye = torch.eye(Z.shape[1], dtype=torch.float32, device=Z.device)
    _, E = blocked_cholesky(Z.T @ Z + (nu / gamma) * eye)
    theta = E.T @ (E @ (Z.T @ y) + torch.sqrt(nu) * eps)
    return AcquisitionStateTS(forest=chosen, theta=theta)


def _evaluate_acquisition_ts(
    acq: AcquisitionStateTS,
    candidates: torch.Tensor,
    feat_types: torch.Tensor,
    max_depth: int = 16,
    kappa: float = DEFAULT_KAPPA,
) -> torch.Tensor:
    """Score = the drawn function's value (kappa unused; lower is better)."""
    del kappa
    max_leaves = (acq.forest.node_limit + 1) // 2
    leaves = route_forest(acq.forest, candidates, feat_types, max_depth)
    h = compact_leaf_indicator(acq.forest, leaves, max_leaves)[0]
    return h @ acq.theta


def evaluate_acquisition(
    acq,
    candidates: torch.Tensor,
    feat_types: torch.Tensor,
    max_depth: int = 16,
    kappa: float = DEFAULT_KAPPA,
) -> torch.Tensor:
    """Score a ``(B, D)`` candidate batch, ``(B,)``; lower is better.

    Dispatches on the state type: dense :class:`AcquisitionState`, factored
    :class:`AcquisitionStateLR` or Thompson :class:`AcquisitionStateTS`.
    """
    check_matmul_precision()
    if isinstance(acq, AcquisitionStateLR):
        return _evaluate_acquisition_lr(acq, candidates, feat_types, max_depth, kappa)
    if isinstance(acq, AcquisitionStateTS):
        return _evaluate_acquisition_ts(acq, candidates, feat_types, max_depth, kappa)
    if isinstance(acq, AcquisitionState):
        return _evaluate_acquisition_dense(acq, candidates, feat_types, max_depth, kappa)
    raise TypeError(f"not an acquisition state: {type(acq).__name__}")
