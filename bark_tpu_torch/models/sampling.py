"""Posterior function sampling: optimum-value (f*) draws and Nystrom features.

Counterpart of ``bark_tpu/models/sampling.py``. The reference ``vmap``-s one
posterior sample over the batch; here every tensor carries the leading dimension
S = chains x samples, the S agreement Grams come from one launch of kernel
K1 (``ops.gram``) and the S factorizations from kernel K2 (``ops.chol``,
through ``ops.linalg.blocked_cholesky``). Every function that draws takes
its standard normals as a tensor, so a test can replay the reference's
``jax.random`` draws.

  - :func:`generate_fstar_samples`: the dense joint posterior over the
    training sites, sampled through an eigenvalue-clamped root of its
    covariance (the agreement kernel is PSD only up to float error);
  - :func:`construct_nystrom_features` / :func:`nystrom_samples`: the
    Nystrom feature map against an inducing set, and prior function draws
    from it;
  - :func:`leaf_function_samples` / :func:`generate_fstar_samples_leaf`:
    exact joint draws in leaf space, one (r, r) factorization per sample
    and no clamping;
  - :func:`fstar_samples_mogp`: f* draws from a LeafMOGP's target-fidelity
    joint posterior, drawn on the host from the caller's numpy generator as
    the reference draws them, so a seed replays them.

Eigenvectors of the agreement kernel are not unique (it has many repeated
and zero eigenvalues), so the dense sampler and the Nystrom features match
the reference through ``root root^T`` and ``phi phi^T``, not draw for draw.
"""

from __future__ import annotations

import numpy as np
import torch

from bark_tpu_torch.fitting.sampler import BARKModel
from bark_tpu_torch.forest import (
    compact_leaf_indicator,
    flatten_batch,
    gram_from_leaves,
    route_forest,
)
from bark_tpu_torch.ops.linalg import JITTER, blocked_cholesky, check_matmul_precision


def _flat(model: BARKModel):
    """The model's forests as (S, m, node_limit) with noise and scale (S,)."""
    return (
        flatten_batch(model.forest),
        model.noise.reshape(-1).to(torch.float32),
        model.scale.reshape(-1).to(torch.float32),
    )


def fstar_moments(
    model: BARKModel,
    train_x: torch.Tensor,
    train_y: torch.Tensor,
    feat_types: torch.Tensor,
    max_depth: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Latent posterior at the training sites: mean (S, N) and a clamped
    root (S, N, N) of its covariance.

    With K = scale * gram and K_s = K + (jitter + noise) I = L L^T (K2,
    which also gives E = L^-1): ``mu = K K_s^-1 y = (E K)^T (E y)`` and
    ``Sigma = K - K K_s^-1 K = K - (E K)^T (E K)``. ``root = V
    diag(sqrt(max(lambda, 0)))`` from ``eigh`` of the symmetrised Sigma, so
    ``root root^T`` is Sigma with its negative eigenvalues clamped to 0.
    """
    check_matmul_precision()
    flat, noise, scale = _flat(model)
    n = train_x.shape[0]
    leaves = route_forest(flat, train_x, feat_types, max_depth)
    K = scale[:, None, None] * gram_from_leaves(leaves, leaves, None, None, flat.node_limit)
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    _, E = blocked_cholesky(K + (JITTER + noise)[:, None, None] * eye)
    W = E @ K  # L^-1 K
    y = train_y.reshape(-1).to(torch.float32)
    mu = (W.transpose(1, 2) @ (E @ y)[..., None])[..., 0]
    sigma = K - W.transpose(1, 2) @ W
    evals, evecs = torch.linalg.eigh(0.5 * (sigma + sigma.transpose(1, 2)))
    return mu, evecs * torch.sqrt(evals.clamp_min(0.0))[:, None, :]


def generate_fstar_samples(
    model: BARKModel,
    train_x: torch.Tensor,
    train_y: torch.Tensor,
    feat_types: torch.Tensor,
    z: torch.Tensor,
    max_depth: int = 16,
) -> torch.Tensor:
    """Optimum values f* from the latent posterior at the training sites.

    ``z`` (S, N, num_fstar) holds the standard normals. Each sample's joint
    draws are ``mu + root z`` (:func:`fstar_moments`) and f* is their
    minimum over the sites. Returns (S, num_fstar).
    """
    mu, root = fstar_moments(model, train_x, train_y, feat_types, max_depth)
    return (mu[..., None] + root @ z).amin(1)


def construct_nystrom_features(
    model: BARKModel,
    inducing_x: torch.Tensor,
    candidates: torch.Tensor,
    feat_types: torch.Tensor,
    max_depth: int = 16,
    eig_floor: float = 1e-6,
) -> torch.Tensor:
    """Nystrom feature map of every posterior sample: (S, M, Z).

    ``phi(x) = K_xZ V diag(lambda)^-1/2`` from the eigendecomposition of
    K_ZZ over the inducing set, eigenvalues at or below ``eig_floor``
    dropped, so that ``phi(x) phi(x')^T`` approximates k(x, x') and equals
    it on the inducing set. Two K1 calls (K_ZZ on the symmetric path, K_xZ).
    """
    check_matmul_precision()
    flat, _, scale = _flat(model)
    z_leaves = route_forest(flat, inducing_x, feat_types, max_depth)
    c_leaves = route_forest(flat, candidates, feat_types, max_depth)
    s = scale[:, None, None]
    K_zz = s * gram_from_leaves(z_leaves, z_leaves, None, None, flat.node_limit)
    K_xz = s * gram_from_leaves(c_leaves, z_leaves, None, None, flat.node_limit)
    evals, evecs = torch.linalg.eigh(K_zz)
    inv_root = torch.where(
        evals > eig_floor, 1.0 / torch.sqrt(evals.clamp_min(eig_floor)), 0.0
    )
    return K_xz @ (evecs * inv_root[:, None, :])


def nystrom_samples(features: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Approximate prior function draws ``f(x) = phi(x) w`` from Nystrom
    features (S, M, Z) and standard normals ``w`` (S, Z, num_samples).
    Returns (S, num_samples, M)."""
    return (features @ w).transpose(1, 2)


def leaf_function_samples(
    model: BARKModel,
    train_x: torch.Tensor,
    train_y: torch.Tensor,
    X_eval: torch.Tensor,
    feat_types: torch.Tensor,
    eps: torch.Tensor,
    max_depth: int = 16,
    train_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Exact joint posterior function draws at ``X_eval``: (S, num_draws, M).

    The agreement GP is a Bayesian linear model over the compact leaf
    indicators, f(x) = z_x^T theta with theta ~ N(0, gamma I_r), so theta |
    y ~ N(A^-1 Z^T y, nu A^-1) with A = (nu/gamma) I + Z^T Z (nu = jitter +
    noise, gamma = scale/m, r = m * (node_limit + 1) // 2). With A = L L^T
    factored by K2 (``blocked_cholesky``, host-blocked above 256), which
    also gives E = L^-1, the draws are ``theta = E^T (E Z^T y) + sqrt(nu)
    E^T eps``: both solves are products. ``eps`` (S, r, num_draws) holds the
    standard normals. A is SPD by construction: no clamping. The y-side
    products run at full float32 (checked at entry).
    """
    check_matmul_precision()
    flat, noise, scale = _flat(model)
    m = flat.num_trees
    max_leaves = (flat.node_limit + 1) // 2
    y = train_y.reshape(-1).to(torch.float32)
    if train_mask is not None:
        y = y * train_mask
    Z = compact_leaf_indicator(flat, route_forest(flat, train_x, feat_types, max_depth),
                               max_leaves)  # (S, N, r)
    if train_mask is not None:
        Z = Z * train_mask[:, None]
    Ze = compact_leaf_indicator(flat, route_forest(flat, X_eval, feat_types, max_depth),
                                max_leaves)  # (S, M, r)
    nu = JITTER + noise
    gamma = scale / m
    Zt = Z.transpose(1, 2)
    eye = torch.eye(Z.shape[-1], dtype=torch.float32, device=Z.device)
    _, E = blocked_cholesky(Zt @ Z + (nu / gamma)[:, None, None] * eye)
    Et = E.transpose(1, 2)
    theta_bar = Et @ (E @ (Zt @ y)[..., None])  # (S, r, 1)
    theta = theta_bar + torch.sqrt(nu)[:, None, None] * (Et @ eps)  # (S, r, D)
    return (Ze @ theta).transpose(1, 2)


def generate_fstar_samples_leaf(
    model: BARKModel,
    train_x: torch.Tensor,
    train_y: torch.Tensor,
    feat_types: torch.Tensor,
    eps: torch.Tensor,
    max_depth: int = 16,
    train_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """:func:`generate_fstar_samples` through the exact leaf-space draws
    (:func:`leaf_function_samples` at the training sites, the padded ones
    left out of the minimum). ``eps`` as there. Returns (S, num_fstar)."""
    draws = leaf_function_samples(
        model, train_x, train_y, train_x, feat_types, eps, max_depth, train_mask
    )  # (S, D, N)
    if train_mask is not None:
        draws = torch.where(train_mask > 0, draws, torch.inf)
    return draws.amin(-1)


def fstar_samples_mogp(mogp, X_train, num_fstar: int, rng: np.random.Generator) -> np.ndarray:
    """Optimum-value samples from a LeafMOGP's target-fidelity posterior:
    ``(num_fstar,)`` numpy, in standardized units.

    The joint latent posterior over the training sites at task 0
    (``mogp._posterior_joint``: two K1 launches and a solve on the device)
    is sampled on the host in float64 through an eigenvalue-clamped root of
    its covariance, with ``rng.standard_normal((num_fstar, N))``, and each
    draw minimized.
    """
    mu, cov = mogp._posterior_joint(X_train, np.zeros(len(X_train), np.int64))
    mu = mu.cpu().numpy().astype(np.float64)
    cov = cov.cpu().numpy().astype(np.float64)
    w, V = np.linalg.eigh(0.5 * (cov + cov.T))
    half = V * np.sqrt(np.clip(w, 1e-12, None))
    eps = rng.standard_normal((num_fstar, len(mu)))
    draws = mu[None, :] + eps @ half.T
    return draws.min(axis=1)
