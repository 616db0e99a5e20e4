"""Posterior GP prediction over batched forest samples.

Counterpart of ``bark_tpu/models/gp.py`` (``forest_predict``,
``forest_predict_leaf`` and ``mixture_of_gaussians_as_normal``). The
reference ``vmap``-s one posterior sample over the batch; here every tensor
carries the leading dimension S = chains x samples: the data is routed
through all S forests at once, the S agreement Grams come from one launch
of kernel K1 (``ops.gram``), and the S factorizations from one launch of
kernel K2 (``ops.chol``, through ``ops.linalg``).

The dense path factors the (S, N, N) kernel matrices; the leaf path factors
the (S, r, r) leaf-space matrices A = (nu/gamma) I + Z^T Z instead and never
builds anything N x N. Both give the same posterior up to float association.
"""

from __future__ import annotations

import torch

from bark_tpu_torch.forest import (
    Forest,
    compact_leaf_indicator,
    flatten_batch,
    gram_from_leaves,
    route_forest,
)
from bark_tpu_torch.ops.linalg import (
    JITTER,
    blocked_cholesky,
    check_matmul_precision,
    gp_posterior,
    kernel_matrix,
    robust_chol_inv_logdet,
)


def forest_predict(
    forest: Forest,
    noise: torch.Tensor,
    scale: torch.Tensor,
    train_x: torch.Tensor,
    train_y: torch.Tensor,
    candidates: torch.Tensor,
    feat_types: torch.Tensor,
    max_depth: int = 16,
    train_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and variance under every posterior sample: ``(S, M)``.

    Forest fields may carry any leading batch shape (chains x samples);
    noise/scale match it, and S is its product. ``train_mask`` marks real
    rows when the training set is padded to a bucket size: masked rows have
    zero cross-kernel columns and an isolated diagonal block, so they drop
    out of the posterior exactly.

    Two K1 calls (K_XX on the symmetric path, K_xX with the column mask
    only) and one K2 call, plus one more K2 call per jitter escalation when
    a sample's kernel fails to factor.
    """
    check_matmul_precision()
    flat = flatten_batch(forest)
    node_limit = flat.node_limit
    noise = noise.reshape(-1).to(torch.float32)
    scale = scale.reshape(-1).to(torch.float32)
    train_leaves = route_forest(flat, train_x, feat_types, max_depth)
    cand_leaves = route_forest(flat, candidates, feat_types, max_depth)
    gram = gram_from_leaves(train_leaves, train_leaves, train_mask, train_mask, node_limit)
    K_inv, _ = robust_chol_inv_logdet(kernel_matrix(gram, noise, scale))
    K_xX = scale[:, None, None] * gram_from_leaves(
        cand_leaves, train_leaves, None, train_mask, node_limit
    )
    return gp_posterior(K_inv, K_xX, train_y.to(torch.float32), scale)


def forest_predict_leaf(
    forest: Forest,
    noise: torch.Tensor,
    scale: torch.Tensor,
    train_x: torch.Tensor,
    train_y: torch.Tensor,
    candidates: torch.Tensor,
    feat_types: torch.Tensor,
    max_depth: int = 16,
    train_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact large-N sibling of :func:`forest_predict` in leaf space.

    With the compact leaf-indicator matrices Z (N, r), Z_x (M, r) and
    A = (nu/gamma) I_r + Z^T Z (nu = jitter + noise, gamma = scale / m,
    r = m * max_leaves), the Woodbury identity collapses the posterior to

        mu(x)  = z_x^T A^-1 (Z^T y)
        var(x) = nu * || L_A^-1 z_x ||^2

    (from K = nu I + gamma Z Z^T; diag(Z_x Z_x^T) = m makes the prior
    variance cancel exactly). One (r, r) factorization per sample replaces
    the (N, N) one, and the per-tree dense ranking is injective for any
    forest, so there is no budget assumption. The factorization goes through
    ``blocked_cholesky`` (K2 on the 256-blocks), whose inverse factor
    E = L_A^-1 gives both solves as products: ``A^-1 u = E^T (E u)`` and
    ``L_A^-1 Z_x^T = E Z_x^T``. The variance is a sum of squares and cannot
    go negative.
    """
    check_matmul_precision()
    flat = flatten_batch(forest)
    m = flat.num_trees
    max_leaves = (flat.node_limit + 1) // 2
    noise = noise.reshape(-1).to(torch.float32)
    scale = scale.reshape(-1).to(torch.float32)
    y = train_y.reshape(-1).to(torch.float32)
    if train_mask is not None:
        y = y * train_mask
    train_leaves = route_forest(flat, train_x, feat_types, max_depth)
    cand_leaves = route_forest(flat, candidates, feat_types, max_depth)
    Z = compact_leaf_indicator(flat, train_leaves, max_leaves)  # (S, N, r)
    if train_mask is not None:
        Z = Z * train_mask[:, None]
    Zx = compact_leaf_indicator(flat, cand_leaves, max_leaves)  # (S, M, r)
    nu = JITTER + noise
    gamma = scale / m
    eye = torch.eye(Z.shape[-1], dtype=torch.float32, device=Z.device)
    Zt = Z.transpose(1, 2)
    A = Zt @ Z + (nu / gamma)[:, None, None] * eye
    _, E = blocked_cholesky(A)
    u = Zt @ y  # (S, r)
    w = (E.transpose(1, 2) @ (E @ u[..., None]))  # A^-1 u, (S, r, 1)
    mu = (Zx @ w)[..., 0]
    T = E @ Zx.transpose(1, 2)  # (S, r, M)
    var = nu[:, None] * (T * T).sum(1)
    return mu, var


def mixture_of_gaussians_as_normal(mu, var):
    """Moment-match a uniform mixture of Gaussians (leading dim) to one
    Gaussian. Takes tensors or numpy arrays."""
    mu_y = mu.mean(0)
    var_y = (var + mu**2).mean(0) - mu_y**2
    return mu_y, var_y
