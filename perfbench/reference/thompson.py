"""Plain reference of the Thompson-sampling acquisition: one exact draw of
the GP's function over a sampled forest, in the forest's leaf space.

From the model's definition, in plain PyTorch; it imports nothing of the
program and takes from it only the draw's randomness (which posterior
sample, and the normal vector) and the outputs it judges. For one forest of
m trees with noise nu_0 and scale s, the GP is Bayesian linear regression on
the leaf indicators: a row's indicator z (one column per tree and leaf) and
leaf weights theta ~ N(0, gamma I), gamma = s / m, so that
z^T z' gamma = s k(x, x'). With Z ``(N, r)`` the training rows' indicators,
nu = jitter + nu_0 and A = (nu / gamma) I + Z^T Z = L L^T,

    theta = A^-1 Z^T y + sqrt(nu) L^-T eps,   score(x) = z_x^T theta,

a draw from theta | y (its covariance nu A^-1). The columns are packed as
the program packs them, so that the same eps gives the same draw: tree j
owns columns [j w, (j + 1) w), w = (node_limit + 1) // 2, and its active
leaves take them in node order; r = m w.

``precision`` as in ``gp.py``: ``"float64"`` (the reference) or ``"tf32"``
(the control: float32, every matrix product's operands rounded to TF32).
"""

from __future__ import annotations

import torch

from perfbench.reference.forest import route
from perfbench.reference.gp import _dtype, matmul


def leaf_columns(forest: dict) -> torch.Tensor:
    """The column of each active leaf, ``(m, node_limit)`` int64 (-1 at
    every other slot), of one forest with fields ``(m, node_limit)``."""
    m, nl = forest["is_leaf"].shape
    width = (nl + 1) // 2
    leaf = forest["is_leaf"] & forest["active"]
    rank = torch.cumsum(leaf.long(), dim=-1) - 1
    base = width * torch.arange(m, device=rank.device)[:, None]
    return torch.where(leaf, base + rank, -1)


def indicator(forest: dict, X: torch.Tensor, feat_types: torch.Tensor, dtype,
              max_depth: int = 16) -> torch.Tensor:
    """The leaf indicators of the rows of ``X`` ``(B, r)``: a one in each
    tree's column of the leaf the row lands in."""
    m, nl = forest["is_leaf"].shape
    r = m * ((nl + 1) // 2)
    leaves = route({k: v[None] for k, v in forest.items()}, X.to(torch.float32), feat_types,
                   max_depth)[0]  # (B, m)
    cols = torch.gather(leaf_columns(forest), 1, leaves.T).T  # (B, m)
    if bool((cols < 0).any()):
        raise ValueError("a row landed on a slot that is not an active leaf")
    z = torch.zeros((X.shape[0], r), dtype=dtype, device=X.device)
    return z.scatter_(1, cols, 1.0)


def scores(forest: dict, noise, scale, X_train, y, eps, candidates, feat_types, jitter: float,
           precision: str = "float64", max_depth: int = 16) -> torch.Tensor:
    """The drawn function at ``candidates`` ``(B, D)``, ``(B,)``, for one
    forest (fields ``(m, node_limit)``), its noise and scale, the training
    rows and standardized y, and the normal vector ``eps`` ``(r,)``."""
    dt = _dtype(precision)
    m = forest["is_leaf"].shape[0]
    Z = indicator(forest, X_train, feat_types, dt, max_depth)
    H = indicator(forest, candidates, feat_types, dt, max_depth)
    nu = jitter + torch.as_tensor(noise, dtype=dt)
    gamma = torch.as_tensor(scale, dtype=dt) / m
    eye = torch.eye(Z.shape[1], dtype=dt, device=Z.device)
    A = matmul(Z.T, Z, precision) + (nu / gamma) * eye
    L = torch.linalg.cholesky(A)
    zty = matmul(Z.T, y.to(dt)[:, None], precision)
    mean = torch.cholesky_solve(zty, L)[:, 0]
    spread = torch.linalg.solve_triangular(L.T, eps.to(dt)[:, None], upper=True)[:, 0]
    theta = mean + torch.sqrt(nu) * spread
    return matmul(H, theta[:, None], precision)[:, 0]
