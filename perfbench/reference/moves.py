"""Plain reference of one sampler step's move scan: the MLL difference of
each of the m tree moves, replayed from the step's input forests and its m
proposed trees.

From the model's definition, in plain PyTorch; it imports nothing of the
program. Move j replaces tree j of the current forest by its proposal; its
MLL difference is mll(forest with the proposal) - mll(current forest), and
the current forest takes the proposal where the step accepted it (the
replay follows the step's decisions, which the caller judges separately).

The MLL is computed in leaf space, so that N in the thousands costs no
N x N matrix: with Z the rows' leaf indicators (a column per tree and
leaf that holds a row), gamma = scale / m and nu = jitter + noise,

    K = gamma Z Z^T + nu I,
    log det K = N log nu + log det B,        B = I + (gamma / nu) Z^T Z,
    y^T K^-1 y = y^T (y - Z w) / nu,         w = (gamma / nu) B^-1 Z^T y,
    mll = -(y^T K^-1 y + log det K) / 2.

``precision`` as in :mod:`perfbench.reference.gp`: ``"float64"`` or
``"tf32"`` (float32 with every product's operands rounded to TF32).
"""

from __future__ import annotations

import torch

from perfbench.reference.forest import route
from perfbench.reference.gp import _dtype, matmul


def indicators(leaves: torch.Tensor, node_limit: int, dtype) -> torch.Tensor:
    """The leaf indicators Z ``(C, N, W)`` of leaves ``(C, N, m)``: a column
    for each (tree, leaf) that holds a row, W the most any chain has (a
    chain with fewer has empty columns, which change neither form above)."""
    c, n, m = leaves.shape
    key = (leaves.long() + torch.arange(m, device=leaves.device) * node_limit).reshape(c, -1)
    used = torch.zeros((c, m * node_limit), dtype=torch.bool, device=leaves.device)
    used.scatter_(1, key, True)
    col = used.long().cumsum(1) - 1
    width = int(used.sum(1).max())
    idx = torch.gather(col, 1, key).reshape(c, n, m)
    return torch.zeros((c, n, width), dtype=dtype, device=leaves.device).scatter_(2, idx, 1.0)


def leaf_mll(leaves: torch.Tensor, noise, scale, y, m: int, jitter: float, node_limit: int,
             precision: str = "float64"):
    """Per chain ``(C,)``: the MLL, y^T K^-1 y and log det K of the forests
    whose leaves are ``leaves`` ``(C, N, m)``."""
    dt = _dtype(precision)
    Z = indicators(leaves, node_limit, dt)
    n, w = Z.shape[1:]
    nu = (jitter + noise.to(dt))[:, None]
    ratio = (scale.to(dt) / m)[:, None] / nu  # gamma / nu, (C, 1)
    yv = y.to(dt).expand(Z.shape[0], n)
    Zt = Z.transpose(1, 2)
    eye = torch.eye(w, dtype=dt, device=Z.device)
    B = eye + ratio[..., None] * matmul(Zt, Z, precision)
    L = torch.linalg.cholesky(B)
    logdet = n * torch.log(nu[:, 0]) + 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    zy = matmul(Zt, yv[..., None], precision)
    wv = ratio[..., None] * torch.cholesky_solve(zy, L)
    resid = yv - matmul(Z, wv, precision)[..., 0]
    quad = matmul(resid[:, None, :], yv[..., None], precision)[:, 0, 0] / nu[:, 0]
    return -0.5 * (quad + logdet), quad, logdet


def move_deltas(forest: dict, proposed: dict, accepts: torch.Tensor, noise, scale, X, y,
                feat_types, m: int, jitter: float, precision: str = "float64",
                block: int = 8, max_depth: int = 16):
    """The m moves' MLL differences ``(C, m)`` of one step. ``forest`` and
    ``proposed`` are the input forests and the proposals (field dicts,
    ``(C, m, node_limit)``; tree j of ``proposed`` is move j's proposal),
    ``accepts`` ``(C, m)`` the step's decisions."""
    X = X.to(torch.float32)
    node_limit = forest["is_leaf"].shape[-1]
    c = noise.shape[0]
    deltas = []
    for lo in range(0, c, block):
        rows = slice(lo, min(lo + block, c))
        cur = route({k: v[rows] for k, v in forest.items()}, X, feat_types, max_depth)
        prop = route({k: v[rows] for k, v in proposed.items()}, X, feat_types, max_depth)
        args = (noise[rows], scale[rows], y, m, jitter, node_limit, precision)
        cur_mll = leaf_mll(cur, *args)[0]
        out = []
        for j in range(m):
            trial = cur.clone()
            trial[..., j] = prop[..., j]
            new_mll = leaf_mll(trial, *args)[0]
            out.append((new_mll - cur_mll).double())
            acc = accepts[rows, j].to(cur.device)
            cur = torch.where(acc[:, None, None], trial, cur)
            cur_mll = torch.where(acc, new_mll, cur_mll)
        deltas.append(torch.stack(out, 1))
    return torch.cat(deltas)
