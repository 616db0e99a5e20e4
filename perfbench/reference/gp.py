"""Plain reference of the GP over a sampled forest: the kernel, its factor,
the marginal likelihood and the acquisition.

From the model's definition, in plain PyTorch; it imports nothing of the
program and takes from it only the outputs it judges. With k(x, x') the
share of trees in which x and x' share a leaf, noise nu and scale s,

    K = s G + (jitter + nu) I,   mll = -(y^T K^-1 y + log det K) / 2,

and the acquisition is the sample average of the lower confidence bound
mu - kappa sigma, with the Gram over the trees that are not a lone root
(a lone-root tree adds the same constant to every entry):

    mu(x) = s k(x)^T K^-1 y,   sigma^2(x) = s - s^2 k(x)^T K^-1 k(x).

``precision`` is ``"float64"`` (the reference) or ``"tf32"`` (the control:
float32 arithmetic with every matrix product's operands rounded to TF32's
10-bit mantissa, the precision just below the program's float32 with TF32
off). Chains or samples go through in blocks of ``block``, so that N x N
float64 matrices fit.
"""

from __future__ import annotations

import torch

from perfbench.reference.forest import agreement, route

PRECISIONS = ("float64", "tf32")


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 explicit mantissa bits), to
    nearest, ties to even."""
    t = t.to(torch.float32).contiguous()
    bits = t.view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    finite = torch.isfinite(t)
    return torch.where(finite, rounded.view(torch.float32), t)


def _dtype(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return torch.float64 if precision == "float64" else torch.float32


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return tf32(a) @ tf32(b)
    return a @ b


def check_block(n: int) -> int:
    """Chains or samples the reference takes a block at N rows: its N x N
    float64 matrices, about 4 GiB a block, at most 16."""
    return max(1, min(16, (4 << 30) // (48 * n * n)))


def _slice(forest: dict, rows) -> dict:
    return {k: v[rows] for k, v in forest.items()}


def _factor(G: torch.Tensor, noise, scale, jitter: float, precision: str):
    """log det K and K^-1 = L^-T L^-1 of K = scale G + (jitter + noise) I,
    through its Cholesky factor L."""
    n = G.shape[-1]
    eye = torch.eye(n, dtype=G.dtype, device=G.device)
    K = scale[:, None, None] * G + (jitter + noise)[:, None, None] * eye
    L = torch.linalg.cholesky(K)
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    E = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    K_inv = matmul(E.transpose(1, 2), E, precision)
    return logdet, K_inv


def chain_state(forest: dict, noise, scale, X, y, feat_types, m: int, jitter: float,
                precision: str = "float64", block: int = 8, max_depth: int = 16,
                kinv_claim: torch.Tensor | None = None, keep_kinv: bool = False):
    """Per chain ``(C,)``: the leaves ``(C, N, m)``, log det K, the quadratic
    y^T K^-1 y and the MLL; with ``kinv_claim`` (a K^-1 ``(C, N, N)`` to
    judge) also ``kinv_gap``, each chain's largest entry of
    |claim - K^-1| over the largest |K^-1|; with ``keep_kinv`` K^-1 itself."""
    dt = _dtype(precision)
    X = X.to(torch.float32)
    yv = y.to(dt)
    c = noise.shape[0]
    leaves, logdets, quads, gaps, kinvs = [], [], [], [], []
    for lo in range(0, c, block):
        rows = slice(lo, min(lo + block, c))
        lv = route(_slice(forest, rows), X, feat_types, max_depth)
        G = agreement(lv, lv, dtype=dt) / m
        logdet, K_inv = _factor(G, noise[rows].to(dt), scale[rows].to(dt), jitter, precision)
        quad = matmul(matmul(K_inv, yv[:, None], precision)[..., 0], yv[:, None], precision)[..., 0]
        leaves.append(lv)
        logdets.append(logdet)
        quads.append(quad)
        if keep_kinv:
            kinvs.append(K_inv)
        if kinv_claim is not None:
            diff = (kinv_claim[rows].to(K_inv.device, torch.float64) - K_inv.double()).abs()
            gaps.append(diff.amax((-2, -1)) / K_inv.double().abs().amax((-2, -1)))
    logdet = torch.cat(logdets)
    quad = torch.cat(quads)
    out = {"leaves": torch.cat(leaves), "logdet": logdet, "quad": quad,
           "mll": -0.5 * (quad + logdet)}
    if kinv_claim is not None:
        out["kinv_gap"] = torch.cat(gaps)
    if keep_kinv:
        out["K_inv"] = torch.cat(kinvs)
    return out


def lcb(forest: dict, noise, scale, X_train, y, candidates, feat_types, jitter: float,
        kappa: float, precision: str = "float64", block: int = 4, max_depth: int = 16):
    """The acquisition at ``candidates`` ``(B, D)``: the average over the S
    samples of mu - kappa sigma, ``(B,)``; y is the standardized target."""
    dt = _dtype(precision)
    X_train = X_train.to(torch.float32)
    candidates = candidates.to(torch.float32)
    yv = y.to(dt)
    s_count, m = forest["is_leaf"].shape[:2]
    total = torch.zeros(candidates.shape[0], dtype=dt, device=candidates.device)
    for lo in range(0, s_count, block):
        rows = slice(lo, min(lo + block, s_count))
        f = _slice(forest, rows)
        live = ~f["is_leaf"][..., 0]  # trees that are more than a root
        denom = live.sum(-1).clamp_min(1).to(dt)[:, None, None]
        lt = route(f, X_train, feat_types, max_depth)
        lc = route(f, candidates, feat_types, max_depth)
        G = agreement(lt, lt, live, dt) / denom
        k = agreement(lc, lt, live, dt) / denom
        sc = scale[rows].to(dt)
        _, K_inv = _factor(G, noise[rows].to(dt), sc, jitter, precision)
        mu = sc[:, None] * matmul(k, matmul(K_inv, yv[:, None], precision), precision)[..., 0]
        quad = (matmul(k, K_inv, precision) * k).sum(-1)
        var = torch.clamp_min(sc[:, None] - sc[:, None] ** 2 * quad, 1e-12)
        total += (mu - kappa * torch.sqrt(var)).sum(0)
    return total / s_count
