"""Matrix-free GP algebra: conjugate-gradient posteriors over the factored kernel.

Counterpart of ``bark_tpu/ops/iterative.py``. The agreement kernel factors: with Z the
leaf indicator of the training rows scaled by 1/sqrt(m),

    K = scale Z Z^T,    (K + (noise + jitter) I) v = scale Z (Z^T v) + (noise + jitter) v,

so a kernel product never builds anything N x N, and preconditioned CG
gives posterior means and variances from such products alone.

The reference's Z is the (N, m * node_limit) one-hot of every (tree, leaf
id) slot, of which m entries a row are nonzero and most columns are empty:
at N=4096, S=32 it would be 1.7 GB, and each product would do ~25x the
work of the slots any row occupies. Here Z keeps only the occupied slots:
:func:`leaf_columns` packs the (tree, leaf id) pairs that some training
row reaches, in slot order, into ``width`` columns (the largest count over
the batch, a multiple of 32), and :func:`leaf_features` builds the 0/1
indicator over them by direct indexing. ``Z Z^T`` is the reference's
exactly, and both products are batched matmuls on (S, N, width) tensors.
(Index products, a gather-sum for Z u and a scatter-add for Z^T v, compute
the same thing, but read the (S, N, B) block once per tree and contend on
the ~N/3 rows that share a leaf; the packed matmul reads it once.) A
candidate's slot that no training row occupies is dropped: it adds nothing
to K_xX = scale Z_x Z^T.

Sharding: every tensor of the solve has N on its row axis only, so the
training rows split over the ranks of a mesh (:func:`shard_posterior_inputs`)
and each rank keeps its block of Z, r, p and x. Where XLA inserted the
collectives into the reference's sharded solve, they are explicit here
(``mesh=``): the occupied slots are or-ed over the ranks once, and each CG
trip all-reduces the Z^T v partial product and each of its row sums. Every
sum over rows (Z^T v and the CG's dot products) accumulates in float64 and
is rounded back to float32, so the sum over ranks rounds to what one
process gives and a sharded solve follows the single-process one.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from bark_tpu_torch.forest import indicator_from_targets
from bark_tpu_torch.ops.linalg import JITTER
from bark_tpu_torch.parallel.distributed import all_reduce, mesh_rank

#: trips of the CG loop between two host checks of whether every column
#: has converged (the loop makes no host sync in between)
CHECK_EVERY = 16


class LeafColumns(NamedTuple):
    """Packed columns of the occupied (tree, leaf id) slots."""

    target: torch.Tensor  # (..., m, node_limit) column of each slot; width if unoccupied
    width: int


def _rowsum(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum over the row axis (-2), over every rank's rows with ``mesh``,
    accumulated in float64 (so that the sum over ranks rounds to what one
    process gives) and returned in x's dtype."""
    s = x.sum(-2, dtype=torch.float64)
    return (s if mesh is None else all_reduce(s, mesh)).to(x.dtype)


def _zt(Z: torch.Tensor, v: torch.Tensor, mesh) -> torch.Tensor:
    """Z^T v, a sum over rows like :func:`_rowsum`: in float64, over every
    rank's rows with ``mesh``, returned in v's dtype."""
    ztv = Z.transpose(-1, -2).double() @ v.double()
    return (ztv if mesh is None else all_reduce(ztv, mesh)).to(v.dtype)


def shard_posterior_inputs(mesh, *arrays: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """This rank's block of rows of each array: the row axis is dim 0 of a
    vector (y, a mask) and dim -2 of anything else (X (N, D), leaves
    (..., N, m)). Row counts must divide by the number of ranks."""
    rank, size = mesh_rank(mesh)

    def block(a):
        dim = 0 if a.dim() == 1 else a.dim() - 2
        n = a.shape[dim]
        if n % size:
            raise ValueError(f"{n} rows do not divide over {size} ranks")
        return a.narrow(dim, rank * (n // size), n // size)

    return tuple(block(a) for a in arrays)


def leaf_columns(leaves: torch.Tensor, node_limit: int, mesh=None) -> LeafColumns:
    """The slots the rows of ``leaves`` (..., N, m) occupy, packed in slot
    order (tree-major); ``width`` is the largest count over the batch,
    rounded up to a multiple of 32. With ``mesh`` the slots occupied on any
    rank's rows, alike on every rank. One host sync (the width)."""
    *batch, n, m = leaves.shape
    occupied = torch.zeros((*batch, m, node_limit), dtype=torch.int32, device=leaves.device)
    occupied.scatter_(-1, leaves.transpose(-1, -2).long(), 1)
    if mesh is not None:
        occupied = all_reduce(occupied, mesh, dist.ReduceOp.MAX)
    flat = occupied.reshape(*batch, m * node_limit)
    ranks = (torch.cumsum(flat, -1, dtype=torch.int32) - 1).reshape(occupied.shape)
    width = max(32, -(-int(flat.sum(-1).max()) // 32) * 32)
    return LeafColumns(torch.where(occupied > 0, ranks, width), width)


def leaf_features(
    leaves: torch.Tensor, columns: LeafColumns, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """(..., N, width) leaf indicator over the packed ``columns``, scaled by
    1/sqrt(m), so that ``K = scale Z Z^T``. Masked (padded) rows are zeroed:
    they get zero kernel rows and columns and an isolated (noise + jitter)
    diagonal, so they drop out of the posterior, as in the dense path."""
    m = leaves.shape[-1]
    z = indicator_from_targets(leaves, columns.target, columns.width)
    z = z / math.sqrt(m)
    if mask is not None:
        z = z * mask.to(z.dtype)[..., None]
    return z


def _bcast(x, like: torch.Tensor) -> torch.Tensor:
    """A float or (...,) tensor shaped to broadcast over (..., N, B)."""
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return x.reshape(*x.shape, *([1] * (like.dim() - x.dim())))


def kernel_matvec(Z: torch.Tensor, noise, scale, v: torch.Tensor, mesh=None) -> torch.Tensor:
    """``(K + (noise + jitter) I) v`` without K: Z (..., N, w), v (..., N, B);
    noise and scale are floats or carry Z's leading dims. With ``mesh``, Z
    and v are this rank's rows and Z^T v is summed over the ranks."""
    return _bcast(scale, v) * (Z @ _zt(Z, v, mesh)) + (JITTER + _bcast(noise, v)) * v


def _jacobi_diag(Z: torch.Tensor, noise, scale) -> torch.Tensor:
    """diag(K) + noise + jitter, (..., N): scale + noise + jitter on real
    rows, noise + jitter on padded ones."""
    d = (Z * Z).sum(-1)
    return _bcast(scale, d) * d + (JITTER + _bcast(noise, d))


def cg_solve(
    Z: torch.Tensor,
    noise,
    scale,
    rhs: torch.Tensor,
    maxiter: int = 256,
    tol: float = 1e-6,
    mesh=None,
) -> torch.Tensor:
    """Solve ``(K + (noise + jitter) I) x = rhs`` by Jacobi-preconditioned CG.

    ``rhs`` is (..., N) or (..., N, B), with Z's leading dims. Every column of every batch entry
    runs the reference's iteration (``jax.scipy.sparse.linalg.cg`` from
    x = 0) in one loop of at most ``maxiter`` trips: a column stops when
    ``||r||^2 <= tol^2 ||b||^2``, and from then on its x, r and p stay as
    they are (the reference's vmapped while-loop selects them alike), so
    CG scalars never mix columns. Every :data:`CHECK_EVERY` trips one host
    sync asks whether all columns have stopped. The trips run are left in
    ``cg_solve.trips``. With ``mesh``, Z and rhs are this rank's rows (the
    solution too), and every product over rows is summed over the ranks.
    """
    vec = rhs.dim() == Z.dim() - 1
    b = rhs[..., None] if vec else rhs
    diag = _jacobi_diag(Z, noise, scale)[..., None]
    matvec = lambda v: kernel_matvec(Z, noise, scale, v, mesh)  # noqa: E731
    stop = (tol * tol) * _rowsum(b * b, mesh)  # (..., B)
    x = torch.zeros_like(b)
    r = b.clone()
    p = r / diag
    gamma = _rowsum(r * p, mesh)
    trips = 0
    for trips in range(1, maxiter + 1):
        live = _rowsum(r * r, mesh) > stop
        Ap = matvec(p)
        alpha = torch.where(live, gamma / _rowsum(p * Ap, mesh), 0.0)[..., None, :]
        x = x + alpha * p
        r = r - alpha * Ap
        z = r / diag
        gamma_new = _rowsum(r * z, mesh)
        beta = torch.where(live, gamma_new / gamma, 0.0)
        p = torch.where(live[..., None, :], z + beta[..., None, :] * p, p)
        gamma = torch.where(live, gamma_new, gamma)
        if trips % CHECK_EVERY == 0 and not bool((_rowsum(r * r, mesh) > stop).any()):
            break
    cg_solve.trips = trips
    return x[..., 0] if vec else x


cg_solve.trips = 0


def cg_posterior(
    train_leaves: torch.Tensor,
    cand_leaves: torch.Tensor,
    y: torch.Tensor,
    noise,
    scale,
    node_limit: int,
    mask: torch.Tensor | None = None,
    maxiter: int = 256,
    mesh=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and variance at the candidates, matrix-free.

    ``train_leaves`` (..., N, m), ``cand_leaves`` (..., B, m), ``y`` (N,);
    noise and scale floats or (...,). The semantics of the dense
    ``gp_posterior`` (prior variance = scale, diag(gram) = 1):

        mu  = K_xX (K + nu I)^-1 y
        var = scale - diag(K_xX (K + nu I)^-1 K_Xx)

    with K_Xx = scale Z Z_x^T (N, B) built from the factors and both solves,
    y's column and the B columns of K_Xx, in one CG loop. The variance is
    clamped at 1e-12. With ``mesh``, ``train_leaves``, ``y`` and ``mask``
    are this rank's rows (:func:`shard_posterior_inputs`), the candidates
    are every rank's, and mu and var come out alike on every rank.
    """
    columns = leaf_columns(train_leaves, node_limit, mesh)
    Z = leaf_features(train_leaves, columns, mask)  # (..., N, w)
    Zc = leaf_features(cand_leaves, columns)  # (..., B, w)
    y = y.reshape(-1).to(Z.dtype)
    K_Xx = _bcast(scale, Z) * (Z @ Zc.transpose(-1, -2))  # (..., N, B)
    rhs = torch.cat([y.expand(*K_Xx.shape[:-1])[..., None], K_Xx], -1)
    sol = cg_solve(Z, noise, scale, rhs, maxiter=maxiter, mesh=mesh)
    alpha, W = sol[..., :1], sol[..., 1:]
    mu = (_bcast(scale, Zc) * (Zc @ _zt(Z, alpha, mesh)))[..., 0]
    var = _bcast(scale, mu) - _rowsum(K_Xx * W, mesh)
    return mu, var.clamp_min(1e-12)
