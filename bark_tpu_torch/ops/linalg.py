"""GP linear algebra: kernel matrix, MLL, Cholesky with inverse, posterior.

Counterpart of the parts of ``bark_tpu/ops/linalg.py`` the sampler, the
posterior prediction and the acquisition use. Every factorization goes
through the batched Cholesky-with-inverse kernel (``ops.chol``, K2): in one
launch for N <= 256, which covers the whole dense tier, and above that as
the diagonal blocks of :func:`blocked_cholesky`, whose panels and trailing
updates are ``torch.matmul`` as in the reference. The predict and
acquisition paths factor through :func:`robust_cholesky`, which re-factors
with more jitter the matrices that failed.

Precision: the reference runs its MLL-critical products at full float32
(``MM_PRECISION = "highest"``) because reduced-precision matmuls biased the
posterior. Here the same requirement is a guard, :func:`check_matmul_precision`,
called at the sampler's, the prediction's and the acquisition's entry
points: TF32 matmuls must be off.
"""

from __future__ import annotations

import torch

from bark_tpu_torch.ops.chol import MAX_BLOCK, chol_inv

JITTER = 1e-6  # as bark_tpu.ops.linalg.JITTER


def check_matmul_precision() -> None:
    """Raise unless float32 matmuls run at full float32 precision.

    Counterpart of the reference's ``MM_PRECISION = "highest"``: TF32 keeps
    about three decimal digits, which the MLL's quadratic forms cannot
    afford. Set ``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.set_float32_matmul_precision("highest")`` (PyTorch's defaults).
    """
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: the sampler needs "
            "full-float32 matmuls (TF32 biases the MLL); set it to False"
        )
    precision = torch.get_float32_matmul_precision()
    if precision != "highest":
        raise RuntimeError(
            f"torch.get_float32_matmul_precision() is {precision!r}: the "
            'sampler needs "highest" (full-float32 matmuls)'
        )


def kernel_matrix(
    gram: torch.Tensor, noise: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """``scale * gram + (jitter + noise) I``; noise/scale carry the batch
    dims of ``gram`` (..., N, N)."""
    eye = torch.eye(gram.shape[-1], dtype=gram.dtype, device=gram.device)
    return scale[..., None, None] * gram + (JITTER + noise)[..., None, None] * eye


def masked_mll(
    K_inv: torch.Tensor,
    K_logdet: torch.Tensor,
    y: torch.Tensor,
    noise: torch.Tensor,
    pad_count: torch.Tensor,
) -> torch.Tensor:
    """MLL over the real rows of a padded system (up to the 2 pi constant).

    Padded rows are masked out of the Gram, so K is block-diagonal with
    ``(jitter + noise) I`` on the pads; their y is 0, and the logdet's
    over-count ``pad_count * log(jitter + noise)`` is added back.
    """
    y = y.reshape(-1)
    quad = (K_inv @ y) @ y
    correction = pad_count * torch.log(JITTER + noise)
    return 0.5 * (-quad - K_logdet + correction)


def blocked_cholesky(
    K: torch.Tensor, block: int = MAX_BLOCK
) -> tuple[torch.Tensor, torch.Tensor]:
    """Right-looking blocked Cholesky with inverse: ``(L, L^-1)`` of K.

    K is (..., N, N). For N <= ``block`` (256, the kernel's limit) this is
    one K2 call, which blocks inside the kernel; that is every dense-tier N.
    Above, K is padded with an identity block to a multiple of ``block`` --
    inert:
    blockdiag(K, I) factors to blockdiag(L, I) -- the diagonal blocks are
    factored by K2, which also returns their inverses, so each panel is the
    product ``off @ Ld^-T`` and the trailing update ``T - Loff Loff^T``
    (as ``bark_tpu.ops.linalg.blocked_cholesky(impl="pallas")``). The
    inverse factor is assembled by block forward substitution,
    ``E_ij = -E_ii sum_k L_ik E_kj``: matmuls only, no triangular solve.

    A matrix that fails at a pivot of any diagonal block gets NaN over all
    of its L and E, as on the one-launch path; the rest of the batch is
    left alone. (K2 poisons the failed block whole, and the blocks after it
    inherit the NaN, but the blocks before it would stay finite.)
    """
    n = K.shape[-1]
    if n <= block:
        return chol_inv(K)
    nb = -(-n // block)
    npad = nb * block
    batch = K.shape[:-2]
    Kp = torch.zeros((*batch, npad, npad), dtype=K.dtype, device=K.device)
    Kp[..., :n, :n] = K
    pad = torch.arange(n, npad, device=K.device)
    Kp[..., pad, pad] = 1.0

    Lb = [[None] * nb for _ in range(nb)]  # Lb[i][j]: (block, block) of L
    Ed = []  # inverses of the diagonal blocks
    T = Kp  # trailing matrix, shrinks by one block per panel
    for p in range(nb):
        Ld, Einv = chol_inv(T[..., :block, :block])
        Lb[p][p] = Ld
        Ed.append(Einv)
        if p + 1 < nb:
            Loff = T[..., block:, :block] @ Einv.transpose(-1, -2)
            for i in range(p + 1, nb):
                s = (i - p - 1) * block
                Lb[i][p] = Loff[..., s : s + block, :]
            T = T[..., block:, block:] - Loff @ Loff.transpose(-1, -2)

    Eb = [[None] * nb for _ in range(nb)]
    for i in range(nb):
        Eb[i][i] = Ed[i]
        for j in range(i):
            acc = sum(Lb[i][k] @ Eb[k][j] for k in range(j, i))
            Eb[i][j] = -(Ed[i] @ acc)

    zeros = torch.zeros((*batch, block, block), dtype=K.dtype, device=K.device)
    failed = torch.stack([torch.isnan(e[..., 0, 0]) for e in Ed]).any(0)[..., None, None]

    def assemble(blocks):
        rows = [
            torch.cat([blocks[i][j] if j <= i else zeros for j in range(nb)], -1)
            for i in range(nb)
        ]
        return torch.where(failed, torch.nan, torch.cat(rows, -2)[..., :n, :n])

    return assemble(Lb), assemble(Eb)


def chol_inv_logdet(K: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense inverse and logdet of PD matrices K (..., N, N) via K2."""
    L, E = blocked_cholesky(K)
    K_inv = E.transpose(-1, -2) @ E
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    return K_inv, logdet


def robust_cholesky(
    K: torch.Tensor, shifts: tuple[float, ...]
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(L, L^-1)`` of K (..., N, N) with diagonal escalation per matrix.

    Every matrix is factored once. A matrix whose factorization failed (K2
    and its plain version turn a failed matrix into NaN whole, so a
    non-finite logdet says so) is factored again as ``K + shift I`` for each
    shift in turn until one succeeds; a matrix that fails every shift keeps
    the last attempt's NaN. Each matrix therefore gets the first attempt
    that is finite, as the reference's select over three factorizations of
    the whole batch does, but only the failed matrices are factored again.
    One host check (``.any()``) decides whether any matrix needs it, so this
    belongs to the predict and acquisition paths (once per fit or ask), not
    to the sampler's loop, where a NaN MLL rejects the move.
    """
    n = K.shape[-1]
    flat = K.reshape(-1, n, n)
    L, E = blocked_cholesky(flat)
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    for shift in shifts:
        bad = ~torch.isfinite(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1))
        if not bool(bad.any()):
            break
        idx = torch.nonzero(bad).flatten()
        L[idx], E[idx] = blocked_cholesky(flat[idx] + shift * eye)
        robust_cholesky.escalations += 1
    return L.reshape(K.shape), E.reshape(K.shape)


robust_cholesky.escalations = 0  # factorizations beyond the first, for the chip check


def robust_chol_inv_logdet(
    K: torch.Tensor, escalations: tuple[float, ...] = (1e2, 1e4)
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`chol_inv_logdet` with jitter escalation per matrix.

    The agreement kernel is only PSD up to sampling, so a near-singular
    posterior sample can fail the factorization. A failed matrix is factored
    again as ``K + f * JITTER * I`` for each ``f`` in ``escalations``
    (:func:`robust_cholesky`); ``K^-1 = E^T E`` and the logdet come from the
    attempt that succeeded.
    """
    L, E = robust_cholesky(K, tuple(f * JITTER for f in escalations))
    K_inv = E.transpose(-1, -2) @ E
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    return K_inv, logdet


def gp_posterior(
    K_inv: torch.Tensor, K_xX: torch.Tensor, y: torch.Tensor, prior_var: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and diagonal variance, batched over kernel samples.

    ``K_inv`` (..., N, N), ``K_xX`` (..., M, N), ``y`` (N,), ``prior_var``
    (...): ``mu = K_xX K^-1 y``; ``var = prior_var - diag(K_xX K^-1 K_xX^T)``,
    clamped at 1e-12 (float32 round-off can push a tiny posterior variance
    below zero).
    """
    y = y.reshape(-1)
    mu = (K_xX @ (K_inv @ y)[..., None])[..., 0]
    solve = K_inv @ K_xX.transpose(-1, -2)  # (..., N, M)
    var = prior_var[..., None] - (K_xX * solve.transpose(-1, -2)).sum(-1)
    return mu, var.clamp_min(1e-12)
