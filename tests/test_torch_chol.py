"""Parity of the port's Cholesky-with-inverse (K2's plain version) and its
blocked factorization with the JAX reference.

Tolerances are the reference's own for its Pallas kernel
(tests/ops/test_pallas_chol.py): L within 5e-5 absolute of the reference
factor, and E an inverse of the emitted L to 5e-4 (|E L - I|), both float32
factorizations by different LAPACK/XLA orderings of the same sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bark_tpu.ops.linalg import chol_inv_logdet as jax_chol_inv_logdet
from bark_tpu.ops.linalg import masked_mll as jax_masked_mll
from bark_tpu.ops.pallas_chol import chol_inv_blocks

from bark_tpu_torch.ops.chol import chol_inv, chol_inv_plain
from bark_tpu_torch.ops.linalg import (
    blocked_cholesky,
    chol_inv_logdet,
    check_matmul_precision,
    kernel_matrix,
    masked_mll,
)


def _spd(rng, g, bk, rank=16, ridge=0.5):
    a = rng.normal(size=(g, bk, rank)).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) / rank + ridge * np.eye(bk)).astype(np.float32)


@pytest.mark.parametrize("g,bk", [(6, 64), (8, 128), (3, 64), (2, 200), (2, 256)])
def test_chol_inv_plain_matches_pallas(g, bk):
    d = _spd(np.random.default_rng(0), g, bk)
    L_ref, E_ref = chol_inv_blocks(jnp.asarray(d), interpret=True)
    L, E = chol_inv_plain(torch.as_tensor(d))
    np.testing.assert_allclose(L.numpy(), np.asarray(L_ref), atol=5e-5)
    resid = (E @ L).numpy() - np.eye(bk, dtype=np.float32)
    assert np.abs(resid).max() < 5e-4
    assert torch.equal(torch.tril(L), L) and torch.equal(torch.tril(E), E)
    # the CPU dispatch takes the plain version
    L2, E2 = chol_inv(torch.as_tensor(d))
    assert torch.equal(L2, L) and torch.equal(E2, E)


def test_chol_inv_not_positive_definite_is_nan():
    """A failed factorization yields NaN (as jnp.linalg.cholesky does), so a
    sampler MLL through it is NaN and the MH step rejects."""
    d = _spd(np.random.default_rng(1), 3, 16)
    d[1] = -d[1]
    L, E = chol_inv_plain(torch.as_tensor(d))
    assert torch.isnan(L[1]).all() and torch.isnan(E[1]).all()
    assert torch.isfinite(L[[0, 2]]).all() and torch.isfinite(E[[0, 2]]).all()
    assert np.isnan(np.asarray(jnp.linalg.cholesky(jnp.asarray(d[1])))).any()


def _break(d, i, fault):
    """Make matrix i of the batch fail at a pivot: an exactly singular
    matrix (a zero row and column) or a negated one."""
    if fault == "zero_row":
        r = d.shape[-1] // 2
        d[i, r, :] = 0.0
        d[i, :, r] = 0.0
    else:
        d[i] = -d[i]
    return d


@pytest.mark.parametrize("bk", [16, 200])
@pytest.mark.parametrize("fault", ["zero_row", "negated"])
def test_chol_inv_pivot_fault_poisons_whole_matrix(fault, bk):
    """A pivot <= 0 turns all of that matrix's L and E into NaN, as the
    reference's Cholesky does, and leaves its neighbours finite; a pivot
    of exactly 0 (the zero row) counts as a failure too."""
    d = _break(_spd(np.random.default_rng(2), 3, bk), 1, fault)
    assert np.isnan(np.asarray(jnp.linalg.cholesky(jnp.asarray(d[1])))).any()
    for L, E in (chol_inv_plain(torch.as_tensor(d)), chol_inv(torch.as_tensor(d))):
        assert torch.isnan(L[1]).all() and torch.isnan(E[1]).all()
        assert torch.isfinite(L[[0, 2]]).all() and torch.isfinite(E[[0, 2]]).all()


@pytest.mark.parametrize(
    "n,fault,row",
    [(384, "zero_row", 300), (384, "zero_row", 100), (512, "zero_row", 400), (384, "negated", 0)],
)
def test_blocked_cholesky_pivot_fault_poisons_whole_matrix(n, fault, row):
    """Above 256 (the leaf tier's R = 384 and 512, blocked at 256) a pivot
    failure in any diagonal block, the second one included, turns all of
    that matrix's L and E into NaN, as the one-launch path does, and the
    other matrices of the batch still factor to torch.linalg.cholesky's L
    (atol 2e-4)."""
    d = _spd(np.random.default_rng(n + row), 3, n, rank=24)
    if fault == "zero_row":
        d[1, row, :] = 0.0
        d[1, :, row] = 0.0
    else:
        d[1] = -d[1]
    L, E = blocked_cholesky(torch.as_tensor(d))
    assert torch.isnan(L[1]).all() and torch.isnan(E[1]).all()
    good = torch.as_tensor(d[[0, 2]])
    assert torch.isfinite(L[[0, 2]]).all() and torch.isfinite(E[[0, 2]]).all()
    np.testing.assert_allclose(L[[0, 2]].numpy(), torch.linalg.cholesky(good).numpy(), atol=2e-4)


@pytest.mark.parametrize("n,calls", [(50, 1), (200, 1), (256, 1), (300, 2)])
def test_blocked_cholesky_routing(monkeypatch, n, calls):
    """Every dense-tier N (up to the kernel's 256) is one K2 call, so the
    refresh launches the kernel once per factorization; above 256 the
    factorization is blocked at 256 (two diagonal blocks at N=300)."""
    from bark_tpu_torch.ops import linalg

    shapes = []

    def counting(a):
        shapes.append(tuple(a.shape[-2:]))
        return chol_inv(a)

    monkeypatch.setattr(linalg, "chol_inv", counting)
    K = torch.as_tensor(_spd(np.random.default_rng(n), 2, n, rank=24))
    L, _ = linalg.blocked_cholesky(K)
    assert len(shapes) == calls
    assert all(s == (min(n, 256),) * 2 for s in shapes)
    np.testing.assert_allclose(L.numpy(), torch.linalg.cholesky(K).numpy(), atol=2e-4)


@pytest.mark.parametrize("n,batch", [(200, (2, 3)), (300, (2,)), (256, (1,))])
def test_blocked_cholesky_with_identity_padding(n, batch):
    """N <= 256 is one K2 call (the kernel pads inside); N=300 is blocked at
    256, padded with an identity block to 512. L agrees with
    torch.linalg.cholesky (atol 2e-4, the reference's bound for its blocked
    path) and E is the inverse of L."""
    rng = np.random.default_rng(3)
    K = torch.as_tensor(_spd(rng, int(np.prod(batch)), n, rank=24).reshape(*batch, n, n))
    L, E = blocked_cholesky(K)
    assert L.shape == K.shape and E.shape == K.shape
    np.testing.assert_allclose(L.numpy(), torch.linalg.cholesky(K).numpy(), atol=2e-4)
    resid = (E @ L - torch.eye(n)).abs().max().item()
    assert resid < 5e-4
    assert torch.equal(torch.tril(L), L) and torch.equal(torch.tril(E), E)


@pytest.mark.parametrize("n", [50, 200])
def test_chol_inv_logdet_and_mll_match_reference(n):
    """K^-1 (rtol 1e-3 / atol 2e-3) and logdet (rtol 1e-4 / atol 1e-3) on an
    agreement-kernel matrix, the tolerances of the reference's own
    maintained-vs-rebuilt check (tests/fitting/test_sampler.py); the masked
    MLL to the logdet's tolerance."""
    rng = np.random.default_rng(4)
    leaves = rng.integers(0, 6, (n, 20)).astype(np.int32)
    gram = (leaves[:, None, :] == leaves[None, :, :]).mean(-1).astype(np.float32)
    mask = (rng.uniform(size=n) > 0.1).astype(np.float32)
    gram = gram * mask[:, None] * mask[None, :]
    y = (rng.standard_normal(n) * mask).astype(np.float32)
    noise, scale = np.float32(0.05), np.float32(1.3)
    K = gram * scale + (1e-6 + noise) * np.eye(n, dtype=np.float32)

    K_inv, logdet = chol_inv_logdet(torch.as_tensor(K))
    Kt = kernel_matrix(torch.as_tensor(gram), torch.tensor(noise), torch.tensor(scale))
    np.testing.assert_allclose(Kt.numpy(), K, rtol=1e-6)
    ref_inv, ref_logdet = jax_chol_inv_logdet(jnp.asarray(K))
    np.testing.assert_allclose(K_inv.numpy(), np.asarray(ref_inv), rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(float(logdet), float(ref_logdet), rtol=1e-4, atol=1e-3)

    pad = torch.tensor(float(n - mask.sum()))
    mll = masked_mll(K_inv, logdet, torch.as_tensor(y), torch.tensor(noise), pad)
    ref_mll = jax_masked_mll(
        ref_inv, ref_logdet, jnp.asarray(y), jnp.float32(noise), jnp.float32(pad)
    )
    np.testing.assert_allclose(float(mll), ref_mll, rtol=1e-4, atol=1e-3)


def test_precision_guard():
    """The sampler refuses TF32 / reduced-precision float32 matmuls."""
    check_matmul_precision()
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="highest|allow_tf32"):
            check_matmul_precision()
    finally:
        torch.set_float32_matmul_precision(before)
    check_matmul_precision()
