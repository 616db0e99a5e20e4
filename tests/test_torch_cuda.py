"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided in the
fixture, not at import). The machine with the card has no JAX, so this file
imports none and runs without the suite's conftest:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerances: K1 counts integers, so kernel and plain version agree exactly;
K2 and cuSOLVER order the same float32 sums differently, so L agrees to
1e-4 (2e-4 through ``blocked_cholesky``, the reference's bound for its
blocked path) and E is an inverse of L to 5e-4 (the bounds of chip_smoke.py, from
the reference's tests/ops/test_pallas_chol.py).
"""

import numpy as np
import pytest
import torch

from bark_tpu_torch.ops.chol import MAX_BLOCK, chol_inv_cuda, chol_inv_plain
from bark_tpu_torch.ops.gram import gram_cuda, gram_from_leaves, gram_plain
from bark_tpu_torch.ops.linalg import blocked_cholesky

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _spd(rng, g, bk, rank=16, ridge=0.5):
    a = rng.normal(size=(g, bk, rank)).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) / rank + ridge * np.eye(bk)).astype(np.float32)


@pytest.mark.parametrize(
    "b,n,mcols,m",
    [(1, 1, 1, 1), (2, 33, 31, 7), (4, 50, 50, 50), (3, 77, 130, 64), (2, 40, 70, 130)],
)
@pytest.mark.parametrize("masks", ["none", "shared", "batched"])
def test_gram_kernel_equals_plain(dev, b, n, mcols, m, masks):
    """Ragged tiles, tree counts across the 64-tree staging passes, and both
    mask layouts: exact equality."""
    rng = np.random.default_rng(b * 1000 + n)
    l1 = torch.as_tensor(rng.integers(0, 5, (b, n, m)), dtype=torch.int32, device=dev)
    l2 = torch.as_tensor(rng.integers(0, 5, (b, mcols, m)), dtype=torch.int32, device=dev)

    def mask(*shape):
        return torch.as_tensor((rng.uniform(size=shape) > 0.3).astype(np.float32), device=dev)

    m1, m2 = {
        "none": (None, None),
        "shared": (mask(n), mask(mcols)),
        "batched": (mask(b, n), mask(b, mcols)),
    }[masks]
    before = gram_cuda.launches
    got = gram_cuda(l1, l2, m1, m2)
    want = gram_plain(l1, l2, m1, m2)
    torch.cuda.synchronize()
    assert gram_cuda.launches == before + 1
    assert torch.equal(got, want)


def test_gram_dispatch_flattens_leading_dims(dev):
    rng = np.random.default_rng(5)
    leaves = torch.as_tensor(rng.integers(0, 4, (2, 3, 20, 9)), dtype=torch.int32, device=dev)
    mask = torch.as_tensor(rng.uniform(size=(2, 3, 20)) > 0.5, device=dev)
    got = gram_from_leaves(leaves, leaves, mask, mask)
    assert got.shape == (2, 3, 20, 20)
    assert torch.equal(got, gram_plain(leaves, leaves, mask, mask))


def test_gram_kernel_rejects_bad_arguments(dev):
    leaves = torch.zeros((2, 8, 5), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        gram_cuda(leaves.long(), leaves.long())
    with pytest.raises(ValueError, match="contiguous"):
        gram_cuda(leaves.transpose(1, 2), leaves.transpose(1, 2))
    with pytest.raises(ValueError, match="mask shape"):
        gram_cuda(leaves, leaves, torch.ones(7, device=dev))


@pytest.mark.parametrize("bk", [1, 7, 32, 33, 50, 127, 128, 129, 200, 255, MAX_BLOCK])
def test_chol_inv_kernel_matches_plain(dev, bk):
    """Ragged tiles on both sides of every 32-tile edge, up to BK=256."""
    a = torch.as_tensor(_spd(np.random.default_rng(bk), 5, bk), device=dev)
    before = chol_inv_cuda.launches
    L, E = chol_inv_cuda(a)
    Lp, _ = chol_inv_plain(a)
    torch.cuda.synchronize()
    assert chol_inv_cuda.launches == before + 1
    assert (L - Lp).abs().max().item() <= 1e-4
    assert (E @ L - torch.eye(bk, device=dev)).abs().max().item() <= 5e-4
    assert torch.equal(torch.tril(L), L) and torch.equal(torch.tril(E), E)


@pytest.mark.parametrize("bk", [16, 200])
@pytest.mark.parametrize("fault", ["zero_row", "negated"])
def test_chol_inv_kernel_not_positive_definite_is_nan(dev, fault, bk):
    """A pivot <= 0 (an exactly singular matrix with a zero row and column,
    or a negated one) poisons all of that matrix's L and E, as the plain
    version does, and no other matrix of the batch."""
    d = _spd(np.random.default_rng(1), 3, bk)
    if fault == "zero_row":
        d[1, bk // 2, :] = 0.0
        d[1, :, bk // 2] = 0.0
    else:
        d[1] = -d[1]
    a = torch.as_tensor(d, device=dev)
    L, E = chol_inv_cuda(a)
    Lp, Ep = chol_inv_plain(a)
    torch.cuda.synchronize()
    assert torch.isnan(L[1]).all() and torch.isnan(E[1]).all()
    assert torch.isnan(Lp[1]).all() and torch.isnan(Ep[1]).all()
    assert torch.isfinite(L[[0, 2]]).all() and torch.isfinite(E[[0, 2]]).all()
    assert (L[[0, 2]] - Lp[[0, 2]]).abs().max().item() <= 1e-4


def test_chol_inv_kernel_rejects_bad_arguments(dev):
    with pytest.raises(ValueError, match=f"BK={MAX_BLOCK + 1}"):
        chol_inv_cuda(torch.eye(MAX_BLOCK + 1, device=dev)[None])
    with pytest.raises(ValueError, match="float32"):
        chol_inv_cuda(torch.eye(4, device=dev, dtype=torch.float64)[None])


@pytest.mark.parametrize("n,launches", [(200, 1), (255, 1), (300, 2)])
def test_blocked_cholesky_on_the_card(dev, n, launches):
    """The dense tier's N (up to 256) is one launch; N=300 is two 256-blocks
    through the kernel with panels by matmul."""
    K = torch.as_tensor(_spd(np.random.default_rng(n), 4, n, rank=24), device=dev)
    before = chol_inv_cuda.launches
    L, E = blocked_cholesky(K)
    torch.cuda.synchronize()
    assert chol_inv_cuda.launches == before + launches
    assert (L - torch.linalg.cholesky(K)).abs().max().item() <= 2e-4
    assert (E @ L - torch.eye(n, device=dev)).abs().max().item() <= 5e-4


@pytest.mark.parametrize("n", [384, 512])
def test_blocked_cholesky_pivot_faults_on_the_card(dev, n):
    """The leaf tier's R = 384 and 512 (two 256-blocks, two launches): a
    zero pivot in the second diagonal block, one in the first and a
    negated matrix each poison all of that matrix's L and E, as the plain
    version does; the other 125 matrices agree with it."""
    d = _spd(np.random.default_rng(n), 128, n, rank=24)
    for i, row in ((3, n - 40), (5, 60)):
        d[i, row, :] = 0.0
        d[i, :, row] = 0.0
    d[7] = -d[7]
    K = torch.as_tensor(d, device=dev)
    before = chol_inv_cuda.launches
    L, E = blocked_cholesky(K)
    Lp, Ep = chol_inv_plain(K)
    torch.cuda.synchronize()
    assert chol_inv_cuda.launches == before + 2
    good = [i for i in range(128) if i not in (3, 5, 7)]
    for l_, e_ in ((L, E), (Lp, Ep)):
        for i in (3, 5, 7):
            assert torch.isnan(l_[i]).all() and torch.isnan(e_[i]).all()
        assert torch.isfinite(l_[good]).all() and torch.isfinite(e_[good]).all()
    assert (L[good] - Lp[good]).abs().max().item() <= 2e-4
    assert (E[good] @ L[good] - torch.eye(n, device=dev)).abs().max().item() <= 5e-4
