"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided in the
fixture, not at import). The machine with the card has no JAX, so this file
imports none and runs without the suite's conftest:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerances: K1 counts integers and divides and masks in the plain
version's order, so kernel and plain version agree exactly;
K2 and cuSOLVER order the same float32 sums differently, so L agrees to
1e-4 (2e-4 through ``blocked_cholesky``, the reference's bound for its
blocked path) and E is an inverse of L to 5e-4 (the bounds of chip_smoke.py, from
the reference's tests/ops/test_pallas_chol.py).
"""

import numpy as np
import pytest
import torch

from bark_tpu_torch.ops.chol import MAX_BLOCK, chol_inv_cuda, chol_inv_plain
from bark_tpu_torch.ops import gram
from bark_tpu_torch.ops.gram import gram_cuda, gram_from_leaves, gram_plain
from bark_tpu_torch.ops.linalg import JITTER, blocked_cholesky, robust_chol_inv_logdet

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _spd(rng, g, bk, rank=16, ridge=0.5):
    a = rng.normal(size=(g, bk, rank)).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) / rank + ridge * np.eye(bk)).astype(np.float32)


def _leaf_ids(rng, shape, node_limit):
    """Ids from a few values spread over [0, node_limit), the top one
    included, so rows agree often and every bit plane is used."""
    vals = np.unique(np.r_[rng.choice(node_limit, min(node_limit, 5), replace=False),
                           node_limit - 1])
    return vals[rng.integers(0, vals.size, shape)]


def _leaves(dev, ids, layout):
    """(B, R, m) int32 on the card, contiguous or as a tree-major view."""
    t = torch.as_tensor(ids, dtype=torch.int32, device=dev)
    return t if layout == "contiguous" else t.transpose(1, 2).contiguous().transpose(1, 2)


@pytest.mark.parametrize(
    "b,n,mcols,m,node_limit",
    [(1, 1, 1, 1, 64), (2, 33, 31, 7, 64), (4, 50, 50, 50, 64), (3, 77, 130, 64, 64),
     (2, 40, 70, 130, 64), (3, 77, 130, 37, 64), (2, 45, 45, 3, 254),
     (2, 45, 50, 37, 300), (2, 64, 64, 65, 300)],
)
@pytest.mark.parametrize("masks", ["none", "shared", "batched"])
@pytest.mark.parametrize("layout", ["contiguous", "tree_major"])
def test_gram_kernel_equals_plain(dev, b, n, mcols, m, node_limit, masks, layout):
    """Ragged tiles, ragged m (a partial last 32-tree word), tree counts
    across the 128-tree staging passes, 6 and 16 bit planes, both mask
    layouts and tree-major leaves (copied by the wrapper): exact equality."""
    rng = np.random.default_rng(b * 1000 + n + m)
    l1 = _leaves(dev, _leaf_ids(rng, (b, n, m), node_limit), layout)
    l2 = _leaves(dev, _leaf_ids(rng, (b, mcols, m), node_limit), layout)

    def mask(*shape):
        return torch.as_tensor((rng.uniform(size=shape) > 0.3).astype(np.float32), device=dev)

    m1, m2 = {
        "none": (None, None),
        "shared": (mask(n), mask(mcols)),
        "batched": (mask(b, n), mask(b, mcols)),
    }[masks]
    before = gram_cuda.launches
    got = gram_cuda(l1, l2, m1, m2, node_limit)
    want = gram_plain(l1, l2, m1, m2)
    torch.cuda.synchronize()
    assert gram_cuda.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 50, 64, 200, 255])
@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("masks", ["none", "shared", "batched"])
def test_gram_symmetric_path_equals_plain(dev, n, tile, masks):
    """The same leaves and mask twice take the symmetric path (the tiles
    with ti <= tj, each mirrored), in one launch, bit-exact against the
    plain version with non-0/1 float masks, at every tile."""
    rng = np.random.default_rng(n * 10 + tile)
    b, m = 3, 50
    leaves = _leaves(dev, _leaf_ids(rng, (b, n, m), 64), "contiguous")
    shape = {"none": None, "shared": (n,), "batched": (b, n)}[masks]
    mask = None if shape is None else torch.as_tensor(
        rng.uniform(0.1, 3.0, shape).astype(np.float32), device=dev)
    want = gram_plain(leaves, leaves, mask, mask)
    plan = gram.launch_plan(b, n, n, m, symmetric=True, tile=tile)
    assert plan.symmetric
    before = gram_cuda.launches
    got = gram.launch(plan, leaves, leaves, mask, mask)
    chosen = gram_cuda(leaves, leaves, mask, mask)
    torch.cuda.synchronize()
    assert gram_cuda.launches == before + 2  # one launch per call
    assert torch.equal(got, want) and torch.equal(chosen, want)


def test_gram_dispatch_flattens_leading_dims(dev):
    rng = np.random.default_rng(5)
    leaves = torch.as_tensor(rng.integers(0, 4, (2, 3, 20, 9)), dtype=torch.int32, device=dev)
    mask = torch.as_tensor(rng.uniform(size=(2, 3, 20)) > 0.5, device=dev)
    before = gram_cuda.launches
    got = gram_from_leaves(leaves, leaves, mask, mask)
    assert gram_cuda.launches == before + 1
    assert got.shape == (2, 3, 20, 20)
    assert torch.equal(got, gram_plain(leaves, leaves, mask, mask))


def test_gram_kernel_rejects_bad_arguments(dev):
    leaves = torch.zeros((2, 8, 5), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        gram_cuda(leaves.long(), leaves.long())
    with pytest.raises(ValueError, match="contiguous"):
        gram_cuda(leaves, leaves, torch.ones(2, 16, device=dev)[:, ::2])
    with pytest.raises(ValueError, match="mask shape"):
        gram_cuda(leaves, leaves, torch.ones(7, device=dev))
    with pytest.raises(ValueError, match="node_limit"):
        gram_cuda(leaves, leaves, node_limit=65537)


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


@pytest.mark.parametrize("s,b,n", [(6, 64, 32), (16, 1024, 224), (4, 4096, 224)])
def test_gram_acquisition_shape_with_the_column_mask_only(dev, s, b, n):
    """K1 as the dense acquisition and predict call it: candidates against
    training leaves, (S, B, N), no row mask and one (N,) column mask shared
    by the batch (the padded rows of a bucket): exact, one launch."""
    rng = np.random.default_rng(s + b)
    m = 50
    cand = _leaves(dev, _leaf_ids(rng, (s, b, m), 64), "contiguous")
    train = _leaves(dev, _leaf_ids(rng, (s, n, m), 64), "contiguous")
    mask = torch.zeros(n, device=dev)
    mask[: n - 24] = 1.0
    before = gram_cuda.launches
    got = gram_from_leaves(cand, train, None, mask, 64)
    torch.cuda.synchronize()
    assert gram_cuda.launches == before + 1
    assert got.shape == (s, b, n)
    assert torch.equal(got, gram_plain(cand, train, None, mask))
    assert not got[..., n - 24:].any() and got[..., : n - 24].any()


def test_robust_chol_inv_logdet_refactors_the_failed_matrix_on_the_card(dev):
    """K2 through the predict path's factorization, (8, 224, 224), with one
    matrix whose smallest eigenvalue is slightly negative: one launch for
    the batch, one more for that matrix with 100 x jitter; it then agrees
    with the plain version factored with that jitter, and the others with
    the plain version as they are."""
    n = 224
    d = _spd(np.random.default_rng(0), 8, n, rank=24)
    w, U = np.linalg.eigh(d[5].astype(np.float64))
    w[0] = -2e-5
    d[5] = ((U * w) @ U.T).astype(np.float32)
    K = torch.as_tensor(d, device=dev)
    before = chol_inv_cuda.launches
    K_inv, logdet = robust_chol_inv_logdet(K)
    torch.cuda.synchronize()
    assert chol_inv_cuda.launches == before + 2
    assert torch.isfinite(K_inv).all() and torch.isfinite(logdet).all()
    shifted = K.clone()
    shifted[5] += 100 * JITTER * torch.eye(n, device=dev)
    Lp, Ep = chol_inv_plain(shifted)
    want = Ep.transpose(1, 2) @ Ep
    good = [i for i in range(8) if i != 5]
    assert (K_inv[good] - want[good]).abs().max().item() <= 1e-3 * want[good].abs().max().item()
    # the refactored matrix is nearly singular (condition number ~1e5)
    assert (K_inv[5] - want[5]).abs().max().item() <= 5e-2 * want[5].abs().max().item()
    want_logdet = 2.0 * torch.log(torch.diagonal(Lp, dim1=1, dim2=2)).sum(-1)
    torch.testing.assert_close(logdet, want_logdet, rtol=1e-4, atol=2e-2)
    # a batch without a failure is one launch
    before = chol_inv_cuda.launches
    robust_chol_inv_logdet(K[:5])
    assert chol_inv_cuda.launches == before + 1
