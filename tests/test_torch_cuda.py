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
the reference's tests/ops/test_pallas_chol.py). K3, the move scan, sums its
products in another order than its twin's cuBLAS calls, so its decisions
agree up to near-ties and its log alphas are held to the float64 loop's (see
its test).
"""

import numpy as np
import pytest
import torch

from bark_tpu_torch.ops.chol import MAX_BLOCK, chol_inv_cuda, chol_inv_plain
from bark_tpu_torch.ops import gram
from bark_tpu_torch.ops.gram import gram_cuda, gram_from_leaves, gram_plain
from bark_tpu_torch.ops.linalg import JITTER, blocked_cholesky, robust_chol_inv_logdet
from bark_tpu_torch.ops.scan import MAX_N, move_scan_cuda

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


def test_kernel_time_falls_back_to_events_on_the_card(dev, monkeypatch):
    """With every profiler capture refused, ``kernel_time`` times K2 at the
    PT round's (64, 256, 256) with CUDA events behind a device spin: one
    launch a call, a time between half and 1.1 times the call time (events
    around back-to-back calls, the host's enqueueing included)."""
    from bark_tpu_torch.benchmarks import kernel_timing

    A = torch.as_tensor(_spd(np.random.default_rng(0), 64, 256), device=dev)
    run = lambda: chol_inv_cuda(A)  # noqa: E731
    call = kernel_timing.call_ms(torch, run)

    def refused(*_, **__):
        raise RuntimeError("the profiler captured 0 of the 20 device kernels")

    monkeypatch.setattr(kernel_timing, "device_ms", refused)
    before = chol_inv_cuda.launches
    ms, per_call, split, source = kernel_timing.kernel_time(torch, run, "chol_inv_kernel", 1)
    assert source == "events" and per_call == 1 and split == {}
    assert chol_inv_cuda.launches - before == 3 + 20 + 3 * 20
    assert 0.5 * call <= ms <= 1.1 * call, (ms, call)


@pytest.mark.parametrize("n,mcols", [(24, 24), (200, 200), (300, 300), (1024, 200),
                                     (4096, 200), (2048, 300), (300, 1)])
def test_gram_single_forest_shapes(dev, n, mcols):
    """K1 at the single-forest shapes of LeafGP and LeafMOGP: unbatched
    (N, m) leaves, G = 1, the same tensor twice on the symmetric path (the
    fits' Grams) and candidates against training leaves (predict, scoring):
    exact, one launch."""
    rng = np.random.default_rng(n + mcols)
    l1 = _leaves(dev, _leaf_ids(rng, (1, n, 50), 64), "contiguous")[0]
    l2 = l1 if n == mcols else _leaves(dev, _leaf_ids(rng, (1, mcols, 50), 64),
                                       "contiguous")[0]
    before = gram_cuda.launches
    got = gram_from_leaves(l1, l2, node_limit=64)
    torch.cuda.synchronize()
    assert gram_cuda.launches == before + 1
    assert gram.launch_plan(1, n, mcols, 50, 64, l1 is l2).jobs > 0
    assert got.shape == (n, mcols) and torch.equal(got, gram_plain(l1, l2))


@pytest.mark.parametrize("n,launches", [(24, 1), (200, 1), (256, 1), (300, 2)])
def test_robust_chol_inv_logdet_single_matrix(dev, n, launches):
    """K2 as the LeafGP and MOGP builds call it: one unbatched (N, N)
    kernel matrix, G = 1; one launch up to 256, two through
    ``blocked_cholesky`` at 300; K^-1 within 1e-3 of the plain version's
    largest entry."""
    K = torch.as_tensor(_spd(np.random.default_rng(n), 1, n, rank=24)[0], device=dev)
    before = chol_inv_cuda.launches
    K_inv, logdet = robust_chol_inv_logdet(K)
    torch.cuda.synchronize()
    assert chol_inv_cuda.launches == before + launches
    Lp, Ep = chol_inv_plain(K[None])
    want = (Ep.transpose(1, 2) @ Ep)[0]
    assert K_inv.shape == (n, n)
    assert (K_inv - want).abs().max().item() <= 1e-3 * want.abs().max().item()
    want_logdet = 2.0 * torch.log(torch.diagonal(Lp[0])).sum()
    torch.testing.assert_close(logdet, want_logdet, rtol=1e-4, atol=1e-3)


def test_leafgp_and_mogp_on_the_card_agree_with_the_cpu(dev):
    """The booster surrogates on the card and on the CPU from the same data:
    the same forests; LeafGP's hyperparameters within 2e-3 relative and its
    predictions within 1e-3 + 1e-3 |value|. LeafMOGP's 300 Adam steps carry
    float32 round-off far along the flat directions of its MLL (its
    parameters part by percents between the card and the CPU), so its fit
    is held to climbing from Adam's start, and its predictions to 1e-3 +
    1e-3 |value| from one set of parameters on both devices."""
    from bark_tpu_torch.benchmarks import map_benchmark
    from bark_tpu_torch.models.leafgp import LeafGPSurrogate
    from bark_tpu_torch.models.mogp import LeafMOGPSurrogate, MOGPParams, _mogp_mll

    bench = map_benchmark("TreeFunction", dim=3, m=10, function_seed=2)
    X = bench.domain.sample(60, np.random.default_rng(0))
    C = bench.domain.sample(100, np.random.default_rng(1))
    y = bench.f(X)
    card = LeafGPSurrogate(bench.domain, num_boost_round=20).fit(X, y)
    host = LeafGPSurrogate(bench.domain, num_boost_round=20, device="cpu").fit(X, y)
    assert card.device.type == "cuda"
    for a, b in zip(card.model.forest, host.model.forest):
        assert torch.equal(a.cpu(), b)
    torch.testing.assert_close(card.model.noise.cpu(), host.model.noise, rtol=2e-3, atol=0)
    torch.testing.assert_close(card.model.scale.cpu(), host.model.scale, rtol=2e-3, atol=0)
    for a, b in zip(card.predict(C), host.predict(C)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)
    fid = np.arange(60) % 2
    card = LeafMOGPSurrogate(bench.domain, num_boost_round=20).fit(X, fid, y)
    host = LeafMOGPSurrogate(bench.domain, num_boost_round=20, device="cpu").fit(X, fid, y)
    for a, b in zip(card.forest, host.forest):
        assert torch.equal(a.cpu(), b)
    _, tasks, y_std, _, gram = card.train
    start = MOGPParams(torch.ones(2, device=dev), torch.zeros(2, device=dev),
                       torch.full((2,), -1.5, device=dev))
    assert _mogp_mll(card.params, gram, tasks, y_std) >= _mogp_mll(start, gram, tasks, y_std)
    host.params = MOGPParams(*(p.cpu() for p in card.params))
    tasks = np.arange(100) % 2
    for a, b in zip(card.predict(C, tasks), host.predict(C, tasks)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)


def test_bart_two_runs_from_one_seed_are_equal_on_the_card(dev):
    """The residual sums are fixed-order products (no float atomics), so two
    runs from one generator seed give equal trees, leaf values and sigma2."""
    from bark_tpu_torch.fitting.bart import BARTParams, run_bart_sampler

    rng = np.random.default_rng(6)
    X = torch.as_tensor(rng.uniform(size=(300, 3)).astype(np.float32), device=dev)
    y = torch.as_tensor(np.sin(6 * rng.uniform(size=300)).astype(np.float32) * 0.4, device=dev)
    bounds = torch.tensor([[0.0, 1.0]] * 3, device=dev)
    ft = torch.full((3,), 2, dtype=torch.int32, device=dev)
    params = BARTParams(warmup_steps=20, num_samples=5, num_chains=3, num_trees=20)
    before = (gram_cuda.launches, chol_inv_cuda.launches)
    runs = [run_bart_sampler(torch.Generator(device=dev).manual_seed(1), X, y, bounds, ft,
                             params, 0.01) for _ in range(2)]
    for a, b in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        assert torch.equal(a, b)
    assert (gram_cuda.launches, chol_inv_cuda.launches) == before  # BART runs neither


@pytest.mark.parametrize("s,n,mcols", [(32, 16384, 64), (32, 64, 64)])
def test_gram_grid_ucb_shapes(dev, s, n, mcols):
    """K1 at the grid-UCB ask's predict shapes: K_xX over the 16,384-point
    grid and K_XX (symmetric), masked columns, exact."""
    rng = np.random.default_rng(n)
    l2 = _leaves(dev, _leaf_ids(rng, (s, mcols, 50), 64), "contiguous")
    l1 = l2 if n == mcols else _leaves(dev, _leaf_ids(rng, (s, n, 50), 64), "contiguous")
    mask = torch.as_tensor((np.arange(mcols) < 50).astype(np.float32), device=dev)
    m1 = mask if l1 is l2 else None
    assert torch.equal(gram_cuda(l1, l2, m1, mask), gram_plain(l1, l2, m1, mask))


def test_chol_inv_grid_ucb_shape(dev):
    a = torch.as_tensor(_spd(np.random.default_rng(2), 32, 64), device=dev)
    L, E = chol_inv_cuda(a)
    Lp, _ = chol_inv_plain(a)
    assert (L - Lp).abs().max().item() <= 1e-4
    assert (E @ L - torch.eye(64, device=dev)).abs().max().item() <= 5e-4


def test_grid_ucb_ask_on_the_card_agrees_with_the_cpu(dev):
    """One grid-UCB ask over BARK on the card and from the same posterior and
    normals on the CPU: the same grid point (or one whose LCB on the card is
    within 1e-5 relative of the card's maximum)."""
    from bark_tpu_torch.benchmarks import map_benchmark
    from bark_tpu_torch.fitting.params import SamplerParams
    from bark_tpu_torch.models.surrogate import BARKSurrogate
    from bark_tpu_torch.strategies.baselines import GridUCBStrategy, reparam_lcb

    bench = map_benchmark("TreeFunction", dim=3, m=20, function_seed=2)
    params = SamplerParams(num_chains=2, num_samples=4, steps_per_sample=2, warmup_steps=10,
                           num_trees=20)
    s = GridUCBStrategy(bench.domain, seed=1, params=params, max_grid=4096)
    X = bench.domain.sample(40, np.random.default_rng(1))
    s.tell(X, bench.f(X))
    eps = np.random.default_rng(2).standard_normal((1, 8, 4096))
    x = s.ask(1, eps=eps)
    grid = bench.domain.sample_sobol(4096, seed=1)
    sur = s.surrogate
    host = BARKSurrogate(bench.domain, params, device="cpu")
    host.model = type(sur.model)(sur.model.forest.to("cpu"), sur.model.noise.cpu(),
                                 sur.model.scale.cpu())
    host.train_data = tuple(t.cpu() for t in sur.train_data)
    host.train_mask, host.scaler = sur.train_mask.cpu(), sur.scaler
    lcb = reparam_lcb(sur.function_samples(grid, eps=eps), s.kappa)
    lcb_c = reparam_lcb(host.function_samples(grid, eps=eps), s.kappa)
    np.testing.assert_allclose(lcb, lcb_c, rtol=1e-4, atol=1e-4 * np.abs(lcb_c).max())
    assert np.array_equal(x[0], grid[int(np.argmax(lcb))])
    i_c = int(np.argmax(lcb_c))
    assert abs(lcb.max() - lcb[i_c]) <= 1e-5 * abs(lcb.max())


def _scan_case(dev, chains, n, pads, seed=0, steps=20):
    """The move scan's inputs on the card: a state after ``steps`` sampler
    steps from empty forests (TreeFunction(dim=5, m=50), the last ``pads``
    rows masked), then one step's proposal batch and update patterns.
    Returns (state, batch, W_pat, y, mask, pad_count, params)."""
    from bark_tpu_torch.benchmarks.tree_function import TreeFunction
    from bark_tpu_torch.fitting import sampler
    from bark_tpu_torch.fitting.params import SamplerParams
    from bark_tpu_torch.forest import create_empty_forest

    tf = TreeFunction(dim=5, m=50, function_seed=1)
    rng = np.random.default_rng(seed)
    X_np = tf.domain.sample(n, rng)
    y_np = tf.f(X_np)
    y_np = (y_np - y_np.mean()) / y_np.std()
    y_np[n - pads:] = 0.0
    X = torch.as_tensor(X_np, device=dev)
    y = torch.as_tensor(y_np, dtype=torch.float32, device=dev)
    mask = torch.ones(n, device=dev)
    mask[n - pads:] = 0.0
    ft = torch.as_tensor(tf.domain.feature_types(), device=dev)
    bounds = torch.as_tensor(tf.domain.bounds("bitmask"), device=dev)
    params = SamplerParams(warmup_steps=steps, num_samples=1, steps_per_sample=1,
                           num_chains=chains, num_trees=50)
    model = sampler.BARKModel(create_empty_forest(50, params.node_limit, (chains,), dev),
                              torch.full((chains,), 0.1, device=dev),
                              torch.ones(chains, device=dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = sampler.run_chain(gen, model, X, y, bounds, ft, params, mask=mask).state
    params = sampler._resolve_styles(params, n)
    draws = sampler.draw_step(gen, chains, params, dev)
    packed0, batch = sampler._propose_all_trees(state, X, ft, bounds, params, draws.proposal)
    W_pat = sampler._update_patterns(packed0, batch, mask)
    return state, batch, W_pat, y, mask, n - mask.sum(), params


def _float64(x):
    """``x`` with every float tensor in it, inside tuples and named tuples,
    in float64."""
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if isinstance(x, tuple):
        items = [_float64(t) for t in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


@pytest.mark.parametrize("beta", ["one", "per-chain"])
@pytest.mark.parametrize("chains,n,pads,seed", [(64, 50, 0, 0), (4, 64, 6, 0), (4, 64, 14, 0),
                                                (16, 200, 0, 1), (8, MAX_N, 0, 1),
                                                (8, MAX_N, 0, 2)])
def test_move_scan_kernel_matches_its_twin(dev, chains, n, pads, seed, beta):
    """K3 against the torch loop on the card, from a state 20-40 steps from
    empty forests, move by move until a chain reaches a near-tie (u within
    1e-5 of the float32 or the float64 loop's acceptance probability) or the
    float64 loop decides otherwise than the float32 one:

      - the accepts are the float32 loop's;
      - the log alphas lie no farther from the float64 loop's than 1e-4
        beyond the float32 loop's farthest, and at the cells' N (50, 64)
        within 1e-4 of the float32 loop's. From N ~ 128 the float32 loop is
        itself up to ~2e-3 off the float64 one (MLL terms near 1,000 in
        float32), so there the kernel is held to float64.
    """
    from bark_tpu_torch.fitting import sampler

    args = _scan_case(dev, chains, n, pads, seed=seed, steps=20 + 10 * seed)
    b = 1.0 if beta == "one" else torch.linspace(0.2, 1.0, chains, device=dev)
    before = move_scan_cuda.launches
    acc, la = sampler._scan_plain(*args, b)
    torch.cuda.synchronize()
    assert move_scan_cuda.launches == before + 1
    assert acc.shape == la.shape == (chains, 50) and acc.dtype == torch.bool
    want_acc, want_la = (torch.stack(t, 1) for t in sampler._scan_plain_loop(*args, b))
    acc64, la64 = (torch.stack(t, 1) for t in sampler._scan_plain_loop(*_float64(args),
                                                                      _float64(b)))
    u = args[1].u_accept.double()
    tie = ((u - torch.exp(torch.clamp_max(want_la.double(), 0.0))).abs() <= 1e-5) | (
        (u - torch.exp(torch.clamp_max(la64, 0.0))).abs() <= 1e-5) | (acc64 != want_acc)
    stop = torch.where(tie.any(1), tie.int().argmax(1), 50)
    compared = torch.arange(50, device=dev) < stop[:, None]
    assert torch.equal(acc[compared], want_acc[compared])
    assert torch.equal(torch.isinf(la[compared]), torch.isinf(want_la[compared]))
    fin = compared & torch.isfinite(la64)
    kernel_gap = (la[fin].double() - la64[fin]).abs().max().item()
    loop_gap = (want_la[fin].double() - la64[fin]).abs().max().item()
    assert kernel_gap <= loop_gap + 1e-4, (kernel_gap, loop_gap)
    if n <= 64:
        assert (la[fin] - want_la[fin]).abs().max().item() <= 1e-4
    assert compared.sum() >= 0.75 * chains * 50
    assert 0 < want_acc.float().mean() < 1


def test_run_chain_launches_the_scan_kernel_once_a_step(dev):
    """50 steps of the dense tier at 64 chains: one K3 launch a step, none in
    the init."""
    from bark_tpu_torch.benchmarks.tree_function import TreeFunction
    from bark_tpu_torch.fitting.params import SamplerParams
    from bark_tpu_torch.fitting.sampler import BARKModel, run_chain
    from bark_tpu_torch.forest import create_empty_forest

    tf = TreeFunction(dim=5, m=50, function_seed=1)
    X_np = tf.domain.sample(50, np.random.default_rng(0))
    y_np = tf.f(X_np)
    X = torch.as_tensor(X_np, device=dev)
    y = torch.as_tensor((y_np - y_np.mean()) / y_np.std(), dtype=torch.float32, device=dev)
    params = SamplerParams(warmup_steps=0, num_samples=10, steps_per_sample=5, num_chains=64,
                           num_trees=50)
    model = BARKModel(create_empty_forest(50, params.node_limit, (64,), dev),
                      torch.full((64,), 0.1, device=dev), torch.ones(64, device=dev))
    before = move_scan_cuda.launches
    run = run_chain(torch.Generator(device=dev).manual_seed(0), model, X, y,
                    torch.as_tensor(tf.domain.bounds("bitmask"), device=dev),
                    torch.as_tensor(tf.domain.feature_types(), device=dev), params)
    torch.cuda.synchronize()
    assert move_scan_cuda.launches - before == 50
    assert 0 < run.tree_accept_rate.mean().item() < 1
