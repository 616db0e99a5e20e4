"""K1's bit-plane arithmetic and launch plan on the CPU.

The CUDA kernel (``bark_tpu_torch/csrc/gram.cu``) runs only on the card, so
its word arithmetic is emulated here in numpy with the wrapper's own plane
count (``ops/gram.launch_plan``): each 32-bit plane word holds bit p of the
ids of 32 trees, eq = AND over the planes of ~(a_p ^ b_p), started from the
mask of the trees that exist, and the count is the popcount of eq. The
emulation must equal the reference's Pallas kernel (interpret mode) bit for
bit, and its one-hot Gram on the counts (the jitted one-hot path multiplies
by 1/m, which may differ by one float32 ulp). Inputs are made with numpy in
explicit int32/float32 (the suite turns on JAX x64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bark_tpu.forest as jf
from bark_tpu.ops.pallas_gram import gram_from_leaves_pallas

from bark_tpu_torch.ops import gram as g


def emulate_kernel(l1, l2, mask1, mask2, node_limit):
    """The kernel's arithmetic on (N, m) and (M, m) int32 ids, in numpy."""
    n, m = l1.shape
    plan = g.launch_plan(1, n, l2.shape[0], m, node_limit)
    trees = np.arange(plan.words * 32)

    def planes(ids):  # (rows, words, planes) uint32: bit t of word w, plane p
        padded = np.zeros((ids.shape[0], plan.words * 32), np.int64)
        padded[:, :m] = ids
        bits = (padded[:, :, None] >> np.arange(plan.planes)) & 1  # (rows, trees, P)
        bits = bits.reshape(ids.shape[0], plan.words, 32, plan.planes)
        return (bits << np.arange(32)[None, None, :, None]).sum(2).astype(np.uint32)

    a, b = planes(l1), planes(l2)
    valid = ((trees < m).reshape(plan.words, 32) << np.arange(32)).sum(1).astype(np.uint32)
    eq = np.broadcast_to(valid, (n, l2.shape[0], plan.words)).copy()
    for p in range(plan.planes):
        eq &= ~(a[:, None, :, p] ^ b[None, :, :, p])
    counts = np.unpackbits(eq.view(np.uint8), axis=-1).reshape(*eq.shape[:2], -1).sum(-1)
    sim = counts.astype(np.float32) / np.float32(m)
    if mask1 is not None:
        sim = sim * mask1[:, None]
    if mask2 is not None:
        sim = sim * mask2[None, :]
    return counts, sim


def leaf_ids(rng, shape, node_limit):
    """Ids from a few values spread over [0, node_limit), the top one
    included, so lanes agree often and use their high bits."""
    vals = np.unique(np.r_[rng.choice(node_limit, min(node_limit, 5), replace=False),
                           node_limit - 1])
    return vals[rng.integers(0, vals.size, shape)].astype(np.int32)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("node_limit", [64, 254, 300])
@pytest.mark.parametrize("m", [1, 3, 4, 37, 50, 65])
def test_lane_rule_equals_reference(m, node_limit, masked):
    rng = np.random.default_rng(m * 1000 + node_limit)
    n, mcols = 9, 13
    l1 = leaf_ids(rng, (n, m), node_limit)
    l2 = leaf_ids(rng, (mcols, m), node_limit)
    m1 = m2 = None
    if masked:
        m1 = rng.uniform(0.2, 1.5, n).astype(np.float32)
        m2 = (rng.uniform(size=mcols) > 0.3).astype(np.float32)
    counts, got = emulate_kernel(l1, l2, m1, m2, node_limit)
    assert got.dtype == np.float32

    jm1 = None if m1 is None else jnp.asarray(m1)
    jm2 = None if m2 is None else jnp.asarray(m2)
    pallas = np.asarray(
        gram_from_leaves_pallas(jnp.asarray(l1), jnp.asarray(l2), jm1, jm2, interpret=True)
    )
    np.testing.assert_array_equal(got, pallas)
    onehot = np.asarray(
        jf.gram_from_leaves(jnp.asarray(l1), jnp.asarray(l2), node_limit, jm1, jm2)
    )
    if not masked:
        np.testing.assert_array_equal(counts, np.rint(onehot * m))
    # one ulp from the multiply by 1/m, and one more rounding of that
    # difference through the float row mask
    np.testing.assert_allclose(got, onehot, rtol=2**-22 if masked else 2**-23, atol=0)
    # and the port's plain version, the kernel's oracle on the card
    t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
    plain = g.gram_plain(t(l1), t(l2), t(m1), t(m2), node_limit).numpy()
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize(
    "node_limit,planes",
    [(1, 6), (2, 6), (64, 6), (65, 16), (254, 16), (300, 16), (65536, 16)],
)
def test_plane_count(node_limit, planes):
    """The fewest instantiated planes whose ids reach node_limit - 1."""
    assert g.planes_for(node_limit) == planes
    assert 2**planes >= node_limit


@pytest.mark.parametrize("node_limit", [0, 65537, 100_000])
def test_node_limit_out_of_range_raises(node_limit):
    with pytest.raises(ValueError, match="node_limit"):
        g.launch_plan(64, 50, 50, 50, node_limit)


def test_launch_plan_at_the_dense_tier_headline():
    """(64, 50, 50), m = 50: the symmetric call (the sampler's) takes
    16-tiles, 640 jobs for blocks of 64 threads; a non-symmetric one
    32-tiles, 256 jobs. Both keep at least MIN_JOBS."""
    sym = g.launch_plan(64, 50, 50, 50, symmetric=True)
    assert (sym.tile, sym.micro, sym.threads) == (16, 2, 64)
    assert (sym.tiles, sym.cols, sym.jobs) == (10, 4, 640)
    assert (sym.planes, sym.words) == (6, 2)
    full = g.launch_plan(64, 50, 50, 50)
    assert (full.tile, full.micro, full.threads) == (32, 4, 64)
    assert (full.tiles, full.cols, full.jobs) == (4, 2, 256)
    assert min(sym.jobs, full.jobs) >= g.MIN_JOBS


def decode(plan, job):
    """The kernel's job decode (csrc/gram.cu, decode): (chain, row tile,
    column tile, mirrored)."""
    b, t = divmod(job, plan.tiles)
    if not plan.symmetric:
        return b, t // plan.cols, t % plan.cols, False
    ti = 0
    while t >= plan.cols - ti:
        t -= plan.cols - ti
        ti += 1
    return b, ti + t, ti, t != 0


@pytest.mark.parametrize("shape", [(64, 200, 200), (64, 1024, 200), (3, 77, 130), (1, 5, 5)])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("tile", [None, 16, 32])
def test_launch_plan_covers_every_tile(shape, symmetric, tile):
    """The jobs cover every output tile once, a symmetric call's through
    its mirrors; a symmetric job takes its rows from the later tile."""
    b, n, mcols = shape
    if symmetric:
        mcols = n
    plan = g.launch_plan(b, n, mcols, 50, symmetric=symmetric, tile=tile)
    assert plan.micro == dict(g.TILES)[plan.tile]
    rows, cols = -(-n // plan.tile), -(-mcols // plan.tile)
    seen = []
    for job in range(plan.jobs):
        c, it, jt, mirror = decode(plan, job)
        assert it >= jt or not symmetric
        seen.append((c, it, jt))
        if mirror:
            seen.append((c, jt, it))
    assert sorted(seen) == [(c, i, j) for c in range(b) for i in range(rows) for j in range(cols)]


def test_symmetric_path_only_for_the_same_tensors():
    leaves = torch.zeros((2, 8, 5), dtype=torch.int32)
    mask = torch.ones(8)
    assert g.is_symmetric_call(leaves, leaves, mask, mask)
    assert g.is_symmetric_call(leaves, leaves, None, None)
    assert not g.is_symmetric_call(leaves, leaves.clone(), mask, mask)
    assert not g.is_symmetric_call(leaves, leaves, mask, mask.clone())
    assert not g.is_symmetric_call(leaves, leaves, mask, None)
    with pytest.raises(ValueError, match="N == M"):
        g.launch_plan(2, 8, 9, 5, symmetric=True)
    with pytest.raises(ValueError, match="tile"):
        g.launch_plan(2, 8, 8, 5, tile=64)


def test_gram_from_leaves_takes_node_limit_on_the_cpu():
    """The CPU path is the plain version whatever the lane width would be."""
    rng = np.random.default_rng(4)
    leaves = torch.as_tensor(leaf_ids(rng, (2, 11, 7), 300))
    mask = torch.as_tensor(rng.uniform(size=11).astype(np.float32))
    got = g.gram_from_leaves(leaves, leaves, mask, mask, node_limit=300)
    assert torch.equal(got, g.gram_plain(leaves, leaves, mask, mask))
