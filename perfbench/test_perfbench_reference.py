"""The yardstick on the CPU: the reference against hand-worked cases, each
frozen copy against the code it was copied from, the roofline counts
against worked shapes, and the metric readers on a synthetic trace."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from perfbench.data import tree_function as frozen
from perfbench.lib import readers
from perfbench.lib.trace import Event, Trace, breakdown
from perfbench.reference import forest as ref_forest
from perfbench.reference import gp, moves
from perfbench.roofline import counts


def two_trees():
    """Tree 0 splits x0 at 0.5; tree 1 is a lone root. As (1, 2, 4) fields."""
    f = {k: torch.zeros((1, 2, 4), dtype=torch.int32) for k in frozen.FIELDS}
    f["is_leaf"] = torch.zeros((1, 2, 4), dtype=torch.bool)
    f["active"] = torch.zeros((1, 2, 4), dtype=torch.bool)
    f["threshold"] = torch.zeros((1, 2, 4))
    f["active"][0, 0, :3] = True
    f["is_leaf"][0, 0, 1:3] = True
    f["threshold"][0, 0, 0] = 0.5
    f["left"][0, 0, 0], f["right"][0, 0, 0] = 1, 2
    f["parent"][0, 0, 1:3] = 0
    f["depth"][0, 0, 1:3] = 1
    f["active"][0, 1, 0] = True
    f["is_leaf"][0, 1, 0] = True
    return f


X3 = torch.tensor([[0.2, 0.9], [0.5, 0.1], [0.7, 0.3]])
CONT = torch.tensor([2, 2], dtype=torch.int32)
BOUNDS = torch.tensor([[0.0, 1.0], [0.0, 1.0]])


def test_route_and_agreement_by_hand():
    leaves = ref_forest.route(two_trees(), X3, CONT)
    assert leaves[0].tolist() == [[1, 0], [1, 0], [2, 0]]  # x <= 0.5 goes left
    counts_ = ref_forest.agreement(leaves, leaves)[0]
    assert counts_.tolist() == [[2, 2, 1], [2, 2, 1], [1, 1, 2]]
    live = torch.tensor([[True, False]])
    assert ref_forest.agreement(leaves, leaves, live)[0].tolist() == [
        [1, 1, 0], [1, 1, 0], [0, 0, 1]]


def test_mll_by_hand():
    """K = s G + (j + nu) I with G = counts / m; mll = -(y K^-1 y + logdet)/2."""
    f = two_trees()
    noise, scale = torch.tensor([0.3], dtype=torch.float64), torch.tensor([2.0])
    y = torch.tensor([1.0, -0.5, 0.25], dtype=torch.float64)
    got = gp.chain_state(f, noise, scale, X3, y, CONT, m=2, jitter=1e-6, keep_kinv=True)
    G = np.array([[2, 2, 1], [2, 2, 1], [1, 1, 2]]) / 2
    K = 2.0 * G + (1e-6 + 0.3) * np.eye(3)
    yv = y.numpy()
    want = -0.5 * (yv @ np.linalg.solve(K, yv) + np.linalg.slogdet(K)[1])
    assert math.isclose(float(got["mll"][0]), want, rel_tol=1e-12)
    np.testing.assert_allclose(got["K_inv"][0].numpy(), np.linalg.inv(K), rtol=1e-10)


def test_lcb_by_hand():
    f = two_trees()
    noise, scale = torch.tensor([0.3], dtype=torch.float64), torch.tensor([2.0])
    y = torch.tensor([1.0, -0.5, 0.25], dtype=torch.float64)
    x = torch.tensor([[0.1, 0.5], [0.9, 0.5]])
    got = gp.lcb(f, noise, scale, X3, y, x, CONT, jitter=0.0, kappa=1.96).numpy()
    G = np.array([[1, 1, 0], [1, 1, 0], [0, 0, 1]], float)  # over the one live tree
    K = 2.0 * G + 0.3 * np.eye(3)
    k = np.array([[1, 1, 0], [0, 0, 1]], float)
    mu = 2.0 * k @ np.linalg.solve(K, y.numpy())
    var = 2.0 - 4.0 * np.einsum("bi,bi->b", k @ np.linalg.inv(K), k)
    np.testing.assert_allclose(got, mu - 1.96 * np.sqrt(var), rtol=1e-12)


def test_leaf_space_mll_equals_the_dense_one():
    """The leaf-space MLL of the move replay against K built whole, on a
    forest of the frozen TreeFunction (12 trees, 40 rows)."""
    fn = frozen.TreeFunction(dim=3, cat_dim=2, m=12, function_seed=4)
    f = {k: torch.as_tensor(v)[None].expand(2, *v.shape).clone() for k, v in fn.fields.items()}
    X = torch.as_tensor(fn.sample(40, np.random.default_rng(1)))
    y = torch.as_tensor(np.random.default_rng(2).normal(size=40))
    ft = torch.as_tensor(fn.feature_types())
    noise = torch.tensor([0.3, 0.01], dtype=torch.float64)
    scale = torch.tensor([2.0, 0.5], dtype=torch.float64)
    dense = gp.chain_state(f, noise, scale, X, y, ft, m=12, jitter=1e-6)
    leaves = ref_forest.route(f, X, ft)
    got, quad, logdet = moves.leaf_mll(leaves, noise, scale, y, 12, 1e-6, 64)
    np.testing.assert_allclose(got.numpy(), dense["mll"].numpy(), rtol=1e-10)
    np.testing.assert_allclose(logdet.numpy(), dense["logdet"].numpy(), rtol=1e-10)


def test_move_deltas_by_hand():
    """Tree 1, a lone root, is proposed to split x1 at 0.5 (move 1); tree 0
    is proposed to prune to its root (move 0). Move 0 rejected, move 1
    accepted: each difference is the MLL of K built whole with and
    without the move, from the forest the earlier moves left."""
    f = two_trees()
    grown = {k: v.clone() for k, v in f.items()}
    grown["is_leaf"][0, 1, 0] = False
    grown["feature"][0, 1, 0] = 1
    grown["threshold"][0, 1, 0] = 0.5
    grown["left"][0, 1, 0], grown["right"][0, 1, 0] = 1, 2
    grown["active"][0, 1, 1:3] = True
    grown["is_leaf"][0, 1, 1:3] = True
    grown["parent"][0, 1, 1:3] = 0
    grown["depth"][0, 1, 1:3] = 1
    proposed = {k: v.clone() for k, v in grown.items()}
    for k in frozen.FIELDS:  # tree 0's proposal: a lone root
        proposed[k][0, 0] = f[k][0, 1]
    noise, scale = torch.tensor([0.3], dtype=torch.float64), torch.tensor([2.0])
    y = torch.tensor([1.0, -0.5, 0.25], dtype=torch.float64)
    accepts = torch.tensor([[False, True]])
    got = moves.move_deltas(f, proposed, accepts, noise, scale, X3, y, CONT, 2, 1e-6)

    def mll(forest):
        return float(gp.chain_state(forest, noise, scale, X3, y, CONT, m=2, jitter=1e-6)["mll"][0])

    pruned = {k: v.clone() for k, v in f.items()}
    for k in frozen.FIELDS:
        pruned[k][0, 0] = f[k][0, 1]
    want = [mll(pruned) - mll(f), mll(grown) - mll(f)]
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-10, atol=1e-12)


def test_invalid_nodes_counts_each_break():
    f = two_trees()
    assert ref_forest.invalid_nodes(f, BOUNDS, CONT).tolist() == [0]
    bad = {k: v.clone() for k, v in f.items()}
    bad["threshold"][0, 0, 0] = 1.5  # outside the domain
    assert ref_forest.invalid_nodes(bad, BOUNDS, CONT).tolist() == [1]
    bad = {k: v.clone() for k, v in f.items()}
    bad["active"][0, 0, 3] = True  # active and unreachable
    bad["is_leaf"][0, 0, 3] = True
    assert ref_forest.invalid_nodes(bad, BOUNDS, CONT).tolist() == [1]
    bad = {k: v.clone() for k, v in f.items()}
    bad["depth"][0, 0, 2] = 3  # child not one level down
    assert ref_forest.invalid_nodes(bad, BOUNDS, CONT).tolist() == [1]


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-12, -3.0])
    assert gp.tf32(x).tolist() == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9, 1.0, -3.0]


# --- frozen copies against the code they were copied from ---------------------


@pytest.mark.parametrize("cat_dim", [0, 2])
def test_tree_function_copy_equals_the_port(cat_dim):
    from bark_tpu_torch.benchmarks.tree_function import TreeFunction

    port = TreeFunction(dim=5 - cat_dim, cat_dim=cat_dim, m=50, function_seed=1)
    copy = frozen.TreeFunction(dim=5 - cat_dim, cat_dim=cat_dim, m=50, function_seed=1)
    for k in frozen.FIELDS:
        np.testing.assert_array_equal(getattr(port.forest, k).numpy(), copy.fields[k])
    np.testing.assert_array_equal(port.leaf_values, copy.leaf_values)
    X = port.domain.sample(200, np.random.default_rng(5))
    np.testing.assert_array_equal(X, copy.sample(200, np.random.default_rng(5)))
    np.testing.assert_array_equal(port.f(X), copy.f(X))
    np.testing.assert_array_equal(port.domain.bounds("bitmask"), copy.bounds("bitmask"))
    np.testing.assert_array_equal(port.domain.bounds("ordinal"), copy.bounds("ordinal"))
    np.testing.assert_array_equal(port.domain.feature_types(), copy.feature_types())


def test_reference_routing_and_gram_equal_the_ports():
    from bark_tpu_torch.forest import route_forest
    from bark_tpu_torch.ops.gram import gram_plain

    fn = frozen.TreeFunction(dim=3, cat_dim=2, m=12, function_seed=4)
    f = {k: torch.as_tensor(v)[None] for k, v in fn.fields.items()}
    X = torch.as_tensor(fn.sample(40, np.random.default_rng(1)))
    ft = torch.as_tensor(fn.feature_types())
    from bark_tpu_torch.forest import Forest

    port_leaves = route_forest(Forest(*(f[k] for k in frozen.FIELDS)), X, ft)
    leaves = ref_forest.route(f, X, ft)
    np.testing.assert_array_equal(leaves.numpy(), port_leaves.long().numpy())
    gram = gram_plain(port_leaves, port_leaves)
    np.testing.assert_allclose(ref_forest.agreement(leaves, leaves).numpy() / 12,
                               gram.double().numpy(), rtol=1e-6)


def test_roofline_counts_equal_kernel_timing():
    from bark_tpu_torch.benchmarks import kernel_timing as kt

    for shape, sym, masked in [((64, 50, 50), True, True), ((64, 200, 200), True, True),
                               ((64, 1024, 200), False, False), ((128, 4096, 224), False, True)]:
        want_ms, _ = kt.k1_bound(*shape, 50, sym, masked)
        got_s = counts.bound_s(*counts.k1_work(*shape, 50, sym, masked))
        assert math.isclose(got_s * 1e3, want_ms, rel_tol=1e-12)
    for b, n in [(128, 50), (128, 256), (32, 1600)]:
        want_ms, _ = kt.k2_bound(b, n)
        assert math.isclose(counts.bound_s(*counts.k2_work([n] * b)) * 1e3, want_ms,
                            rel_tol=1e-12)


# --- the roofline counts against worked shapes --------------------------------


def test_k1_symmetric_count():
    """A symmetric call counts N (N + 1) / 2 pairs: the kernel computes the
    upper tiles and mirrors them."""
    bytes_, ops = counts.k1_work(64, 50, 50, 50, symmetric=True, masked=True)
    assert ops == 2 * 64 * (50 * 51 / 2) * 50 == 8_160_000
    assert bytes_ == 4 * (64 * 50 * 50 + 50 + 64 * 50 * 50) == 1_280_200
    # bound by bytes: 1,280,200 B / 3.35 TB/s = 0.382 us (PERF.md's 0.00038 ms)
    assert math.isclose(counts.bound_s(bytes_, ops), 1_280_200 / 3.35e12)
    _, ops = counts.k1_work(2, 10, 7, 3, symmetric=False, masked=False)
    assert ops == 2 * 2 * 10 * 7 * 3


def test_k2_count_takes_the_rows_with_data():
    bytes_, ops = counts.k2_work([50, 10])
    assert bytes_ == 12 * (2500 + 100)
    assert ops == 2 * (50**3 + 10**3) / 3


def test_step_and_ask_counts():
    n, m = 50, 50
    assert counts.dense_step_flops(n, m) == 8 * m * n * n + m * n * (n + 1) + 2 * n**3 + 4 * n * n
    assert counts.step_flops("dense", 50, 50) == 1_000_000 + 127_500 + 250_000 + 10_000
    L = 300.0
    leaf = counts.leaf_step_flops(4096, 50, L)
    assert leaf == pytest.approx(8 * 4096 * L * 50 + 8 * L * L * 50 + 8 * 4096 * 2500
                                 + 32 * 125_000 + 2 * 4096 * L * L + 2 * L**3 / 3
                                 + 8 * L * L + 6 * 4096 * L + 4 * 4096)
    assert counts.dense_ask_flops(1, 2, 1, 1) == (2 * 3 + 16 / 3 + 8) + (4 + 8 + 8)
    assert counts.factored_ask_flops(1, 2, 1.0, 1) == (4 + 4 + 2 / 3 + 4) + (2 + 4)


# --- the readers on a synthetic trace ------------------------------------------


def synthetic_trace():
    """10 ms profiled; kernels busy 0-2 ms, 3-4 ms and 6-7 ms (4 ms in all,
    with an overlapping copy at 1-1.5 ms); one K1 launch (planes + Gram,
    1 ms) and one K2 launch (1 ms)."""
    ms = 1_000_000
    device = [Event("void gram_planes_kernel<6>(...)", 0, ms // 2),
              Event("void gram_kernel<64, 4>(...)", ms // 2, ms // 2),
              Event("Memcpy HtoD (Pageable -> Device)", ms, ms // 2),
              Event("elementwise_kernel", ms, ms),
              Event("chol_inv_kernel(float const*, ...)", 3 * ms, ms),
              Event("reduce_kernel", 6 * ms, ms)]
    host = [Event("aten::item", 2 * ms, ms), Event("cudaStreamSynchronize", 2 * ms + 10, ms),
            Event("aten::nonzero", 4 * ms, 2 * ms)]
    k1 = [{"b": 64, "n": 50, "mcols": 50, "m": 50, "symmetric": True, "masked": True}]
    k2 = [{"rows": [50] * 128}]
    return Trace(device, host, 0.010, k1, k2)


def test_readers_on_a_synthetic_trace():
    t = synthetic_trace()
    ctx = {"trace": t, "profiled_steps": 2}
    assert readers.idle_share(ctx) == pytest.approx(100 * (1 - 0.004 / 0.010))
    assert readers.launches_per_step(ctx) == 5 / 2  # the copy is not a kernel
    k1_bound = counts.bound_s(*counts.k1_work(64, 50, 50, 50, True, True))
    assert readers.roofline(ctx, "k1") == pytest.approx(100 * k1_bound / 1e-3)
    k2_bound = counts.bound_s(*counts.k2_work([50] * 128))
    assert readers.roofline(ctx, "k2") == pytest.approx(100 * k2_bound / 1e-3)
    assert readers.mfu(67e12 * 0.5, 1.0) == pytest.approx(50.0)
    assert readers.span_mean({"spans": {"fit_s": [1.0, 2.0]}}, "fit_s") == 1.5
    assert readers.span_mean({}, "fit_s") is None


def test_readers_say_nothing_where_nothing_ran():
    t = synthetic_trace()
    t.k1 = t.k1 * 2  # two launches recorded, one traced: no share
    assert readers.roofline({"trace": t}, "k1") is None
    t.k2 = []
    assert readers.roofline({"trace": t}, "k2") is None
    assert readers.idle_share({}) is None


def test_breakdown_names_the_idle_stretches():
    out = breakdown(synthetic_trace())
    assert out["device_ops"][0][1] == pytest.approx(1e-3)
    gaps = dict(out["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == pytest.approx(1e-3)  # 2-3 ms, inside aten::item
    assert gaps["aten::nonzero"] == pytest.approx(2e-3)  # 4-6 ms


def test_breakdown_takes_the_idle_stretches_from_the_host_capture():
    """Device operations from the device's capture; idle stretches, and the
    host operations that name them, from the second capture alone."""
    device_only = synthetic_trace()
    device_only.host = []
    ms = 1_000_000
    host = Trace([Event("k", 0, ms), Event("k", 5 * ms, ms)],
                 [Event("aten::item", ms, 4 * ms)], 0.006)
    out = breakdown(device_only, host)
    assert out["device_ops"] == breakdown(synthetic_trace())["device_ops"]
    assert out["idle_gaps"] == [["aten::item", pytest.approx(4e-3)]]
