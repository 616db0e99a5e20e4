"""The port's booster import against the JAX package's, on the CPU.

The native booster's source, the numpy copies (``Domain.sample_sobol``,
``Domain.cat_indices``, CurrinExp2D) and every forest the port fits or
imports must equal the reference's exactly: the same bytes, the same
points, the same arrays. The native cases skip only where no C++ compiler
is on the PATH, as the reference's own tests do.
"""

import importlib.util
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from torch_support import REPO, run_python

import bark_tpu.domain as jdomain
from bark_tpu import native as jnative
from bark_tpu.benchmarks import map_benchmark as jmap_benchmark
from bark_tpu.fitting.booster import fit_booster_forest as jfit
from bark_tpu.fitting.booster import lgbm_dump_to_forest as jdump

from bark_tpu_torch import native as tnative
from bark_tpu_torch.benchmarks import map_benchmark as tmap_benchmark
from bark_tpu_torch.convert import domain_from_reference
from bark_tpu_torch.fitting.booster import fit_booster_forest as tfit
from bark_tpu_torch.fitting.booster import lgbm_dump_to_forest as tdump
from bark_tpu_torch.forest import FOREST_FIELDS, route_forest

needs_cxx = pytest.mark.skipif(not tnative.gbdt_available(), reason="no C++ compiler")


def _load_lgbm_import_tests():
    path = REPO / "tests" / "fitting" / "test_lgbm_import.py"
    spec = importlib.util.spec_from_file_location("lgbm_import_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mixed_domain(mod=jdomain):
    return mod.Domain([
        mod.ContinuousInput("x_0", (0.0, 1.0)),
        mod.CategoricalInput("c_0", ("a", "b", "c", "d", "e")),
        mod.IntegerInput("i_0", (-2, 4)),
        mod.ContinuousInput("x_1", (-1.0, 2.0)),
    ])


def data(dom, n, seed):
    rng = np.random.default_rng(seed)
    X = dom.sample(n, rng)
    y = np.sin(4 * X[:, 0]) + np.where(np.isin(X[:, 1], [1, 3]), 1.5, -0.5) + 0.1 * X[:, 2]
    y = y + 0.05 * rng.standard_normal(n)
    return X, (y - y.mean()) / y.std()


def assert_same_forest(ref, port):
    for k in FOREST_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ref, k)), getattr(port, k).numpy(),
                                      err_msg=k)


def test_gbdt_source_is_a_byte_copy():
    port = REPO / "bark_tpu_torch" / "native" / "gbdt.cpp"
    assert port.read_bytes() == (REPO / "bark_tpu" / "native" / "gbdt.cpp").read_bytes()
    assert tnative.SOURCE == port
    assert tnative.CXX_FLAGS == ("-O3", "-std=c++17", "-shared", "-fPIC")
    # the library lands in the port's gitignored build directory, never
    # beside the reference's source
    assert tnative.library_path().parent == REPO / "bark_tpu_torch" / "_build"


@pytest.mark.parametrize("n,seed", [(7, 0), (64, 3), (100, 11)])
def test_domain_copies_equal_the_originals(n, seed):
    jd = mixed_domain()
    td = domain_from_reference(jd)
    assert td.cat_indices() == jd.cat_indices() == [1]
    np.testing.assert_array_equal(td.sample_sobol(n, seed=seed), jd.sample_sobol(n, seed=seed))


def test_currin_copy_equals_the_original():
    jb, tb = jmap_benchmark("CurrinExp2D"), tmap_benchmark("CurrinExp2D")
    assert domain_from_reference(jb.domain) == tb.domain
    assert (tb.num_fidelities, tb.fidelity_costs) == (jb.num_fidelities, jb.fidelity_costs)
    X = jb.domain.sample(50, np.random.default_rng(5))
    X[:3] = [[0.0, 0.0], [1.0, 1.0], [0.02, 0.98]]  # the clipped corners
    fid = np.random.default_rng(6).integers(0, 2, 50)
    np.testing.assert_array_equal(tb.f(X), jb.f(X))
    np.testing.assert_array_equal(tb.f_fidelity(X, fid), jb.f_fidelity(X, fid))


@needs_cxx
@pytest.mark.parametrize("n,rounds,seed", [(30, 10, 0), (40, 20, 1)])
def test_native_forest_equals_the_reference(n, rounds, seed):
    jd = mixed_domain()
    X, y = data(jd, n, seed)
    ref = jfit(X, y, jd, num_boost_round=rounds, backend="native")
    port = tfit(X, y, domain_from_reference(jd), num_boost_round=rounds, backend="native")
    assert_same_forest(ref, port)
    assert port.is_leaf.shape == (rounds, 64) and port.is_leaf.device.type == "cpu"
    # "auto" is the native booster in the port (and, with a compiler, in
    # the reference too)
    assert_same_forest(ref, tfit(X, y, domain_from_reference(jd), num_boost_round=rounds))


@needs_cxx
def test_native_arrays_and_routing_equal_the_reference():
    jd = mixed_domain()
    X, y = data(jd, 40, 2)
    ft, cs = jd.feature_types(), np.array([0, 5, 0, 0], np.int32)
    ref = jnative.fit_gbdt(X, y, ft, cs, num_rounds=15, max_depth=3)
    port = tnative.fit_gbdt(X, y, ft, cs, num_rounds=15, max_depth=3)
    assert ref.keys() == port.keys()
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    leaves, pred = tnative.predict_gbdt(X, port, ft)
    leaves_ref, pred_ref = jnative.predict_gbdt(X, ref, ft)
    np.testing.assert_array_equal(leaves, leaves_ref)
    np.testing.assert_array_equal(pred, pred_ref)
    # the C++ router and the port's forest router agree
    forest = tfit(X, y, domain_from_reference(jd), num_boost_round=15)
    routed = route_forest(forest, torch.as_tensor(X), torch.as_tensor(ft))
    np.testing.assert_array_equal(routed.numpy(), leaves)
    with pytest.raises(OverflowError, match="node_limit"):
        tnative.fit_gbdt(X, y, ft, cs, num_rounds=2, max_depth=3, node_limit=8)


@pytest.mark.parametrize("rounds,depth", [(10, 3), (20, 2)])
def test_sklearn_forest_equals_the_reference(rounds, depth):
    jd = mixed_domain()
    X, y = data(jd, 40, 4)
    kwargs = dict(num_boost_round=rounds, max_depth=depth, random_state=3, backend="sklearn")
    assert_same_forest(jfit(X, y, jd, **kwargs),
                       tfit(X, y, domain_from_reference(jd), **kwargs))


def test_dump_import_equals_the_reference():
    dump = _load_lgbm_import_tests()._dump()
    for node_limit in (8, 16, 64):
        assert_same_forest(jdump(dump, node_limit=node_limit), tdump(dump, node_limit=node_limit))
    thr = tdump(dump, node_limit=16).threshold
    assert int(thr[0, 0]) == (1 << 0) + (1 << 2) + (1 << 3) and int(thr[1, 0]) == 1 << 4
    with pytest.raises(OverflowError, match="node_limit"):
        tdump(dump, node_limit=4)
    bad = {"tree_info": [{"tree_structure": {
        "split_feature": 0, "decision_type": "==", "threshold": "25",
        "left_child": {"leaf_index": 0}, "right_child": {"leaf_index": 1},
    }}]}
    with pytest.raises(ValueError, match="24-bit"):
        tdump(bad, node_limit=8)


def test_lightgbm_backend_raises_and_unknown_backends_are_refused():
    dom = domain_from_reference(mixed_domain())
    X, y = data(mixed_domain(), 10, 0)
    with pytest.raises(RuntimeError, match="lightgbm"):
        tfit(X, y, dom, backend="lightgbm")
    with pytest.raises(ValueError, match="backend"):
        tfit(X, y, dom, backend="xgboost")


def test_auto_backend_raises_where_the_build_fails(tmp_path, monkeypatch):
    """ROADMAP queue 3 O8: where the reference's "auto" quietly fits sklearn
    trees, the port's reaches the caller with the compiler's output."""
    import sklearn.ensemble

    fake = tmp_path / "cxx"
    fake.write_text("#!/bin/sh\necho 'error: fake compiler refused' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(tnative, "CXX", str(fake))
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)

    def no_sklearn(*a, **k):
        raise AssertionError("the sklearn booster was fitted without being asked for")

    monkeypatch.setattr(sklearn.ensemble, "GradientBoostingRegressor", no_sklearn)
    dom = domain_from_reference(mixed_domain())
    X, y = data(mixed_domain(), 10, 0)
    for backend in ("auto", "native"):
        with pytest.raises(RuntimeError, match="fake compiler refused"):
            tfit(X, y, dom, backend=backend)
    assert list((tmp_path / "build").iterdir()) == []  # no half-written library
    assert tnative._lib is None


@needs_cxx
def test_concurrent_builds_leave_one_whole_library(tmp_path):
    """Processes that build the library at once (as the test workers do)
    each rename a whole file into place; every one of them loads it."""
    code = (
        "import sys; from pathlib import Path; import numpy as np\n"
        "from bark_tpu_torch import native\n"
        f"native.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "X = np.random.default_rng(0).uniform(size=(20, 2)).astype(np.float32)\n"
        "out = native.fit_gbdt(X, X[:, 0], np.array([2, 2]), np.zeros(2), num_rounds=3)\n"
        "print(int(out['active'].sum()))\n"
    )
    with ThreadPoolExecutor(4) as pool:
        procs = list(pool.map(lambda _: run_python(code, timeout=300), range(4)))
    assert all(p.returncode == 0 for p in procs), [p.stderr[-2000:] for p in procs]
    assert len({p.stdout.strip() for p in procs}) == 1
    assert [p.name for p in tmp_path.iterdir()] == [tnative.library_path().name]
