"""The port's benchmark objectives against the JAX package's, on the CPU.

Every benchmark is numpy code copied into the port, so each registry name
is held equal to its original: the domain (bounds in both encodings,
feature types, input keys), ``f`` on 64 sampled points (float64, rtol
1e-12), the constraints' total violation there (float64, rtol 1e-12) and
the known optimum. PestControl's noise comes from a generator that every
call advances, so both packages see the same sequence of calls.

The model-training benchmarks run their sklearn backends (xgboost is not
installed here, and the reference then uses sklearn): SVRBench at the size
of the reference's own test (400 rows, 10 features), XGBoostMNIST on 4
points (a HistGradientBoosting fit takes ~0.8 s). DatasetBenchmark is held
on a DataFrame made from a seed (its fetcher needs the network).
"""

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

from bark_tpu.benchmarks import BENCHMARK_MAP as JAX_MAP
from bark_tpu.benchmarks import map_benchmark as jmap_benchmark
from bark_tpu.constraints import total_violation as jtotal_violation

import bark_tpu_torch.domain as tdomain
from bark_tpu_torch.benchmarks import BENCHMARK_MAP, map_benchmark
from bark_tpu_torch.constraints import total_violation

PORTED = ("Friedman", "Rastrigin", "StyblinskiTang", "Schwefel", "G1", "G3", "G4", "G6", "G7",
          "G10", "Alkylation", "DiscreteAckley", "DiscreteRosenbrock", "PressureVessel",
          "CombinationFunc2", "PestControl", "Hartmann", "MAXBandit", "ToyReaction",
          "CCOBench", "SVRBench", "XGBoostMNIST")
KWARGS = {"PestControl": {"seed": 0},
          "SVRBench": {"num_features_to_optimize": 10, "num_features_to_keep": 10,
                       "num_samples": 400, "backend": "sklearn"},
          "XGBoostMNIST": {"backend": "sklearn"}}
POINTS = {"XGBoostMNIST": 4}


def test_registry_covers_the_reference():
    assert set(BENCHMARK_MAP) == set(PORTED) | {"TreeFunction", "CurrinExp2D", "DatasetBenchmark"}
    assert set(BENCHMARK_MAP) == set(JAX_MAP)


@pytest.mark.parametrize("name", PORTED)
def test_benchmark_equals_the_reference(name):
    # one BLAS/OpenMP thread: the model benchmarks' fits otherwise contend
    # with the other test workers for every core, and XGBoostMNIST's
    # OpenMP threads then slow it down a hundredfold
    with threadpool_limits(1):
        _benchmark_equals_the_reference(name)


def _benchmark_equals_the_reference(name):
    port = map_benchmark(name, **KWARGS.get(name, {}))
    ref = jmap_benchmark(name, **KWARGS.get(name, {}))
    assert port.name == ref.name == name
    td, jd = port.domain, ref.domain
    assert td.input_keys == jd.input_keys
    np.testing.assert_array_equal(td.feature_types(), jd.feature_types())
    for enc in ("bitmask", "ordinal"):
        np.testing.assert_array_equal(td.bounds(enc), jd.bounds(enc))
    assert [type(c).__name__ for c in td.constraints] == [type(c).__name__
                                                        for c in jd.constraints]
    assert all(isinstance(f, getattr(tdomain, type(f).__name__)) for f in td.inputs)
    X = td.sample(POINTS.get(name, 64), np.random.default_rng(0))
    for _ in range(2):  # PestControl: two calls of the same sequence
        np.testing.assert_allclose(port.f(X), ref.f(X), rtol=1e-12, atol=0)
    X64 = X.astype(np.float64)
    np.testing.assert_allclose(total_violation(td.constraints, X64, td.input_keys),
                               jtotal_violation(jd.constraints, X64, jd.input_keys),
                               rtol=1e-12, atol=0)
    opt_t, opt_j = port.get_optima(), ref.get_optima()
    assert (opt_t is None) == (opt_j is None)
    if opt_t is not None:
        np.testing.assert_array_equal(opt_t[0], opt_j[0])
        assert opt_t[1] == opt_j[1]


def test_map_benchmark_raises_for_unported_and_unknown_names():
    """Every name of the reference's registry is ported; an unknown name
    raises."""
    assert sorted(JAX_MAP) == sorted(BENCHMARK_MAP)
    with pytest.raises(KeyError):
        map_benchmark("Nope")


def test_max_bandit_data_is_a_byte_copy():
    from pathlib import Path

    import bark_tpu.benchmarks.max_bandit as jmax

    import bark_tpu_torch.benchmarks.max_bandit as tmax

    assert Path(tmax.DATA_PATH).read_bytes() == Path(jmax.DATA_PATH).read_bytes()
    port, ref = map_benchmark("MAXBandit"), jmap_benchmark("MAXBandit")
    np.testing.assert_array_equal(port.candidates, ref.candidates)
    np.testing.assert_array_equal(port.targets, ref.targets)
    X, idx = port.sample_candidates(10, np.random.default_rng(0))
    Xr, idxr = ref.sample_candidates(10, np.random.default_rng(0))
    np.testing.assert_array_equal(X, Xr)
    np.testing.assert_array_equal(port.f_by_idx(idx), ref.f_by_idx(idxr))


def test_cco_synthetic_powermaps_equal_the_reference():
    import bark_tpu.benchmarks.cco as jcco

    import bark_tpu_torch.benchmarks.cco as tcco

    got, want = tcco.synthetic_powermaps(seed=3, grid_size=21), jcco.synthetic_powermaps(
        seed=3, grid_size=21)
    assert sorted(got) == sorted(want)
    for dt in want:
        assert sorted(got[dt]) == sorted(want[dt])
        for k in want[dt]:
            np.testing.assert_array_equal(got[dt][k], want[dt][k])
    port, ref = map_benchmark("CCOBench", n_int_values=11, seed=1), jmap_benchmark(
        "CCOBench", n_int_values=11, seed=1)
    assert port.data_source == ref.data_source
    X = port.domain.sample(16, np.random.default_rng(1))
    np.testing.assert_allclose(port.f(X), ref.f(X), rtol=1e-12, atol=0)


def test_dataset_benchmark_equals_the_reference():
    """The same DataFrame (made from a seed: the UCI fetcher needs the
    network) gives the same encoded rows, targets, draws and lookups."""
    pd = pytest.importorskip("pandas")
    from bark_tpu.benchmarks.dataset import dataset_domain as jdomain

    rng = np.random.default_rng(0)
    dom = jdomain("Abalone")
    raw = {}
    for f in dom.inputs:
        if hasattr(f, "categories"):
            raw[f.key] = rng.choice(f.categories, size=40)
        else:
            raw[f.key] = rng.uniform(*f.bounds, size=40)
    raw[dom.output_keys[0]] = rng.normal(size=40)
    df = pd.DataFrame(raw)
    port = map_benchmark("DatasetBenchmark", dataset_name="Abalone", data=df)
    ref = jmap_benchmark("DatasetBenchmark", dataset_name="Abalone", data=df)
    np.testing.assert_array_equal(port.X_data, ref.X_data)
    np.testing.assert_array_equal(port.y_data, ref.y_data)
    for _ in range(2):
        X, Xr = port.sample(8, seed=3), ref.sample(8, seed=3)
        np.testing.assert_array_equal(X, Xr)
        np.testing.assert_array_equal(port.f(X), ref.f(Xr))
    with pytest.raises(KeyError):
        port.f(np.full((1, dom.dim), -123.0, np.float32))


@pytest.mark.parametrize("name, kwargs, package", [
    ("XGBoostMNIST", {}, "xgboost"),
    ("SVRBench", {"num_samples": 400}, "xgboost"),
])
def test_model_benchmarks_raise_naming_a_missing_package(name, kwargs, package, monkeypatch):
    """The default backend is xgboost, and without it the benchmark raises
    naming it: the sklearn objective runs only when asked for."""
    import sys

    monkeypatch.setitem(sys.modules, package, None)
    with pytest.raises(RuntimeError, match=package):
        map_benchmark(name, **kwargs)
    with pytest.raises(ValueError, match="backend"):
        map_benchmark(name, backend="lightgbm", **kwargs)


def test_build_integer_input_equals_the_reference():
    from bark_tpu.domain import build_integer_input as jbuild

    got = tdomain.build_integer_input(key="k", bounds=(1.0, 9.0), unit="mm")
    want = jbuild(key="k", bounds=(1.0, 9.0), unit="mm")
    assert isinstance(got, tdomain.IntegerInput) and got.bounds == want.bounds == (1, 9)
    assert got.key == want.key
