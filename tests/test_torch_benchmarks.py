"""The port's benchmark objectives against the JAX package's, on the CPU.

Every benchmark is numpy code copied into the port, so each registry name
is held equal to its original: the domain (bounds in both encodings,
feature types, input keys), ``f`` on 64 sampled points (float64, rtol
1e-12), the constraints' total violation there (float64, rtol 1e-12) and
the known optimum. PestControl's noise comes from a generator that every
call advances, so both packages see the same sequence of calls.
"""

import numpy as np
import pytest

from bark_tpu.benchmarks import BENCHMARK_MAP as JAX_MAP
from bark_tpu.benchmarks import map_benchmark as jmap_benchmark
from bark_tpu.constraints import total_violation as jtotal_violation

import bark_tpu_torch.domain as tdomain
from bark_tpu_torch.benchmarks import BENCHMARK_MAP, map_benchmark
from bark_tpu_torch.benchmarks.base import NOT_PORTED
from bark_tpu_torch.constraints import total_violation

PORTED = ("Friedman", "Rastrigin", "StyblinskiTang", "Schwefel", "G1", "G3", "G4", "G6", "G7",
          "G10", "Alkylation", "DiscreteAckley", "DiscreteRosenbrock", "PressureVessel",
          "CombinationFunc2", "PestControl", "Hartmann")
KWARGS = {"PestControl": {"seed": 0}}


def test_registry_covers_the_reference():
    assert set(BENCHMARK_MAP) == set(PORTED) | {"TreeFunction", "CurrinExp2D"}
    assert set(BENCHMARK_MAP) | set(NOT_PORTED) == set(JAX_MAP)


@pytest.mark.parametrize("name", PORTED)
def test_benchmark_equals_the_reference(name):
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
    X = td.sample(64, np.random.default_rng(0))
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
    for name in NOT_PORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            map_benchmark(name)
    with pytest.raises(KeyError):
        map_benchmark("Nope")


def test_build_integer_input_equals_the_reference():
    from bark_tpu.domain import build_integer_input as jbuild

    got = tdomain.build_integer_input(key="k", bounds=(1.0, 9.0), unit="mm")
    want = jbuild(key="k", bounds=(1.0, 9.0), unit="mm")
    assert isinstance(got, tdomain.IntegerInput) and got.bounds == want.bounds == (1, 9)
    assert got.key == want.key
