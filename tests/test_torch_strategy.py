"""The port's BO strategy layer against the JAX reference, on the CPU.

The numpy-only copies (domain, constraints, diagnostics, capabilities) must
equal their originals exactly. The strategy's host-side logic (duplicate
test, warm-start seeds, the dedup ladder) is held against the reference's on
the same inputs; ``ask`` must let every exception but the search's own
``AcquisitionFailure`` reach the caller; and a short BO loop runs end to end
with ``device="cpu"``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import bark_tpu.constraints as jcons
import bark_tpu.domain as jdomain
import bark_tpu.strategies.capabilities as jcaps
import bark_tpu.utils.diagnostics as jdiag
from bark_tpu.strategies.tree_kernel import RandomStrategy as JaxRandomStrategy
from bark_tpu.strategies.tree_kernel import TreeKernelStrategy as JaxStrategy

import bark_tpu_torch.constraints as tcons
import bark_tpu_torch.domain as tdomain
import bark_tpu_torch.strategies.capabilities as tcaps
import bark_tpu_torch.strategies.tree_kernel as tk
import bark_tpu_torch.utils.diagnostics as tdiag
from bark_tpu_torch.benchmarks import BENCHMARK_MAP, map_benchmark
from bark_tpu_torch.convert import domain_from_reference
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.optimizer.search import AcquisitionFailure

SMALL = dict(num_trees=6, node_limit=16, max_depth=6, num_chains=2, num_samples=3,
             steps_per_sample=2, warmup_steps=4)


def domains(constraints_of=lambda mod: ()):
    def make(dmod, cmod):
        return dmod.Domain(
            [
                dmod.ContinuousInput("x_0", (0.0, 1.0)),
                dmod.ContinuousInput("x_1", (-2.0, 3.0)),
                dmod.IntegerInput("i_0", (0, 5)),
                dmod.CategoricalInput("c_0", ("a", "b", "c", "d")),
            ],
            constraints=constraints_of(cmod),
        )

    return make(jdomain, jcons), make(tdomain, tcons)


def all_constraints(mod):
    return (
        mod.LinearInequalityConstraint(["x_0", "x_1"], [1.0, 2.0], 1.5),
        mod.LinearEqualityConstraint(["x_0", "i_0"], [1.0, -0.1], 0.2),
        mod.QuadraticInequalityConstraint([("x_0", "x_1"), ("x_1", "x_1")], [1.0, 0.5], 2.0,
                                          linear_features=["i_0"], linear_coefficients=[0.1]),
        mod.QuadraticEqualityConstraint([("x_0", "x_0")], [1.0], 0.25),
        mod.FunctionalInequalityConstraint(lambda x: x[0] * x[2] - x[1], 1.0),
        mod.FunctionalEqualityConstraint(lambda x: x[0] + x[1], 0.5),
        mod.NChooseKConstraint(["x_0", "x_1", "i_0"], max_count=2, min_count=1,
                               none_also_valid=False),
    )


def test_domain_copy_equals_the_original():
    jd, td = domains()
    assert td.dim == jd.dim and td.input_keys == jd.input_keys
    assert [f.name for f in dataclasses.fields(td)] == [f.name for f in dataclasses.fields(jd)]
    assert td.outputs[0].key == jd.outputs[0].key and td.outputs[0].minimize
    raw = {"x_0": [0.1, 0.9], "x_1": [2.0, -1.0], "i_0": [3, 0], "c_0": ["c", "a"]}
    np.testing.assert_array_equal(td.transform(raw), jd.transform(raw))
    X = np.array([[1.7, -9.0, 2.6, 3.4], [0.2, 0.3, -1.0, 9.0], [0.5, 2.5, 2.5, 0.5]])
    np.testing.assert_array_equal(td.round(X), jd.round(X))
    np.testing.assert_array_equal(td.transform(X), jd.transform(X))
    assert td.transform(X).dtype == np.float32
    y = np.random.default_rng(0).normal(3.0, 2.0, 17)
    js, ts = jdomain.Standardize(), tdomain.Standardize()
    np.testing.assert_array_equal(ts(y, train=True), js(y, train=True))
    assert (ts.mean, ts.std) == (js.mean, js.std)
    np.testing.assert_array_equal(ts(y[:3], train=False), js(y[:3], train=False))
    mu, var = ts.untransform_mu_var(y[:4], y[4:8] ** 2)
    mu_ref, var_ref = js.untransform_mu_var(y[:4], y[4:8] ** 2)
    np.testing.assert_array_equal(mu, mu_ref)
    np.testing.assert_array_equal(var, var_ref)
    const = tdomain.Standardize()
    const(np.ones(5), train=True)
    assert const.std == 1e-6


def test_constraints_copy_equals_the_original():
    jd, td = domains(all_constraints)
    X = jd.sample(40, np.random.default_rng(1)).astype(np.float64)
    X[:5, :3] = 0.0
    keys = jd.input_keys
    for jc, tc in zip(jd.constraints, td.constraints):
        assert type(jc).__name__ == type(tc).__name__ and jc.is_equality == tc.is_equality
        np.testing.assert_array_equal(tc.violation(X, keys), jc.violation(X, keys))
        np.testing.assert_array_equal(tc.satisfied(X, keys), jc.satisfied(X, keys))
    with pytest.raises(NotImplementedError):
        td.constraints[-1].expr(X, keys)
    np.testing.assert_array_equal(
        tcons.total_violation(td.constraints, X, keys),
        jcons.total_violation(jd.constraints, X, keys),
    )
    np.testing.assert_array_equal(
        tcons.is_feasible(td.constraints[:1], X, keys),
        jcons.is_feasible(jd.constraints[:1], X, keys),
    )
    np.testing.assert_array_equal(tcons.total_violation((), X, keys), np.zeros(40))
    # the converter rebuilds each constraint as the port's class of that name
    conv = domain_from_reference(jd)
    assert [type(c) for c in conv.constraints] == [type(c) for c in td.constraints]
    np.testing.assert_array_equal(
        tcons.total_violation(conv.constraints, X, keys),
        jcons.total_violation(jd.constraints, X, keys),
    )


def test_diagnostics_copy_equals_the_original():
    rng = np.random.default_rng(2)
    chains = np.cumsum(rng.normal(size=(4, 60)), axis=1) * 0.1 + rng.normal(size=(4, 60))
    for arr in (chains, chains[:, :3], np.ones((2, 8))):
        for name in ("gelman_rubin", "effective_sample_size"):
            got, want = getattr(tdiag, name)(arr), getattr(jdiag, name)(arr)
            assert got == want or (np.isnan(got) and np.isnan(want)), name
    assert tdiag.effective_sample_size(chains, max_lag=10) == jdiag.effective_sample_size(
        chains, max_lag=10)
    assert tdiag.mll_trace_summary(chains) == jdiag.mll_trace_summary(chains)


def test_capabilities_copy_equals_the_original():
    jd, td = domains(lambda mod: all_constraints(mod)[:1])
    tcaps.validate_domain(tk.TreeKernelStrategy, td)
    jcaps.validate_domain(JaxStrategy, jd)
    assert tk.TreeKernelStrategy.SUPPORTED_FEATURES == tuple(
        getattr(tdomain, t.__name__) for t in JaxStrategy.SUPPORTED_FEATURES)
    assert tk.TreeKernelStrategy.SUPPORTED_CONSTRAINTS == tuple(
        getattr(tcons, t.__name__) for t in JaxStrategy.SUPPORTED_CONSTRAINTS)

    class OnlyContinuous:
        SUPPORTED_FEATURES = (tdomain.ContinuousInput,)
        SUPPORTED_CONSTRAINTS = ()

    with pytest.raises(ValueError, match="IntegerInput"):
        tcaps.validate_domain(OnlyContinuous, td)
    cont = tdomain.Domain([tdomain.ContinuousInput("x_0", (0.0, 1.0))],
                          constraints=td.constraints)
    with pytest.raises(ValueError, match="LinearInequalityConstraint"):
        tcaps.validate_domain(OnlyContinuous, cont)
    with pytest.raises(ValueError, match="not a"):
        tcaps.validate_domain(
            tk.TreeKernelStrategy, tdomain.Domain(td.inputs, constraints=(object(),)))
    tcaps.validate_domain(tk.RandomStrategy, cont)  # ALL: unrestricted
    for cls, jcls in ((tk.TreeKernelStrategy, JaxStrategy), (tk.RandomStrategy, JaxRandomStrategy)):
        for name in ("LinearEqualityConstraint", "NChooseKConstraint", "Constraint"):
            assert tcaps.supports_constraint(cls, getattr(tcons, name)) == (
                jcaps.supports_constraint(jcls, getattr(jcons, name)))
        assert tcaps.supports_feature(cls, tdomain.IntegerInput) == (
            jcaps.supports_feature(jcls, jdomain.IntegerInput))


def test_duplicate_test_and_warm_start_seeds_match_reference():
    jd, td = domains()
    params = SamplerParams(**SMALL)
    port = tk.TreeKernelStrategy(td, params=params, seed=3, device="cpu")
    ref = JaxStrategy(jd, seed=3)
    rng = np.random.default_rng(5)
    X = jd.sample(9, rng)
    y = rng.normal(size=9)
    assert port._warm_start_seeds() is None and not port._is_duplicate(X[0])
    for s in (port, ref):
        s.X, s.y = X, y
        s._last_proposal = X[4] + np.float32(1e-3)
    np.testing.assert_array_equal(port._warm_start_seeds(), ref._warm_start_seeds())
    probes = [X[2], X[2] + 1e-8, X[2] + 1e-3, X[4] + np.float32(1e-3), jd.sample(1, rng)[0]]
    got = [port._is_duplicate(p) for p in probes]
    assert got == [ref._is_duplicate(p) for p in probes] == [True, True, False, True, False]


def fitted_strategy(**kwargs):
    bench = map_benchmark("TreeFunction", dim=2, m=5, function_seed=1)
    X = bench.domain.sample(6, np.random.default_rng(0))
    s = tk.make_strategy("BARK", bench.domain, seed=0, params=SamplerParams(**SMALL),
                         num_candidates=64, num_rounds=1, device="cpu", **kwargs)
    s.tell(X, bench.f(X))
    return s, bench


def test_ask_lets_a_runtime_error_through(monkeypatch):
    """A failure inside the search (a kernel that did not launch, an
    unported option) reaches the caller; nothing is proposed at random."""
    s, _ = fitted_strategy()

    def boom(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(tk, "propose", boom)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        s.ask(1)
    monkeypatch.setattr(tk, "build_acquisition", lambda *a, **k: (_ for _ in ()).throw(
        NotImplementedError("not ported")))
    with pytest.raises(NotImplementedError):
        s.ask(1)
    assert s.fallbacks == 0 and s._last_proposal is None


def test_ask_counts_an_acquisition_failure(monkeypatch):
    s, bench = fitted_strategy()

    def fail(*a, **k):
        raise AcquisitionFailure("all scores non-finite")

    monkeypatch.setattr(tk, "propose", fail)
    c = s.ask(1)
    assert s.fallbacks == 1 and c.shape == (1, 2) and s._last_proposal is None
    lo, hi = bench.domain.bounds("ordinal").T
    assert (lo <= c[0]).all() and (c[0] <= hi).all()
    s.ask(1)
    assert s.fallbacks == 2


def test_dedup_ladder(monkeypatch):
    """A duplicate LCB proposal is replaced by a Thompson proposal, and a
    duplicate Thompson proposal by a feasible random point."""
    s, _ = fitted_strategy()
    dup, fresh = s.X[0].copy(), np.array([0.123, 0.456], np.float32)
    calls = []

    def scripted(answers):
        it = iter(answers)

        def once(use_ts):
            calls.append(use_ts)
            return next(it)

        return once

    monkeypatch.setattr(s, "_propose_once", scripted([fresh]))
    np.testing.assert_array_equal(s.ask(1), fresh[None])
    assert calls == [False]
    calls.clear()
    monkeypatch.setattr(s, "_propose_once", scripted([dup, fresh + 0.1]))
    np.testing.assert_array_equal(s.ask(1), (fresh + 0.1)[None])
    assert calls == [False, True]
    calls.clear()
    monkeypatch.setattr(s, "_propose_once", scripted([dup, fresh + 0.1]))  # the last proposal
    out = s.ask(1)
    assert calls == [False, True]
    assert not np.array_equal(out[0], dup) and not np.array_equal(out[0], fresh + 0.1)
    calls.clear()
    s.dedup = False
    monkeypatch.setattr(s, "_propose_once", scripted([dup]))
    np.testing.assert_array_equal(s.ask(1), dup[None])
    assert calls == [False] and s.fallbacks == 0
    with pytest.raises(ValueError):
        s.ask(2)


@pytest.mark.parametrize("backend,wants", [
    ("auto", "build_acquisition"), ("lowrank", "build_acquisition_lr"),
    ("thompson", "build_acquisition_ts"), ("auto-large", "build_acquisition_lr"),
])
def test_propose_once_picks_the_build(monkeypatch, backend, wants):
    """``auto`` is the dense build up to LR_THRESHOLD padded rows and the
    factored one above; the real functions run and the proposal is in-domain."""
    if backend == "auto-large":
        monkeypatch.setattr(tk, "LR_THRESHOLD", 16)
        backend = "auto"
    s, bench = fitted_strategy(acq_backend=backend)
    used = []
    for name in ("build_acquisition", "build_acquisition_lr", "build_acquisition_ts"):
        real = getattr(tk, name)
        monkeypatch.setattr(
            tk, name, lambda *a, _n=name, _r=real, **k: (used.append(_n), _r(*a, **k))[1])
    c = s.ask(1)
    assert used[0] == wants
    lo, hi = bench.domain.bounds("ordinal").T
    assert (lo <= c[0]).all() and (c[0] <= hi).all()
    with pytest.raises(ValueError):
        tk.TreeKernelStrategy(bench.domain, acq_backend="nope", device="cpu")


def test_bo_loop_on_the_cpu():
    """Five iterations end to end: every ask lies in the domain, none
    repeats a training row or the previous proposal, the history grows, and
    nothing fell back."""
    s, bench = fitted_strategy()
    lo, hi = bench.domain.bounds("ordinal").T
    for i in range(5):
        c = s.ask(1)
        assert c.shape == (1, 2) and (lo <= c[0]).all() and (c[0] <= hi).all()
        rel = np.abs(s.X.astype(np.float64) - c[0].astype(np.float64)).max(axis=1)
        assert (rel > 1e-6).all(), f"iteration {i} repeats a training row"
        s.add(c, bench.f(c))
        assert len(s.y) == 7 + i and s.surrogate.train_mask.sum() == 7 + i
    assert s.fallbacks == 0
    mu, std = s.predict(s.X)
    assert mu.shape == (11, 1) and np.isfinite(mu).all() and (std > 0).all()
    assert s.surrogate.model.noise.shape == (SMALL["num_chains"], SMALL["num_samples"])


def test_ask_before_data_and_random_strategy():
    jd, td = domains(lambda mod: all_constraints(mod)[:1])
    s = tk.make_strategy("TreeKernel", td, seed=1, params=SamplerParams(**SMALL), device="cpu")
    assert isinstance(s, tk.TreeKernelStrategy) and not s.has_sufficient_experiments()
    first = s.ask(1)
    assert tcons.is_feasible(td.constraints, first.astype(np.float64), td.input_keys).all()
    s.add(first, [0.3])  # one point: still not enough to fit
    assert not s.surrogate.is_fitted and len(s.y) == 1
    rnd, ref = tk.make_strategy("Random", td, seed=4), JaxRandomStrategy(jd, seed=4)
    np.testing.assert_array_equal(rnd.ask(3), ref.ask(3))
    rnd.tell(first, [0.3])
    rnd.add(first, [0.1])
    assert rnd.X.shape == (2, 4) and rnd.y.tolist() == [0.3, 0.1]


def test_make_strategy_names_and_device():
    _, td = domains()
    for name in ("BARKPrior", "LeafGP", "LeafMOGP", "BART", "BARTGrid", "GridUCB",
                 "RelaxedSobo", "Sobo", "RelaxedGP", "SMAC", "Entmoot"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 10"):
            tk.make_strategy(name, td, device="cpu")
    with pytest.raises(KeyError):
        tk.make_strategy("Nope", td, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tk.make_strategy("BARK", td)
        with pytest.raises(RuntimeError, match="CUDA"):
            tk.TreeKernelStrategy(td)
    assert tk.make_strategy("BARK", td, device="cpu").device == torch.device("cpu")


def test_map_benchmark_knows_the_tree_function():
    bench = map_benchmark("TreeFunction", dim=2, m=10, function_seed=1)
    assert bench.domain.dim == 2 and set(BENCHMARK_MAP) == {"TreeFunction"}
    X = bench.domain.sample(4, np.random.default_rng(0))
    assert bench.f(X).shape == (4,)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        map_benchmark("Hartmann")
