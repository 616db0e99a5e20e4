"""The port's baseline strategies against the JAX package's, on the CPU.

The reference runs with JAX's x64 mode off (the suite turns it on), so that
it computes in float32 as the port does. Tolerances:

  - the relaxed box and the relaxed round trip: exact;
  - RelaxedGP's Adam: the port's ``torch.optim.Adam(lr=0.05)`` against the
    reference's ``optax.adam(0.05)`` from the same start, the first 20
    losses within 1e-4 relative, the fitted hyperparameters within 2e-3
    relative (float32 round-off in the Cholesky backward parts the two
    trajectories, as for LeafGP);
  - RelaxedGP's and GridUCB's proposals from the same hyperparameters or
    posterior and the same draws: equal;
  - the Sobol grid: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bark_tpu.domain as jdomain
import bark_tpu.fitting.bart as jbart
import bark_tpu.models.bart as jmbart
import bark_tpu.strategies.baselines as jbase
from bark_tpu.benchmarks import map_benchmark as jmap_benchmark
from bark_tpu.fitting.params import SamplerParams as JaxParams
from bark_tpu.fitting.prior import sample_forest_prior
from bark_tpu.fitting.sampler import BARKModel as JaxModel
from bark_tpu.models.surrogate import BARKSurrogate as JaxSurrogate

import bark_tpu_torch.domain as tdomain
import bark_tpu_torch.strategies.baselines as tbase
import bark_tpu_torch.strategies.tree_kernel as tk
from bark_tpu_torch.benchmarks import map_benchmark
from bark_tpu_torch.convert import (
    bart_params_from_reference,
    bart_samples_from_reference,
    domain_from_reference,
    surrogate_from_reference,
)
from bark_tpu_torch.fitting.bart import BARTParams
from bark_tpu_torch.models.bart import BARTSurrogate

STRATEGY_NAMES = ("BARK", "TreeKernel", "BARKPrior", "LeafGP", "LeafMOGP", "Random", "BART",
                  "BARTGrid", "GridUCB", "RelaxedSobo", "Sobo", "RelaxedGP", "SMAC", "Entmoot")
NEEDS_PACKAGE = ("SMAC", "Entmoot")
NO_DEVICE = ("Random",) + NEEDS_PACKAGE


def x64_off():
    return jax.enable_x64(False)


def make_domain(mod):
    return mod.Domain([
        mod.ContinuousInput("x_0", (0.0, 1.0)),
        mod.IntegerInput("i_0", (-2, 3)),
        mod.CategoricalInput("c_0", ("a", "b", "c")),
        mod.ContinuousInput("x_1", (-1.0, 2.0)),
    ])


def data(n=14, seed=0):
    dom = make_domain(tdomain)
    rng = np.random.default_rng(seed)
    X = dom.sample(n, rng)
    y = np.sin(3 * X[:, 0]) + 0.3 * X[:, 1] - (X[:, 2] == 1) + X[:, 3] ** 2
    return X, y + 0.05 * rng.standard_normal(n)


def test_relax_bounds_and_round_trip():
    jd, td = make_domain(jdomain), make_domain(tdomain)
    jb, jblocks = jbase._relax_bounds(jd)
    tb, tblocks = tbase._relax_bounds(td)
    np.testing.assert_array_equal(tb, jb)
    assert tblocks == jblocks
    ref = jbase.RelaxedGPStrategy(jd)
    port = tbase.RelaxedGPStrategy(td, device="cpu")
    X = td.sample(30, np.random.default_rng(1))
    Z = port._to_relaxed(X)
    np.testing.assert_array_equal(Z, ref._to_relaxed(X))
    np.testing.assert_array_equal(port._from_relaxed(Z), X)
    Zr = np.random.default_rng(2).uniform(tb[:, 0], tb[:, 1], (30, tb.shape[0])).astype(np.float32)
    np.testing.assert_array_equal(port._from_relaxed(Zr), ref._from_relaxed(Zr))


def test_relaxed_gp_adam_matches_optax(monkeypatch):
    """The reference's own loop (run eagerly so that its losses can be
    recorded) against the port's, from the same data and start."""
    jd, td = make_domain(jdomain), make_domain(tdomain)
    X, y = data()
    ref = jbase.RelaxedGPStrategy(jd, fit_steps=20)
    port = tbase.RelaxedGPStrategy(td, device="cpu")
    Z = port._to_relaxed(X)
    y_std = ((y - y.mean()) / y.std()).astype(np.float32)
    span = port.bounds_relax[:, 1] - port.bounds_relax[:, 0]
    ls0 = np.maximum(span, 1e-3) * 0.3
    losses = []
    value_and_grad = jax.value_and_grad

    def recording(fn):
        def run(p):
            loss, grads = value_and_grad(fn)(p)
            losses.append(float(loss))
            return loss, grads
        return run

    monkeypatch.setattr(jax, "value_and_grad", recording)
    with x64_off(), jax.disable_jit():
        want = ref._fit_hypers(jnp.asarray(Z), jnp.asarray(y_std), jnp.asarray(ls0))
    ls, scale, noise, got_losses = tbase.fit_rbf_hypers(
        torch.as_tensor(Z), torch.as_tensor(y_std), torch.as_tensor(ls0), 20)
    assert len(losses) == 20
    np.testing.assert_allclose(got_losses.numpy(), losses, rtol=1e-4)
    np.testing.assert_allclose(ls.numpy(), np.asarray(want[0]), rtol=2e-3)
    np.testing.assert_allclose([float(scale), float(noise)], want[1:], rtol=2e-3)


@pytest.mark.parametrize("fit_hypers", [False, True])
def test_relaxed_gp_ask_equals_the_reference(fit_hypers, monkeypatch):
    """Same hyperparameters and candidate uniforms -> the same proposal (the
    fitted case fixes both packages' fit to one answer)."""
    jd, td = make_domain(jdomain), make_domain(tdomain)
    X, y = data()
    ref = jbase.RelaxedGPStrategy(jd, seed=3, fit_hypers=fit_hypers, num_candidates=512)
    port = tbase.RelaxedGPStrategy(td, seed=3, fit_hypers=fit_hypers, num_candidates=512,
                                   device="cpu")
    if fit_hypers:
        ref._fit_hypers = lambda Z, y_std, ls: (ls * 1.3, 0.8, 0.01)
        monkeypatch.setattr(tbase, "fit_rbf_hypers", lambda Z, y_std, ls, steps: (
            ls * 1.3, torch.tensor(0.8), torch.tensor(0.01), None))
    ref.tell(X, y)
    port.tell(X, y)
    with x64_off():
        _, k = jax.random.split(jax.random.key(3))
        u = np.array(jax.random.uniform(k, (512, port.bounds_relax.shape[0])))
        want = ref.ask(1)
    got = port.ask(1, u=u)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (1, 4) and np.array_equal(td.round(got), got)
    drawn = port.ask(1)  # candidates from the strategy's own generator
    assert np.array_equal(td.round(drawn), drawn)


def _bart_pair(dom_j, X, y):
    params = jbart.BARTParams(warmup_steps=10, num_samples=4, num_chains=2, num_trees=6,
                              node_limit=16)
    with x64_off():
        ref = jmbart.BARTSurrogate(dom_j, params, seed=0).fit(X, y)
    port = BARTSurrogate(domain_from_reference(dom_j), bart_params_from_reference(params),
                         device="cpu")
    port.samples = bart_samples_from_reference(ref.samples, "cpu")
    port.scaler.y_min, port.scaler.range = ref.scaler.y_min, ref.scaler.range
    return ref, port


def _bark_pair(dom_j, X, y):
    params = JaxParams(num_trees=6, node_limit=16, max_depth=6, num_chains=2, num_samples=3)
    with x64_off():
        ref = JaxSurrogate(dom_j, params)
        ref._store_train_data(X, y)
        forest = sample_forest_prior(
            jax.random.key(4), 6, jnp.asarray(dom_j.bounds("bitmask")),
            jnp.asarray(dom_j.feature_types()), num_samples=6, node_limit=16, max_depth=6)
        forest = jax.tree.map(lambda a: a.reshape(2, 3, *a.shape[1:]), forest)
        ref.model = JaxModel(forest, jnp.linspace(0.05, 0.3, 6).reshape(2, 3),
                             jnp.linspace(0.5, 1.5, 6).reshape(2, 3))
    return ref, surrogate_from_reference(ref, device="cpu")


@pytest.mark.parametrize("pair", [_bart_pair, _bark_pair], ids=["BART", "BARK"])
def test_grid_ucb_grid_and_argmax_equal_the_reference(pair):
    jd, td = make_domain(jdomain), make_domain(tdomain)
    X, y = data(20)
    ref_sur, port_sur = pair(jd, X, y)
    ref = jbase.GridUCBStrategy(jd, surrogate=ref_sur, seed=2, max_grid=512)
    port = tbase.GridUCBStrategy(td, surrogate=port_sur, seed=2, max_grid=512)
    ref.X, ref.y = X, y
    port.X, port.y = X, y
    with x64_off():
        want = ref.ask(1)
        grid = td.sample_sobol(512, seed=2)
        S = port_sur.predict(X[:1], batched=True)[0].shape[0]
        eps = np.asarray(jax.random.normal(jax.random.key(3), (1, S, 512)))
    np.testing.assert_array_equal(port.next_grid(), grid)
    port._ask_count = 0
    got = port.ask(1, eps=eps)
    np.testing.assert_array_equal(got, want)
    assert port._ask_count == ref._ask_count == 1


@pytest.mark.parametrize("cls", ["GridUCBStrategy", "RelaxedGPStrategy", "SMACStrategy",
                                 "EntmootStrategy"])
def test_baselines_reject_constrained_domains(cls):
    """Like the reference's, the baselines refuse a constrained domain."""
    bench = map_benchmark("G6")
    with pytest.raises(ValueError, match="does not support") as got:
        getattr(tbase, cls)(bench.domain)
    with pytest.raises(ValueError, match="does not support") as want:
        getattr(jbase, cls)(jmap_benchmark("G6").domain)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", NEEDS_PACKAGE)
def test_optional_baselines_raise_without_their_packages(name):
    td = make_domain(tdomain)
    with pytest.raises(RuntimeError, match=name):
        tk.make_strategy(name, td, device="cpu")


@pytest.mark.parametrize("name", STRATEGY_NAMES)
def test_every_strategy_name_builds_on_the_cpu(name):
    """Every reference name builds with device="cpu" (the two optional
    packages' names raise), and without CUDA and without a device raises as
    BARK does."""
    td = make_domain(tdomain)
    kwargs = {"fidelity_costs": [1.0, 0.5]} if name == "LeafMOGP" else {}
    if name in NEEDS_PACKAGE:
        with pytest.raises(RuntimeError, match="requires"):
            tk.make_strategy(name, td, device="cpu")
        return
    s = tk.make_strategy(name, td, seed=1, device="cpu", **kwargs)
    assert callable(s.ask) and callable(s.tell)
    if name not in NO_DEVICE:
        assert s.device == torch.device("cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                tk.make_strategy(name, td, seed=1, **kwargs)
    if name in ("BART", "BARTGrid"):
        assert isinstance(s.surrogate, BARTSurrogate)
    if name == "GridUCB":
        assert isinstance(s.surrogate, tk.BARKSurrogate)


def test_grid_ucb_and_relaxed_gp_loops_on_the_cpu():
    td = make_domain(tdomain)
    X, y = data(8)
    f = lambda Z: np.sin(3 * Z[:, 0]) + Z[:, 3] ** 2  # noqa: E731
    small = BARTParams(warmup_steps=10, num_samples=4, num_trees=6, node_limit=16)
    for s in (tk.make_strategy("BARTGrid", td, device="cpu", max_grid=256, bart_params=small),
              tk.make_strategy("RelaxedGP", td, device="cpu", fit_steps=10,
                               num_candidates=128)):
        s.tell(X, f(X))
        for _ in range(2):
            c = s.ask(1)
            assert c.shape == (1, 4) and np.array_equal(td.round(c), c)
            s.add(c, f(c))
        assert len(s.y) == 10


def test_relaxed_gp_ask_refuses_reduced_matmul_precision():
    td = make_domain(tdomain)
    X, y = data()
    s = tbase.RelaxedGPStrategy(td, fit_steps=2, device="cpu")
    s.tell(X, y)
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="full-float32"):
            s.ask(1)
    finally:
        torch.set_float32_matmul_precision("highest")
