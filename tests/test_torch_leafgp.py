"""The port's LeafGP against the JAX package's, on the CPU.

Both packages fit the same booster forest (exact), build the same agreement
Gram (exact) and run the same Adam on the MLL from the same start: the
port's ``torch.optim.Adam(lr=0.05)`` and the reference's ``optax.adam(0.05)``
are the same update, and only float32 round-off in the Cholesky backward
separates the trajectories. Tolerances: the first 20 losses within 1e-4
relative, the fitted noise and scale within 2e-3 relative, the MLL at them
(float64) within 1e-4 relative; predictions and acquisition scores from one
state carried across by ``convert`` within 1e-4 relative + 1e-5, predictions
compared as the standardized mean and variance (the variance is
``prior - quad`` in float32 in both packages, each about 1e-5 from the
float64 value on these data; its square root would amplify that where the
variance is small). The reference runs with JAX's x64 mode off (the suite turns it on), so that it
computes in float32 as the port does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bark_tpu.optimizer.acquisition as jacq
from bark_tpu.benchmarks import map_benchmark as jmap_benchmark
from bark_tpu.domain import CategoricalInput, ContinuousInput, Domain, IntegerInput
from bark_tpu.fitting.booster import fit_booster_forest as jfit
from bark_tpu.forest import gram_from_leaves as jgram
from bark_tpu.forest import route_forest as jroute
from bark_tpu.models import leafgp as jleafgp
from bark_tpu.ops.pallas_gram import gram_from_leaves_pallas

import bark_tpu_torch.optimizer.acquisition as tacq
import bark_tpu_torch.strategies.tree_kernel as tk
from bark_tpu_torch.benchmarks import map_benchmark
from bark_tpu_torch.convert import domain_from_reference, leafgp_from_reference
from bark_tpu_torch.models import leafgp as tleafgp
from bark_tpu_torch.ops.gram import gram_from_leaves

N = 32  # one shape for every reference fit, so that each jitted function compiles once
ROUNDS = 15


def x64_off():
    return jax.enable_x64(False)


def t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def mixed_domain():
    return Domain([
        ContinuousInput("x_0", (0.0, 1.0)),
        CategoricalInput("c_0", ("a", "b", "c", "d")),
        IntegerInput("i_0", (0, 6)),
    ])


def case_data(which):
    """(reference domain, X, y) at N points."""
    if which == "tree":
        bench = jmap_benchmark("TreeFunction", dim=3, m=10, function_seed=2)
        X = bench.domain.sample(N, np.random.default_rng(0))
        return bench.domain, X, bench.f(X)
    dom = mixed_domain()
    rng = np.random.default_rng(1)
    X = dom.sample(N, rng)
    y = np.cos(5 * X[:, 0]) + (X[:, 1] == 2) - 0.2 * X[:, 2] + 0.1 * rng.standard_normal(N)
    return dom, X, y


@pytest.fixture(scope="module", params=["tree", "mixed"])
def case(request):
    dom, X, y = case_data(request.param)
    with x64_off():
        ref = jleafgp.LeafGPSurrogate(dom, num_boost_round=ROUNDS).fit(X, y)
    return dom, X, y, ref


def mll64(gram, y, noise, scale):
    gram = np.asarray(gram, np.float64)
    y = np.asarray(y, np.float64)
    K = scale * gram + (1e-6 + noise) * np.eye(len(y))
    L = np.linalg.cholesky(K)
    z = np.linalg.solve(L, y)
    return -0.5 * (z @ z + 2.0 * np.log(np.diag(L)).sum())


def assert_same_moments(scaler, mu, sd, mu_r, sd_r, rtol=1e-4, atol=1e-5):
    """Standardized mean and variance within ``rtol`` relative + ``atol``."""
    def std(m, s):
        m, s = np.asarray(m, np.float64), np.asarray(s, np.float64)
        return (m - scaler.mean) / scaler.std, (s / scaler.std) ** 2

    (m, v), (m_r, v_r) = std(mu, sd), std(mu_r, sd_r)
    np.testing.assert_allclose(m, m_r, rtol=rtol, atol=atol)
    np.testing.assert_allclose(v, v_r, rtol=rtol, atol=atol)


def reference_gram(ref, X):
    forest = jax.tree.map(lambda a: a[0], ref.model.forest)
    with x64_off():
        leaves = jroute(forest, jnp.asarray(X), jnp.asarray(ref.domain.feature_types()))
        return leaves, jgram(leaves, leaves, ref.node_limit)


def test_gram_equals_the_reference(case):
    """The single-forest Gram (the same leaves twice, as the fit calls it)
    equals the reference's Pallas kernel K1 (interpret mode) exactly, and
    the reference's one-hot Gram in its counts (whose division XLA may
    round one ulp apart)."""
    dom, X, y, ref = case
    leaves, gram = reference_gram(ref, X)
    tl = t(leaves, torch.int32)
    port = gram_from_leaves(tl, tl, node_limit=64).numpy()
    with x64_off():
        pallas = gram_from_leaves_pallas(leaves, leaves, interpret=True)
    np.testing.assert_array_equal(port, np.asarray(pallas))
    m = leaves.shape[1]
    np.testing.assert_array_equal(np.rint(port * m), np.rint(np.asarray(gram) * m))
    np.testing.assert_allclose(port, np.asarray(gram), rtol=2**-23, atol=0)


def test_fit_hypers_matches_the_reference(case):
    dom, X, y, ref = case
    _, gram = reference_gram(ref, X)
    y_std = np.asarray(ref.train_data[1])
    with x64_off():
        noise_r, scale_r, losses_r = jleafgp._fit_hypers(
            jnp.asarray(gram, jnp.float32), jnp.asarray(y_std, jnp.float32))
    noise, scale, losses = tleafgp._fit_hypers(t(gram, torch.float32), t(y_std, torch.float32))
    assert losses.shape == (200,)
    np.testing.assert_allclose(losses[:20].numpy(), np.asarray(losses_r)[:20], rtol=1e-4)
    np.testing.assert_allclose([float(noise), float(scale)],
                               [float(noise_r), float(scale_r)], rtol=2e-3)
    np.testing.assert_allclose(mll64(gram, y_std, float(noise), float(scale)),
                               mll64(gram, y_std, float(noise_r), float(scale_r)), rtol=1e-4)
    # Adam climbed: the fitted MLL is not below the MLL at its start
    assert mll64(gram, y_std, float(noise), float(scale)) >= mll64(gram, y_std, 0.1, 1.0)


def test_fit_matches_the_reference(case):
    dom, X, y, ref = case
    port = tleafgp.LeafGPSurrogate(domain_from_reference(dom), num_boost_round=ROUNDS,
                                   device="cpu").fit(X, y)
    for a, b in zip(ref.model.forest, port.model.forest):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert port.model.forest.is_leaf.shape == (1, ROUNDS, 64)
    assert port.model.noise.shape == port.model.scale.shape == (1,)
    np.testing.assert_allclose(port.model.noise.numpy(), np.asarray(ref.model.noise), rtol=2e-3)
    np.testing.assert_allclose(port.model.scale.numpy(), np.asarray(ref.model.scale), rtol=2e-3)
    for a, b in zip(ref.train_data, port.train_data):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert port.train_mask is None and port.is_fitted
    assert (port.scaler.mean, port.scaler.std) == (ref.scaler.mean, ref.scaler.std)
    assert port.model_as_tuple() is port.model and port.device == torch.device("cpu")


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("observed", [True, False])
def test_converted_surrogate_predicts_as_the_reference(case, batched, observed):
    dom, X, y, ref = case
    port = leafgp_from_reference(ref, device="cpu")
    C = dom.sample(50, np.random.default_rng(9))
    with x64_off():
        mu_r, sd_r = ref.predict(C, batched=batched, predict_observed=observed)
    mu, sd = port.predict(C, batched=batched, predict_observed=observed)
    assert mu.shape == np.shape(mu_r) == ((1, 50, 1) if batched else (50, 1))
    assert_same_moments(port.scaler, mu, sd, mu_r, sd_r)


def test_single_forest_acquisition_matches_the_reference(case):
    """The dense build and its scores over the batch of one forest, as
    ``TreeKernelStrategy`` calls them for LeafGP."""
    dom, X, y, ref = case
    port = leafgp_from_reference(ref, device="cpu")
    ft = dom.feature_types()
    C = dom.sample(64, np.random.default_rng(10))
    with x64_off():
        state = jacq.build_acquisition(ref.model, *ref.train_data, jnp.asarray(ft))
        want = jacq.evaluate_acquisition(state, jnp.asarray(C), jnp.asarray(ft))
    acq = tacq.build_acquisition(port.model, *port.train_data, t(ft),
                                 train_mask=port.train_mask)
    got = tacq.evaluate_acquisition(acq, t(C), t(ft))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_make_strategy_runs_the_leafgp_loop():
    bench = map_benchmark("TreeFunction", dim=2, m=10, function_seed=4)
    dom = bench.domain
    s = tk.make_strategy("LeafGP", dom, seed=0, num_candidates=256, num_rounds=2,
                         num_boost_round=12, device="cpu")
    assert isinstance(s, tk.TreeKernelStrategy)
    assert isinstance(s.surrogate, tleafgp.LeafGPSurrogate)
    assert s.surrogate.num_boost_round == 12 and s.device == torch.device("cpu")
    X = dom.sample(16, np.random.default_rng(0))
    s.tell(X, bench.f(X))
    lo, hi = dom.bounds("ordinal").T
    for _ in range(3):
        c = s.ask()
        assert c.shape == (1, 2) and (lo <= c[0]).all() and (c[0] <= hi).all()
        s.add(c, bench.f(c))
    assert len(s.y) == 19 and s.fallbacks == 0
    assert s.surrogate.model.forest.is_leaf.shape == (1, 12, 64)


@pytest.mark.parametrize("entry", ["fit", "predict"])
def test_entry_points_refuse_reduced_matmul_precision(case, entry):
    """ROADMAP queue 3 check a: fit and predict raise while float32 matmuls
    may run at reduced precision."""
    dom, X, y, ref = case
    port = leafgp_from_reference(ref, device="cpu")
    calls = {"fit": lambda: port.fit(X, y), "predict": lambda: port.predict(X[:4])}
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="matmul"):
            calls[entry]()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_device_must_be_asked_for():
    dom = domain_from_reference(mixed_domain())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tleafgp.LeafGPSurrogate(dom)
        with pytest.raises(RuntimeError, match="CUDA"):
            tk.make_strategy("LeafGP", dom)
    assert tleafgp.LeafGPSurrogate(dom, device="cpu").device == torch.device("cpu")
