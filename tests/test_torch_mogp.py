"""The port's LeafMOGP and multi-fidelity loop against the JAX package's, on
the CPU.

Both packages fit the same booster forest (exact) and run the same Adam
(``torch.optim.Adam(lr=0.05)`` against ``optax.adam(0.05)``, the same
update) over the three (T,) task and noise parameters from the same start.
Float32 round-off in the Cholesky backward separates the trajectories, and
the MLL is flat along the trade-off of w w^T against diag(v), so 300 steps
carry the gap further than LeafGP's 200 do. Tolerances, each case with the
gap measured on these data: the first 20 losses within 1e-4 of the
trajectory's scale (its largest |loss|; the loss crosses zero, where a
relative bound means nothing; measured 1.0e-5); the fitted parameters within
5e-3 relative on CurrinExp2D (measured 2.6e-3 through the full fit, whose
Gram differs from the reference's by one ulp) and 1e-2 on a three-task
problem (measured 3.3e-3), 1e-5 absolute for a parameter near 0; the MLL
at them within 1e-4 relative (measured 2.1e-5) and 2e-3 (measured 9.9e-4)
respectively. From one state carried across by ``convert``: ``predict``
(standardized mean and variance) and ``_posterior_joint`` within 1e-4
relative + 1e-5, the acquisition scores within 1e-4, the information gain
within 1e-4 relative with the same fidelity chosen, and
``MultiFidelityStrategy.ask`` fed the reference's search draws returns the
same point (1e-6) and fidelity. The f* draws replay one numpy seed exactly
from the same joint posterior; from the port's own posterior (within 1e-4
of the reference's) they differ up to 1.3e-2, since ``eigh`` of a
covariance with repeated eigenvalues may return any basis of their
eigenspace. The reference runs with JAX's x64 mode off (the suite turns it
on), so that it computes in float32 as the port does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bark_tpu.constraints as jcons
import bark_tpu.optimizer.acquisition as jacq
from bark_tpu.benchmarks import map_benchmark as jmap_benchmark
from bark_tpu.fitting.booster import fit_booster_forest as jfit
from bark_tpu.forest import gram_from_leaves as jgram
from bark_tpu.forest import route_forest as jroute
from bark_tpu.models import mogp as jmogp
from bark_tpu.models.sampling import fstar_samples_mogp as jfstar
from bark_tpu.optimizer import fidelity as jfid
from bark_tpu.strategies.multi_fidelity import MultiFidelityStrategy as JaxMF

import bark_tpu_torch.constraints as tcons
import bark_tpu_torch.optimizer.acquisition as tacq
import bark_tpu_torch.strategies.multi_fidelity as tmf
import bark_tpu_torch.strategies.tree_kernel as tk
from bark_tpu_torch.benchmarks import map_benchmark
from bark_tpu_torch.benchmarks.mf_bo import run_study
from bark_tpu_torch.convert import (
    acquisition_state_from_reference,
    domain_from_reference,
    mogp_from_reference,
)
from bark_tpu_torch.models import mogp as tmogp
from bark_tpu_torch.models.sampling import fstar_samples_mogp as tfstar
from bark_tpu_torch.optimizer import fidelity as tfid
from bark_tpu_torch.optimizer.search import sample_feasible
from test_torch_leafgp import assert_same_moments
from test_torch_search import reference_search_draws

N = 24  # one shape for every reference fit, so that each jitted function compiles once
ROUNDS = 15
COSTS = (1.0, 0.25)


def x64_off():
    return jax.enable_x64(False)


def t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def currin_data(seed=0, n=N):
    bench = jmap_benchmark("CurrinExp2D")
    X = bench.domain.sample(n, np.random.default_rng(seed))
    fid = np.arange(n) % 2
    return bench, X, fid, bench.f_fidelity(X, fid)


@pytest.fixture(scope="module")
def case():
    bench, X, fid, y = currin_data()
    with x64_off():
        ref = jmogp.LeafMOGPSurrogate(bench.domain, num_tasks=2, num_boost_round=ROUNDS)
        ref.fit(X, fid, y)
    return bench, X, fid, y, ref


def mll64(gram, tasks, y, params):
    w, v, r = (np.asarray(p, np.float64) for p in params)
    B = np.outer(w, w) + np.diag(np.logaddexp(v, 0.0))
    K = np.asarray(gram, np.float64) * B[tasks[:, None], tasks[None, :]]
    K = K + np.diag(1e-6 + np.logaddexp(r, 0.0)[tasks])
    L = np.linalg.cholesky(K)
    z = np.linalg.solve(L, np.asarray(y, np.float64))
    return -0.5 * (z @ z + 2.0 * np.log(np.diag(L)).sum())


def three_task_data():
    """A synthetic three-task problem on the Currin domain."""
    bench, X, _, _ = currin_data(seed=4)
    tasks = np.random.default_rng(5).integers(0, 3, N)
    y = np.sin(6 * X[:, 0]) + X[:, 1] + 0.3 * tasks + 0.05 * np.random.default_rng(6).normal(size=N)
    return bench.domain, X, tasks, (y - y.mean()) / y.std()


# per case: (relative bound on the fitted parameters, on the MLL at them)
FIT_RTOL = {"currin": (5e-3, 1e-4), "three_tasks": (1e-2, 2e-3)}


def assert_losses_agree(losses, losses_r):
    """The first 20 losses within 1e-4 of the trajectory's scale."""
    got, want = np.asarray(losses)[:20], np.asarray(losses_r)[:20]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("which", ["currin", "three_tasks"])
def test_fit_mogp_hypers_matches_the_reference(which):
    if which == "currin":
        bench, X, tasks, y = currin_data()
        dom, y = bench.domain, (y - y.mean()) / y.std()
    else:
        dom, X, tasks, y = three_task_data()
    T = int(tasks.max()) + 1
    with x64_off():
        forest = jfit(X, y, dom, num_boost_round=ROUNDS)
        leaves = jroute(forest, jnp.asarray(X), jnp.asarray(dom.feature_types()))
        gram = jgram(leaves, leaves, 64)
        params_r, losses_r = jmogp.fit_mogp_hypers(
            gram, jnp.asarray(tasks, jnp.int32), jnp.asarray(y, jnp.float32), T)
    params, losses = tmogp.fit_mogp_hypers(t(gram, torch.float32), t(tasks), t(y, torch.float32), T)
    assert losses.shape == (300,) and all(p.shape == (T,) for p in params)
    assert_losses_agree(losses, losses_r)
    rtol_params, rtol_mll = FIT_RTOL[which]
    for name, got, want in zip(tmogp.MOGPParams._fields, params, params_r):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol_params, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(mll64(gram, tasks, y, params), mll64(gram, tasks, y, params_r),
                               rtol=rtol_mll)
    start = (np.ones(T), np.zeros(T), np.full(T, -1.5))
    assert mll64(gram, tasks, y, params) >= mll64(gram, tasks, y, start)


def test_task_covariance_and_kernel_match_the_reference():
    rng = np.random.default_rng(2)
    p = [rng.normal(size=3).astype(np.float32) for _ in range(3)]
    gram = rng.uniform(size=(7, 5)).astype(np.float32)
    t1, t2 = rng.integers(0, 3, 7), rng.integers(0, 3, 5)
    with x64_off():
        jp = jmogp.MOGPParams(*(jnp.asarray(a) for a in p))
        B_r = jmogp.task_covariance(jp)
        K_r = jmogp.mogp_kernel(jnp.asarray(gram), jnp.asarray(t1), jnp.asarray(t2), jp)
    tp = tmogp.MOGPParams(*(t(a) for a in p))
    np.testing.assert_allclose(tmogp.task_covariance(tp).numpy(), np.asarray(B_r), rtol=1e-6)
    np.testing.assert_allclose(tmogp.mogp_kernel(t(gram), t(t1), t(t2), tp).numpy(),
                               np.asarray(K_r), rtol=1e-6)


def test_fit_matches_the_reference(case):
    bench, X, fid, y, ref = case
    port = tmogp.LeafMOGPSurrogate(domain_from_reference(bench.domain), num_tasks=2,
                                   num_boost_round=ROUNDS, device="cpu").fit(X, fid, y)
    for a, b in zip(ref.forest, port.forest):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    Xr, tr, yr, lr, gr = ref.train
    Xp, tp, yp, lp, gp = port.train
    for a, b in ((Xr, Xp), (tr, tp), (yr, yp), (lr, lp)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_allclose(gp.numpy(), np.asarray(gr), rtol=2**-23, atol=0)
    rtol_params, rtol_mll = FIT_RTOL["currin"]
    for name, got, want in zip(tmogp.MOGPParams._fields, port.params, ref.params):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol_params, atol=1e-5,
                                   err_msg=name)
    tasks = np.asarray(tr)
    np.testing.assert_allclose(mll64(gr, tasks, yr, port.params), mll64(gr, tasks, yr, ref.params),
                               rtol=rtol_mll)
    assert (port.scaler.mean, port.scaler.std) == (ref.scaler.mean, ref.scaler.std)


@pytest.mark.parametrize("observed", [True, False])
def test_converted_surrogate_predicts_as_the_reference(case, observed):
    bench, X, fid, y, ref = case
    port = mogp_from_reference(ref, device="cpu")
    C = bench.domain.sample(40, np.random.default_rng(7))
    tasks = np.random.default_rng(8).integers(0, 2, 40)
    with x64_off():
        mu_r, sd_r = ref.predict(C, tasks, predict_observed=observed)
        jmu, jcov = ref._posterior_joint(C, tasks)
    mu, sd = port.predict(C, tasks, predict_observed=observed)
    assert mu.shape == sd.shape == (40,)
    assert_same_moments(port.scaler, mu, sd, mu_r, sd_r)
    pmu, pcov = port._posterior_joint(C, tasks)
    np.testing.assert_allclose(pmu.numpy(), np.asarray(jmu), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pcov.numpy(), np.asarray(jcov), rtol=1e-4, atol=1e-5)


def test_acquisition_matches_the_reference(case):
    bench, X, fid, y, ref = case
    port = mogp_from_reference(ref, device="cpu")
    ft = bench.domain.feature_types()
    C = bench.domain.sample(128, np.random.default_rng(11))
    with x64_off():
        state_r = jacq.build_acquisition_mogp(ref)
        want = jacq.evaluate_acquisition(state_r, jnp.asarray(C), jnp.asarray(ft))
    state = tacq.build_acquisition_mogp(port)
    assert isinstance(state, tacq.AcquisitionStateMOGP)
    assert state.forest.is_leaf.shape == (1, ROUNDS, 64) and state.K_inv.shape == (N, N)
    got = tacq.evaluate_acquisition(state, t(C), t(ft))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # the converted reference state scores alike
    conv = acquisition_state_from_reference(state_r, device="cpu")
    assert isinstance(conv, tacq.AcquisitionStateMOGP)
    np.testing.assert_allclose(tacq.evaluate_acquisition(conv, t(C), t(ft)).numpy(),
                               np.asarray(want), atol=1e-4)


def test_fstar_samples_replay_the_numpy_seed(case, monkeypatch):
    """From the same joint posterior (the reference's, handed to the port
    as tensors) the draws of one numpy seed are the reference's; the
    posterior itself is held by the predict test."""
    bench, X, fid, y, ref = case
    port = mogp_from_reference(ref, device="cpu")
    with x64_off():
        want = jfstar(ref, X, 16, np.random.default_rng(3))
        mu_r, cov_r = ref._posterior_joint(X, np.zeros(N, np.int64))
    monkeypatch.setattr(port, "_posterior_joint", lambda *a: (t(mu_r), t(cov_r)))
    rng = np.random.default_rng(3)
    got = tfstar(port, X, 16, rng)
    assert got.shape == (16,) and got.dtype == np.float64
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12, atol=1e-12)
    # the generator advanced by the same draws
    r = np.random.default_rng(3)
    r.standard_normal((16, N))
    np.testing.assert_array_equal(rng.standard_normal(3), r.standard_normal(3))


@pytest.mark.parametrize("point", [0, 1, 2])
def test_information_gain_and_fidelity_choice_match_the_reference(case, point):
    bench, X, fid, y, ref = case
    port = mogp_from_reference(ref, device="cpu")
    x = bench.domain.sample(3, np.random.default_rng(12))[point]
    with x64_off():
        f_star = np.asarray(jfstar(ref, X, 16, np.random.default_rng(4)))
        igs_r = [jfid.information_gain(ref, x, f_star, m) for m in (0, 1)]
        choice_r = jfid.propose_fidelity_information_based(ref, x, COSTS, f_star)
    igs = [tfid.information_gain(port, x, f_star, m) for m in (0, 1)]
    np.testing.assert_allclose(igs, igs_r, rtol=1e-4)
    assert tfid.propose_fidelity_information_based(port, x, COSTS, f_star) == choice_r


@pytest.mark.parametrize("seed", [0, 3])
def test_ask_replays_the_reference_search(case, seed, monkeypatch):
    """``MultiFidelityStrategy.ask`` from the reference's state, fed the
    arrays the reference's search draws from its key, proposes the same
    point and fidelity; the numpy generator advances alike."""
    bench, X, fid, y, ref_sur = case
    kwargs = dict(num_candidates=128, num_rounds=2, num_fstar=8, seed=seed)
    ref = JaxMF(bench.domain, list(COSTS), surrogate=ref_sur, **kwargs)
    ref.X, ref.fid, ref.y = X, fid, y
    port = tmf.MultiFidelityStrategy(domain_from_reference(bench.domain), list(COSTS),
                                     surrogate=mogp_from_reference(ref_sur, device="cpu"),
                                     device="cpu", **kwargs)
    port.X, port.fid, port.y = X, fid, y
    _, key = jax.random.split(jax.random.key(seed + 1))
    draws = reference_search_draws(key, 128, 2, 2, 64)
    monkeypatch.setattr(tmf, "draw_search", lambda *a, **k: draws)
    with x64_off():
        x_r, f_r = ref.ask()
    x, f = port.ask()
    assert x.shape == (1, 2) and f in (0, 1)
    np.testing.assert_allclose(x, x_r, atol=1e-6)
    assert f == f_r
    np.testing.assert_array_equal(port._rng.standard_normal(2), ref._rng.standard_normal(2))


def test_run_study_loop():
    """The MF study for four iterations, with the properties the reference's
    own test holds: valid fidelities, cost strictly growing, a finite target
    incumbent that never worsens."""
    records = run_study(seed=0, num_iter=4, num_init=6, num_candidates=64, num_fstar=8,
                        surrogate_kwargs={"num_boost_round": 20}, device="cpu")
    assert len(records) == 4
    assert all(r["fidelity"] in (0, 1) for r in records)
    costs = [r["cum_cost"] for r in records]
    assert all(b > a for a, b in zip(costs, costs[1:]))
    bests = [r["best_target"] for r in records]
    assert all(np.isfinite(b) for b in bests)
    assert all(b2 <= b1 + 1e-12 for b1, b2 in zip(bests, bests[1:]))


def test_cold_start_round_robin_and_make_strategy():
    bench = map_benchmark("CurrinExp2D")
    X = bench.domain.sample(3, np.random.default_rng(0))
    fid = np.zeros(3, np.int64)  # every point at fidelity 0: task 1 unobserved
    s = tk.make_strategy("LeafMOGP", bench.domain, seed=0, fidelity_costs=[1.0, 0.2],
                         device="cpu")
    assert isinstance(s, tmf.MultiFidelityStrategy) and s.device == torch.device("cpu")
    assert isinstance(s.surrogate, tmogp.LeafMOGPSurrogate)
    assert (s.num_candidates, s.num_rounds, s.num_fstar) == (2048, 3, 16)
    x, f = s.ask()
    assert x.shape == (1, 2) and f == 0  # nothing observed yet
    s.tell(X, fid, bench.f_fidelity(X, fid))
    assert not s.has_sufficient_experiments() and s.surrogate.train is None
    x, f = s.ask()
    assert x.shape == (1, 2) and f == 3 % 2
    s.add(x, [f], bench.f_fidelity(x, [f]))
    assert s.has_sufficient_experiments() and s.surrogate.train is not None
    x, f = s.ask()
    lo, hi = bench.domain.bounds("ordinal").T
    assert (lo <= x[0]).all() and (x[0] <= hi).all() and f in (0, 1)


def test_constrained_proposals_survive_the_float32_round_trip():
    """ROADMAP queue 3 check g on the multi-fidelity strategy: its proposal
    is feasible after a cast to float32."""
    dom = domain_from_reference(jmap_benchmark("CurrinExp2D").domain)
    cons = [tcons.LinearInequalityConstraint(["x_0", "x_1"], [1.0, 1.0], 0.7)]
    dom = type(dom)(dom.inputs, constraints=cons)
    bench = map_benchmark("CurrinExp2D")
    s = tmf.MultiFidelityStrategy(dom, list(COSTS), seed=1, num_candidates=256, num_rounds=2,
                                  num_fstar=8, device="cpu")
    X = sample_feasible(dom, 12, np.random.default_rng(2))
    fid = np.arange(len(X)) % 2
    s.tell(X, fid, bench.f_fidelity(X, fid))
    for _ in range(2):
        x, f = s.ask()
        x32 = np.asarray(x, np.float32).astype(np.float64)
        assert tcons.is_feasible(cons, x32, dom.input_keys).all()
        assert jcons.is_feasible([jcons.LinearInequalityConstraint(["x_0", "x_1"], [1.0, 1.0],
                                                                   0.7)], x32,
                                 dom.input_keys).all()
        s.add(x, [f], bench.f_fidelity(x, [f]))


@pytest.mark.parametrize("entry", ["fit", "posterior_joint", "predict", "build",
                                   "evaluate", "fstar"])
def test_entry_points_refuse_reduced_matmul_precision(case, entry):
    """ROADMAP queue 3 check a: every MOGP entry point raises while float32
    matmuls may run at reduced precision."""
    bench, X, fid, y, ref = case
    port = mogp_from_reference(ref, device="cpu")
    state = tacq.build_acquisition_mogp(port)
    ft = t(bench.domain.feature_types())
    calls = {
        "fit": lambda: port.fit(X, fid, y),
        "posterior_joint": lambda: port._posterior_joint(X[:3], [0, 1, 0]),
        "predict": lambda: port.predict(X[:3], [0, 1, 0]),
        "build": lambda: tacq.build_acquisition_mogp(port),
        "evaluate": lambda: tacq.evaluate_acquisition(state, t(X[:3]), ft),
        "fstar": lambda: tfstar(port, X, 4, np.random.default_rng(0)),
    }
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="matmul"):
            calls[entry]()
    finally:
        torch.set_float32_matmul_precision("highest")


def test_device_must_be_asked_for():
    bench = map_benchmark("CurrinExp2D")
    if not torch.cuda.is_available():
        for make in (lambda: tmogp.LeafMOGPSurrogate(bench.domain),
                     lambda: tmf.MultiFidelityStrategy(bench.domain, list(COSTS)),
                     lambda: tk.make_strategy("LeafMOGP", bench.domain,
                                              fidelity_costs=list(COSTS)),
                     lambda: run_study(0, 1)):
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
    assert tmogp.LeafMOGPSurrogate(bench.domain, device="cpu").device == torch.device("cpu")
