"""Parity of the port's three acquisition builds and evaluators with the
JAX reference, on the CPU (the port's kernels run as their plain versions).

Forests come from the reference's prior sampler, data from a numpy seed in
float32. Leaf routings, null-tree counts and indicators are integers and
must match exactly. The float outputs come from float32 factorizations along
different routes (one batched factorization and products with the inverse
factor in the port, per-sample solves in the reference), so they agree to
the tolerance each test states. Scores are compared twice: from the port's
own state, and from a reference state converted field by field
(``acquisition_state_from_reference``), which isolates the evaluator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bark_tpu.forest as jforest
import bark_tpu.optimizer.acquisition as jacq
from bark_tpu.domain import CategoricalInput, ContinuousInput, Domain, IntegerInput
from bark_tpu.fitting.prior import sample_forest_prior
from bark_tpu.fitting.sampler import BARKModel as JaxModel

import bark_tpu_torch.forest as tforest
import bark_tpu_torch.optimizer.acquisition as tacq
from bark_tpu_torch.convert import (
    acquisition_state_from_reference,
    forest_from_reference,
    model_from_reference,
)
from bark_tpu_torch.fitting.sampler import BARKModel

MAX_DEPTH = 8
M, NODE_LIMIT, CHAINS, SAMPLES = 8, 32, 2, 3
S = CHAINS * SAMPLES
N, N_PAD, CANDS = 20, 32, 64
MAX_LEAVES = (NODE_LIMIT + 1) // 2


def mixed_domain():
    return Domain(
        [
            ContinuousInput("x_0", (0.0, 1.0)),
            ContinuousInput("x_1", (-2.0, 3.0)),
            IntegerInput("i_0", (0, 5)),
            CategoricalInput("c_0", ("a", "b", "c", "d")),
        ]
    )


def prior_model(dom, seed=0) -> JaxModel:
    """(CHAINS, SAMPLES) posterior-shaped model from the reference's prior;
    the prior leaves some trees as stumps, so the null-tree rescaling is
    exercised."""
    forest = sample_forest_prior(
        jax.random.key(seed), M, jnp.asarray(dom.bounds("bitmask")),
        jnp.asarray(dom.feature_types()), num_samples=S,
        node_limit=NODE_LIMIT, max_depth=MAX_DEPTH,
    )
    forest = jax.tree.map(lambda a: a.reshape(CHAINS, SAMPLES, *a.shape[1:]), forest)
    noise = jnp.linspace(0.05, 0.4, S, dtype=jnp.float32).reshape(CHAINS, SAMPLES)
    scale = jnp.linspace(0.5, 2.0, S, dtype=jnp.float32).reshape(CHAINS, SAMPLES)
    return JaxModel(forest, noise, scale)


def padded_data(dom, seed=1):
    rng = np.random.default_rng(seed)
    X = dom.sample(N, rng)
    X_pad = np.vstack([X, np.tile(X[:1], (N_PAD - N, 1))]).astype(np.float32)
    y_pad = np.zeros(N_PAD, np.float32)
    y_pad[:N] = rng.standard_normal(N)
    mask = np.zeros(N_PAD, np.float32)
    mask[:N] = 1.0
    cands = dom.sample(CANDS, rng).astype(np.float32)
    return X_pad, y_pad, mask, cands


@pytest.fixture(scope="module")
def case():
    dom = mixed_domain()
    model = prior_model(dom)
    X, y, mask, cands = padded_data(dom)
    ft = dom.feature_types()
    jargs = (model, jnp.asarray(X), jnp.asarray(y), jnp.asarray(ft), MAX_DEPTH)
    t = torch.as_tensor
    targs = (model_from_reference(model, device="cpu"), t(X), t(y), t(ft), MAX_DEPTH)
    return {
        "jargs": jargs, "targs": targs, "jmask": jnp.asarray(mask), "tmask": t(mask),
        "jcands": jnp.asarray(cands), "tcands": t(cands), "jft": jnp.asarray(ft), "tft": t(ft),
    }


def test_num_null_trees_and_nonull_indicator_are_exact(case):
    model = case["jargs"][0]
    flat = jax.tree.map(lambda a: a.reshape(-1, M, NODE_LIMIT), model.forest)
    port = forest_from_reference(flat, device="cpu")
    n_null = tforest.num_null_trees(port)
    np.testing.assert_array_equal(n_null.numpy(), np.asarray(jforest.num_null_trees(flat)))
    assert n_null.dtype == torch.int32 and 0 < int(n_null.sum()) < S * M
    leaves = tforest.route_forest(port, case["tcands"], case["tft"], MAX_DEPTH)
    got = tacq._compact_indicator_nonull(port, leaves, MAX_LEAVES)
    for s in range(S):
        tree = jax.tree.map(lambda a: a[s], flat)
        ref = jacq._compact_indicator_nonull(
            tree, jnp.asarray(leaves[s].numpy()), MAX_LEAVES
        )
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("masked", [True, False], ids=["padded", "unpadded"])
def test_dense_build_and_scores_match_reference(case, masked):
    """Routing and null counts exact; K^-1 and K^-1 y rtol 2e-4 of their
    largest entry (condition number up to ~1e3 in float32); LCB scores rtol
    2e-4, atol 5e-5, from the port's state and from a converted one."""
    jargs, targs = case["jargs"], case["targs"]
    jmask, tmask = (case["jmask"], case["tmask"]) if masked else (None, None)
    if not masked:
        jargs = (jargs[0], jargs[1][:N], jargs[2][:N], *jargs[3:])
        targs = (targs[0], targs[1][:N], targs[2][:N], *targs[3:])
    ref = jacq.build_acquisition(*jargs, train_mask=jmask)
    acq = tacq.build_acquisition(*targs, train_mask=tmask)
    assert torch.equal(acq.train_leaves, torch.as_tensor(np.array(ref.train_leaves)))
    np.testing.assert_array_equal(acq.n_null.numpy(), np.asarray(ref.n_null))
    np.testing.assert_array_equal(acq.train_mask.numpy(), np.asarray(ref.train_mask))
    for name in ("K_inv", "K_inv_y"):
        got, want = getattr(acq, name).numpy(), np.asarray(getattr(ref, name))
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max(), name
    want = np.asarray(jacq.evaluate_acquisition(ref, case["jcands"], case["jft"], MAX_DEPTH))
    converted = acquisition_state_from_reference(ref, device="cpu")
    assert isinstance(converted, tacq.AcquisitionState)
    for state in (acq, converted):
        got = tacq.evaluate_acquisition(state, case["tcands"], case["tft"], MAX_DEPTH)
        assert got.shape == (CANDS,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=5e-5)
    # kappa reaches the score
    lo = tacq.evaluate_acquisition(acq, case["tcands"], case["tft"], MAX_DEPTH, kappa=3.0)
    assert (lo.numpy() < want).all()


@pytest.mark.parametrize("row_block", [None, 8], ids=["one-block", "row-blocks"])
def test_factored_build_and_scores_match_reference(case, row_block, monkeypatch):
    """beta and V relative to their largest entry, 2e-4; var0 exact; scores
    rtol 2e-4, atol 5e-5, and equal to the dense path's within the same;
    also with the statistics accumulated over blocks of 8 rows."""
    if row_block:
        monkeypatch.setattr(tacq, "ROW_BLOCK", row_block)
    ref = jacq.build_acquisition_lr(*case["jargs"], train_mask=case["jmask"], row_block=row_block)
    acq = tacq.build_acquisition_lr(*case["targs"], train_mask=case["tmask"])
    for name in ("beta", "V"):
        got, want = getattr(acq, name).numpy(), np.asarray(getattr(ref, name))
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max(), name
    np.testing.assert_array_equal(acq.var0.numpy(), np.asarray(ref.var0))
    np.testing.assert_array_equal(acq.scale.numpy(), np.asarray(ref.scale))
    want = np.asarray(jacq.evaluate_acquisition(ref, case["jcands"], case["jft"], MAX_DEPTH))
    converted = acquisition_state_from_reference(ref, device="cpu")
    assert isinstance(converted, tacq.AcquisitionStateLR)
    for state in (acq, converted):
        got = tacq.evaluate_acquisition(state, case["tcands"], case["tft"], MAX_DEPTH)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=5e-5)
    dense = tacq.evaluate_acquisition(
        tacq.build_acquisition(*case["targs"], train_mask=case["tmask"]),
        case["tcands"], case["tft"], MAX_DEPTH,
    )
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=2e-4, atol=5e-5)


def test_thompson_build_and_scores_match_reference(case):
    """The reference's key is split as it splits it, and the pick and the
    normal vector go to the port as arguments: the same forest is chosen
    (exact), theta agrees to 2e-4 of its largest entry, scores to rtol 2e-4,
    atol 5e-5."""
    key = jax.random.key(11)
    ref = jacq.build_acquisition_ts(key, *case["jargs"], train_mask=case["jmask"])
    k_pick, k_draw = jax.random.split(key)
    pick = int(jax.random.randint(k_pick, (), 0, S))
    eps = np.asarray(jax.random.normal(k_draw, (M * MAX_LEAVES,), jnp.float32))
    acq = tacq.build_acquisition_ts(
        pick, torch.as_tensor(eps), *case["targs"], train_mask=case["tmask"]
    )
    for k in tforest.FOREST_FIELDS:
        np.testing.assert_array_equal(
            getattr(acq.forest, k).numpy(), np.asarray(getattr(ref.forest, k))
        )
    got, want = acq.theta.numpy(), np.asarray(ref.theta)
    assert got.shape == want.shape == (M * MAX_LEAVES,)
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()
    want = np.asarray(jacq.evaluate_acquisition(ref, case["jcands"], case["jft"], MAX_DEPTH))
    converted = acquisition_state_from_reference(ref, device="cpu")
    assert isinstance(converted, tacq.AcquisitionStateTS)
    for state in (acq, converted):
        got = tacq.evaluate_acquisition(state, case["tcands"], case["tft"], MAX_DEPTH)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=5e-5)


def test_thompson_draws_come_from_the_generator():
    gen = torch.Generator().manual_seed(5)
    picks = set()
    for _ in range(40):
        pick, eps = tacq.draw_acquisition_ts(gen, S, 16)
        assert 0 <= pick < S and eps.shape == (16,) and eps.dtype == torch.float32
        picks.add(pick)
    assert len(picks) > 1
    again = tacq.draw_acquisition_ts(torch.Generator().manual_seed(5), S, 16)
    first = tacq.draw_acquisition_ts(torch.Generator().manual_seed(5), S, 16)
    assert again[0] == first[0] and torch.equal(again[1], first[1])


def test_all_null_forest_scores_the_prior(case):
    """Every tree a stump: mu = 0 and var = scale on the dense and the
    factored path, as in the reference (atol 1e-6)."""
    _, X, y, ft, _ = case["targs"]
    forest = tforest.create_empty_forest(M, NODE_LIMIT, (2,))
    model = BARKModel(forest, torch.tensor([0.1, 0.3]), torch.tensor([1.0, 2.0]))
    want = float(np.mean([-1.96 * np.sqrt(1.0), -1.96 * np.sqrt(2.0)]))
    for build in (tacq.build_acquisition, tacq.build_acquisition_lr):
        acq = build(model, X, y, ft, MAX_DEPTH, train_mask=case["tmask"])
        got = tacq.evaluate_acquisition(acq, case["tcands"], ft, MAX_DEPTH)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_factored_cholesky_escalates_per_matrix():
    """M = I + PSD that float32 cannot factor as it is gets the damped
    factorization; a good one in the same batch is left as it was."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(2, 10, 10)).astype(np.float32)
    M_ = np.eye(10, dtype=np.float32) + a @ np.swapaxes(a, 1, 2)
    w, U = np.linalg.eigh(M_[1].astype(np.float64))
    w[0] = -5e-5
    M_[1] = ((U * w) @ U.T).astype(np.float32)
    L, E = tacq._robust_cholesky_psd_plus_eye(torch.as_tensor(M_))
    assert torch.isfinite(L).all()
    torch.testing.assert_close(L[0] @ L[0].T, torch.as_tensor(M_[0]), rtol=1e-5, atol=1e-5)
    damped = torch.as_tensor(M_[1]) + 1e-4 * torch.eye(10)
    torch.testing.assert_close(L[1] @ L[1].T, damped, rtol=1e-4, atol=1e-5)
    ref = np.asarray(jacq._robust_cholesky_psd_plus_eye(jnp.asarray(M_[1])))
    assert np.abs(L[1].numpy() - ref).max() <= 5e-2 * np.abs(ref).max()
    torch.testing.assert_close(E @ L, torch.eye(10).expand(2, 10, 10), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize(
    "entry", ["build_acquisition", "build_acquisition_lr", "build_acquisition_ts",
              "evaluate_acquisition", "forest_predict", "forest_predict_leaf"],
)
def test_entry_points_refuse_reduced_matmul_precision(case, entry):
    """ROADMAP queue 3 check a on this slice: every entry point raises while
    float32 matmuls may run at reduced precision."""
    import bark_tpu_torch.models.gp as tgp

    model, X, y, ft, depth = case["targs"]
    calls = {
        "build_acquisition": lambda: tacq.build_acquisition(model, X, y, ft, depth),
        "build_acquisition_lr": lambda: tacq.build_acquisition_lr(model, X, y, ft, depth),
        "build_acquisition_ts": lambda: tacq.build_acquisition_ts(
            0, torch.zeros(M * MAX_LEAVES), model, X, y, ft, depth),
        "evaluate_acquisition": lambda: tacq.evaluate_acquisition(
            None, case["tcands"], ft, depth),
        "forest_predict": lambda: tgp.forest_predict(
            model.forest, model.noise, model.scale, X, y, case["tcands"], ft, depth),
        "forest_predict_leaf": lambda: tgp.forest_predict_leaf(
            model.forest, model.noise, model.scale, X, y, case["tcands"], ft, depth),
    }
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="matmul"):
            calls[entry]()
    finally:
        torch.set_float32_matmul_precision("highest")


def test_evaluate_acquisition_refuses_an_unknown_state(case):
    with pytest.raises(TypeError, match="acquisition state"):
        tacq.evaluate_acquisition(object(), case["tcands"], case["tft"], MAX_DEPTH)
    assert tacq.DEFAULT_KAPPA == jacq.DEFAULT_KAPPA and tacq.LR_THRESHOLD == jacq.LR_THRESHOLD
