"""Parity of the port's acquisition search with the JAX reference, on the CPU.

The device half of the search takes its randomness as tensors
(``SearchDraws``); the tests split the reference's key as the reference
does, draw the same arrays and feed them to the port. Those reference calls
run with JAX's x64 mode off (the suite turns it on, and under x64 the
reference would draw in float64): candidates, mutations, leaf boxes and
subspaces must then match exactly. The host half consumes a numpy
``Generator`` call for call, so the same generator gives the same point:
exact. Scores are float32 along different routes and are held to the
tolerance each test states.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bark_tpu.constraints as jcons
import bark_tpu.optimizer.acquisition as jacq
import bark_tpu.optimizer.search as jsearch
from bark_tpu.domain import CategoricalInput, ContinuousInput, Domain, IntegerInput
from bark_tpu.fitting.prior import sample_forest_prior
from bark_tpu.fitting.sampler import BARKModel as JaxModel
from bark_tpu.fitting.traversal import node_subspace as jax_node_subspace

import bark_tpu_torch.optimizer.acquisition as tacq
import bark_tpu_torch.optimizer.search as tsearch
from bark_tpu_torch.convert import (
    acquisition_state_from_reference,
    domain_from_reference,
    forest_from_reference,
)
from bark_tpu_torch.fitting.traversal import node_subspace

MAX_DEPTH = 8
M, NODE_LIMIT, S = 8, 32, 6
N, CANDS, TOP_K, ROUNDS = 20, 64, 16, 2


def x64_off():
    return jax.enable_x64(False)


def mixed_domain(constraints=()):
    return Domain(
        [
            ContinuousInput("x_0", (0.0, 1.0)),
            ContinuousInput("x_1", (-2.0, 3.0)),
            IntegerInput("i_0", (0, 5)),
            CategoricalInput("c_0", ("a", "b", "c", "d")),
            ContinuousInput("x_2", (0.1, 0.7)),
        ],
        constraints=constraints,
    )


def prior_forest(dom, seed=0, num=S):
    return sample_forest_prior(
        jax.random.key(seed), M, jnp.asarray(dom.bounds("bitmask")),
        jnp.asarray(dom.feature_types()), num_samples=num,
        node_limit=NODE_LIMIT, max_depth=MAX_DEPTH,
    )


def reference_state(dom, seed=0):
    """A dense reference acquisition state over prior forests."""
    rng = np.random.default_rng(seed + 1)
    model = JaxModel(
        prior_forest(dom, seed),
        jnp.linspace(0.05, 0.4, S, dtype=jnp.float32),
        jnp.linspace(0.5, 2.0, S, dtype=jnp.float32),
    )
    X = jnp.asarray(dom.sample(N, rng))
    y = jnp.asarray(rng.standard_normal(N), jnp.float32)
    return jacq.build_acquisition(model, X, y, jnp.asarray(dom.feature_types()), MAX_DEPTH)


def t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def reference_search_draws(key, n, d, rounds, top_k):
    """The arrays ``bark_tpu.optimizer.search.propose`` draws from ``key``
    (x64 off), as the port's SearchDraws."""
    with x64_off():
        key, k0 = jax.random.split(key)
        k_cont, k_disc = jax.random.split(k0)
        uniform = tsearch.UniformDraws(
            t(jax.random.uniform(k_cont, (n, d))), t(jax.random.uniform(k_disc, (n, d)))
        )
        out = []
        for _ in range(rounds):
            key, k_mut = jax.random.split(key)
            k_pick, k_mask, k_c, k_i, k_cat = jax.random.split(k_mut, 5)
            out.append(tsearch.MutateDraws(
                t(jax.random.randint(k_pick, (n,), 0, top_k), torch.int64),
                t(jax.random.uniform(k_mask, (n, d))), t(jax.random.normal(k_c, (n, d))),
                t(jax.random.normal(k_i, (n, d))), t(jax.random.uniform(k_cat, (n, d))),
            ))
    return tsearch.SearchDraws(uniform, tuple(out))


def test_node_subspace_is_exact():
    """Every node of every tree, active or not: the same (D, 2) box."""
    dom = mixed_domain()
    forest = prior_forest(dom, seed=2, num=3)
    bounds, ft = dom.bounds("bitmask"), dom.feature_types()
    port = forest_from_reference(forest, device="cpu")
    jb, jft = jnp.asarray(bounds), jnp.asarray(ft)
    walk = jax.jit(jax.vmap(jax.vmap(
        lambda tree, node: jax_node_subspace(tree, node, jb, jft, MAX_DEPTH)
    )))
    for node in (0, 1, 2, 5, 9, NODE_LIMIT - 1):
        idx = torch.full((3, M), node, dtype=torch.int32)
        got = node_subspace(port, idx, t(bounds), t(ft), MAX_DEPTH)
        assert got.shape == (3, M, 5, 2) and got.dtype == torch.float32
        want = walk(forest, jnp.full((3, M), node, jnp.int32))
        assert torch.equal(got, t(want)), node


def test_leaf_box_is_exact():
    dom = mixed_domain()
    ref = reference_state(dom)
    acq = acquisition_state_from_reference(ref, device="cpu")
    bounds, ft = dom.bounds("bitmask"), dom.feature_types()
    for x in dom.sample(8, np.random.default_rng(4)):
        want = jsearch._leaf_box(
            ref, jnp.asarray(x), jnp.asarray(bounds), jnp.asarray(ft), MAX_DEPTH
        )
        got = tsearch._leaf_box(acq, t(x), t(bounds), t(ft), MAX_DEPTH)
        assert got.dtype == torch.float32 and torch.equal(got, t(want))
        # x lies in its own box (numerics) and its category is allowed
        box = got.numpy()
        assert (box[[0, 1, 2, 4], 0] <= x[[0, 1, 2, 4]]).all()
        assert (x[[0, 1, 2, 4]] <= box[[0, 1, 2, 4], 1]).all()
        assert int(box[3, 1]) & (1 << int(x[3]))


def test_uniform_candidates_and_mutations_are_exact():
    """From the reference's own draws: bit-identical float32 batches."""
    dom = mixed_domain()
    bounds, ft = dom.bounds("ordinal"), dom.feature_types()
    n, d = 2048, 5
    with x64_off():
        key = jax.random.key(3)
        want = np.asarray(jsearch._uniform_candidates(key, jnp.asarray(bounds), jnp.asarray(ft), n))
        k_cont, k_disc = jax.random.split(key)
        draws = tsearch.UniformDraws(
            t(jax.random.uniform(k_cont, (n, d))), t(jax.random.uniform(k_disc, (n, d)))
        )
    got = tsearch._uniform_candidates(draws, t(bounds), t(ft))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, 2] == got[:, 2].round()).all() and (got[:, 3] <= 3).all()

    parents = want[:TOP_K]
    for sigma in (0.2, 0.05):
        with x64_off():
            key = jax.random.key(5)
            want_m = np.asarray(jsearch._mutate(
                key, jnp.asarray(parents), jnp.asarray(bounds), jnp.asarray(ft), n, sigma
            ))
            k_pick, k_mask, k_c, k_i, k_cat = jax.random.split(key, 5)
            mdraws = tsearch.MutateDraws(
                t(jax.random.randint(k_pick, (n,), 0, TOP_K), torch.int64),
                t(jax.random.uniform(k_mask, (n, d))), t(jax.random.normal(k_c, (n, d))),
                t(jax.random.normal(k_i, (n, d))), t(jax.random.uniform(k_cat, (n, d))),
            )
        got_m = tsearch._mutate(mdraws, t(parents), t(bounds), t(ft), sigma)
        np.testing.assert_array_equal(got_m.numpy(), want_m)


def test_draw_search_shapes_and_seed():
    gen = torch.Generator().manual_seed(1)
    draws = tsearch.draw_search(gen, 32, 5, 3, top_k=8)
    assert len(draws.rounds) == 3
    assert draws.uniform.u_cont.shape == draws.uniform.u_disc.shape == (32, 5)
    for r in draws.rounds:
        assert r.idx.shape == (32,) and r.idx.dtype == torch.int64
        assert 0 <= int(r.idx.min()) and int(r.idx.max()) < 8
        assert all(a.shape == (32, 5) for a in r[1:])
    assert not torch.equal(draws.rounds[0].u_mask, draws.rounds[1].u_mask)
    again = tsearch.draw_search(torch.Generator().manual_seed(1), 32, 5, 3, top_k=8)
    assert torch.equal(again.rounds[2].z_int, draws.rounds[2].z_int)
    assert torch.equal(again.to("cpu").uniform.u_cont, draws.uniform.u_cont)


def test_elite_selection_orders_ties_as_top_k():
    """Scores full of exact ties: the k lowest, lowest index first among
    equals, as ``jax.lax.top_k`` of the negated scores."""
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 4, 200).astype(np.float32)
    _, want = jax.lax.top_k(-jnp.asarray(scores), 50)
    got = tsearch._top(torch.as_tensor(scores), 50)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def linear_constraints(mod):
    return (
        mod.LinearInequalityConstraint(["x_0", "x_1"], [1.0, 1.0], 1.2),
        mod.NChooseKConstraint(["x_0", "i_0"], max_count=1),
    )


def test_penalize_matches_reference():
    """float64 on the host in both packages, returned as float32: exact."""
    dom = mixed_domain(linear_constraints(jcons))
    pdom = domain_from_reference(dom)
    rng = np.random.default_rng(5)
    cands = dom.sample(CANDS, rng)
    scores = rng.standard_normal(CANDS).astype(np.float32)
    want = jsearch._penalize(jnp.asarray(scores), jnp.asarray(cands), dom.constraints, dom.input_keys)
    got = tsearch._penalize(t(scores), t(cands), pdom.constraints, pdom.input_keys)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() > scores).any() and (got.numpy() == scores).any()
    assert tsearch._penalize(t(scores), t(cands), (), pdom.input_keys) is not None


def volume_constraint(mod):
    """A constraint of magnitude ~1.3e6, where one float32 ulp of x moves
    the expression by ~0.1: pi x_1^2 x_2 + 4/3 pi x_1^3 >= 1296000."""
    return mod.FunctionalInequalityConstraint(
        lambda x: -(math.pi * x[1] ** 2 * x[2] + 4.0 / 3.0 * math.pi * x[1] ** 3), -1296000.0
    )


def vessel_domain(mod_cons):
    return Domain(
        [
            IntegerInput("n_0", (1, 99)),
            ContinuousInput("r", (10.0, 200.0)),
            ContinuousInput("l", (10.0, 240.0)),
            CategoricalInput("c", ("a", "b", "c")),
        ],
        constraints=(volume_constraint(mod_cons),),
    )


@pytest.mark.parametrize("which", ["linear", "volume"])
def test_host_side_centering_matches_reference(which):
    """_box_center, _sample_in_box, _constrained_center, sample_feasible and
    _margin_violation from the same numpy generator: the same points."""
    if which == "linear":
        dom = mixed_domain(linear_constraints(jcons))
        box = np.array([[0.3, 0.9], [0.2, 2.5], [1.0, 4.0], [0.0, 0b1011], [0.1, 0.4]], np.float32)
    else:
        dom = vessel_domain(jcons)
        box = np.array([[3.0, 40.0], [20.0, 90.0], [15.0, 200.0], [0.0, 0b101]], np.float32)
    pdom = domain_from_reference(dom)
    assert type(pdom.constraints[0]).__module__ == "bark_tpu_torch.constraints"
    for seed in range(3):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(
            tsearch._box_center(box, pdom, r2), jsearch._box_center(box, dom, r1)
        )
        np.testing.assert_array_equal(
            tsearch._sample_in_box(box, pdom, r2, 9), jsearch._sample_in_box(box, dom, r1, 9)
        )
        got = tsearch._constrained_center(box, pdom, pdom.constraints, r2)
        want = jsearch._constrained_center(box, dom, dom.constraints, r1)
        np.testing.assert_array_equal(got, want)
        assert jcons.is_feasible(dom.constraints, np.asarray(want, np.float64)[None], dom.input_keys)[0]
        np.testing.assert_array_equal(
            tsearch.sample_feasible(pdom, 5, r2), jsearch.sample_feasible(dom, 5, r1)
        )
        # both generators were consumed alike
        assert r1.integers(1 << 30) == r2.integers(1 << 30)
    X = dom.sample(16, np.random.default_rng(9)).astype(np.float64)
    np.testing.assert_array_equal(
        tsearch._margin_violation(pdom.constraints, X, pdom.input_keys, 1e-6),
        jsearch._margin_violation(dom.constraints, X, dom.input_keys, 1e-6),
    )
    # unconstrained sampling is the domain's own
    free = domain_from_reference(Domain(dom.inputs))
    np.testing.assert_array_equal(
        tsearch.sample_feasible(free, 4, np.random.default_rng(2)),
        dom.sample(4, np.random.default_rng(2)),
    )


@pytest.mark.parametrize("constrained", [False, True], ids=["free", "constrained"])
def test_propose_with_replayed_draws_finds_the_reference_optimum(constrained):
    """The port's search, fed the reference's draws and a converted state,
    returns a point whose score under the JAX evaluator is within 1e-4 of
    the reference's best (scores differ by float32 round-off, so an exact
    tie may resolve to another point of the same score); its reported value
    agrees to the same; the leaf-box center keeps that score."""
    dom = mixed_domain(linear_constraints(jcons) if constrained else ())
    pdom = domain_from_reference(dom)
    ref = reference_state(dom, seed=3)
    acq = acquisition_state_from_reference(ref, device="cpu")
    ft = dom.feature_types()
    key = jax.random.key(21)
    seeds = dom.sample(3, np.random.default_rng(8))
    with x64_off():
        x_ref, val_ref = jsearch.propose(
            key, ref, dom, jnp.asarray(ft), num_candidates=CANDS, num_rounds=ROUNDS,
            top_k=TOP_K, max_depth=MAX_DEPTH, return_center=False, seeds=seeds,
        )
    draws = reference_search_draws(key, CANDS, 5, ROUNDS, TOP_K)
    kwargs = dict(top_k=TOP_K, max_depth=MAX_DEPTH, seeds=seeds)
    x, val = tsearch.propose(draws, acq, pdom, t(ft), return_center=False, **kwargs)
    assert x.shape == (5,) and x.dtype == np.float32
    assert abs(val - val_ref) <= 1e-4

    def jax_score(pt):
        s = jacq.evaluate_acquisition(
            ref, jnp.asarray(np.asarray(pt, np.float32))[None], jnp.asarray(ft), MAX_DEPTH
        )
        s = jsearch._penalize(s, jnp.asarray(np.asarray(pt, np.float32))[None],
                              dom.constraints, dom.input_keys)
        return float(s[0])

    assert abs(jax_score(x) - jax_score(x_ref)) <= 1e-4
    center, val_c = tsearch.propose(
        draws, acq, pdom, t(ft), rng=np.random.default_rng(0), **kwargs
    )
    assert val_c == val
    lo, hi = dom.bounds("ordinal").T
    assert (lo <= center).all() and (center <= hi).all()
    if constrained:
        assert jcons.is_feasible(
            dom.constraints, np.asarray(center, np.float32).astype(np.float64)[None],
            dom.input_keys,
        )[0]
    else:
        # the acquisition is constant on the winner's leaf box
        assert abs(jax_score(center) - jax_score(x)) <= 1e-4


def test_constrained_proposals_survive_the_float32_round_trip():
    """ROADMAP queue 3 check g on the port: with a constraint of magnitude
    1.3e6, every proposal is feasible after casting to float32 and back."""
    dom = vessel_domain(jcons)
    pdom = domain_from_reference(dom)
    ft = t(dom.feature_types())
    forest = prior_forest(dom, seed=5)
    rng = np.random.default_rng(0)
    model = JaxModel(forest, jnp.full((S,), 0.1, jnp.float32), jnp.ones((S,), jnp.float32))
    X = jnp.asarray(dom.sample(N, rng))
    y = jnp.asarray(rng.standard_normal(N), jnp.float32)
    acq = acquisition_state_from_reference(
        jacq.build_acquisition(model, X, y, jnp.asarray(dom.feature_types()), MAX_DEPTH),
        device="cpu",
    )
    gen = torch.Generator().manual_seed(0)
    np_rng = np.random.default_rng(1)
    for _ in range(6):
        draws = tsearch.draw_search(gen, 128, 4, 2, top_k=TOP_K)
        x, _ = tsearch.propose(draws, acq, pdom, ft, top_k=TOP_K, max_depth=MAX_DEPTH, rng=np_rng)
        x32 = np.asarray(x, np.float32).astype(np.float64)
        assert jcons.is_feasible(dom.constraints, x32[None], dom.input_keys)[0], x
        assert x32[0] == round(x32[0]) and x32[3] in (0.0, 1.0, 2.0)


def test_propose_raises_its_own_failure_when_no_score_is_finite():
    dom = mixed_domain()
    acq = acquisition_state_from_reference(reference_state(dom), device="cpu")
    bad = acq._replace(K_inv=torch.full_like(acq.K_inv, torch.nan))
    draws = tsearch.draw_search(torch.Generator().manual_seed(0), CANDS, 5, 1, top_k=TOP_K)
    with pytest.raises(tsearch.AcquisitionFailure, match="non-finite"):
        tsearch.propose(draws, bad, domain_from_reference(dom), t(dom.feature_types()),
                        top_k=TOP_K, max_depth=MAX_DEPTH)
    assert issubclass(tsearch.AcquisitionFailure, RuntimeError)
    # one failed posterior sample out of S poisons the mean too
    one = acq.K_inv.clone()
    one[0] = torch.nan
    with pytest.raises(tsearch.AcquisitionFailure):
        tsearch.propose(draws, acq._replace(K_inv=one), domain_from_reference(dom),
                        t(dom.feature_types()), top_k=TOP_K, max_depth=MAX_DEPTH)


def test_search_runs_on_the_factored_and_thompson_states():
    """_leaf_box and propose read only ``acq.forest``: all three states."""
    dom = mixed_domain()
    pdom = domain_from_reference(dom)
    ft = t(dom.feature_types())
    rng = np.random.default_rng(2)
    from bark_tpu_torch.convert import model_from_reference

    model = model_from_reference(JaxModel(
        prior_forest(dom, 6), jnp.full((S,), 0.1, jnp.float32), jnp.ones((S,), jnp.float32)
    ), device="cpu")
    X, y = t(dom.sample(N, rng)), t(rng.standard_normal(N).astype(np.float32))
    states = [
        tacq.build_acquisition_lr(model, X, y, ft, MAX_DEPTH),
        tacq.build_acquisition_ts(2, torch.zeros(M * 16), model, X, y, ft, MAX_DEPTH),
    ]
    lo, hi = dom.bounds("ordinal").T
    for acq in states:
        draws = tsearch.draw_search(torch.Generator().manual_seed(3), CANDS, 5, 2, top_k=TOP_K)
        x, val = tsearch.propose(draws, acq, pdom, ft, top_k=TOP_K, max_depth=MAX_DEPTH,
                                 rng=np.random.default_rng(0))
        assert np.isfinite(val) and (lo <= x).all() and (x <= hi).all()
        again = tacq.evaluate_acquisition(acq, t(np.asarray(x, np.float32))[None], ft, MAX_DEPTH)
        assert abs(float(again[0]) - val) <= 1e-5
