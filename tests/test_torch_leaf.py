"""Parity of the port's leaf tier (padded N >= 256) with the JAX reference.

The trajectory replays of the leaf tier are cases of
tests/test_torch_sampler.py, whose JAX subprocess runs with x64 off. Here:

  - the compact leaf indicator (``leaf_rank_targets``, ``_leaf_Z``,
    ``compact_leaf_indicator``) on prior forests: exact equality with the
    reference, an over-budget forest included, and ``Z Z^T`` equal to the
    integer co-occurrence counts (m * gram) exactly;
  - ``_leaf_budget`` and ``_resolve_styles`` equal to the reference's over a
    grid of N, tree counts, depth priors, explicit budgets and pins;
  - an over-budget initial forest gives a NaN MLL, as in the reference;
  - padding rows leaves the leaf tier's trajectory unchanged;
  - after a run at N=256 the carried factor equals a plain rebuild from a
    fresh Z (rtol 1e-4 / atol 1e-4 on L, the logdet to rtol 1e-4 /
    atol 1e-3), and the leaf-space MLL equals the dense one computed in
    float64 from gamma Z Z^T + nu I (rtol 1e-4 / atol 1e-3).
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bark_tpu.fitting.sampler as js
import bark_tpu.forest as jf
from bark_tpu.fitting.params import SamplerParams as JaxParams
from bark_tpu.fitting.prior import sample_forest_prior
from bark_tpu.domain import CategoricalInput, ContinuousInput, Domain, IntegerInput

import bark_tpu_torch.forest as tf
from bark_tpu_torch.convert import chain_state_from_reference, forest_from_reference, to_numpy
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.fitting.sampler import (
    BARKModel,
    _leaf_budget,
    _leaf_Z,
    _resolve_styles,
    draw_step,
    init_chain_state,
    run_chain,
    step_with_info,
)
from bark_tpu_torch.fitting.traversal import terminal_mask
from bark_tpu_torch.ops.linalg import JITTER

LEAF_PINS = {"scan_style": "coeff", "refresh_style": "leaf"}


def _domain():
    return Domain(
        [
            ContinuousInput("x_0", (0.0, 1.0)),
            ContinuousInput("x_1", (-2.0, 3.0)),
            IntegerInput("i_0", (0, 5)),
            CategoricalInput("c_0", ("a", "b", "c", "d")),
        ]
    )


def _problem(n, seed=0):
    dom = _domain()
    rng = np.random.default_rng(seed)
    X = dom.sample(n, rng).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    return tuple(torch.as_tensor(a) for a in (X, y, dom.bounds("bitmask"), dom.feature_types()))


def _prior(m, num, seed=3, node_limit=64):
    dom = _domain()
    return sample_forest_prior(
        jax.random.key(seed), m, jnp.asarray(dom.bounds("bitmask"), jnp.float32),
        jnp.asarray(dom.feature_types()), num_samples=num, node_limit=node_limit,
    )


@pytest.mark.parametrize("node_limit", [64, 32])
def test_leaf_indicator_matches_reference(node_limit):
    """Ranks, budget packing (within and over the budget) and the per-tree
    block packing equal the reference's exactly; Z Z^T counts agreements."""
    m, chains = 10, 4
    forests = _prior(m, chains, node_limit=node_limit)
    X, _, _, ft = _problem(301, seed=1)
    port = forest_from_reference(forests)
    leaves = tf.route_forest(port, X, ft)  # (C, N, m)
    mask = torch.as_tensor((np.random.default_rng(2).uniform(size=301) > 0.2).astype(np.float32))

    tmask, ranks, counts = tf.leaf_rank_targets(port)
    for got, want in zip((tmask, ranks, counts), jf.leaf_rank_targets(forests)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    totals = counts.sum(-1)
    over = int(totals.min()) - 3  # every chain over this budget
    for budget in (128, over):
        Z, total = _leaf_Z(port, leaves, budget, mask)
        assert Z.shape == (chains, 301, budget) and torch.equal(total, totals)
        for c in range(chains):
            one = jax.tree.map(lambda a: a[c], forests)
            Zr, total_r = js._leaf_Z(one, jnp.asarray(leaves[c].numpy()), budget, jnp.asarray(mask.numpy()))
            np.testing.assert_array_equal(Z[c].numpy(), np.asarray(Zr))
            assert int(total_r) == int(total[c])

    # within the budget Z Z^T is the masked co-occurrence count, m * gram
    Z, _ = _leaf_Z(port, leaves, 128, mask)
    counts_ij = (leaves[:, :, None, :] == leaves[:, None, :, :]).sum(-1).to(torch.float32)
    counts_ij = counts_ij * mask[:, None] * mask[None, :]
    assert torch.equal(Z @ Z.transpose(1, 2), counts_ij)
    gram = tf.gram_from_leaves(leaves, leaves, mask, mask)
    assert torch.equal(torch.round(gram * m), counts_ij)

    max_leaves = (node_limit + 1) // 2
    Zc = tf.compact_leaf_indicator(port, leaves, max_leaves)
    for c in range(chains):
        one = jax.tree.map(lambda a: a[c], forests)
        ref = jf.compact_leaf_indicator(one, jnp.asarray(leaves[c].numpy()), max_leaves)
        np.testing.assert_array_equal(Zc[c].numpy(), np.asarray(ref))
    assert torch.equal(Zc @ Zc.transpose(1, 2), (leaves[:, :, None, :] == leaves[:, None, :, :])
                       .sum(-1).to(torch.float32))


_N_GRID = [64, 224, 256, 512, 2048, 2049, 8193]


@pytest.mark.parametrize("n", _N_GRID)
def test_leaf_budget_matches_reference(n):
    for m, (alpha, beta), budget, node_limit in itertools.product(
        (5, 50), ((0.95, 2.0), (0.99, 2.0), (0.95, 1.5)), (0, 300), (64, 8)
    ):
        kw = dict(num_trees=m, alpha=alpha, beta=beta, leaf_budget=budget, node_limit=node_limit)
        assert _leaf_budget(SamplerParams(**kw), n) == js._leaf_budget(JaxParams(**kw), n), kw


@pytest.mark.parametrize("n", _N_GRID)
def test_resolve_styles_matches_reference(n):
    """Where the reference resolves to one of the port's two tiers the port
    resolves alike; every other resolution raises NotImplementedError."""
    ran = set()
    scans = ("auto", "plain", "coeff", "lowrank", "aug")
    refreshes = ("auto", "onesolve", "leaf", "pair", "batched", "factor")
    for scan, refresh in itertools.product(scans, refreshes):
        kw = dict(num_trees=5, scan_style=scan, refresh_style=refresh, leaf_budget=7)
        try:
            ref = js._resolve_styles(JaxParams(**kw), n)
        except ValueError:  # refresh leaf/factor with a non-coeff scan pin
            with pytest.raises(ValueError):
                SamplerParams(**kw)
            continue
        want = (ref.scan_style, ref.refresh_style)
        if want in (("plain", "onesolve"), ("coeff", "leaf")):
            got = _resolve_styles(SamplerParams(**kw), n)
            assert dataclasses.asdict(got) == dataclasses.asdict(ref), kw
            ran.add(want)
        else:
            with pytest.raises(NotImplementedError):
                _resolve_styles(SamplerParams(**kw), n)
    assert ran == {("plain", "onesolve"), ("coeff", "leaf")}
    auto = _resolve_styles(SamplerParams(), n)
    assert (auto.scan_style, auto.refresh_style) == (
        ("coeff", "leaf") if n >= 256 else ("plain", "onesolve")
    )
    for other in ({"kernel_backend": "chol"}, {"hot_style": "select"}, {"subspace_mode": "carry"}):
        with pytest.raises(NotImplementedError):
            _resolve_styles(SamplerParams(**other), n)


def test_over_budget_initial_forest_gives_nan_mll():
    """An initial forest with more leaves than the budget cannot be packed:
    its chain's MLL is NaN (the reference's too), while a chain within the
    budget is unaffected. The move scan seeds from its own quantities, so
    the capacity guard still runs: no move that keeps the total over the
    budget or raises it is accepted, and the MLL stays NaN for as long as
    the total exceeds the budget."""
    m = 8
    X, y, bounds, ft = _problem(20)
    forests = _prior(m, 2, seed=4)
    port = forest_from_reference(forests)
    totals = terminal_mask(port).sum((1, 2))
    assert totals[0] != totals[1]
    budget = int(totals.min())
    over = int(totals.argmax())
    params = SamplerParams(num_trees=m, leaf_budget=budget, **LEAF_PINS)
    state = init_chain_state(port, torch.tensor([0.1, 0.2]), torch.ones(2), X, y, ft, params,
                             bounds=bounds)
    assert torch.isnan(state.mll[over]) and torch.isfinite(state.mll[1 - over])
    one = jax.tree.map(lambda a: a[over], forests)
    ref = js.init_chain_state(one, 0.1, 1.0, jnp.asarray(X.numpy()), jnp.asarray(y.numpy()),
                              jnp.asarray(ft.numpy()), JaxParams(**dataclasses.asdict(params)),
                              bounds=jnp.asarray(bounds.numpy()))
    assert np.isnan(float(ref.mll))
    for s in range(3):
        draws = draw_step(torch.Generator().manual_seed(s), 2, params)
        before = terminal_mask(state.forest).sum((1, 2))[over]
        state, info = step_with_info(state, X, y, bounds, ft, params, draws)
        after = terminal_mask(state.forest).sum((1, 2))[over]
        assert int(after) <= int(before)
        assert bool(torch.isnan(state.mll[over])) == bool(after > budget)
        assert torch.isfinite(state.mll[1 - over])


def test_leaf_padded_run_equals_unpadded():
    """Padding rows (masked out, y = 0) leaves the leaf tier's trajectory
    unchanged: same decisions, forests and leaves, the same MLL, the same
    factor of A (the pads' Z rows are zero) and a logdet larger by exactly
    the pads' pad * log(jitter + noise)."""
    n, pad, m = 20, 12, 8
    X, y, bounds, ft = _problem(n, seed=5)
    Xp = torch.cat([X, X[:1].expand(pad, -1)])
    yp = torch.cat([y, torch.zeros(pad)])
    mask = torch.cat([torch.ones(n), torch.zeros(pad)])
    params = SamplerParams(num_trees=m, **LEAF_PINS)
    forest = forest_from_reference(_prior(m, 2, seed=6))
    noise0, scale0 = torch.tensor([0.1, 0.3]), torch.tensor([1.0, 0.7])
    plain = init_chain_state(forest, noise0, scale0, X, y, ft, params, bounds=bounds)
    padded = init_chain_state(forest, noise0, scale0, Xp, yp, ft, params, mask, bounds)
    gen = torch.Generator().manual_seed(3)
    for s in range(4):
        draws = draw_step(gen, 2, params)
        plain, info = step_with_info(plain, X, y, bounds, ft, params, draws)
        padded, pinfo = step_with_info(padded, Xp, yp, bounds, ft, params, draws, mask)
        assert torch.equal(info.tree_accepts, pinfo.tree_accepts), s
        assert torch.equal(info.hyper_accept, pinfo.hyper_accept), s
        for k in tf.FOREST_FIELDS:
            assert torch.equal(getattr(plain.forest, k), getattr(padded.forest, k)), (s, k)
        assert torch.equal(plain.leaves, padded.leaves[:, :n])
        assert torch.equal(plain.noise, padded.noise)
        torch.testing.assert_close(padded.mll, plain.mll, rtol=1e-4, atol=1e-3)
        corr = pad * torch.log(JITTER + padded.noise)
        torch.testing.assert_close(padded.kern.K_logdet - corr, plain.kern.K_logdet,
                                   rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(padded.kern.L, plain.kern.L)
    assert info.tree_accepts.any() and not info.tree_accepts.all()


def test_leaf_run_chain_state_consistent_with_rebuild():
    """``auto`` at N=256 runs the leaf tier end to end; its final state
    equals a fresh routing and a plain rebuild, stays within the budget,
    converts to the reference's layout and back, and its MLL equals the
    dense float64 MLL of the same kernel."""
    n, m, chains = 256, 8, 3
    X, y, bounds, ft = _problem(n, seed=7)
    params = SamplerParams(num_trees=m, warmup_steps=3, num_samples=2, steps_per_sample=2)
    budget = _leaf_budget(params, n)
    model = BARKModel(tf.create_empty_forest(m, 64, (chains,)), torch.full((chains,), 0.1),
                      torch.ones(chains))
    run = run_chain(torch.Generator().manual_seed(0), model, X, y, bounds, ft, params)
    st = run.state
    assert st.kern.K_inv is None and st.kern.L.shape == (chains, budget, budget)
    assert bool(((run.tree_accept_rate > 0) & (run.tree_accept_rate < 1)).all())
    assert bool((terminal_mask(st.forest).sum((1, 2)) <= budget).all())
    leaves = tf.route_forest(st.forest, X, ft)
    assert torch.equal(leaves, st.leaves)

    Z, _ = _leaf_Z(st.forest, leaves, budget, torch.ones(n))
    nu, gamma = JITTER + st.noise, st.scale / m
    A = Z.transpose(1, 2) @ Z + (nu / gamma)[:, None, None] * torch.eye(budget)
    L = torch.linalg.cholesky(A)
    logdet = (n * torch.log(nu) + budget * torch.log(gamma / nu)
              + 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1))
    torch.testing.assert_close(st.kern.L, L, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st.kern.K_logdet, logdet, rtol=1e-4, atol=1e-3)

    Zd, yd = Z.double(), y.double()
    K = gamma.double()[:, None, None] * Zd @ Zd.transpose(1, 2) + nu.double()[:, None, None] * torch.eye(n)
    Lk = torch.linalg.cholesky(K)
    z = torch.linalg.solve_triangular(Lk, yd[None, :, None].expand(chains, n, 1), upper=False)
    dense = 0.5 * (-(z ** 2).sum((1, 2)) - 2.0 * torch.log(torch.diagonal(Lk, dim1=-2, dim2=-1)).sum(-1))
    torch.testing.assert_close(st.mll.double(), dense, rtol=1e-4, atol=1e-3)

    back = chain_state_from_reference(to_numpy(st))
    assert back.kern.K_inv is None and torch.equal(back.kern.L, st.kern.L)
    assert torch.equal(back.kern.K_logdet, st.kern.K_logdet)
