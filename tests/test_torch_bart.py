"""The port's BART sampler and surrogate against the JAX package's, on the CPU.

The reference runs with JAX's x64 mode off (the suite turns it on), so that
it draws and computes in float32 as the port does. Its draws are rebuilt
from its own tree of keys (``bark_tpu/fitting/bart.py``: a sweep splits its
key into the trees' keys and sigma2's; a tree's key into the proposal's,
the accept's and the leaves'; the proposal noise is
``make_proposal_noise(split(k_prop)[0], 1, node_limit)``; warmup and sample
keys as ``run_bart_chain`` splits them, chains as ``run_bart_sampler``
does) and handed to the port as :class:`BARTDraws`.

Tolerances (float32 on both sides; the residual sums are one-hot products
that XLA and PyTorch sum in other orders):

  - trees (``packed``) and cached leaves: exact;
  - leaf values, sigma2, f_total and predictions: within 1e-5 of the
    largest entry of the reference's array (relative 1e-5);
  - the closed-form likelihood against the dense Gaussian in float64:
    rtol = atol = 1e-5 (the reference's test);
  - padding: trees exact, values rtol 1e-4 / atol 1e-6 (the reference's);
  - recovery of a step function: the reference test's bounds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bark_tpu.domain as jdomain
import bark_tpu.fitting.bart as jbart
import bark_tpu.models.bart as jmbart
from bark_tpu.fitting.proposals import make_proposal_noise as jax_noise

import bark_tpu_torch.domain as tdomain
import bark_tpu_torch.fitting.bart as tbart
import bark_tpu_torch.models.bart as tmbart
from bark_tpu_torch.convert import (
    bart_params_from_reference,
    bart_samples_from_reference,
    bart_state_from_reference,
    domain_from_reference,
)
from bark_tpu_torch.fitting.proposals import ProposalNoise, make_proposal_noise, propose_tree_packed
from bark_tpu_torch.forest import pack_forest, route_tree, unpack_forest

N, N_PAD = 40, 48
PARAMS = dict(warmup_steps=4, num_samples=3, steps_per_sample=2, num_chains=2,
              num_trees=8, node_limit=16)
REL = 1e-5


def x64_off():
    return jax.enable_x64(False)


def t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * np.abs(want).max())


def make_domain(mod):
    return mod.Domain([
        mod.ContinuousInput("x_0", (0.0, 1.0)),
        mod.ContinuousInput("x_1", (-1.0, 2.0)),
        mod.IntegerInput("i_0", (0, 5)),
        mod.CategoricalInput("c_0", ("a", "b", "c", "d")),
    ])


def make_data(seed=0):
    """Padded (X, y, mask) numpy float32 of a mixed-domain step function in
    BART's [-0.5, 0.5] scale."""
    dom = make_domain(tdomain)
    rng = np.random.default_rng(seed)
    X = dom.sample(N, rng)
    f = np.where(X[:, 0] > 0.5, 1.0, -1.0) + 0.5 * (X[:, 3] == 2) - 0.1 * X[:, 2]
    y = f + 0.1 * rng.standard_normal(N)
    y = (y - y.min()) / (y.max() - y.min()) - 0.5
    Xp = np.concatenate([X, np.repeat(X[:1], N_PAD - N, 0)]).astype(np.float32)
    yp = np.concatenate([y, np.zeros(N_PAD - N)]).astype(np.float32)
    mask = np.r_[np.ones(N), np.zeros(N_PAD - N)].astype(np.float32)
    return dom, Xp, yp, mask


def sweep_draws(key, m, node_limit, gamma_shape):
    """The reference's draws of one sweep from its key (``bart_step``)."""
    k_trees, k_sigma = jax.random.split(key)

    def per_tree(kj):
        k_prop, k_acc, k_leaf = jax.random.split(kj, 3)
        k_noise, _ = jax.random.split(k_prop)
        noise = jax.tree.map(lambda a: a[0], jax_noise(k_noise, 1, node_limit))
        return (noise, jax.random.uniform(k_acc, dtype=jnp.float32),
                jax.random.normal(k_leaf, (node_limit,), jnp.float32))

    noise, u, normal = jax.vmap(per_tree)(jax.random.split(k_trees, m))
    return noise, u, normal, jax.random.gamma(k_sigma, gamma_shape, dtype=jnp.float32)


def chain_step_keys(key, params):
    """The sweep keys of one chain of ``run_bart_chain``, in order."""
    keys = []
    if params.warmup_steps > 0:
        key, k_warm = jax.random.split(key)
        keys += list(jax.random.split(k_warm, params.warmup_steps))
    for k in jax.random.split(key, params.num_samples):
        keys += list(jax.random.split(k, params.steps_per_sample))
    return keys


def gamma_shape(params, mask):
    return jnp.float32(params.noise_prior_shape) + 0.5 * jnp.sum(jnp.asarray(mask))


def draws_from_keys(chain_keys, params, mask):
    """BARTDraws (steps, C, ...) from the per-chain lists of sweep keys."""
    a = gamma_shape(params, mask)
    per_step = []
    for step_keys in zip(*chain_keys):
        per_chain = [sweep_draws(k, params.num_trees, params.node_limit, a) for k in step_keys]
        per_step.append(per_chain)

    def stack(get):
        return t(np.stack([np.stack([np.asarray(get(d)) for d in row]) for row in per_step]))

    noise = ProposalNoise(*(stack(lambda d, i=i: d[0][i]) for i in range(7)))
    return tbart.BARTDraws(noise, stack(lambda d: d[1]), stack(lambda d: d[2]),
                           stack(lambda d: d[3]))


def sampler_draws(key, params, mask):
    """The draws of ``run_bart_sampler(key, ...)``."""
    return draws_from_keys(
        [chain_step_keys(k, params) for k in jax.random.split(key, params.num_chains)],
        params, mask)


@pytest.fixture(scope="module")
def problem():
    dom, X, y, mask = make_data()
    bounds, ft = dom.bounds("bitmask"), dom.feature_types()
    return dom, X, y, mask, bounds, ft


@pytest.fixture(scope="module")
def reference_run(problem):
    """The reference's run_bart_sampler from stumps, its draws, and one more
    sweep from its final state."""
    _, X, y, mask, bounds, ft = problem
    params = jbart.BARTParams(**PARAMS)
    rate = 0.02
    with x64_off():
        args = tuple(jnp.asarray(a) for a in (X, y, bounds, ft))
        samples, state = jbart.run_bart_sampler(
            jax.random.key(3), *args, params, jnp.float32(rate), mask=jnp.asarray(mask))
        draws = sampler_draws(jax.random.key(3), params, mask)
        k_step = jax.random.key(11)
        step = jax.jit(jax.vmap(
            lambda k, s: jbart.bart_step(k, s, *args, params, jnp.float32(rate),
                                         jnp.asarray(mask))))
        chain_keys = jax.random.split(k_step, params.num_chains)
        after = step(chain_keys, state)
        step_draws = draws_from_keys([[k] for k in chain_keys], params, mask)
    return params, rate, samples, state, draws, after, step_draws


def port_args(problem):
    _, X, y, mask, bounds, ft = problem
    return t(X), t(y), t(bounds), t(ft), t(mask)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_marginal_loglik_matches_dense_mvn(seed):
    """sum-over-leaves closed form == log N(R | 0, s2 I + sm2 Z Z^T) + const,
    the const ||R||^2/(2 s2) + (N/2) log(2 pi s2)."""
    rng = np.random.default_rng(seed)
    n, node_limit = 12, 16
    sigma2, sigma_mu2 = 0.3, 0.07
    slots = rng.choice(node_limit, size=4, replace=False)
    leaves = slots[rng.integers(0, 4, size=n)]
    resid = rng.normal(size=n).astype(np.float32)
    n_l, s_l = tbart.leaf_suff_stats(t(leaves), t(resid), node_limit, None)
    got = tbart.tree_marginal_loglik(n_l, s_l, torch.tensor(sigma2), sigma_mu2)
    Z = np.eye(node_limit)[leaves]
    cov = sigma2 * np.eye(n) + sigma_mu2 * Z @ Z.T
    _, logdet = np.linalg.slogdet(cov)
    r = resid.astype(np.float64)
    dense = -0.5 * (n * np.log(2 * np.pi) + logdet + r @ np.linalg.solve(cov, r))
    const = -0.5 * r @ r / sigma2 - 0.5 * n * np.log(2 * np.pi * sigma2)
    np.testing.assert_allclose(float(got), dense - const, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_leaf_suff_stats_and_leaf_draws_equal_the_reference(masked):
    rng = np.random.default_rng(4)
    node_limit = 16
    leaves = rng.integers(0, node_limit, size=(3, N)).astype(np.int32)
    resid = rng.normal(size=(3, N)).astype(np.float32)
    mask = (rng.uniform(size=N) < 0.7).astype(np.float32) if masked else None
    n_t, s_t = tbart.leaf_suff_stats(t(leaves), t(resid), node_limit,
                                     None if mask is None else t(mask))
    sigma2 = np.float32(0.4)
    slot = rng.uniform(size=(3, node_limit)) < 0.6
    with x64_off():
        for c in range(3):
            n_j, s_j = jbart.leaf_suff_stats(jnp.asarray(leaves[c]), jnp.asarray(resid[c]),
                                             node_limit, None if mask is None else
                                             jnp.asarray(mask))
            np.testing.assert_array_equal(n_t[c].numpy(), np.asarray(n_j))
            close(s_t[c], s_j)
            key = jax.random.key(c)
            want = jbart.sample_leaf_values(key, n_j, s_j, jnp.float32(sigma2), 0.01,
                                            jnp.asarray(slot[c]))
            normal = t(jax.random.normal(key, (node_limit,), jnp.float32))
            got = tbart.sample_leaf_values(normal, n_t[c], s_t[c], torch.tensor(sigma2), 0.01,
                                           t(slot[c]))
            close(got, want)
            assert (got[~t(slot[c])] == 0).all()


def test_moved_leaves_equal_a_fresh_routing(problem):
    """The proposed tree's leaves from the cached ones equal routing it."""
    _, X, _, _, bounds, ft = problem
    Xt, bt, ftt = t(X), t(bounds), t(ft)
    gen = torch.Generator().manual_seed(0)
    params = tbart.BARTParams(**PARAMS).proposal_params()
    packed = pack_forest(unpack_forest(
        tbart.init_bart_state(Xt, tbart.BARTParams(num_chains=64, num_trees=1,
                                                   node_limit=16)).packed[:, 0]))
    for _ in range(12):
        leaves = route_tree(unpack_forest(packed), Xt, ftt)
        noise = make_proposal_noise(gen, 64, 16)
        new, log_q, move, node = propose_tree_packed(packed, bt, ftt, params, noise)
        got = tbart._moved_leaves(leaves, new, node, move, torch.isneginf(log_q), Xt.t(), ftt)
        assert torch.equal(got, route_tree(unpack_forest(new), Xt, ftt))
        packed = new


def test_run_bart_sampler_replays_the_reference(problem, reference_run):
    params_j, rate, samples, state, draws, _, _ = reference_run
    params = bart_params_from_reference(params_j)
    assert params == tbart.BARTParams(**PARAMS)
    X, y, bounds, ft, mask = port_args(problem)
    got, final = tbart.run_bart_sampler(None, X, y, bounds, ft, params, rate, mask=mask,
                                        draws=draws)
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(samples.packed))
    close(got.leaf_values, samples.leaf_values)
    close(got.sigma2, samples.sigma2)
    np.testing.assert_array_equal(final.leaves.numpy(), np.asarray(state.leaves))
    close(final.f_total, state.f_total)
    # the run moved the trees: some grew, so the comparison is not of stumps
    assert (final.packed[..., 7].sum(-1) > 1).any()


def test_bart_step_replays_the_reference(problem, reference_run):
    params_j, rate, _, state, _, after, step_draws = reference_run
    X, y, bounds, ft, mask = port_args(problem)
    start = bart_state_from_reference(state, "cpu")
    got, info = tbart.bart_step_with_info(step_draws.step(0), start, X, y, bounds, ft,
                                          bart_params_from_reference(params_j), rate, mask)
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(after.packed))
    np.testing.assert_array_equal(got.leaves.numpy(), np.asarray(after.leaves))
    close(got.leaf_values, after.leaf_values)
    close(got.f_total, after.f_total)
    close(got.sigma2, after.sigma2)
    assert info.accept.shape == (2, 8) and not info.margin.isnan().any()
    # an invalid proposal (log alpha = -inf) is never taken
    assert not info.accept[torch.isneginf(info.log_alpha)].any()


def test_padding_is_inert(problem):
    """Masked rows change nothing: the same trees, values and sigma2."""
    X, y, bounds, ft, mask = port_args(problem)
    params = tbart.BARTParams(**PARAMS)
    a = tbart.posterior_gamma_shape(params, N)
    draws = tbart.draw_bart(torch.Generator().manual_seed(5), params.num_steps, 2, 8, 16, a)
    plain, _ = tbart.run_bart_sampler(None, X[:N], y[:N], bounds, ft, params, 0.02,
                                      mask=torch.ones(N), draws=draws)
    padded, _ = tbart.run_bart_sampler(None, X, y, bounds, ft, params, 0.02, mask=mask,
                                       draws=draws)
    assert torch.equal(plain.packed, padded.packed)
    torch.testing.assert_close(plain.leaf_values, padded.leaf_values, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(plain.sigma2, padded.sigma2, rtol=1e-4, atol=1e-6)


def test_two_runs_from_one_seed_are_equal(problem):
    X, y, bounds, ft, mask = port_args(problem)
    params = tbart.BARTParams(**PARAMS)
    runs = [tbart.run_bart_sampler(torch.Generator().manual_seed(9), X, y, bounds, ft,
                                   params, 0.02, mask=mask)[0] for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_sampler_recovers_a_step_function():
    """The reference test's recovery bounds, on the port's own generator."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0.0, 1.0, size=(96, 2)).astype(np.float32)
    f = np.where(X[:, 0] > 0.5, 1.0, -1.0) + 0.5 * np.where(X[:, 1] > 0.3, 1, -1)
    y = (f + 0.1 * rng.normal(size=96)).astype(np.float32)
    bounds = torch.tensor([[0.0, 1.0], [0.0, 1.0]])
    ft = torch.tensor([2, 2], dtype=torch.int32)
    params = tbart.BARTParams(warmup_steps=150, num_samples=30, num_trees=20, node_limit=32,
                              num_chains=2)
    samples, _ = tbart.run_bart_sampler(torch.Generator().manual_seed(0), t(X), t(y), bounds,
                                        ft, params, 0.1)
    pred = tbart.bart_predict_samples(samples.packed.flatten(0, 1),
                                      samples.leaf_values.flatten(0, 1), t(X), ft).mean(0)
    mse = float(np.mean((pred.numpy() - y) ** 2))
    assert mse < 0.15 * float(np.var(y)), mse
    s2 = float(samples.sigma2.mean())
    assert s2 < 0.2 * float(np.var(y)), s2


def test_predict_samples_equal_the_reference(problem, reference_run):
    _, X, _, _, _, ft = problem
    _, _, samples, _, _, _, _ = reference_run
    port = bart_samples_from_reference(samples, "cpu")
    Xq = make_domain(tdomain).sample(64, np.random.default_rng(7))
    with x64_off():
        want = jbart.bart_predict_samples(
            samples.packed.reshape((-1,) + samples.packed.shape[2:]),
            samples.leaf_values.reshape((-1,) + samples.leaf_values.shape[2:]),
            jnp.asarray(Xq), jnp.asarray(ft))
    got = tbart.bart_predict_samples(port.packed.flatten(0, 1), port.leaf_values.flatten(0, 1),
                                     t(Xq), t(ft))
    close(got, want)


@pytest.fixture(scope="module")
def fitted_surrogates():
    """A fitted reference BARTSurrogate and the port's over the same posterior."""
    jd = make_domain(jdomain)
    rng = np.random.default_rng(2)
    X = jd.sample(N, rng)
    y = 7.0 * np.sin(4 * X[:, 0]) + (X[:, 3] == 1) + 100.0
    params = jbart.BARTParams(**{**PARAMS, "warmup_steps": 6})
    with x64_off():
        ref = jmbart.BARTSurrogate(jd, params, seed=0).fit(X, y)
    port = tmbart.BARTSurrogate(domain_from_reference(jd), bart_params_from_reference(params),
                                device="cpu")
    port.samples = bart_samples_from_reference(ref.samples, "cpu")
    port._state = bart_state_from_reference(ref._state, "cpu")
    port.scaler.y_min, port.scaler.range = ref.scaler.y_min, ref.scaler.range
    return ref, port, X, y


def test_surrogate_predict_and_function_samples_equal_the_reference(fitted_surrogates):
    ref, port, X, y = fitted_surrogates
    Xq = make_domain(tdomain).sample(50, np.random.default_rng(8))
    with x64_off():
        for kw in ({}, {"batched": True}, {"predict_observed": False}):
            for got, want in zip(port.predict(Xq, **kw), ref.predict(Xq, **kw)):
                close(got, want)
        key = jax.random.key(5)
        want = ref.function_samples(Xq, key=key, num_draws=2)
        eps = np.asarray(jax.random.normal(key, (2, 6, 50)))
    close(port.function_samples(Xq, eps=eps, num_draws=2), want)
    assert port.function_samples(Xq).shape == (6, 50)


def test_warm_state_and_training_data_equal_the_reference(fitted_surrogates):
    ref, port, X, y = fitted_surrogates
    X2, y2 = np.vstack([X, X[:3] * 0.5]), np.r_[y, y[:3]]
    with x64_off():
        ref._store_train_data(X2, y2)
        want = ref._warm_state(ref.train_data[0])
    port._store_train_data(X2, y2)
    np.testing.assert_array_equal(port.train_data[0].numpy(), np.asarray(ref.train_data[0]))
    np.testing.assert_array_equal(port.train_data[1].numpy(), np.asarray(ref.train_data[1]))
    np.testing.assert_array_equal(port.train_mask.numpy(), np.asarray(ref.train_mask))
    assert port._noise_rate == float(ref._noise_rate)
    got = port._warm_state(port.train_data[0])
    np.testing.assert_array_equal(got.leaves.numpy(), np.asarray(want.leaves))
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
    close(got.f_total, want.f_total)
    close(got.sigma2, want.sigma2)


def test_surrogate_fits_and_refits_on_the_cpu():
    dom = make_domain(tdomain)
    _, X, y, _ = make_data(1)
    X, y = X[:N], 3.0 * y[:N] + 10.0
    sur = tmbart.BARTSurrogate(dom, tbart.BARTParams(warmup_steps=30, num_samples=8,
                                                     num_trees=10, node_limit=16), device="cpu")
    sur.fit(X, y)
    mu, std = sur.predict(X)
    assert mu.shape == (N, 1) and (std > 0).all()
    assert float(np.mean((mu[:, 0] - y) ** 2)) < 0.5 * float(np.var(y))
    sur.fit(np.vstack([X, X[:1]]), np.r_[y, y[:1]])
    assert sur.samples.packed.shape[:2] == (1, 8)
    assert dataclasses.replace(sur.params) == sur.params


def test_sampler_refuses_reduced_matmul_precision(problem):
    """The residual sums are one-hot products: TF32 would round them."""
    X, y, bounds, ft, mask = port_args(problem)
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="full-float32"):
            tbart.run_bart_sampler(torch.Generator().manual_seed(0), X, y, bounds, ft,
                                   tbart.BARTParams(**PARAMS), 0.02, mask=mask)
    finally:
        torch.set_float32_matmul_precision("highest")
