"""Parity of the port's posterior prediction and surrogate with the JAX
reference, on the CPU (the port's kernels run as their plain versions).

Inputs come from a numpy seed (the forests from the reference's prior
sampler), are cast to float32 and handed to both packages. Both compute in
float32 along different routes (the port factors once for the whole batch
and multiplies by the inverse factor where the reference solves), so the
float outputs agree to the tolerance each test states; integer and
structural outputs agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as stats
import torch

import bark_tpu.models.gp as jgp
import bark_tpu.ops.linalg as jlinalg
from bark_tpu.domain import CategoricalInput, ContinuousInput, Domain, IntegerInput
from bark_tpu.fitting.params import SamplerParams as JaxParams
from bark_tpu.fitting.prior import sample_forest_prior
from bark_tpu.fitting.sampler import BARKModel as JaxModel
from bark_tpu.models.surrogate import BARKSurrogate as JaxSurrogate
from bark_tpu.models.surrogate import bucket_size as jax_bucket_size

import bark_tpu_torch.models.gp as tgp
import bark_tpu_torch.ops.linalg as tlinalg
from bark_tpu_torch.convert import (
    domain_from_reference,
    model_from_reference,
    surrogate_from_reference,
)
from bark_tpu_torch.fitting.noise_scale import get_noise_scale_proposal
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.models.surrogate import BARKSurrogate, bucket_size, resolve_device

MAX_DEPTH = 8
M, NODE_LIMIT, CHAINS, SAMPLES = 8, 32, 2, 3
N, N_PAD, CANDS = 20, 32, 64


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
    """(CHAINS, SAMPLES) posterior-shaped model from the reference's prior."""
    forest = sample_forest_prior(
        jax.random.key(seed), M, jnp.asarray(dom.bounds("bitmask")),
        jnp.asarray(dom.feature_types()), num_samples=CHAINS * SAMPLES,
        node_limit=NODE_LIMIT, max_depth=MAX_DEPTH,
    )
    forest = jax.tree.map(lambda a: a.reshape(CHAINS, SAMPLES, *a.shape[1:]), forest)
    noise = jnp.linspace(0.05, 0.4, CHAINS * SAMPLES, dtype=jnp.float32)
    scale = jnp.linspace(0.5, 2.0, CHAINS * SAMPLES, dtype=jnp.float32)
    return JaxModel(forest, noise.reshape(CHAINS, SAMPLES), scale.reshape(CHAINS, SAMPLES))


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


@pytest.mark.parametrize("masked", [True, False], ids=["padded", "unpadded"])
@pytest.mark.parametrize("backend", ["dense", "leaf"])
def test_forest_predict_matches_reference(backend, masked):
    """mu and var of every posterior sample: rtol 2e-4, atol 2e-5 (float32
    factorizations of matrices with condition number up to ~1e3)."""
    dom = mixed_domain()
    model = prior_model(dom)
    X, y, mask, cands = padded_data(dom)
    if not masked:
        X, y, mask = X[:N], y[:N], None
    ft = dom.feature_types()
    jfn = {"dense": jgp.forest_predict, "leaf": jgp.forest_predict_leaf}[backend]
    tfn = {"dense": tgp.forest_predict, "leaf": tgp.forest_predict_leaf}[backend]
    mu_ref, var_ref = jfn(
        model.forest, model.noise, model.scale, jnp.asarray(X), jnp.asarray(y),
        jnp.asarray(cands), jnp.asarray(ft), MAX_DEPTH,
        train_mask=None if mask is None else jnp.asarray(mask),
    )
    port = model_from_reference(model)
    t = torch.as_tensor
    mu, var = tfn(
        port.forest, port.noise, port.scale, t(X), t(y), t(cands), t(ft), MAX_DEPTH,
        train_mask=None if mask is None else t(mask),
    )
    assert mu.shape == var.shape == (CHAINS * SAMPLES, CANDS)
    assert mu.dtype == var.dtype == torch.float32
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_ref), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_ref), rtol=2e-4, atol=2e-5)
    assert (var.numpy() > 0).all()


def test_leaf_predict_equals_dense_predict():
    """The two backends compute one posterior: rtol 5e-4, atol 5e-5."""
    dom = mixed_domain()
    port = model_from_reference(prior_model(dom, seed=4))
    X, y, mask, cands = (torch.as_tensor(a) for a in padded_data(dom, seed=5))
    ft = torch.as_tensor(dom.feature_types())
    args = (port.forest, port.noise, port.scale, X, y, cands, ft, MAX_DEPTH)
    mu_d, var_d = tgp.forest_predict(*args, train_mask=mask)
    mu_l, var_l = tgp.forest_predict_leaf(*args, train_mask=mask)
    torch.testing.assert_close(mu_l, mu_d, rtol=5e-4, atol=5e-5)
    torch.testing.assert_close(var_l, var_d, rtol=5e-4, atol=5e-5)


def _spd_batch(rng, g, n):
    a = rng.normal(size=(g, n, 6)).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) / 6 + 0.5 * np.eye(n)).astype(np.float32)


def test_robust_chol_inv_logdet_matches_reference_with_an_escalation():
    """A batch in which matrix 1 fails the first factorization and succeeds
    at the first escalation (+1e-4 I), matrix 3 needs the second (+1e-2 I)
    and matrix 4 fails all three: each matrix gets the reference's pick.
    Well-conditioned matrices: rtol 1e-4, atol 1e-5; the escalated ones are
    nearly singular (condition number ~1e5 and ~1e3), so their inverses are
    held relative to their largest entry, 2e-2 and 1e-3."""
    rng = np.random.default_rng(0)
    n = 12
    K = _spd_batch(rng, 5, n)
    for i, eig in ((1, -2e-5), (3, -5e-3), (4, -1.0)):
        # the smallest eigenvalue made negative
        w, U = np.linalg.eigh(K[i].astype(np.float64))
        w[0] = eig
        K[i] = ((U * w) @ U.T).astype(np.float32)
    K_inv_ref, logdet_ref = jlinalg.robust_chol_inv_logdet(jnp.asarray(K))
    K_inv_ref, logdet_ref = np.asarray(K_inv_ref), np.asarray(logdet_ref)
    K_inv, logdet = tlinalg.robust_chol_inv_logdet(torch.as_tensor(K))
    K_inv, logdet = K_inv.numpy(), logdet.numpy()
    assert np.isfinite(logdet_ref[:4]).all() and not np.isfinite(logdet_ref[4])
    np.testing.assert_array_equal(np.isfinite(logdet), np.isfinite(logdet_ref))
    assert np.isnan(K_inv[4]).all()
    for i in (0, 2):
        np.testing.assert_allclose(K_inv[i], K_inv_ref[i], rtol=1e-4, atol=1e-5)
    for i, rel in ((1, 2e-2), (3, 1e-3)):
        assert np.abs(K_inv[i] - K_inv_ref[i]).max() <= rel * np.abs(K_inv_ref[i]).max()
    np.testing.assert_allclose(logdet[:4], logdet_ref[:4], rtol=1e-3, atol=2e-2)
    # the escalated matrices really took different attempts
    first = tlinalg.chol_inv_logdet(torch.as_tensor(K))[1].numpy()
    np.testing.assert_array_equal(np.isfinite(first), [True, False, True, False, False])


def test_robust_cholesky_factors_only_the_failed_matrices(monkeypatch):
    """One factorization of the whole batch, then one of each escalation's
    failures alone; a batch without failures is factored once."""
    sizes = []
    real = tlinalg.blocked_cholesky
    monkeypatch.setattr(
        tlinalg, "blocked_cholesky", lambda K: (sizes.append(K.shape[0]), real(K))[1]
    )
    K = torch.as_tensor(_spd_batch(np.random.default_rng(1), 4, 6))
    L, E = tlinalg.robust_cholesky(K, (1e-4, 1e-2))
    assert sizes == [4]
    torch.testing.assert_close(L @ L.transpose(-1, -2), K, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(E @ L, torch.eye(6).expand(4, 6, 6), rtol=1e-5, atol=1e-5)
    sizes.clear()
    K[2] = -K[2]  # fails every attempt
    # smallest eigenvalue -5e-3: fails as it is and at +1e-4, factors at +1e-2
    K[0] = K[0] - (torch.linalg.eigvalsh(K[0])[0] + 5e-3) * torch.eye(6)
    L, _ = tlinalg.robust_cholesky(K, (1e-4, 1e-2))
    assert sizes == [4, 2, 2]
    assert torch.isfinite(L[[0, 1, 3]]).all() and torch.isnan(L[2]).all()


def test_gp_posterior_matches_reference():
    """Batched over samples against the reference's per-sample function:
    rtol 1e-5, atol 1e-6 (the same products in the same order), and the
    variance clamp at 1e-12."""
    rng = np.random.default_rng(2)
    s, n, m = 3, 10, 7
    K_inv = np.linalg.inv(_spd_batch(rng, s, n).astype(np.float64)).astype(np.float32)
    K_xX = rng.normal(size=(s, m, n)).astype(np.float32) * 0.3
    y = rng.normal(size=n).astype(np.float32)
    prior = np.asarray([1.0, 0.5, 1e-3], np.float32)  # the last one clamps
    mu, var = tlinalg.gp_posterior(*(torch.as_tensor(a) for a in (K_inv, K_xX, y, prior)))
    for i in range(s):
        mu_ref, var_ref = jlinalg.gp_posterior(
            jnp.asarray(K_inv[i]), jnp.asarray(K_xX[i]), jnp.asarray(y), jnp.float32(prior[i])
        )
        np.testing.assert_allclose(mu[i].numpy(), np.asarray(mu_ref), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(var[i].numpy(), np.asarray(var_ref), rtol=1e-5, atol=1e-6)
    assert (var[2] == 1e-12).any() and (var >= 1e-12).all()


def test_mixture_of_gaussians_matches_reference():
    rng = np.random.default_rng(3)
    mu = rng.normal(size=(6, 11)).astype(np.float32)
    var = rng.uniform(0.1, 2.0, (6, 11)).astype(np.float32)
    mu_ref, var_ref = jgp.mixture_of_gaussians_as_normal(jnp.asarray(mu), jnp.asarray(var))
    for conv in (torch.as_tensor, np.asarray):
        got_mu, got_var = tgp.mixture_of_gaussians_as_normal(conv(mu), conv(var))
        np.testing.assert_allclose(np.asarray(got_mu), np.asarray(mu_ref), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(np.asarray(got_var), np.asarray(var_ref), rtol=1e-5, atol=1e-6)


def _fitted_reference_surrogate(dom, predict_backend="auto"):
    """A reference surrogate with a prior-sampled posterior in place of a
    fit (its ``_store_train_data`` standardizes and pads as a fit does)."""
    rng = np.random.default_rng(7)
    X = dom.sample(N, rng)
    y = 3.0 + 2.0 * rng.standard_normal(N)
    ref = JaxSurrogate(
        dom, JaxParams(num_trees=M, node_limit=NODE_LIMIT, max_depth=MAX_DEPTH,
                       num_chains=CHAINS, num_samples=SAMPLES),
        predict_backend=predict_backend,
    )
    ref._store_train_data(X, y)
    ref.model = prior_model(dom, seed=8)
    return ref, X, y


@pytest.mark.parametrize("backend", ["auto", "leaf"])
@pytest.mark.parametrize("batched", [False, True])
def test_converted_surrogate_predicts_as_the_reference(backend, batched):
    """surrogate_from_reference -> predict: mean and std in y units, rtol
    2e-4, atol 5e-5 (the scaler multiplies the posterior's error by the y
    standard deviation, 2)."""
    dom = mixed_domain()
    ref, _, _ = _fitted_reference_surrogate(dom, backend)
    port = surrogate_from_reference(ref, device="cpu")
    assert port.train_data[0].shape == (N_PAD, 4) and port.train_mask.sum() == N
    Xq = dom.sample(CANDS, np.random.default_rng(9))
    mu_ref, std_ref = ref.predict(Xq, batched=batched)
    mu, std = port.predict(Xq, batched=batched)
    assert mu.shape == mu_ref.shape == ((CHAINS * SAMPLES, CANDS, 1) if batched else (CANDS, 1))
    np.testing.assert_allclose(mu, mu_ref, rtol=2e-4, atol=5e-5)
    np.testing.assert_allclose(std, std_ref, rtol=2e-4, atol=5e-5)
    # latent (noise-free) standard deviation is smaller
    _, std_latent = port.predict(Xq, batched=batched, predict_observed=False)
    assert (std_latent < std).all()


def test_store_train_data_matches_reference():
    """Standardized, bucket-padded training data and mask: exact."""
    dom = mixed_domain()
    ref, X, y = _fitted_reference_surrogate(dom)
    port = BARKSurrogate(domain_from_reference(dom), device="cpu")
    port._store_train_data(X, y)
    np.testing.assert_array_equal(port.train_data[0].numpy(), np.asarray(ref.train_data[0]))
    np.testing.assert_array_equal(port.train_data[1].numpy(), np.asarray(ref.train_data[1]))
    np.testing.assert_array_equal(port.train_mask.numpy(), np.asarray(ref.train_mask))
    assert (port.scaler.mean, port.scaler.std) == (ref.scaler.mean, ref.scaler.std)
    for n in (0, 1, 31, 32, 33, 200, 4096):
        assert bucket_size(n) == jax_bucket_size(n)


def test_function_samples_use_the_given_normals():
    dom = mixed_domain()
    ref, _, _ = _fitted_reference_surrogate(dom)
    port = surrogate_from_reference(ref, device="cpu")
    Xq = dom.sample(5, np.random.default_rng(1))
    eps = np.random.default_rng(2).standard_normal((3, CHAINS * SAMPLES, 5))
    mu, std = port.predict(Xq, batched=True)
    draws = port.function_samples(Xq, eps=eps, num_draws=3)
    assert draws.shape == (3 * CHAINS * SAMPLES, 5)
    np.testing.assert_allclose(
        draws.reshape(3, CHAINS * SAMPLES, 5), mu[None, ..., 0] + std[None, ..., 0] * eps
    )
    assert port.function_samples(Xq).shape == (CHAINS * SAMPLES, 5)


def test_fit_warm_starts_and_records_diagnostics(monkeypatch):
    """Two fits on the CPU: the second starts from each chain's last sample
    with no warmup, and every fit leaves finite diagnostics and a model of
    shape (chains, samples)."""
    import bark_tpu_torch.models.surrogate as mod

    dom = domain_from_reference(mixed_domain())
    rng = np.random.default_rng(3)
    X = dom.sample(12, rng)
    y = np.sin(3 * X[:, 0]) + 0.1 * rng.standard_normal(12)
    params = SamplerParams(num_trees=M, node_limit=NODE_LIMIT, max_depth=MAX_DEPTH,
                           num_chains=2, num_samples=4, steps_per_sample=2, warmup_steps=3)
    sur = BARKSurrogate(dom, params, seed=0, device="cpu")
    assert not sur.is_fitted
    steps = []
    real = mod.run_bark_sampler

    def spy(gen, start, X_, y_, b, ft, p, mask=None):
        steps.append((p.warmup_steps, start))
        return real(gen, start, X_, y_, b, ft, p, mask=mask)

    monkeypatch.setattr(mod, "run_bark_sampler", spy)
    sur.fit(X, y)
    first = sur.model
    sur.fit(np.vstack([X, X[:1] * 0.5]), np.append(y, 0.2))
    assert [w for w, _ in steps] == [3, 0]
    assert torch.equal(steps[1][1].noise, first.noise[:, -1])
    assert all(torch.equal(a, b[:, -1]) for a, b in zip(steps[1][1].forest, first.forest))
    assert sur.model.noise.shape == (2, 4) and sur.model.forest.is_leaf.shape == (2, 4, M, NODE_LIMIT)
    assert np.isfinite(sur.fit_diagnostics["noise_mean"])
    assert set(sur.fit_diagnostics) == {"r_hat_noise", "ess_noise", "noise_mean"}
    mu, std = sur.predict(X)
    assert mu.shape == (12, 1) and np.isfinite(mu).all() and (std > 0).all()


def test_device_must_be_asked_for():
    """No CUDA here: the default device raises; unported options name their
    ROADMAP item."""
    dom = domain_from_reference(mixed_domain())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            BARKSurrogate(dom)
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BARKSurrogate(dom, fit_style="tempered", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BARKSurrogate(dom, predict_backend="cg", device="cpu")
    with pytest.raises(ValueError):
        BARKSurrogate(dom, predict_backend="nope", device="cpu")


def test_leaf_budget_check_refuses_an_overfull_warm_start():
    dom = domain_from_reference(mixed_domain())
    params = SamplerParams(num_trees=M, node_limit=NODE_LIMIT, num_chains=CHAINS * SAMPLES,
                           refresh_style="leaf", scan_style="coeff", leaf_budget=M + 1)
    sur = BARKSurrogate(dom, params, device="cpu")
    model = model_from_reference(prior_model(mixed_domain()))
    flat = type(model)(
        type(model.forest)(*(t.reshape(-1, M, NODE_LIMIT) for t in model.forest)),
        model.noise.reshape(-1), model.scale.reshape(-1),
    )
    with pytest.raises(ValueError, match="leaf_budget"):
        sur._check_leaf_budget(flat, params, 32)
    sur._check_leaf_budget(sur._init_state(), params, 32)  # stumps: m leaves fit


def test_softplus_noise_proposal_samples_the_prior():
    """ROADMAP queue 3 check f on the port: a prior-only MH chain under the
    default ``q_ratio_style="correct"`` reproduces the analytic inverse-gamma
    prior (the bounds of the reference's own test), and the ``"reference"``
    style stays detectably biased (upper tail roughly halved)."""
    chains, steps, burn = 32, 4000, 1000
    dist = stats.invgamma(SamplerParams().gamma_prior_shape,
                          scale=1.0 / SamplerParams().gamma_prior_rate)

    def prior_chain(style):
        params = SamplerParams(q_ratio_style=style)
        gen = torch.Generator().manual_seed(0)
        noise = torch.ones(chains)
        scale = torch.ones(chains)
        z = torch.randn((steps, chains), generator=gen)
        log_u = torch.log(torch.rand((steps, chains), generator=gen))
        trace = []
        for i in range(steps):
            (new, _), log_alpha = get_noise_scale_proposal(z[i], z[i], noise, scale, params)
            noise = torch.where(log_u[i] <= log_alpha.clamp_max(0.0), new, noise)
            trace.append(noise)
        return torch.stack(trace[burn:]).numpy().astype(np.float64)

    post = prior_chain("correct")
    assert abs(np.quantile(post, 0.5) - dist.ppf(0.5)) < 0.02
    assert abs(np.quantile(post, 0.1) - dist.ppf(0.1)) < 0.01
    assert abs(np.quantile(post, 0.9) - dist.ppf(0.9)) < 0.12
    assert np.quantile(prior_chain("reference"), 0.9) < 0.6 * dist.ppf(0.9)
