"""Posterior function sampling (``models/sampling.py``) of the port against the
JAX reference, on the CPU.

The reference runs in a subprocess with JAX's x64 mode off, as in
tests/test_torch_sampler.py; this file is that subprocess's script too
(``python tests/test_torch_sampling.py OUT.npz``). The problem is that of
tests/models/test_mogp_sampling.py: TreeFunction(dim=3, m=10, seed=4), 60
training rows, 15 evaluation points, two prior forests (node_limit 32,
depth 8) with noise 0.1 / 0.2 and scale 1.0 / 0.7. Each reference function
is compiled once.

What is held, and how:

  - ``leaf_function_samples`` draw for draw, given the reference's own
    standard normals (rebuilt from its per-sample keys): rtol 1e-4, with an
    atol of 1e-5 of the largest draw (draws cross zero);
  - the dense f* sampler through what is unique, the posterior mean and
    the clamped ``root root^T`` at the training sites (atol 1e-4), and the
    reference's own f* equal to the minimum of ``mu + root z`` from those
    quantities and its normals (its eigenvectors are not unique, so raw
    draws cannot be compared);
  - Nystrom through ``phi phi^T`` (atol 1e-4);
  - the reference's statistical tests (tests/models/test_mogp_sampling.py),
    mirrored on the port's own draws.
"""

import sys

import numpy as np
import pytest
import torch

from torch_support import run_reference

from bark_tpu_torch.benchmarks import map_benchmark
from bark_tpu_torch.benchmarks.tree_function import TreeFunction
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.fitting.sampler import BARKModel
from bark_tpu_torch.forest import FOREST_FIELDS, forest_from_numpy, gram_from_leaves, route_forest
from bark_tpu_torch.models.gp import forest_predict_leaf
from bark_tpu_torch.models.sampling import (
    construct_nystrom_features,
    fstar_moments,
    generate_fstar_samples,
    generate_fstar_samples_leaf,
    leaf_function_samples,
    nystrom_samples,
)
from bark_tpu_torch.models.surrogate import BARKSurrogate

M, NODE_LIMIT, DEPTH = 10, 32, 8
R = M * ((NODE_LIMIT + 1) // 2)
DRAWS, FSTAR = 64, 512


def problem():
    bench = TreeFunction(dim=3, m=10, function_seed=4)
    dom = bench.domain
    rng = np.random.default_rng(0)
    X = dom.sample(60, rng)
    y = bench.f(X).astype(np.float32)
    C = dom.sample(15, rng)
    return X, y, C, dom.feature_types(), dom.bounds("bitmask")


def reference_run(out_path: str) -> None:
    """The JAX side (run as a script, x64 off)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from bark_tpu.fitting.prior import sample_forest_prior
    from bark_tpu.fitting.sampler import BARKModel as JaxModel
    from bark_tpu.forest import gram_from_leaves as jgram
    from bark_tpu.forest import route_forest_auto
    from bark_tpu.models import sampling as js
    from bark_tpu.ops.linalg import JITTER

    X, y, C, ft, bounds = (jnp.asarray(a) for a in problem())
    forest = sample_forest_prior(jax.random.key(5), M, bounds, ft, num_samples=2,
                                 node_limit=NODE_LIMIT, max_depth=DEPTH)
    model = JaxModel(forest, jnp.array([0.1, 0.2], jnp.float32),
                     jnp.array([1.0, 0.7], jnp.float32))
    out = {f"forest.{k}": np.asarray(getattr(forest, k)) for k in FOREST_FIELDS}

    def normals(key, shape):
        """The per-sample normals the reference draws from ``key``."""
        return np.stack([np.asarray(jax.random.normal(k, shape, jnp.float32))
                         for k in jax.random.split(key, 2)])

    out["leaf/draws"] = np.asarray(js.leaf_function_samples(
        jax.random.key(0), model, X, y, C, ft, num_draws=DRAWS, max_depth=DEPTH))
    out["leaf/eps"] = normals(jax.random.key(0), (R, DRAWS))

    out["fstar"] = np.asarray(js.generate_fstar_samples(
        jax.random.key(2), model, X, y, ft, num_fstar=FSTAR, max_depth=DEPTH))
    out["fstar/z"] = normals(jax.random.key(2), (X.shape[0], FSTAR))
    out["fstar_leaf"] = np.asarray(js.generate_fstar_samples_leaf(
        jax.random.key(1), model, X, y, ft, num_fstar=FSTAR, max_depth=DEPTH))

    @jax.jit
    def moments(tree_sample, noise_s, scale_s):
        # the lines of generate_fstar_samples' per_sample up to the root
        n = X.shape[0]
        leaves = route_forest_auto(tree_sample, X, ft, DEPTH)
        K = scale_s * jgram(leaves, leaves, NODE_LIMIT)
        K_s = K + (JITTER + noise_s) * jnp.eye(n)
        sol = jnp.linalg.solve(K_s, jnp.concatenate([y[:, None], K], axis=1))
        mu = K @ sol[:, 0]
        Sigma = K - K @ sol[:, 1:]
        evals, evecs = jnp.linalg.eigh(0.5 * (Sigma + Sigma.T))
        root = evecs * jnp.sqrt(jnp.maximum(evals, 0.0))[None, :]
        return mu, root, root @ root.T

    mu, root, rrt = jax.vmap(moments)(forest, model.noise, model.scale)
    out["fstar/mu"], out["fstar/root"], out["fstar/rrt"] = (
        np.asarray(a) for a in (mu, root, rrt))

    feats = js.construct_nystrom_features(model, X[:15], C, ft, max_depth=DEPTH)
    out["nystrom/ppt"] = np.asarray(jnp.einsum("smz,snz->smn", feats, feats))
    on_z = js.construct_nystrom_features(model, X[:15], X[:15], ft, max_depth=DEPTH)
    out["nystrom/ppt_z"] = np.asarray(jnp.einsum("smz,snz->smn", on_z, on_z))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(__file__, tmp_path_factory.mktemp("reference"), "reference.npz")


@pytest.fixture(scope="module")
def inputs(reference):
    X, y, C, ft, _ = (torch.as_tensor(a) for a in problem())
    forest = forest_from_numpy({k: reference[f"forest.{k}"] for k in FOREST_FIELDS})
    model = BARKModel(forest, torch.tensor([0.1, 0.2]), torch.tensor([1.0, 0.7]))
    return model, X, y, C, ft


def test_leaf_function_samples_replay_reference_draws(reference, inputs):
    model, X, y, C, ft = inputs
    eps = torch.as_tensor(reference["leaf/eps"])
    got = leaf_function_samples(model, X, y, C, ft, eps, DEPTH).numpy()
    want = reference["leaf/draws"]
    assert got.shape == want.shape == (2, DRAWS, 15)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_dense_fstar_moments_match_reference(reference, inputs):
    model, X, y, _, ft = inputs
    mu, root = fstar_moments(model, X, y, ft, DEPTH)
    np.testing.assert_allclose(mu.numpy(), reference["fstar/mu"], atol=1e-4)
    rrt = (root @ root.transpose(1, 2)).numpy()
    np.testing.assert_allclose(rrt, reference["fstar/rrt"], atol=1e-4)
    # the reference's f* is the minimum of mu + root z over the sites, from
    # those quantities and its own normals
    ref_fstar = (reference["fstar/mu"][..., None]
                 + reference["fstar/root"] @ reference["fstar/z"]).min(1)
    np.testing.assert_allclose(ref_fstar, reference["fstar"], rtol=1e-5, atol=1e-5)
    z = torch.as_tensor(reference["fstar/z"])
    got = generate_fstar_samples(model, X, y, ft, z, DEPTH)
    assert got.shape == (2, FSTAR) and bool(torch.isfinite(got).all())


def test_fstar_samplers_agree_with_reference_in_distribution(reference, inputs):
    """The port's f* from its own normals against the reference's f*: the
    same posterior, so the same law (per sample, means within 5 se)."""
    model, X, y, _, ft = inputs
    gen = torch.Generator().manual_seed(11)
    dense = generate_fstar_samples(model, X, y, ft, torch.randn(2, 60, FSTAR, generator=gen),
                                   DEPTH).numpy()
    leaf = generate_fstar_samples_leaf(model, X, y, ft, torch.randn(2, R, FSTAR, generator=gen),
                                       DEPTH).numpy()
    for got, want in ((dense, reference["fstar"]), (leaf, reference["fstar_leaf"])):
        se = np.sqrt(got.var(1) / FSTAR + want.var(1) / FSTAR)
        assert (np.abs(got.mean(1) - want.mean(1)) < 5 * se).all(), (got.mean(1), want.mean(1))


def test_nystrom_features_match_reference(reference, inputs):
    model, X, _, C, ft = inputs
    feats = construct_nystrom_features(model, X[:15], C, ft, DEPTH)
    assert feats.shape[:2] == (2, 15)
    ppt = (feats @ feats.transpose(1, 2)).numpy()
    np.testing.assert_allclose(ppt, reference["nystrom/ppt"], atol=1e-4)
    on_z = construct_nystrom_features(model, X[:15], X[:15], ft, DEPTH)
    np.testing.assert_allclose((on_z @ on_z.transpose(1, 2)).numpy(), reference["nystrom/ppt_z"],
                               atol=1e-4)
    w = torch.randn(2, feats.shape[-1], 6, generator=torch.Generator().manual_seed(0))
    draws = nystrom_samples(feats, w)
    assert draws.shape == (2, 6, 15)
    torch.testing.assert_close(draws[1, 2], feats[1] @ w[1, :, 2])


# ---- the reference's statistical tests, on the port's own draws ------------


def test_leaf_function_samples_match_posterior_moments(inputs):
    """Mirror of tests/models/test_mogp_sampling.py:116-170: the empirical
    mean and variance of 4096 leaf-space draws against forest_predict_leaf,
    and the leaf and dense f* samplers against each other in distribution."""
    model, X, y, C, ft = inputs
    D = 4096
    gen = torch.Generator().manual_seed(0)
    draws = leaf_function_samples(model, X, y, C, ft, torch.randn(2, R, D, generator=gen),
                                  DEPTH)
    mu, var = forest_predict_leaf(model.forest, model.noise, model.scale, X, y, C, ft, DEPTH)
    np.testing.assert_allclose(draws.mean(1).numpy(), mu.numpy(),
                               atol=4.5 * float(np.sqrt(var.max().item() / D)))
    np.testing.assert_allclose(draws.var(1).numpy(), var.numpy(), rtol=0.15, atol=1e-4)
    fs_leaf = generate_fstar_samples_leaf(model, X, y, ft, torch.randn(2, R, 512, generator=gen),
                                          DEPTH).numpy()
    fs_dense = generate_fstar_samples(model, X, y, ft, torch.randn(2, 60, 512, generator=gen),
                                      DEPTH).numpy()
    assert abs(fs_leaf.mean() - fs_dense.mean()) < 0.2
    assert abs(fs_leaf.std() - fs_dense.std()) < 0.2


def _fitted_bark(seed=0):
    bench = map_benchmark("TreeFunction", dim=2, m=8, function_seed=1)
    rng = np.random.default_rng(seed)
    Xtr = bench.domain.sample(20, rng)
    params = SamplerParams(warmup_steps=10, num_samples=3, steps_per_sample=2, num_trees=8)
    sur = BARKSurrogate(bench.domain, params, seed=seed, device="cpu").fit(Xtr, bench.f(Xtr))
    return bench, sur


def test_fstar_samples_below_posterior_mean_min():
    """Mirror of tests/models/test_mogp_sampling.py:66-77."""
    bench, sur = _fitted_bark()
    tx, ty = sur.train_data
    ft = torch.as_tensor(bench.domain.feature_types())
    z = torch.randn(3, tx.shape[0], 32, generator=torch.Generator().manual_seed(0))
    fstar = generate_fstar_samples(sur.model, tx, ty, ft, z).numpy()
    assert fstar.shape == (3, 32)
    assert np.isfinite(fstar).all()
    assert fstar.mean() < 0


def test_nystrom_features_approximate_kernel():
    """Mirror of tests/models/test_mogp_sampling.py:80-100: on the inducing
    set, phi phi^T reproduces K_ZZ."""
    bench, sur = _fitted_bark()
    tx, _ = sur.train_data
    ft = torch.as_tensor(bench.domain.feature_types())
    Z = tx[:15]
    feats = construct_nystrom_features(sur.model, Z, Z, ft)
    forest0 = type(sur.model.forest)(*(t.reshape(-1, 8, 64)[0] for t in sur.model.forest))
    leaves = route_forest(forest0, Z, ft)
    K = float(sur.model.scale.reshape(-1)[0]) * gram_from_leaves(leaves, leaves)
    np.testing.assert_allclose((feats[0] @ feats[0].T).numpy(), K.numpy(), atol=5e-3)
    w = torch.randn(3, feats.shape[-1], 6, generator=torch.Generator().manual_seed(1))
    assert nystrom_samples(feats, w).shape == (3, 6, 15)


def test_fstar_leaf_leaves_padded_rows_out(inputs):
    """Padded training rows (mask 0, y 0) neither move the draws at the real
    rows nor enter the minimum."""
    model, X, y, _, ft = inputs
    pad = 4
    Xp = torch.cat([X, X[:pad]])
    yp = torch.cat([y, torch.zeros(pad)])
    mask = torch.cat([torch.ones(60), torch.zeros(pad)])
    eps = torch.randn(2, R, 32, generator=torch.Generator().manual_seed(2))
    plain = generate_fstar_samples_leaf(model, X, y, ft, eps, DEPTH)
    padded = generate_fstar_samples_leaf(model, Xp, yp, ft, eps, DEPTH, train_mask=mask)
    torch.testing.assert_close(padded, plain, rtol=1e-5, atol=1e-5)


def test_sampling_entry_points_refuse_reduced_matmul_precision(inputs):
    model, X, y, C, ft = inputs
    eps = torch.zeros(2, R, 1)
    calls = (
        lambda: fstar_moments(model, X, y, ft, DEPTH),
        lambda: construct_nystrom_features(model, X[:15], C, ft, DEPTH),
        lambda: leaf_function_samples(model, X, y, C, ft, eps, DEPTH),
    )
    torch.set_float32_matmul_precision("high")
    try:
        for call in calls:
            with pytest.raises(RuntimeError, match="full-float32"):
                call()
    finally:
        torch.set_float32_matmul_precision("highest")


@pytest.mark.parametrize("name", ["LeafGP", "LeafMOGP", "BART", "GridUCB", "SMAC", "Entmoot"])
def test_unported_strategy_names_still_raise(name):
    """Every reference strategy name is ported now: each builds on the CPU,
    but SMAC and Entmoot, which raise the reference's RuntimeError without
    their optional packages."""
    from bark_tpu_torch.domain import ContinuousInput, Domain
    from bark_tpu_torch.strategies import tree_kernel
    from bark_tpu_torch.strategies.tree_kernel import make_strategy

    assert not hasattr(tree_kernel, "_NOT_PORTED")
    dom = Domain([ContinuousInput("x", (0.0, 1.0))])
    if name in ("SMAC", "Entmoot"):
        with pytest.raises(RuntimeError, match=f"{name}Strategy requires"):
            make_strategy(name, dom, device="cpu")
        return
    kwargs = {"fidelity_costs": [1.0, 0.5]} if name == "LeafMOGP" else {}
    assert make_strategy(name, dom, device="cpu", **kwargs).device == torch.device("cpu")


if __name__ == "__main__":
    reference_run(sys.argv[1])
