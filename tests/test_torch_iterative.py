"""The matrix-free CG posterior (``ops/iterative.py``, ``forest_predict_cg`` and
``predict_backend="cg"``) of the port against the JAX reference, on the CPU.

The reference runs in a subprocess with JAX's x64 mode off, as in
tests/test_torch_sampler.py; this file is that subprocess's script too
(``python tests/test_torch_iterative.py OUT.npz``). The cases are those of
tests/ops/test_iterative.py (random partitions: 12 trees of 5 leaf ids,
node_limit 16) plus ``forest_predict_cg`` on prior forests of the
mixed domain (2 x 3 samples). The port batches every sample's columns into one CG loop
where the reference runs one vmapped solve per column.

Tolerances: ``Z Z^T`` and the kernel product rtol 2e-5 (the reference's
own); ``cg_solve`` rtol 1e-4 against the reference and against a float64
Cholesky solve, with an atol of 1e-4 of the solution's largest entry (CG
stops at a relative residual of 1e-6 in float32); the posterior rtol 1e-3 /
atol 1e-4, and padded against unpadded rtol 1e-4 / atol 1e-5 (the
reference's).
"""

import sys

import numpy as np
import pytest
import torch

from test_torch_gp import CHAINS, SAMPLES, mixed_domain, prior_model
from torch_support import run_reference

from bark_tpu_torch.benchmarks import map_benchmark
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.forest import FOREST_FIELDS
from bark_tpu_torch.models.gp import forest_predict, forest_predict_cg
from bark_tpu_torch.models.surrogate import BARKSurrogate
from bark_tpu_torch.ops import iterative
from bark_tpu_torch.ops.gram import gram_plain
from bark_tpu_torch.ops.linalg import JITTER

NODE_LIMIT = 16
S = CHAINS * SAMPLES  # posterior samples of the forest_predict_cg case


def random_leaves(rng, n, m=12):
    """tests/ops/test_iterative.py:_random_leaves: random partitions."""
    return rng.integers(0, 5, size=(n, m)).astype(np.int32)


def cases():
    rng = np.random.default_rng(0)
    out = {"mv/leaves": random_leaves(rng, 40),
           "mv/v": rng.normal(size=40).astype(np.float32)}
    rng = np.random.default_rng(1)
    out["cg/leaves"] = random_leaves(rng, 48)
    out["cg/y"] = rng.normal(size=48).astype(np.float32)
    rng = np.random.default_rng(2)
    out["post/leaves"] = random_leaves(rng, 56)
    out["post/cand"] = random_leaves(rng, 9)
    out["post/y"] = rng.normal(size=56).astype(np.float32)
    rng = np.random.default_rng(3)
    leaves = random_leaves(rng, 40)
    out["pad/cand"] = random_leaves(rng, 5)
    y = rng.normal(size=40).astype(np.float32)
    out["pad/y"] = np.concatenate([y, np.zeros(24, np.float32)])
    out["pad/leaves"] = np.concatenate([leaves, np.broadcast_to(leaves[:1], (24, 12))])
    out["pad/mask"] = np.concatenate([np.ones(40, np.float32), np.zeros(24, np.float32)])
    dom = mixed_domain()
    rng = np.random.default_rng(4)
    out["fp/X"] = dom.sample(30, rng)
    out["fp/y"] = rng.standard_normal(30).astype(np.float32)
    out["fp/C"] = dom.sample(11, rng)
    return out


def reference_run(out_path: str) -> None:
    """The JAX side (run as a script, x64 off)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from bark_tpu.models.gp import forest_predict_cg as jax_predict_cg
    from bark_tpu.ops import iterative as jit_

    c = {k: jnp.asarray(v) for k, v in cases().items()}
    out = {}
    Z = jit_.leaf_features(c["mv/leaves"], NODE_LIMIT)
    out["mv/ZZt"] = np.asarray(Z @ Z.T)
    out["mv/Kv"] = np.asarray(jit_.kernel_matvec(Z, 0.1, 1.3, c["mv/v"]))
    Zc = jit_.leaf_features(c["cg/leaves"], NODE_LIMIT)
    out["cg/x"] = np.asarray(jit_.cg_solve(Zc, 0.05, 0.9, c["cg/y"]))
    out["cg/X2"] = np.asarray(jit_.cg_solve(Zc, 0.05, 0.9, jnp.stack([c["cg/y"], -2.0 * c["cg/y"]
                                                                     + 0.5], 1)))
    mu, var = jit_.cg_posterior(c["post/leaves"], c["post/cand"], c["post/y"], 0.08, 1.4,
                                NODE_LIMIT)
    out["post/mu"], out["post/var"] = np.asarray(mu), np.asarray(var)
    mu, var = jit_.cg_posterior(c["pad/leaves"], c["pad/cand"], c["pad/y"], 0.1, 1.0,
                                NODE_LIMIT, c["pad/mask"])
    out["pad/mu"], out["pad/var"] = np.asarray(mu), np.asarray(var)
    model = prior_model(mixed_domain(), seed=3)
    mu, var = jax_predict_cg(model.forest, model.noise, model.scale, c["fp/X"], c["fp/y"],
                             c["fp/C"], jnp.asarray(mixed_domain().feature_types()))
    out["fp/mu"], out["fp/var"] = np.asarray(mu), np.asarray(var)
    for k in FOREST_FIELDS:
        out[f"fp/forest.{k}"] = np.asarray(getattr(model.forest, k))
    out["fp/noise"], out["fp/scale"] = np.asarray(model.noise), np.asarray(model.scale)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(__file__, tmp_path_factory.mktemp("reference"), "reference.npz")


@pytest.fixture(scope="module")
def case():
    return {k: torch.as_tensor(v) for k, v in cases().items()}


def _dense_K(leaves, noise, scale, mask=None):
    gram = gram_plain(leaves, leaves, mask, mask).double()
    return scale * gram + (JITTER + noise) * torch.eye(leaves.shape[0], dtype=torch.float64)


def _features(leaves, mask=None):
    return iterative.leaf_features(leaves, iterative.leaf_columns(leaves, NODE_LIMIT), mask)


def test_packed_features_give_the_reference_kernel(reference, case):
    leaves = case["mv/leaves"]
    columns = iterative.leaf_columns(leaves, NODE_LIMIT)
    occupied = {(t, int(i)) for t in range(12) for i in leaves[:, t]}
    assert int((columns.target < columns.width).sum()) == len(occupied)
    assert columns.width % 32 == 0 and columns.width >= len(occupied)
    Z = iterative.leaf_features(leaves, columns)
    np.testing.assert_allclose((Z @ Z.T).numpy(), reference["mv/ZZt"], rtol=2e-5, atol=1e-7)
    torch.testing.assert_close(Z @ Z.T, gram_plain(leaves, leaves), rtol=2e-5, atol=1e-7)


def test_kernel_matvec_matches_reference_and_dense(reference, case):
    Z = _features(case["mv/leaves"])
    v = case["mv/v"]
    got = iterative.kernel_matvec(Z, 0.1, 1.3, v[:, None])[:, 0]
    np.testing.assert_allclose(got.numpy(), reference["mv/Kv"], rtol=2e-5, atol=1e-6)
    want = _dense_K(case["mv/leaves"], 0.1, 1.3) @ v.double()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=1e-6)


def test_cg_solve_matches_reference_and_cholesky(reference, case):
    Z = _features(case["cg/leaves"])
    y = case["cg/y"]
    K = _dense_K(case["cg/leaves"], 0.05, 0.9)
    for got, want, rhs in (
        (iterative.cg_solve(Z, 0.05, 0.9, y), reference["cg/x"], y),
        (iterative.cg_solve(Z, 0.05, 0.9, torch.stack([y, -2.0 * y + 0.5], 1)),
         reference["cg/X2"], torch.stack([y, -2.0 * y + 0.5], 1)),
    ):
        exact = torch.linalg.solve(K, rhs.double()).numpy()
        for target in (want, exact):
            np.testing.assert_allclose(got.numpy(), target, rtol=1e-4,
                                       atol=1e-4 * np.abs(target).max())
    assert 0 < iterative.cg_solve.trips <= 256


def test_cg_solve_batches_samples_without_mixing_columns(case):
    """Three samples with their own noise and scale, two columns each, in one
    loop: each column equals its own solve, and a zero column stays zero."""
    leaves = case["post/leaves"]
    batch = torch.stack([leaves, leaves.flip(0), leaves.roll(3, 0)])
    Z = _features(batch)
    noise, scale = torch.tensor([0.05, 0.2, 0.5]), torch.tensor([0.9, 1.4, 0.6])
    y = case["post/y"]
    rhs = torch.stack([y, torch.zeros_like(y)], 1).expand(3, -1, -1)
    got = iterative.cg_solve(Z, noise, scale, rhs)
    for s in range(3):
        one = iterative.cg_solve(Z[s], noise[s].item(), scale[s].item(), y)
        torch.testing.assert_close(got[s, :, 0], one, rtol=1e-4, atol=1e-4 * one.abs().max().item())
        exact = torch.linalg.solve(_dense_K(batch[s], noise[s].item(), scale[s].item()),
                                   y.double())
        np.testing.assert_allclose(got[s, :, 0].numpy(), exact.numpy(), rtol=1e-4,
                                   atol=1e-4 * exact.abs().max().item())
    assert not got[..., 1].any()


def test_cg_posterior_matches_reference_and_dense_posterior(reference, case):
    leaves, cand, y = case["post/leaves"], case["post/cand"], case["post/y"]
    noise, scale = 0.08, 1.4
    mu, var = iterative.cg_posterior(leaves, cand, y, noise, scale, NODE_LIMIT)
    K = _dense_K(leaves, noise, scale)
    K_xX = scale * gram_plain(cand, leaves).double()
    want_mu = K_xX @ torch.linalg.solve(K, y.double())
    want_var = scale - (K_xX * torch.linalg.solve(K, K_xX.T).T).sum(-1)
    for got, ref, exact in ((mu, reference["post/mu"], want_mu),
                            (var, reference["post/var"], want_var)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=1e-3, atol=1e-4)


def test_cg_posterior_padding_inert(reference, case):
    """Padded rows (mask 0, y 0, leaves copied from a real row) change
    nothing, as in the reference's test."""
    leaves, mask = case["pad/leaves"], case["pad/mask"]
    cand, y = case["pad/cand"], case["pad/y"]
    mu0, var0 = iterative.cg_posterior(leaves[:40], cand, y[:40], 0.1, 1.0, NODE_LIMIT)
    mu1, var1 = iterative.cg_posterior(leaves, cand, y, 0.1, 1.0, NODE_LIMIT, mask)
    torch.testing.assert_close(mu1, mu0, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(var1, var0, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(mu1.numpy(), reference["pad/mu"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(var1.numpy(), reference["pad/var"], rtol=1e-3, atol=1e-4)


def test_forest_predict_cg_matches_reference_and_dense(reference, case):
    from bark_tpu_torch.forest import forest_from_numpy

    forest = forest_from_numpy({k: reference[f"fp/forest.{k}"] for k in FOREST_FIELDS})
    noise, scale = (torch.as_tensor(reference[f"fp/{k}"]) for k in ("noise", "scale"))
    args = (forest, noise, scale, case["fp/X"], case["fp/y"], case["fp/C"],
            torch.as_tensor(mixed_domain().feature_types()))
    mu, var = forest_predict_cg(*args)
    assert mu.shape == var.shape == (S, 11)
    np.testing.assert_allclose(mu.numpy(), reference["fp/mu"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(var.numpy(), reference["fp/var"], rtol=1e-3, atol=1e-4)
    mu_d, var_d = forest_predict(*args)
    torch.testing.assert_close(mu, mu_d, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(var, var_d, rtol=1e-3, atol=1e-4)


def test_surrogate_cg_backend_matches_dense():
    """Mirror of tests/ops/test_iterative.py:119-140: a fitted surrogate
    predicts alike through predict_backend "cg" and "dense"."""
    bench = map_benchmark("TreeFunction", dim=2, m=6, function_seed=1)
    X = bench.domain.sample(20, np.random.default_rng(0))
    params = SamplerParams(warmup_steps=5, num_samples=3, steps_per_sample=2, num_trees=6)
    dense = BARKSurrogate(bench.domain, params, seed=0, predict_backend="dense",
                          device="cpu").fit(X, bench.f(X))
    Xte = bench.domain.sample(7, np.random.default_rng(9))
    mu_d, sd_d = dense.predict(Xte)
    dense.predict_backend = "cg"
    mu_c, sd_c = dense.predict(Xte)
    np.testing.assert_allclose(mu_d, mu_c, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(sd_d, sd_c, rtol=1e-3, atol=1e-4)


def test_forest_predict_cg_refuses_reduced_matmul_precision(case):
    model = prior_model(mixed_domain(), seed=3)
    from bark_tpu_torch.convert import model_from_reference

    port = model_from_reference(model, device="cpu")
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="full-float32"):
            forest_predict_cg(port.forest, port.noise, port.scale, case["fp/X"], case["fp/y"],
                              case["fp/C"], torch.as_tensor(mixed_domain().feature_types()))
    finally:
        torch.set_float32_matmul_precision("highest")


if __name__ == "__main__":
    reference_run(sys.argv[1])
