"""The reference's public names that the port added last, held against it.

The forest Gram API (``forest_gram_matrix`` and its batched and no-null
forms), ``utils/build.build_forest`` and ``LEAF``,
``fitting/noise_scale.gamma_logpdf`` and ``fitting/proposals.propose_tree``,
each on the same inputs as ``bark_tpu``'s. Tree fields, moves and the
single-forest Gram are exact. The reference's batched (vmapped) Gram rounds
some quotients c / m one ulp away from the IEEE quotient that the port
computes, so there the counts c are exact and the Gram is held to 1e-6, as
are the no-null Gram, the gamma log density and log q.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bark_tpu.forest as jf
from bark_tpu.domain import CategoricalInput, ContinuousInput, Domain, IntegerInput
from bark_tpu.fitting.noise_scale import gamma_logpdf as jax_gamma_logpdf
from bark_tpu.fitting.params import SamplerParams as JaxParams
from bark_tpu.fitting.prior import sample_forest_prior
from bark_tpu.fitting.proposals import ProposalNoise as JaxNoise
from bark_tpu.fitting.proposals import propose_tree_packed as jax_propose
from bark_tpu.utils.build import LEAF as JAX_LEAF
from bark_tpu.utils.build import build_forest as jax_build_forest

import bark_tpu_torch.forest as tf
from bark_tpu_torch.convert import forest_from_reference, params_from_reference
from bark_tpu_torch.fitting.noise_scale import gamma_logpdf
from bark_tpu_torch.fitting.proposals import (
    ProposalNoise,
    propose_tree,
    propose_tree_packed,
)
from bark_tpu_torch.utils.build import LEAF, build_forest

TOL = dict(rtol=1e-6, atol=1e-6)


def mixed_domain():
    return Domain([
        ContinuousInput("x_0", (0.0, 1.0)),
        CategoricalInput("c_0", ("a", "b", "c", "d")),
        IntegerInput("i_0", (0, 10)),
    ])


def demo_specs():
    """Continuous, categorical-bitmask and integer splits, and a null tree."""
    return [
        ("split", 0, 0.5, LEAF, ("split", 0, 0.75, LEAF, LEAF)),
        ("split", 1, float(0b0101), LEAF, ("split", 2, 7.0, LEAF, LEAF)),
        ("split", 2, 4.0, ("split", 0, 0.2, LEAF, LEAF), LEAF),
        LEAF,
        ("split", 1, float(0b1000), ("split", 0, 0.9, LEAF, LEAF), LEAF),
    ]


def as_f32(a):
    return jnp.asarray(np.asarray(a, np.float32))


def prior_batch(dom, num=4, m=12, seed=3, node_limit=64):
    """(num, m, node_limit) prior forests of the reference."""
    return sample_forest_prior(
        jax.random.key(seed), m, as_f32(dom.bounds("bitmask")),
        jnp.asarray(dom.feature_types()), num_samples=num, node_limit=node_limit,
    )


def test_leaf_and_build_forest_equal_the_reference():
    assert LEAF == JAX_LEAF
    for node_limit in (64, 16):
        ref = jax_build_forest(demo_specs(), node_limit)
        got = build_forest(demo_specs(), node_limit, device="cpu")
        assert got.is_leaf.shape == (5, node_limit)
        for name, a, b in zip(tf.FOREST_FIELDS, got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
            assert a.dtype == {"is_leaf": torch.bool, "active": torch.bool,
                               "threshold": torch.float32}.get(name, torch.int32)


@pytest.mark.parametrize("same", [False, True], ids=["x1-x2", "x-x"])
def test_forest_gram_matrix_equals_the_reference(same):
    dom = mixed_domain()
    rng = np.random.default_rng(1)
    X1 = dom.sample(40, rng).astype(np.float32)
    X2 = X1 if same else dom.sample(17, rng).astype(np.float32)
    ft = dom.feature_types()
    ref = np.asarray(jf.forest_gram_matrix(
        jax_build_forest(demo_specs()), as_f32(X1), as_f32(X2), jnp.asarray(ft)))
    x1 = torch.as_tensor(X1)
    got = tf.forest_gram_matrix(build_forest(demo_specs(), device="cpu"), x1,
                                x1 if same else torch.as_tensor(X2), torch.as_tensor(ft))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def test_batched_gram_and_no_null_equal_the_reference():
    dom = mixed_domain()
    rng = np.random.default_rng(2)
    X1 = dom.sample(33, rng).astype(np.float32)
    X2 = dom.sample(21, rng).astype(np.float32)
    ft = dom.feature_types()
    # prior forests (some trees are stumps) and the demo forest with its
    # null tree, padded to the prior's 12 trees with stumps
    prior = prior_batch(dom, m=12)
    demo = jax_build_forest(demo_specs() + [JAX_LEAF] * 7)
    ref_forest = jax.tree.map(lambda p, d: jnp.concatenate([p, d[None]]), prior, demo)
    port_forest = forest_from_reference(ref_forest, device="cpu")
    args_ref = (as_f32(X1), as_f32(X2), jnp.asarray(ft))
    args = (torch.as_tensor(X1), torch.as_tensor(X2), torch.as_tensor(ft))

    ref = np.asarray(jf.batched_forest_gram_matrix(ref_forest, *args_ref))
    got = tf.batched_forest_gram_matrix(port_forest, *args).numpy()
    assert got.shape == (5, 33, 21)
    np.testing.assert_array_equal(np.rint(got * 12), np.rint(ref * 12))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    # the port's quotients are the IEEE c / m of the single-forest form
    np.testing.assert_array_equal(got, (np.rint(got * 12) / np.float32(12)).astype(np.float32))

    ref_nn = np.asarray(jf.batched_forest_gram_matrix_no_null(ref_forest, *args_ref))
    got_nn = tf.batched_forest_gram_matrix_no_null(port_forest, *args)
    assert int(tf.num_null_trees(port_forest)[-1]) == 8
    np.testing.assert_allclose(got_nn.numpy(), ref_nn, rtol=1e-6, atol=1e-6)

    with pytest.raises(ValueError, match="batch of forests"):
        tf.batched_forest_gram_matrix(build_forest(demo_specs(), device="cpu"), *args)


def test_gamma_logpdf_equals_the_reference():
    x = np.random.default_rng(4).uniform(1e-3, 8.0, 257).astype(np.float32)
    for shape, rate in ((1.5, 5.0), (2.5, 9.0), (0.7, 0.3)):
        ref = np.asarray(jax_gamma_logpdf(as_f32(x), shape, rate))
        got = gamma_logpdf(torch.as_tensor(x), shape, rate)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def numpy_noise(rng, shape, node_limit):
    u = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    g = -np.log(-np.log(np.maximum(u(*shape, node_limit), np.finfo(np.float32).tiny)))
    return dict(u_move=u(*shape), g_node=g.astype(np.float32), u_feat=u(*shape),
                u_cat=u(*shape), u_int=u(*shape), u_cont=u(*shape), u_accept=u(*shape))


@pytest.mark.parametrize("node_limit,max_depth", [(64, 16), (16, 4)])
def test_propose_tree_equals_propose_tree_packed_and_the_reference(node_limit, max_depth):
    dom = mixed_domain()
    m, num, reps = 6, 3, 8
    prior = prior_batch(dom, num=num, m=m, node_limit=node_limit)
    stumps = jax_build_forest([JAX_LEAF] * m, node_limit)  # prune and change reject
    # (reps, (num + 1) * m) trees: a batch with two leading dims
    trees = jax.tree.map(
        lambda a, b: jnp.tile(jnp.concatenate([a.reshape(num * m, node_limit), b]),
                              (reps, 1, 1)),
        prior, stumps)
    num += 1
    noise = numpy_noise(np.random.default_rng(5), (reps, num * m), node_limit)
    bounds, ft = dom.bounds("bitmask"), dom.feature_types()
    jparams = JaxParams(num_trees=m, node_limit=node_limit, max_depth=max_depth)
    params = params_from_reference(jparams)
    port_trees = forest_from_reference(trees, device="cpu")
    port_noise = ProposalNoise(**{k: torch.as_tensor(v) for k, v in noise.items()})
    tb, tft = torch.as_tensor(bounds), torch.as_tensor(ft)

    new_tree, lq, move, node = propose_tree(port_trees, tb, tft, params, port_noise,
                                            return_move=True)
    assert new_tree.is_leaf.shape == (reps, num * m, node_limit)
    assert lq.shape == move.shape == node.shape == (reps, num * m)

    # the port's packed proposal on the flattened batch, unpacked
    flat_noise = ProposalNoise(*(t.reshape(-1, *t.shape[2:]) for t in port_noise))
    packed = tf.pack_forest(port_trees).reshape(-1, node_limit, 8)
    p_packed, p_lq, p_move, p_node = propose_tree_packed(packed, tb, tft, params, flat_noise)
    for a, b in zip(new_tree, tf.unpack_forest(p_packed)):
        assert torch.equal(a.reshape(b.shape), b)
    assert torch.equal(lq.reshape(-1), p_lq)
    assert torch.equal(move.reshape(-1), p_move) and torch.equal(node.reshape(-1), p_node)

    # the reference's packed proposal under the same noise
    flat_ref = jax.tree.map(lambda a: a.reshape(-1, *a.shape[2:]), trees)
    ref = jax.jit(jax.vmap(
        lambda p, nz: jax_propose(jax.random.key(0), p, as_f32(bounds), jnp.asarray(ft),
                                  jparams, noise=nz)
    ))(jf.pack_forest(flat_ref), JaxNoise(**{k: jnp.asarray(v.reshape(-1, *v.shape[2:]))
                                           for k, v in noise.items()}))
    ref_packed, ref_lq, ref_move, ref_node = map(np.asarray, ref)
    np.testing.assert_array_equal(tf.pack_forest(new_tree).numpy().reshape(ref_packed.shape),
                                  ref_packed)
    np.testing.assert_array_equal(move.numpy().reshape(-1), ref_move)
    np.testing.assert_array_equal(node.numpy().reshape(-1), ref_node)
    lq = lq.numpy().reshape(-1)
    fin = np.isfinite(ref_lq)
    np.testing.assert_array_equal(np.isfinite(lq), fin)
    np.testing.assert_allclose(lq[fin], ref_lq[fin], **TOL)
    assert set(np.unique(ref_move)) == {0, 1, 2} and 0 < fin.sum() < fin.size

    # one tree without a batch dim, as the reference's signature takes it
    one = tf.Forest(*(t[0, 0] for t in port_trees))
    one_noise = ProposalNoise(*(t[0, 0] for t in port_noise))
    t1, lq1 = propose_tree(one, tb, tft, params, one_noise)
    assert t1.is_leaf.shape == (node_limit,) and lq1.shape == ()
    for a, b in zip(t1, new_tree):
        assert torch.equal(a, b[0, 0])
