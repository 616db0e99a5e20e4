"""Parity of the port's forest layer with the JAX reference.

Inputs are made from a seed with numpy, cast to float32, and handed to both
packages. Integer outputs (leaf ids, packed records, co-occurrence counts)
must match exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bark_tpu.forest as jf
from bark_tpu.benchmarks.tree_function import TreeFunction as JaxTreeFunction
from bark_tpu.domain import CategoricalInput, ContinuousInput, Domain, IntegerInput
from bark_tpu.fitting.params import SamplerParams as JaxParams
from bark_tpu.fitting.prior import sample_forest_prior
from bark_tpu.fitting.sampler import BARKModel as JaxModel
from bark_tpu.ops.pallas_gram import gram_from_leaves_pallas

import bark_tpu_torch.domain as td
import bark_tpu_torch.forest as tf
from bark_tpu_torch.benchmarks.tree_function import TreeFunction
from bark_tpu_torch.convert import (
    forest_from_reference,
    model_from_reference,
    params_from_reference,
    to_numpy,
)
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.ops.gram import gram_from_leaves, gram_plain


def mixed_domain():
    return Domain(
        [
            ContinuousInput("x_0", (0.0, 1.0)),
            ContinuousInput("x_1", (-2.0, 3.0)),
            IntegerInput("i_0", (0, 5)),
            CategoricalInput("c_0", ("a", "b", "c", "d")),
            CategoricalInput("c_1", ("a", "b", "c", "d", "e", "f", "g")),
        ]
    )


def port_domain(dom):
    conv = {
        ContinuousInput: lambda f: td.ContinuousInput(f.key, f.bounds),
        IntegerInput: lambda f: td.IntegerInput(f.key, f.bounds),
        CategoricalInput: lambda f: td.CategoricalInput(f.key, f.categories),
    }
    return td.Domain([conv[type(f)](f) for f in dom.inputs])


def prior_forests(dom, m=10, num=4, seed=3, node_limit=64):
    bounds = jnp.asarray(dom.bounds("bitmask"), jnp.float32)
    ft = jnp.asarray(dom.feature_types())
    return sample_forest_prior(
        jax.random.key(seed), m, bounds, ft, num_samples=num, node_limit=node_limit
    )


def test_sampler_params_copy_is_equal():
    jfields = [(f.name, f.default) for f in dataclasses.fields(JaxParams)]
    tfields = [(f.name, f.default) for f in dataclasses.fields(SamplerParams)]
    assert jfields == tfields
    assert JaxParams._ALLOWED_MODES == SamplerParams._ALLOWED_MODES
    ref = JaxParams(num_trees=7, grow_prune_weight=0.3, node_limit=32)
    port = params_from_reference(ref)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.proposal_weights == ref.proposal_weights
    for bad in ({"scan_style": "nope"}, {"chol_block": -2},
                {"refresh_style": "leaf", "scan_style": "plain"}):
        with pytest.raises(ValueError):
            JaxParams(**bad)
        with pytest.raises(ValueError):
            SamplerParams(**bad)


def test_domain_copy_is_equal():
    dom = mixed_domain()
    port = port_domain(dom)
    np.testing.assert_array_equal(port.feature_types(), dom.feature_types())
    for enc in ("bitmask", "ordinal"):
        np.testing.assert_array_equal(port.bounds(enc), dom.bounds(enc))
    np.testing.assert_array_equal(
        port.sample(33, np.random.default_rng(4)),
        dom.sample(33, np.random.default_rng(4)),
    )


@pytest.mark.parametrize("node_limit", [64, 32])
def test_route_forest_matches_reference_on_prior_forests(node_limit):
    """Gather-walk routing is bit-exact against JAX, categorical bitmask
    splits included, for a batch of forests routed at once."""
    dom = mixed_domain()
    forests = prior_forests(dom, node_limit=node_limit)
    X = dom.sample(301, np.random.default_rng(1)).astype(np.float32)
    ft = dom.feature_types()
    port_leaves = tf.route_forest(
        forest_from_reference(forests, device="cpu"), torch.as_tensor(X), torch.as_tensor(ft)
    ).numpy()
    assert port_leaves.shape == (4, 301, 10)
    for s in range(4):
        tree = jax.tree.map(lambda a: a[s], forests)
        ref = np.asarray(jf.route_forest(tree, jnp.asarray(X), jnp.asarray(ft)))
        np.testing.assert_array_equal(port_leaves[s], ref)


def test_pack_unpack_round_trip_matches_reference():
    forests = prior_forests(mixed_domain())
    port = forest_from_reference(forests, device="cpu")
    packed = tf.pack_forest(port)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jf.pack_forest(forests))
    )
    back = tf.unpack_forest(packed)
    for k in tf.FOREST_FIELDS:
        a, b = getattr(back, k), getattr(port, k)
        assert a.dtype == b.dtype, k
        assert torch.equal(a, b), k
    # threshold bits survive exactly (categorical bitmasks and NaN-free floats)
    assert torch.equal(
        back.threshold.view(torch.int32), port.threshold.view(torch.int32)
    )


def test_model_conversion_round_trip():
    """A reference BARKModel converts to the port and back bit for bit."""
    forests = prior_forests(mixed_domain())
    model = JaxModel(
        forests, jnp.asarray([0.1, 0.2, 0.3, 0.4], jnp.float32), jnp.ones(4, jnp.float32)
    )
    port = model_from_reference(model, device="cpu")
    assert port.forest.threshold.dtype == torch.float32 and port.forest.left.dtype == torch.int32
    back = to_numpy(port)
    for k in tf.FOREST_FIELDS:
        np.testing.assert_array_equal(back["forest"][k], np.asarray(getattr(forests, k)))
    np.testing.assert_array_equal(back["noise"], np.asarray(model.noise))
    again = model_from_reference(back, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again.forest, port.forest))


def test_create_empty_forest_matches_reference():
    ref = jf.create_empty_forest(5, 16, batch_shape=(3,))
    port = tf.create_empty_forest(5, 16, batch_shape=(3,))
    for k in tf.FOREST_FIELDS:
        np.testing.assert_array_equal(getattr(port, k).numpy(), np.asarray(getattr(ref, k)))


@pytest.mark.parametrize("n,mm", [(10, 7), (100, 70), (200, 300)])
@pytest.mark.parametrize("masked", [False, True])
def test_gram_plain_matches_reference(n, mm, masked):
    """The plain K1 against both JAX Gram paths, under the mask contract.

    Counts are integers and must match exactly. The Pallas wrapper divides
    by m with an IEEE division, as the port does: exact. XLA rewrites the
    one-hot path's division by the constant m into a multiply by 1/m, which
    can differ by one float32 ulp: that comparison is on the counts
    (gram * m rounded) plus a one-ulp bound on the values.
    """
    rng = np.random.default_rng(0)
    m, nl = 20, 32
    l1 = rng.integers(0, nl, (n, m)).astype(np.int32)
    l2 = rng.integers(0, nl, (mm, m)).astype(np.int32)
    m1 = m2 = None
    if masked:
        m1 = (rng.uniform(size=n) > 0.3).astype(np.float32)
        m2 = (rng.uniform(size=mm) > 0.3).astype(np.float32)
    jm1 = None if m1 is None else jnp.asarray(m1)
    jm2 = None if m2 is None else jnp.asarray(m2)
    t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731

    got = gram_plain(t(l1), t(l2), t(m1), t(m2)).numpy()
    pallas = np.asarray(
        gram_from_leaves_pallas(jnp.asarray(l1), jnp.asarray(l2), jm1, jm2, interpret=True)
    )
    onehot = np.asarray(jf.gram_from_leaves(jnp.asarray(l1), jnp.asarray(l2), nl, jm1, jm2))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(np.rint(got * m), np.rint(onehot * m))
    np.testing.assert_allclose(got, onehot, rtol=2**-23, atol=0)


def test_gram_batched_and_dispatch():
    """Batched leaves (B, N, m) with shared and per-batch masks equal the
    per-batch computation; the forest-level entry dispatches to it."""
    rng = np.random.default_rng(2)
    l1 = torch.as_tensor(rng.integers(0, 9, (3, 17, 6)), dtype=torch.int32)
    l2 = torch.as_tensor(rng.integers(0, 9, (3, 11, 6)), dtype=torch.int32)
    m1 = torch.as_tensor((rng.uniform(size=(3, 17)) > 0.4).astype(np.float32))
    m2 = torch.as_tensor((rng.uniform(size=11) > 0.4).astype(np.float32))
    got = gram_from_leaves(l1, l2, m1, m2)
    for b in range(3):
        assert torch.equal(got[b], gram_plain(l1[b], l2[b], m1[b], m2))
    assert torch.equal(tf.gram_from_leaves(l1, l2, m1, m2), got)


def test_tree_function_matches_reference():
    """Same seed -> same forest, leaf values, X and y, continuous and mixed."""
    for kwargs in ({"dim": 5, "m": 50, "function_seed": 1},
                   {"dim": 3, "cat_dim": 2, "num_cat": 5, "m": 12, "function_seed": 3}):
        ref, port = JaxTreeFunction(**kwargs), TreeFunction(**kwargs)
        for k in tf.FOREST_FIELDS:
            np.testing.assert_array_equal(
                getattr(port.forest, k).numpy(), np.asarray(getattr(ref.forest, k))
            )
        np.testing.assert_array_equal(port.leaf_values, ref.leaf_values)
        X_ref = ref.domain.sample(64, np.random.default_rng(0))
        X = port.domain.sample(64, np.random.default_rng(0))
        np.testing.assert_array_equal(X, X_ref)
        np.testing.assert_array_equal(port.f(X), ref.f(X_ref))
