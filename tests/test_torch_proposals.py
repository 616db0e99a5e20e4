"""Parity of the port's proposal machinery with the JAX reference.

Bit operations, node subspaces and proposed trees are exact. The proposal's
log q-ratio + log prior-ratio and the noise/scale walk go through float32
transcendentals (log, exp, expm1, log1p), which XLA and PyTorch round
differently in the last ulp: they are compared to 1e-6 (rtol and atol).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bark_tpu.fitting.bits as jbits
from bark_tpu.domain import CategoricalInput, ContinuousInput, Domain, IntegerInput
from bark_tpu.fitting.noise_scale import get_noise_scale_proposal as jax_noise_scale
from bark_tpu.fitting.params import SamplerParams as JaxParams
from bark_tpu.fitting.prior import sample_forest_prior
from bark_tpu.fitting.proposals import ProposalNoise as JaxNoise
from bark_tpu.fitting.proposals import propose_tree_packed as jax_propose
from bark_tpu.fitting.traversal import node_subspace_packed as jax_subspace
from bark_tpu.forest import pack_forest as jax_pack

import bark_tpu_torch.fitting.bits as tbits
from bark_tpu_torch.convert import params_from_reference
from bark_tpu_torch.fitting.noise_scale import get_noise_scale_proposal
from bark_tpu_torch.fitting.proposals import ProposalNoise, propose_tree_packed
from bark_tpu_torch.fitting.traversal import node_subspace_packed

TOL = dict(rtol=1e-6, atol=1e-6)


def mixed_domain():
    return Domain(
        [
            ContinuousInput("x_0", (0.0, 1.0)),
            ContinuousInput("x_1", (-2.0, 3.0)),
            IntegerInput("i_0", (0, 5)),
            IntegerInput("i_1", (-3, 40)),
            CategoricalInput("c_0", ("a", "b", "c", "d")),
            CategoricalInput("c_1", tuple("abcdefghij")),
        ]
    )


def packed_prior_trees(dom, m, num, node_limit, max_depth, seed=3):
    """(num * m, node_limit, 8) packed prior trees (numpy)."""
    forests = sample_forest_prior(
        jax.random.key(seed), m, jnp.asarray(dom.bounds("bitmask")),
        jnp.asarray(dom.feature_types()), num_samples=num,
        node_limit=node_limit, max_depth=max_depth,
    )
    packed = np.asarray(jax_pack(forests))
    return packed.reshape(num * m, node_limit, 8)


def numpy_noise(rng, b, node_limit):
    u = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    g = -np.log(-np.log(np.maximum(u(b, node_limit), np.finfo(np.float32).tiny)))
    return dict(
        u_move=u(b), g_node=g.astype(np.float32), u_feat=u(b), u_cat=u(b),
        u_int=u(b), u_cont=u(b), u_accept=u(b),
    )


def test_bit_operations_exact():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.arange(0, 70000, 7), rng.integers(-(2**31), 2**31 - 1, 5000),
        [0, 1, -1, 2**24, 2**24 - 1, 2**31 - 1, -(2**31)],
    ]).astype(np.int32)
    np.testing.assert_array_equal(
        tbits.popcount(torch.as_tensor(x)).numpy(), np.asarray(jbits.popcount(jnp.asarray(x)))
    )
    small = np.abs(x) % (2**24)
    np.testing.assert_array_equal(
        tbits.next_power_of_2(torch.as_tensor(small)).numpy(),
        np.asarray(jbits.next_power_of_2(jnp.asarray(small))),
    )
    masks = rng.integers(0, 2**24, 4000).astype(np.int32)
    r = rng.integers(0, 2**24, 4000).astype(np.int32)
    c = np.array(jbits.popcount(jnp.asarray(masks)))
    ref = np.asarray(jax.vmap(jbits.scatter_bits)(jnp.asarray(r), jnp.asarray(masks), jnp.asarray(c)))
    got = tbits.scatter_bits(torch.as_tensor(r), torch.as_tensor(masks), torch.as_tensor(c))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("node_limit,max_depth", [(64, 16), (16, 4)])
def test_node_subspace_packed_exact(node_limit, max_depth):
    dom = mixed_domain()
    packed = packed_prior_trees(dom, 8, 3, node_limit, max_depth)
    bounds = dom.bounds("bitmask")
    ft = dom.feature_types()
    trees, nodes = np.nonzero(packed[:, :, 7])  # every active node
    ref = jax.jit(jax.vmap(
        lambda p, n: jax_subspace(p, n, jnp.asarray(bounds), jnp.asarray(ft), max_depth)
    ))(jnp.asarray(packed[trees]), jnp.asarray(nodes, jnp.int32))
    got = node_subspace_packed(
        torch.as_tensor(packed[trees]), torch.as_tensor(nodes),
        torch.as_tensor(bounds), torch.as_tensor(ft), max_depth,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("node_limit,max_depth", [(64, 16), (16, 4)])
def test_propose_tree_packed_matches_reference(node_limit, max_depth):
    """Same ProposalNoise -> identical packed tree, move and node; the
    small trees and depth cap exercise the capacity and depth rejections."""
    dom = mixed_domain()
    m, num, reps = 8, 3, 12
    packed = np.tile(packed_prior_trees(dom, m, num, node_limit, max_depth), (reps, 1, 1))
    b = packed.shape[0]
    noise = numpy_noise(np.random.default_rng(1), b, node_limit)
    bounds, ft = dom.bounds("bitmask"), dom.feature_types()
    jparams = JaxParams(num_trees=m, node_limit=node_limit, max_depth=max_depth)

    ref = jax.jit(jax.vmap(
        lambda p, nz: jax_propose(
            jax.random.key(0), p, jnp.asarray(bounds), jnp.asarray(ft), jparams, noise=nz
        )
    ))(jnp.asarray(packed), JaxNoise(**{k: jnp.asarray(v) for k, v in noise.items()}))
    got = propose_tree_packed(
        torch.as_tensor(packed), torch.as_tensor(bounds), torch.as_tensor(ft),
        params_from_reference(jparams),
        ProposalNoise(**{k: torch.as_tensor(v) for k, v in noise.items()}),
    )
    ref_packed, ref_lq, ref_move, ref_node = map(np.asarray, ref)
    new_packed, lq, move, node = (t.numpy() for t in got)
    np.testing.assert_array_equal(move, ref_move)
    np.testing.assert_array_equal(node, ref_node)
    np.testing.assert_array_equal(new_packed, ref_packed)
    np.testing.assert_array_equal(np.isfinite(lq), np.isfinite(ref_lq))
    fin = np.isfinite(ref_lq)
    np.testing.assert_allclose(lq[fin], ref_lq[fin], **TOL)
    # the batch covers every move type, accepted and rejected proposals
    assert set(np.unique(move)) == {0, 1, 2}
    assert 0 < fin.sum() < b


@pytest.mark.parametrize(
    "kwargs",
    [
        {},
        {"q_ratio_style": "reference"},
        {"sample_scale": True},
        {"sample_scale": True, "q_ratio_style": "reference"},
        {"use_softplus_transform": False, "sample_scale": True},
    ],
    ids=["default", "reference-ratio", "joint", "joint-reference", "log-walk"],
)
def test_noise_scale_proposal_matches_reference(kwargs):
    """The port takes the walk's normals as arguments: feed it the normals
    the reference draws inside its key, then compare within 1e-6."""
    jparams = JaxParams(**kwargs)
    rng = np.random.default_rng(2)
    c = 64
    noise = rng.uniform(0.005, 2.0, c).astype(np.float32)
    scale = rng.uniform(0.2, 3.0, c).astype(np.float32)
    keys = jax.random.split(jax.random.key(5), c)

    def ref_one(k, n, s):
        k_noise, k_scale = jax.random.split(k)
        z = (jax.random.normal(k_noise, dtype=jnp.float32),
             jax.random.normal(k_scale, dtype=jnp.float32))
        return z, jax_noise_scale(k, n, s, jparams)

    (zn, zs), ((new_n, new_s), lq) = jax.jit(jax.vmap(ref_one))(
        keys, jnp.asarray(noise), jnp.asarray(scale)
    )
    (t_n, t_s), t_lq = get_noise_scale_proposal(
        torch.as_tensor(np.array(zn)), torch.as_tensor(np.array(zs)),
        torch.as_tensor(noise), torch.as_tensor(scale), params_from_reference(jparams),
    )
    np.testing.assert_allclose(t_n.numpy(), np.asarray(new_n), **TOL)
    np.testing.assert_allclose(t_s.numpy(), np.asarray(new_s), **TOL)
    if kwargs.get("sample_scale") and kwargs.get("q_ratio_style") == "reference":
        # the reference formula's scale term divides the squared one-ulp
        # round-trip error of softplus(softplus^-1(scale)) by
        # SCALE_STEP^2 = 1e-16, so it is ulp noise times 1e16 in both
        # packages: only the noise term is comparable
        return
    np.testing.assert_allclose(t_lq.numpy(), np.asarray(lq), **TOL)
