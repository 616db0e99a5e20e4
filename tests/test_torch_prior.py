"""The port's forest and noise prior against the JAX reference, on the CPU.

The port draws a split rule by the uniform form of its proposals, the
reference by its keyed ``sample_splitting_rule``: the same distributions,
not the same draws one for one. So the forest prior is held to the
reference statistically, on 4,000 trees from each package on the mixed
domain of tests/fitting/test_sampler.py (alpha 0.95, beta 2, m = 8):

  - the histograms of leaves per tree and of leaf depth, by a two-sample
    chi-square at p > 1e-3 (sparse bins pooled). The leaves of one tree are
    not independent draws, so the leaf-depth statistic is divided by the
    mean leaves per tree (the conservative design-effect correction for
    clustered samples);
  - the mean leaves per tree within 4 standard errors of the difference;
  - the share of splits on each feature within 4 standard errors.

Every tree of the port must be valid. The noise prior is exact: fed the
reference's standard-gamma draws it gives the reference's noise within
rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as stats
import torch

from bark_tpu.fitting.prior import sample_forest_prior as jax_forest_prior
from bark_tpu.fitting.prior import sample_noise_prior as jax_noise_prior

from bark_tpu_torch.domain import CategoricalInput, ContinuousInput, Domain, IntegerInput
from bark_tpu_torch.fitting.prior import (
    PriorDraws,
    _grow_trees,
    draw_prior,
    sample_forest_prior,
    sample_noise_prior,
)
from bark_tpu_torch.fitting.traversal import node_subspace_packed
from bark_tpu_torch.forest import FEAT_CAT, FEAT_INT

M, SAMPLES = 8, 500  # 4,000 trees
ALPHA, BETA, NODE_LIMIT, MAX_DEPTH = 0.95, 2.0, 64, 16


def mixed_domain():
    """The domain of tests/fitting/test_sampler.py:make_problem."""
    return Domain(
        [
            ContinuousInput("x_0", (0.0, 1.0)),
            ContinuousInput("x_1", (0.0, 1.0)),
            IntegerInput("i_0", (0, 5)),
            CategoricalInput("c_0", ("a", "b", "c", "d")),
        ]
    )


@pytest.fixture(scope="module")
def forests():
    dom = mixed_domain()
    bounds, ft = dom.bounds("bitmask"), dom.feature_types()
    ref = jax_forest_prior(
        jax.random.key(11), M, jnp.asarray(bounds), jnp.asarray(ft), alpha=ALPHA, beta=BETA,
        num_samples=SAMPLES, node_limit=NODE_LIMIT, max_depth=MAX_DEPTH,
    )
    ref = {k: np.asarray(getattr(ref, k)) for k in ref._fields}
    draws = draw_prior(torch.Generator().manual_seed(11), SAMPLES, M, NODE_LIMIT)
    port = sample_forest_prior(
        draws, M, torch.as_tensor(bounds), torch.as_tensor(ft), ALPHA, BETA, NODE_LIMIT,
        MAX_DEPTH,
    )
    port = {k: getattr(port, k).numpy() for k in port._fields}
    return ref, port, bounds, ft


def _leaves_per_tree(f):
    return (f["active"] & f["is_leaf"]).sum(-1).reshape(-1)


def _leaf_depths(f):
    return f["depth"][f["active"] & f["is_leaf"]]


def _split_features(f):
    return f["feature"][f["active"] & ~f["is_leaf"]]


def _chi2_p(a, b, design_effect=1.0):
    """Two-sample chi-square p-value of integer samples: columns with fewer
    than 10 counts merged into the next, the statistic divided by
    ``design_effect``."""
    values = np.arange(max(a.max(), b.max()) + 1)
    table = np.stack([(a[:, None] == values).sum(0), (b[:, None] == values).sum(0)])
    merged = []
    acc = np.zeros(2, np.int64)
    for col in table.T:
        acc = acc + col
        if acc.sum() >= 10:
            merged.append(acc)
            acc = np.zeros(2, np.int64)
    if acc.sum():
        merged[-1] = merged[-1] + acc
    stat, _, dof, _ = stats.chi2_contingency(np.stack(merged, 1), correction=False)
    return stats.chi2.sf(stat / design_effect, dof)


@pytest.mark.parametrize("what", ["leaves_per_tree", "leaf_depth"])
def test_prior_histograms_match_reference(forests, what):
    ref, port, _, _ = forests
    if what == "leaves_per_tree":
        p = _chi2_p(_leaves_per_tree(ref), _leaves_per_tree(port))
    else:
        per_tree = np.concatenate([_leaves_per_tree(ref), _leaves_per_tree(port)]).mean()
        p = _chi2_p(_leaf_depths(ref), _leaf_depths(port), per_tree)
    assert p > 1e-3, f"{what}: chi-square p = {p}"


def test_prior_mean_leaves_and_feature_shares_match_reference(forests):
    ref, port, bounds, _ = forests
    a, b = _leaves_per_tree(ref), _leaves_per_tree(port)
    se = np.sqrt(a.var() / a.size + b.var() / b.size)
    assert abs(a.mean() - b.mean()) < 4 * se, (a.mean(), b.mean(), se)
    fa, fb = _split_features(ref), _split_features(port)
    for f in range(bounds.shape[0]):
        pa, pb = (fa == f).mean(), (fb == f).mean()
        pool = ((fa == f).sum() + (fb == f).sum()) / (fa.size + fb.size)
        se = np.sqrt(pool * (1 - pool) * (1 / fa.size + 1 / fb.size))
        assert abs(pa - pb) < 4 * se, (f, pa, pb, se)


def test_prior_trees_are_valid(forests):
    """Children of active split nodes are active leaves or splits one level
    deeper, leaves = splits + 1, depth <= max_depth, and every split lies in
    the domain: categorical thresholds proper non-empty subsets of the
    categories, integer thresholds below the upper bound."""
    _, f, bounds, ft = forests
    active, is_leaf = f["active"], f["is_leaf"]
    split = active & ~is_leaf
    np.testing.assert_array_equal(active.sum(-1), 2 * (active & is_leaf).sum(-1) - 1)
    assert f["depth"][active].max() <= MAX_DEPTH
    for child in ("left", "right"):
        c = np.take_along_axis(active, f[child], -1)
        assert c[split].all()
        depth_c = np.take_along_axis(f["depth"], f[child], -1)
        np.testing.assert_array_equal(depth_c[split], f["depth"][split] + 1)
        parent_c = np.take_along_axis(f["parent"], f[child], -1)
        np.testing.assert_array_equal(parent_c[split], np.nonzero(split)[-1])
    feat, thr = f["feature"][split], f["threshold"][split]
    cat = ft[feat] == FEAT_CAT
    full = int(bounds[ft == FEAT_CAT][0, 1])
    t = thr[cat].astype(np.int64)
    assert cat.any() and (t > 0).all() and ((t & ~full) == 0).all() and (t != full).all()
    integer = ft[feat] == FEAT_INT
    assert integer.any() and (thr[integer] < bounds[feat[integer], 1]).all()
    assert (thr[integer] >= bounds[feat[integer], 0]).all()
    cont = ~cat & ~integer
    assert (thr[cont] >= bounds[feat[cont], 0]).all() and (thr[cont] <= bounds[feat[cont], 1]).all()


def test_carried_subspaces_equal_the_walk():
    """The scan carries each slot's sub-domain down from its parent; for every
    active node of 400 trees it equals ``node_subspace_packed``'s walk up
    from the node, exactly (so each split was drawn where the walk puts it)."""
    dom = mixed_domain()
    bounds, ft = torch.as_tensor(dom.bounds("bitmask")), torch.as_tensor(dom.feature_types())
    draws = draw_prior(torch.Generator().manual_seed(3), 50, M, NODE_LIMIT)
    packed, sub = _grow_trees(draws, M, bounds, ft, ALPHA, BETA, NODE_LIMIT, MAX_DEPTH)
    active = packed[..., 7] != 0
    assert int(active.sum(-1).max()) >= 7
    for slot in range(int(active.sum(-1).max()) + 2):
        walk = node_subspace_packed(packed, torch.full((packed.shape[0],), slot), bounds, ft,
                                    MAX_DEPTH)
        rows = active[:, slot]
        assert torch.equal(sub[rows, slot], walk[rows]), slot


def test_noise_prior_replays_reference_gamma_draws():
    with jax.enable_x64(False):
        key = jax.random.key(2)
        gamma = np.asarray(jax.random.gamma(key, 2.5, (64,)))
        want = np.asarray(jax_noise_prior(key, 2.5, 9.0, 64))
    got = sample_noise_prior(torch.tensor(gamma), 9.0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_draw_prior_shapes_and_gamma_moments():
    draws = draw_prior(torch.Generator().manual_seed(0), 20000, 2, 8, gamma_shape=2.5)
    assert isinstance(draws, PriorDraws)
    assert draws.u_grow.shape == (20000, 2, 8) and draws.gamma.shape == (20000,)
    assert all(bool(((t >= 0) & (t < 1)).all()) for t in draws[:5])
    noise = sample_noise_prior(draws.gamma, 9.0).double()
    np.testing.assert_allclose(noise.mean().item(), 2.5 / 9.0, rtol=0.05)
    np.testing.assert_allclose(noise.var().item(), 2.5 / 81.0, rtol=0.1)


def test_prior_root_split_frequency_and_stumps():
    """A root splits with probability alpha; alpha = 0 gives stumps, and a
    node_limit of 1 leaves no room to grow (the reference's structural
    guards)."""
    dom = Domain([ContinuousInput("x", (0.0, 1.0))])
    bounds, ft = torch.as_tensor(dom.bounds("bitmask")), torch.as_tensor(dom.feature_types())
    draws = draw_prior(torch.Generator().manual_seed(1), 20, 100, 16)
    f = sample_forest_prior(draws, 100, bounds, ft, 0.95, 2.0, 16, 8)
    assert abs((~f.is_leaf[..., 0]).float().mean().item() - 0.95) < 0.03
    stumps = sample_forest_prior(draws, 100, bounds, ft, 0.0, 2.0, 16, 8)
    assert bool(stumps.is_leaf[..., 0].all()) and int(stumps.active.sum()) == 2000
    tiny = sample_forest_prior(
        draw_prior(torch.Generator().manual_seed(1), 4, 10, 1), 10, bounds, ft, 0.95, 2.0, 1, 8)
    assert bool(tiny.is_leaf.all())
    with pytest.raises(ValueError, match="node_limit"):
        sample_forest_prior(draws, 100, bounds, ft, 0.95, 2.0, 32, 8)
