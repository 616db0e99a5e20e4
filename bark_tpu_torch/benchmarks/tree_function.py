"""TreeFunction: a ground-truth function sampled from the BARK prior.

Counterpart of ``bark_tpu/benchmarks/tree_function.py`` without JAX: the
same numpy generator calls in the same order, so a seed gives the same
forest, the same leaf values and (routing through the port's
:func:`~bark_tpu_torch.forest.route_forest`) the same f(x).

  - tree structure grown with probability alpha (1 + d)^-beta, feature
    uniform over all dims, threshold ~ U(0, 1) whatever the feature type
    (so categorical splits are degenerate ``int(thr) = 0`` masks that
    always route right, as in the reference);
  - leaf values ~ N(0, 1) per node slot; f(x) = sum over trees of the
    value of the leaf x lands in.
"""

from __future__ import annotations

import numpy as np
import torch

from bark_tpu_torch.benchmarks.base import register_benchmark
from bark_tpu_torch.domain import CategoricalInput, ContinuousInput, Domain
from bark_tpu_torch.forest import Forest, forest_from_numpy, route_forest
from bark_tpu_torch.utils.build import build_tree_arrays


def sample_tree_structure_from_prior(
    m: int, dim: int, rng: np.random.Generator, node_limit: int = 64,
    alpha: float = 0.95, beta: float = 2.0, max_depth: int = 16,
) -> Forest:
    """Host-side prior sample of m tree structures (fields (m, node_limit))."""
    trees = []
    for _ in range(m):
        def sample_spec(depth):
            if depth >= max_depth or rng.uniform() > alpha * (1 + depth) ** (-beta):
                return ("leaf",)
            feat = int(rng.integers(dim))
            thr = float(rng.uniform(0, 1))
            left = sample_spec(depth + 1)
            right = sample_spec(depth + 1)
            return ("split", feat, thr, left, right)

        # resample a tree that does not fit in node_limit slots
        while True:
            spec = sample_spec(0)
            try:
                trees.append(build_tree_arrays(spec, node_limit))
                break
            except OverflowError:
                continue
    stacked = {k: np.stack([t[k] for t in trees]) for k in trees[0]}
    return forest_from_numpy(stacked)


@register_benchmark("TreeFunction")
class TreeFunction:
    """f(x) = sum_j leaf_value_j(x) for a prior-sampled forest."""

    def __init__(self, dim=5, cat_dim=0, num_cat=5, m=50, function_seed=1):
        categories = tuple(chr(i + ord("a")) for i in range(num_cat))
        self.domain = Domain(
            [
                *(ContinuousInput(f"x_{i}", (0.0, 1.0)) for i in range(dim)),
                *(CategoricalInput(f"c_{i}", categories) for i in range(cat_dim)),
            ]
        )
        rng = np.random.default_rng(function_seed)
        self.forest = sample_tree_structure_from_prior(m, dim + cat_dim, rng)
        self.leaf_values = rng.standard_normal(
            (m, self.forest.node_limit)
        ).astype(np.float64)
        self._feat_types = torch.as_tensor(self.domain.feature_types())

    def f(self, X) -> np.ndarray:
        """Evaluate at ordinal-encoded points ``(N, D)``; returns ``(N,)``."""
        X = np.asarray(X, np.float64)
        leaves = np.ascontiguousarray(route_forest(
            self.forest, torch.as_tensor(X, dtype=torch.float32), self._feat_types
        ).numpy())  # (N, m), row-major so the sum over trees runs in order
        vals = self.leaf_values[np.arange(self.leaf_values.shape[0])[None, :], leaves]
        return vals.sum(axis=1).reshape(-1)
