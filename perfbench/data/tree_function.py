"""TreeFunction and the domain sampling the cells use, frozen, in NumPy.

A copy of ``bark_tpu_torch/benchmarks/tree_function.py``,
``bark_tpu_torch/utils/build.py:build_tree_arrays`` and
``Domain.sample``/``bounds``/``feature_types`` for a domain of continuous
inputs on [0, 1] and categorical inputs: the same NumPy generator calls in
the same order, so a seed gives the same forest, leaf values, points and
f(x) as the port's. It imports nothing of the port, so a later change to the
port cannot move the benchmark's data; ``test_perfbench_reference.py`` holds
the two equal.

Feature type codes as the port's: categorical 0, integer 1, continuous 2.
"""

from __future__ import annotations

import numpy as np

FEAT_CAT, FEAT_CONT = 0, 2
FIELDS = ("is_leaf", "feature", "threshold", "left", "right", "parent", "depth", "active")


def build_tree_arrays(spec, node_limit: int = 64) -> dict:
    """One tree's field arrays from a nested spec: ``("leaf",)`` or
    ``("split", feature, threshold, left_spec, right_spec)``; children take
    the next two free slots."""
    arrs = {
        "is_leaf": np.zeros(node_limit, bool),
        "feature": np.zeros(node_limit, np.int32),
        "threshold": np.zeros(node_limit, np.float32),
        "left": np.zeros(node_limit, np.int32),
        "right": np.zeros(node_limit, np.int32),
        "parent": np.zeros(node_limit, np.int32),
        "depth": np.zeros(node_limit, np.int32),
        "active": np.zeros(node_limit, bool),
    }
    next_slot = [1]

    def assign(idx, spec, parent, depth):
        arrs["active"][idx] = True
        arrs["parent"][idx] = parent
        arrs["depth"][idx] = depth
        if spec[0] == "leaf":
            arrs["is_leaf"][idx] = True
            return
        _, feat, thr, left_spec, right_spec = spec
        li, ri = next_slot[0], next_slot[0] + 1
        next_slot[0] += 2
        if ri >= node_limit:
            raise OverflowError("tree spec exceeds node_limit")
        arrs["feature"][idx] = feat
        arrs["threshold"][idx] = thr
        arrs["left"][idx] = li
        arrs["right"][idx] = ri
        assign(li, left_spec, idx, depth + 1)
        assign(ri, right_spec, idx, depth + 1)

    assign(0, spec, 0, 0)
    return arrs


def sample_tree_structures(m: int, dim: int, rng: np.random.Generator, node_limit: int = 64,
                           alpha: float = 0.95, beta: float = 2.0, max_depth: int = 16) -> dict:
    """m prior tree structures as stacked field arrays ``(m, node_limit)``."""
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

        while True:  # resample a tree that does not fit in node_limit slots
            spec = sample_spec(0)
            try:
                trees.append(build_tree_arrays(spec, node_limit))
                break
            except OverflowError:
                continue
    return {k: np.stack([t[k] for t in trees]) for k in FIELDS}


def route(fields: dict, X: np.ndarray, feat_types: np.ndarray, max_depth: int = 16) -> np.ndarray:
    """Leaf of every row in every tree, ``(N, m)``: numeric splits send
    ``x <= threshold`` left, categorical ones test ``(1 << x) & threshold``."""
    m = fields["feature"].shape[0]
    n = X.shape[0]
    trees = np.arange(m)[:, None]
    node = np.zeros((m, n), np.int64)
    rows = np.arange(n)[None, :]
    for _ in range(max_depth):
        feat = fields["feature"][trees, node]
        thr = fields["threshold"][trees, node]
        x = X[rows, feat]
        bit = np.left_shift(1, np.clip(x.astype(np.int32), 0, 31))
        left = np.where(feat_types[feat] == FEAT_CAT,
                        (bit & thr.astype(np.int32)) != 0, x <= thr)
        child = np.where(left, fields["left"][trees, node], fields["right"][trees, node])
        node = np.where(fields["is_leaf"][trees, node], node, child)
    return np.ascontiguousarray(node.T).astype(np.int32)  # row-major: sums run in order


class TreeFunction:
    """f(x) = sum over trees of the value of the leaf x lands in, for a
    forest drawn from the prior (alpha 0.95, beta 2) with ``function_seed``."""

    def __init__(self, dim=5, cat_dim=0, num_cat=5, m=50, function_seed=1):
        self.dim, self.cat_dim, self.num_cat = dim, cat_dim, num_cat
        rng = np.random.default_rng(function_seed)
        self.fields = sample_tree_structures(m, dim + cat_dim, rng)
        self.leaf_values = rng.standard_normal((m, self.fields["feature"].shape[1]))

    def feature_types(self) -> np.ndarray:
        return np.array([FEAT_CONT] * self.dim + [FEAT_CAT] * self.cat_dim, np.int32)

    def bounds(self, encoding: str = "bitmask") -> np.ndarray:
        """``(D, 2)`` float32: [0, 1] for a continuous input; for a
        categorical one [0, 2^k - 1] (bitmask) or [0, k - 1] (ordinal)."""
        ub = float((1 << self.num_cat) - 1) if encoding == "bitmask" else float(self.num_cat - 1)
        rows = [(0.0, 1.0)] * self.dim + [(0.0, ub)] * self.cat_dim
        return np.array(rows, np.float32)

    def sample(self, n: int, rng: np.random.Generator) -> np.ndarray:
        """Uniform points, ordinal-encoded ``(n, D)`` float32 (the port's
        ``Domain.sample``: a column per input, in order)."""
        cols = [rng.uniform(0.0, 1.0, size=n) for _ in range(self.dim)]
        cols += [rng.integers(0, self.num_cat, size=n) for _ in range(self.cat_dim)]
        return np.stack(cols, axis=1).astype(np.float32)

    def f(self, X) -> np.ndarray:
        X = np.asarray(X, np.float32)
        leaves = route(self.fields, X, self.feature_types())
        vals = self.leaf_values[np.arange(self.leaf_values.shape[0])[None, :], leaves]
        return vals.sum(axis=1).reshape(-1)
