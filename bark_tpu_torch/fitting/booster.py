"""Gradient-boosted-forest fitting and import into the forest encoding.

Counterpart of ``bark_tpu/fitting/booster.py``: the forest of the
non-Bayesian LeafGP and LeafMOGP surrogates comes from a booster fitted on
the (ordinal-encoded) data and is imported as a
:class:`~bark_tpu_torch.forest.Forest`. Three backends:

  - ``"native"``: the C++ booster of :mod:`bark_tpu_torch.native`, exact
    greedy L2 trees with arbitrary-subset categorical bitmask splits,
    emitted directly in the flat encoding;
  - ``"sklearn"``: ``GradientBoostingRegressor``, whose ordinal split
    ``cat <= t`` on a categorical feature becomes the bitmask over
    categories {0..t} (a contiguous prefix);
  - ``"lightgbm"``: a LightGBM booster through its ``dump_model()`` JSON
    (:func:`lgbm_dump_to_forest`); it raises where ``lightgbm`` is not
    installed.

One difference from the reference is deliberate: its ``"auto"`` becomes
``"sklearn"`` when no C++ toolchain is found, which gives another forest
and another model without a word to the caller. Here ``"auto"`` means
``"native"``, and a failed build of the native booster raises. The sklearn
forest is fitted only when the caller asks for it.

The forest is returned on the CPU (the booster runs on the host); the
caller moves it to its device.
"""

from __future__ import annotations

import numpy as np

from bark_tpu_torch.domain import Domain
from bark_tpu_torch.forest import Forest, forest_from_numpy


def fit_booster_forest(
    X: np.ndarray,
    y: np.ndarray,
    domain: Domain,
    num_boost_round: int = 50,
    max_depth: int = 3,
    node_limit: int = 64,
    random_state: int = 0,
    backend: str = "auto",
) -> Forest:
    """Fit a GBDT on ordinal-encoded data and import it as a Forest with
    fields ``(num_boost_round, node_limit)``.

    Defaults: depth 3, 50 rounds, 64 node slots. ``backend`` is ``"auto"``
    (= ``"native"``), ``"native"``, ``"sklearn"`` or ``"lightgbm"``.
    """
    if backend in ("auto", "native"):
        return _fit_native(X, y, domain, num_boost_round, max_depth, node_limit)
    if backend == "lightgbm":
        return _fit_lightgbm(X, y, domain, num_boost_round, max_depth, node_limit)
    if backend != "sklearn":
        raise ValueError(f"unknown booster backend: {backend!r}")

    from sklearn.ensemble import GradientBoostingRegressor

    model = GradientBoostingRegressor(
        n_estimators=num_boost_round,
        max_depth=max_depth,
        random_state=random_state,
    )
    model.fit(np.asarray(X, np.float64), np.asarray(y, np.float64).reshape(-1))
    cat_idx = set(domain.cat_indices())
    cat_sizes = {i: len(domain.inputs[i].categories) for i in cat_idx}
    trees = [
        _sklearn_tree_to_arrays(est[0].tree_, cat_idx, cat_sizes, node_limit)
        for est in model.estimators_
    ]
    stacked = {k: np.stack([t[k] for t in trees]) for k in trees[0]}
    return forest_from_numpy(stacked)


def _fit_native(X, y, domain, num_boost_round, max_depth, node_limit) -> Forest:
    """Fit through the C++ booster; its trees arrive in the flat encoding."""
    from bark_tpu_torch import native

    feat_types = np.asarray(domain.feature_types(), np.int32)
    cat_sizes = np.zeros(len(feat_types), np.int32)
    for i in domain.cat_indices():
        cat_sizes[i] = len(domain.inputs[i].categories)
    arrays = native.fit_gbdt(
        np.asarray(X, np.float32),
        np.asarray(y, np.float32).reshape(-1),
        feat_types,
        cat_sizes,
        num_rounds=num_boost_round,
        max_depth=max_depth,
        node_limit=node_limit,
    )
    arrays = {k: v for k, v in arrays.items() if k != "leaf_value"}
    return forest_from_numpy(arrays)


def _fit_lightgbm(X, y, domain, num_boost_round, max_depth, node_limit) -> Forest:
    """Fit a LightGBM booster (depth 3, 50 rounds, min_data_in_leaf 1,
    categorical features declared) and import its dump."""
    try:
        import lightgbm as lgb
    except ImportError as e:
        raise RuntimeError(
            "backend='lightgbm' requires the lightgbm package (not "
            "installed; use the native C++ booster, which produces the "
            "same arbitrary-subset categorical splits)"
        ) from e

    params = {
        "max_depth": max_depth,
        "min_data_in_leaf": 1,
        "verbose": -1,
        "num_boost_round": num_boost_round,
    }
    dataset = lgb.Dataset(
        np.asarray(X, np.float64),
        np.asarray(y, np.float64).reshape(-1),
        categorical_feature=sorted(domain.cat_indices()),
    )
    booster = lgb.train(params, dataset)
    return lgbm_dump_to_forest(booster.dump_model(), node_limit=node_limit)


def _empty_tree_arrays(node_limit: int) -> dict:
    return {
        "is_leaf": np.zeros(node_limit, bool),
        "feature": np.zeros(node_limit, np.int32),
        "threshold": np.zeros(node_limit, np.float32),
        "left": np.zeros(node_limit, np.int32),
        "right": np.zeros(node_limit, np.int32),
        "parent": np.zeros(node_limit, np.int32),
        "depth": np.zeros(node_limit, np.int32),
        "active": np.zeros(node_limit, bool),
    }


def lgbm_dump_to_forest(dump: dict, node_limit: int = 64) -> Forest:
    """Convert a LightGBM ``dump_model()`` dict into a Forest.

    A categorical decision (``decision_type: "=="``) carries either one
    category index or a ``"c1||c2||..."`` subset string as its threshold;
    both become the exact bitmask the router tests with ``(1 << x) & thr``,
    arbitrary subsets included. Nodes are numbered by a depth-first walk
    (children at the next two free slots), with parent and depth filled in.
    """
    trees = []
    for info in dump["tree_info"]:
        arrs = _empty_tree_arrays(node_limit)
        next_free = 1
        stack = [(0, info["tree_structure"], 0, 0)]
        while stack:
            nid, node, parent, depth = stack.pop()
            if nid >= node_limit:
                raise OverflowError(f"LightGBM tree needs > node_limit={node_limit} nodes")
            arrs["active"][nid] = True
            arrs["parent"][nid] = parent
            arrs["depth"][nid] = depth
            if "split_feature" not in node:  # a leaf record
                arrs["is_leaf"][nid] = True
                continue
            f = int(node["split_feature"])
            thr = node["threshold"]
            if node.get("decision_type") == "==":
                cats = [int(c) for c in str(thr).split("||")]
                if any(c >= 24 for c in cats):
                    raise ValueError(
                        f"category index {max(cats)} exceeds the 24-bit "
                        "exact-float32 bitmask range"
                    )
                thr = float(sum(1 << c for c in sorted(set(cats))))
            else:
                thr = float(thr)
            left, right = next_free, next_free + 1
            next_free += 2
            arrs["feature"][nid] = f
            arrs["threshold"][nid] = np.float32(thr)
            arrs["left"][nid] = left
            arrs["right"][nid] = right
            stack.append((left, node["left_child"], nid, depth + 1))
            stack.append((right, node["right_child"], nid, depth + 1))
        trees.append(arrs)
    stacked = {k: np.stack([t[k] for t in trees]) for k in trees[0]}
    return forest_from_numpy(stacked)


def _sklearn_tree_to_arrays(tree, cat_idx, cat_sizes, node_limit) -> dict:
    """One sklearn tree in the flat encoding: sklearn's node ids are a flat
    preorder already and map one to one; parent and depth are filled in."""
    arrs = _empty_tree_arrays(node_limit)
    if tree.node_count > node_limit:
        raise OverflowError(
            f"booster tree has {tree.node_count} nodes > node_limit {node_limit}"
        )
    for nid in range(tree.node_count):
        arrs["active"][nid] = True
        left, right = tree.children_left[nid], tree.children_right[nid]
        if left == -1:  # a leaf
            arrs["is_leaf"][nid] = True
            continue
        f = int(tree.feature[nid])
        t = float(tree.threshold[nid])
        if f in cat_idx:
            # ordinal split "cat <= t" -> bitmask over categories {0..floor(t)}
            upper = int(np.floor(t))
            mask = (1 << (upper + 1)) - 1 if upper >= 0 else 0
            mask &= (1 << cat_sizes[f]) - 1
            t = float(mask)
        arrs["feature"][nid] = f
        arrs["threshold"][nid] = t
        arrs["left"][nid] = left
        arrs["right"][nid] = right
        arrs["parent"][left] = nid
        arrs["parent"][right] = nid
        arrs["depth"][left] = arrs["depth"][nid] + 1
        arrs["depth"][right] = arrs["depth"][nid] + 1
    return arrs
