"""Host-side tree construction from nested specs (numpy only).

    ("leaf",)
    ("split", feature_idx, threshold, left_spec, right_spec)

Children are allocated at the next two free slots, the layout the sampler's
proposals produce, so hand-built trees look like sampled ones.
"""

from __future__ import annotations

import numpy as np

from bark_tpu_torch.forest import DEFAULT_NODE_LIMIT


def build_tree_arrays(spec, node_limit: int = DEFAULT_NODE_LIMIT) -> dict:
    """Build one tree's field arrays from a nested spec (numpy dict)."""
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

