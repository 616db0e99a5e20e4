"""Plotting: GP posteriors, covariance heatmaps, BO traces, MCMC diagnostics.

Counterpart of ``bark_tpu/utils/plots.py``: the same functions, taking the
port's tensors (on any device) or numpy arrays. :func:`format_tree` is plain
text and needs nothing else; the figure functions need matplotlib, which
they import at first use (headless, Agg) and which raises there, naming the
package, where it is not installed (the GPU machine has none).
"""

from __future__ import annotations

import numpy as np
import torch


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def pyplot():
    """``matplotlib.pyplot`` on the headless Agg backend; a RuntimeError
    naming matplotlib where it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError(
            "bark_tpu_torch.utils.plots needs matplotlib, which is not installed"
        ) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_gp_1d(ax, x, mu, std, train_x=None, train_y=None, true_f=None):
    """1-D posterior mean ± 2 std (plot_gp.py:11-45)."""
    pyplot()
    order = np.argsort(x.reshape(-1))
    x, mu, std = (_np(a).reshape(-1)[order] for a in (x, mu, std))
    ax.plot(x, mu, label="posterior mean")
    ax.fill_between(x, mu - 2 * std, mu + 2 * std, alpha=0.3, label="±2σ")
    if true_f is not None:
        ax.plot(x, _np(true_f).reshape(-1)[order], "k--", label="truth")
    if train_x is not None:
        ax.scatter(train_x, train_y, c="r", s=15, zorder=3, label="data")
    ax.legend()
    return ax


def plot_covariance(ax, K):
    """Kernel heatmap (plot_gp.py covariance panel)."""
    im = ax.imshow(_np(K), cmap="viridis")
    pyplot().colorbar(im, ax=ax)
    return ax


def plot_bo_trace(ax, best_trace, label=None):
    """Best-so-far regret curve (logger.py:84-86 / plot_bo_runs intent)."""
    pyplot()
    ax.plot(np.minimum.accumulate(_np(best_trace)), label=label)
    ax.set_xlabel("iteration")
    ax.set_ylabel("best observed")
    if label:
        ax.legend()
    return ax


def plot_mll_trace(ax, mlls):
    """Per-chain MLL traces (analyse_mll_arr.py:4-7 intent)."""
    pyplot()
    mlls = np.atleast_2d(_np(mlls))
    for i, chain in enumerate(mlls):
        ax.plot(chain, alpha=0.8, label=f"chain {i}")
    ax.set_xlabel("sample")
    ax.set_ylabel("MLL")
    ax.legend()
    return ax


def plot_forest_depths(ax, forest):
    """Histogram of active-leaf depths across a forest (tree-structure
    visualization replacing the reference's stale plot_trees.py)."""
    pyplot()
    depth = _np(forest.depth)
    leaf = _np(forest.active & forest.is_leaf)
    ax.hist(depth[leaf].reshape(-1), bins=np.arange(0, depth.max() + 2) - 0.5)
    ax.set_xlabel("leaf depth")
    ax.set_ylabel("count")
    return ax


def format_tree(forest, tree_idx: int, feature_names=None) -> str:
    """Render one tree of a (batch-free) forest as indented text.

    A working replacement for the reference's stale tree-diagram plotter
    (src/bark/utils/plots/plot_trees.py:12-29, which references undefined
    node classes). Splits print as ``feature <= threshold`` for numerics
    and ``feature in {bitmask}`` for categoricals; pass ``feature_names``
    to label features.
    """
    is_leaf = _np(forest.is_leaf)[tree_idx]
    feature = _np(forest.feature)[tree_idx]
    threshold = _np(forest.threshold)[tree_idx]
    left = _np(forest.left)[tree_idx]
    right = _np(forest.right)[tree_idx]
    active = _np(forest.active)[tree_idx]

    def name(f):
        return feature_names[f] if feature_names else f"x{f}"

    lines = []

    def walk(node, depth):
        if not active[node]:
            return
        pad = "  " * depth
        if is_leaf[node]:
            lines.append(f"{pad}leaf[{node}]")
            return
        f, t = int(feature[node]), threshold[node]
        cats = {i for i in range(32) if (1 << i) & int(t)}
        lines.append(
            f"{pad}node[{node}] {name(f)} <= {t:.4g} "
            f"(as bitmask: {{{','.join(map(str, sorted(cats)))}}})"
        )
        walk(int(left[node]), depth + 1)
        walk(int(right[node]), depth + 1)

    walk(0, 0)
    return "\n".join(lines)


def plot_tree(ax, forest, tree_idx: int, feature_names=None):
    """Draw one tree as a node-link diagram (plot_trees.py intent)."""
    pyplot()
    is_leaf = _np(forest.is_leaf)[tree_idx]
    feature = _np(forest.feature)[tree_idx]
    threshold = _np(forest.threshold)[tree_idx]
    left = _np(forest.left)[tree_idx]
    right = _np(forest.right)[tree_idx]
    active = _np(forest.active)[tree_idx]

    pos = {}
    next_x = [0.0]

    def layout(node, depth):
        if not active[node]:
            return
        if is_leaf[node]:
            pos[node] = (next_x[0], -depth)
            next_x[0] += 1.0
            return
        layout(int(left[node]), depth + 1)
        layout(int(right[node]), depth + 1)
        xl = pos[int(left[node])][0]
        xr = pos[int(right[node])][0]
        pos[node] = ((xl + xr) / 2.0, -depth)

    layout(0, 0)
    for node, (x, y) in pos.items():
        if not is_leaf[node]:
            for child in (int(left[node]), int(right[node])):
                cx, cy = pos[child]
                ax.plot([x, cx], [y, cy], "k-", lw=0.8, zorder=1)
        label = (
            f"L{node}"
            if is_leaf[node]
            else (
                (feature_names[int(feature[node])] if feature_names
                 else f"x{int(feature[node])}")
                + f"≤{threshold[node]:.3g}"
            )
        )
        ax.annotate(
            label, (x, y), ha="center", va="center", zorder=2,
            bbox=dict(boxstyle="round", fc="w" if is_leaf[node] else "#cde"),
        )
    ax.set_axis_off()
    return ax


def save_fig(fig, path):
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    pyplot().close(fig)
