"""The port's profiling hooks and plots (``utils/profiling.py``,
``utils/plots.py``) on the CPU, and ``format_tree`` against the JAX
package's: the same text for the same forest, tree by tree."""

import json
import sys

import numpy as np
import pytest
import torch

from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.fitting.prior import draw_prior, sample_forest_prior
from bark_tpu_torch.forest import FOREST_FIELDS
from bark_tpu_torch.benchmarks import map_benchmark
from bark_tpu_torch.utils import plots, profiling


@pytest.fixture(scope="module")
def forest():
    """Six prior forests of 5 trees over a mixed domain (first one used)."""
    dom = map_benchmark("PestControl", seed=0).domain
    params = SamplerParams(num_trees=5)
    gen = torch.Generator().manual_seed(0)
    prior = draw_prior(gen, 6, 5, params.node_limit)
    f = sample_forest_prior(prior, 5, torch.as_tensor(dom.bounds("bitmask")),
                            torch.as_tensor(dom.feature_types()), node_limit=params.node_limit)
    return type(f)(*(t[0] for t in f))


def test_format_tree_equals_the_reference(forest):
    from bark_tpu.utils.plots import format_tree as jformat

    ref_forest = type("F", (), {f: getattr(forest, f).numpy() for f in FOREST_FIELDS})
    names = [f"f{i}" for i in range(25)]
    grown = 0
    for tree in range(forest.num_trees):
        for fn in (None, names):
            text = plots.format_tree(forest, tree, fn)
            assert text == jformat(ref_forest, tree, fn)
        grown += "node[" in text
        assert text.count("leaf[") == int((forest.active & forest.is_leaf)[tree].sum())
    assert grown > 0  # some tree has a split


def test_plots_render(tmp_path, forest):
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 6, figsize=(24, 3))
    x = np.linspace(0, 1, 30)
    plots.plot_gp_1d(axes[0], x, np.sin(x), 0.1 + 0 * x)
    plots.plot_covariance(axes[1], torch.eye(5))
    plots.plot_bo_trace(axes[2], [3, 2, 2.5, 1], label="bark")
    plots.plot_mll_trace(axes[3], torch.randn(2, 20, generator=torch.Generator().manual_seed(0)))
    plots.plot_forest_depths(axes[4], forest)
    tree = int(torch.argmax(forest.active.sum(-1)))
    plots.plot_tree(axes[5], forest, tree)
    out = tmp_path / "plots.png"
    plots.save_fig(fig, out)
    assert out.exists() and out.stat().st_size > 1000


def test_plots_raise_naming_matplotlib_where_it_is_missing(monkeypatch, forest):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        plots.plot_bo_trace(None, [1.0, 0.5])
    assert "leaf[" in plots.format_tree(forest, 0)  # text needs nothing else


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    x = torch.arange(1024.0)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("square"):
            y = x * x
    assert float(y[3]) == 9.0
    events = json.loads((tmp_path / "trace" / profiling.TRACE_FILE).read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "square" in names
    assert any(e.key == "square" for e in prof.key_averages())

