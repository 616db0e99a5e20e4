"""The port's BO-study and regression runners on the CPU at a tiny size.

``run_study`` writes the reference's CSV columns and the merged
configuration as JSON; the configuration dicts of ``EXAMPLE_CONFIGS`` (which
the chip check's phase 12 runs) equal the YAML files of
``examples/configs``; ``run_regression`` scores BART under the mean
predictor.
"""

import csv
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from bark_tpu_torch.benchmarks import study
from bark_tpu_torch.benchmarks.regression import build_surrogate, run_regression
from bark_tpu_torch.benchmarks.study import EXAMPLE_CONFIGS, build_strategy, run_study
from bark_tpu_torch.fitting.bart import BARTParams
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.models.bart import BARTSurrogate

CONFIGS = Path(__file__).resolve().parents[1] / "examples" / "configs"
#: the header of the reference's experiments CSV (examples/bark_study.py)
COLUMNS = ["y", "best", "viol", "fit_s", "optimize_s"]
TINY_BART = {"model": "BART", "model_params": {"warmup_steps": 20, "num_samples": 6,
                                                "num_trees": 8, "node_limit": 16}}


@pytest.mark.parametrize("name", sorted(EXAMPLE_CONFIGS))
def test_example_configs_equal_the_yaml_files(name):
    with open(CONFIGS / f"{name}.yaml") as f:
        assert EXAMPLE_CONFIGS[name] == yaml.safe_load(f)


@pytest.mark.parametrize("bench,model", [
    ({"benchmark": "TreeFunction", "benchmark_params": {"dim": 2, "m": 10}, "num_init": 6,
      "num_iter": 3}, TINY_BART),
    ({"benchmark": "StyblinskiTang", "benchmark_params": {"dim": 2}, "num_init": 6,
      "num_iter": 3}, {"model": "RelaxedGP", "model_params": {"fit_steps": 15,
                                                              "num_candidates": 256}}),
], ids=["TreeFunction-BART", "StyblinskiTang-RelaxedGP"])
def test_run_study_writes_the_reference_columns_and_a_json_config(tmp_path, bench, model):
    merged = run_study(0, bench, model, tmp_path, device="cpu")
    tag = f"{bench['benchmark']}_{model['model']}_seed=0"
    with open(tmp_path / f"experiments_{tag}.csv") as f:
        rows = list(csv.reader(f))
    dim = bench["benchmark_params"]["dim"]
    assert rows[0] == [f"x_{i}" for i in range(dim)] + COLUMNS
    assert len(rows) == 1 + bench["num_iter"]
    best = [float(r[dim + 1]) for r in rows[1:]]
    assert all(b2 <= b1 for b1, b2 in zip(best, best[1:]))
    X = np.array([[float(v) for v in r[:dim]] for r in rows[1:]])
    assert (X >= -5).all() and (X <= 5).all()
    with open(tmp_path / f"config_{tag}.json") as f:
        saved = json.load(f)
    assert saved == merged
    assert saved["benchmark_config"] == bench and saved["model_config"] == model
    assert saved["best"] == best[-1] and saved["feasible_proposal_rate"] == 1.0
    assert np.isfinite(saved["initial_best"])


def test_build_strategy_routes_the_params():
    from bark_tpu_torch.benchmarks import map_benchmark

    dom = map_benchmark("TreeFunction", dim=2, m=4).domain
    bart = build_strategy({**TINY_BART, "model_params": {**TINY_BART["model_params"],
                                                          "max_grid": 64}}, dom, 0, "cpu")
    assert isinstance(bart.surrogate, BARTSurrogate) and bart.max_grid == 64
    assert bart.surrogate.params == BARTParams(warmup_steps=20, num_samples=6, num_trees=8,
                                               node_limit=16)
    bark = build_strategy(EXAMPLE_CONFIGS["model_bark"], dom, 0, "cpu")
    assert bark.surrogate.params == SamplerParams(warmup_steps=50, num_samples=5,
                                                  steps_per_sample=10, num_chains=1,
                                                  num_trees=50)
    grid = build_strategy({"model": "GridUCB", "model_params": {"num_trees": 7}}, dom, 0,
                          "cpu")
    assert grid.surrogate.params.num_trees == 7


def test_run_regression_at_a_tiny_size(tmp_path):
    bench = {**EXAMPLE_CONFIGS["regression_treefunction"],
             "benchmark_params": {"dim": 2, "m": 10}, "num_train": 30, "num_test": 50,
             "num_runs": 2}
    summary = run_regression(0, bench, TINY_BART, tmp_path, device="cpu")
    assert summary["mse"] < summary["mse_mean"] and np.isfinite(summary["nlpd"])
    with open(tmp_path / "regression_TreeFunction_BART_seed=0.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2 and list(rows[0]) == ["run", "nlpd", "mse", "mse_mean", "fit_s"]
    from bark_tpu_torch.benchmarks import map_benchmark

    dom = map_benchmark("TreeFunction", dim=2, m=4).domain
    for name in ("BARK", "BARKPrior", "LeafGP", "BART"):
        assert build_surrogate({"model": name}, dom, 0, "cpu").device.type == "cpu"
    with pytest.raises(KeyError):
        build_surrogate({"model": "Nope"}, dom, 0, "cpu")


def test_yaml_configs_need_pyyaml(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(RuntimeError, match="PyYAML"):
        study.read_yaml(CONFIGS / "model_bart.yaml")


def test_study_main_reads_the_yaml_configs(tmp_path):
    bench = tmp_path / "bench.yaml"
    bench.write_text(yaml.safe_dump({"benchmark": "Hartmann", "num_init": 4, "num_iter": 1}))
    merged = study.main(["-c", str(bench), "-m", str(CONFIGS / "model_random.yaml"), "-o",
                         str(tmp_path), "--device", "cpu"])
    assert merged["model_config"] == {"model": "Random"}
    assert (tmp_path / "config_Hartmann_Random_seed=0.json").exists()


def test_metrics_and_logger_copies_equal_the_originals():
    import bark_tpu.utils.metrics as jmetrics
    from bark_tpu.utils.timer import BOLogger as JaxLogger

    from bark_tpu_torch.utils import metrics as tmetrics
    from bark_tpu_torch.utils.timer import BOLogger, Timer

    rng = np.random.default_rng(3)
    y, mu = rng.normal(size=40), rng.normal(size=(40, 1))
    var = rng.uniform(0.1, 2.0, size=(40, 1))
    np.testing.assert_array_equal(tmetrics.gaussian_log_likelihood(y, mu, var),
                                  jmetrics.gaussian_log_likelihood(y, mu, var))
    assert tmetrics.nlpd(y, mu, var) == jmetrics.nlpd(y, mu, var)
    assert tmetrics.mse(y, mu) == jmetrics.mse(y, mu)
    port, ref = BOLogger(), JaxLogger()
    for i, v in enumerate([3.0, 1.0, 2.0]):
        timer = Timer()
        with timer("fit"):
            pass
        times = {"fit": float(i)}
        port.log_iteration(np.array([i]), v, times)
        ref.log_iteration(np.array([i]), v, times)
    assert list(port.as_rows()) == list(ref.as_rows()) and port.best == [3.0, 1.0, 1.0]
    assert timer["fit"] >= 0.0
