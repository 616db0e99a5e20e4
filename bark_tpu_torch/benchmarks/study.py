"""The BO-study runner: a benchmark, a model, a seed and an output directory.

Counterpart of ``examples/bark_study.py``: ``num_init`` random points, then
``num_iter`` ask / evaluate / add iterations, recording per-iteration fit
and optimize seconds and the experiment trace to CSV (the reference's
columns), and the merged configuration beside it. The configuration is
written as JSON (``config_<tag>.json``), where the reference writes YAML:
PyYAML is not a dependency of the port. The configurations come as dicts;
:data:`EXAMPLE_CONFIGS` holds those of ``examples/configs/*.yaml``.

Usage (``-c``/``-m`` take a name of ``EXAMPLE_CONFIGS`` or, when PyYAML is
importable, a YAML file)::

    python -m bark_tpu_torch.benchmarks.study -s 0 \
        -c examples/configs/benchmark_treefunction.yaml \
        -m examples/configs/model_bart.yaml -o results/ [--device cpu]

One deliberate difference from the reference: a BART model's
``model_params`` that are :class:`~bark_tpu_torch.fitting.bart.BARTParams`
fields go to the surrogate (as the regression runner does), where the
reference hands them to ``GridUCBStrategy``, which refuses them.
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
from pathlib import Path

import numpy as np

from bark_tpu_torch.benchmarks import map_benchmark
from bark_tpu_torch.constraints import total_violation
from bark_tpu_torch.fitting.bart import BARTParams
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.strategies.tree_kernel import make_strategy
from bark_tpu_torch.utils.timer import BOLogger, Timer

logger = logging.getLogger(__name__)

#: ``examples/configs/*.yaml`` as dicts
EXAMPLE_CONFIGS = {
    "benchmark_g6": {"benchmark": "G6", "num_init": 10, "num_iter": 20},
    "benchmark_pestcontrol": {"benchmark": "PestControl", "benchmark_params": {"seed": 0},
                              "num_init": 10, "num_iter": 20},
    "benchmark_pressurevessel": {"benchmark": "PressureVessel", "num_init": 10,
                                 "num_iter": 20},
    "benchmark_styblinskitang": {"benchmark": "StyblinskiTang",
                                 "benchmark_params": {"dim": 5}, "num_init": 10,
                                 "num_iter": 20},
    "benchmark_treefunction": {"benchmark": "TreeFunction",
                               "benchmark_params": {"dim": 5, "m": 50}, "num_init": 10,
                               "num_iter": 20},
    "mcmc_benchmark": {"benchmark": "TreeFunction", "benchmark_params": {"dim": 5, "m": 50},
                       "num_train": 50},
    "mcmc_model": {"model": "BARK", "model_params": {
        "warmup_steps": 0, "num_samples": 500, "steps_per_sample": 1, "num_chains": 4,
        "num_trees": 50}},
    "model_bark": {"model": "BARK", "model_params": {
        "warmup_steps": 50, "num_samples": 5, "steps_per_sample": 10, "num_chains": 1,
        "num_trees": 50}},
    "model_bark_prior": {"model": "BARKPrior"},
    "model_bart": {"model": "BART", "model_params": {
        "warmup_steps": 100, "num_samples": 50, "num_trees": 50}},
    "model_leafgp": {"model": "LeafGP"},
    "model_random": {"model": "Random"},
    "regression_treefunction": {"benchmark": "TreeFunction",
                                "benchmark_params": {"dim": 5, "m": 50}, "num_train": 50,
                                "num_test": 200, "num_runs": 5},
}

#: model names whose SamplerParams / BARTParams fields go to the surrogate
_PARAMS_OF = {
    "BARK": ("params", SamplerParams), "TreeKernel": ("params", SamplerParams),
    "GridUCB": ("params", SamplerParams),
    "BART": ("bart_params", BARTParams), "BARTGrid": ("bart_params", BARTParams),
}


def build_strategy(model_config: dict, domain, seed: int, device=None):
    """The strategy of a model configuration (``make_strategy`` by name)."""
    name = model_config["model"]
    kwargs = dict(model_config.get("model_params", {}))
    if name in _PARAMS_OF:
        arg, cls = _PARAMS_OF[name]
        fields = cls.__dataclass_fields__.keys()
        kwargs = {k: v for k, v in kwargs.items() if k not in fields} | {
            arg: cls(**{k: v for k, v in kwargs.items() if k in fields})}
    return make_strategy(name, domain, seed=seed, device=device, **kwargs)


def run_study(seed: int, benchmark_config: dict, model_config: dict, output, device=None):
    """Run one study and write ``experiments_<tag>.csv`` and
    ``config_<tag>.json`` under ``output``; returns the merged configuration
    (with the best y, the initial best, the feasible-proposal rate and the
    strategy's random fallbacks)."""
    benchmark = map_benchmark(benchmark_config["benchmark"],
                              **benchmark_config.get("benchmark_params", {}))
    domain = benchmark.domain
    num_init = benchmark_config.get("num_init", min(30, 2 * domain.dim))
    num_iter = benchmark_config.get("num_iter", 100)
    logger.info("Benchmark: %s | Model: %s | seed=%d", benchmark_config["benchmark"],
                model_config["model"], seed)
    rng = np.random.default_rng(seed)
    X = domain.sample(num_init, rng)
    y = benchmark.f(X)

    strategy = build_strategy(model_config, domain, seed, device)
    bo_log = BOLogger()
    timer = Timer()
    with timer("fit"):
        strategy.tell(X, y)

    viols = []
    for itr in range(num_iter):
        with timer("optimize"):
            candidate = strategy.ask(1)
        y_new = benchmark.f(candidate)
        with timer("fit"):
            strategy.add(candidate, y_new)
        bo_log.log_iteration(candidate[0], y_new[0], timer)
        viol = total_violation(domain.constraints, candidate.astype(np.float64),
                               domain.input_keys)[0]
        viols.append(float(viol))
        logger.info("iter %d: y=%.4f best=%.4f viol=%.3g fit=%.2fs opt=%.2fs", itr,
                    y_new[0], bo_log.best[-1], viol, timer.get("fit", 0),
                    timer.get("optimize", 0))
        timer = Timer()

    output = Path(output)
    output.mkdir(parents=True, exist_ok=True)
    tag = f"{benchmark_config['benchmark']}_{model_config['model']}_seed={seed}"
    with open(output / f"experiments_{tag}.csv", "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow([*domain.input_keys, "y", "best", "viol", "fit_s", "optimize_s"])
        for row, cand, v in zip(bo_log.as_rows(), bo_log.candidates, viols):
            writer.writerow([*cand, row["y"], row["best"], v, row.get("fit", 0.0),
                             row.get("optimize", 0.0)])
    merged = {
        "seed": seed,
        "benchmark_config": benchmark_config,
        "model_config": model_config,
        "best": bo_log.best[-1] if bo_log.best else float(y.min()),
        "initial_best": float(y.min()),
        "fallbacks": getattr(strategy, "fallbacks", 0),
        "feasible_proposal_rate": (
            float(np.mean([v <= 1e-6 for v in viols])) if viols else 1.0
        ),
    }
    with open(output / f"config_{tag}.json", "w") as f:
        json.dump(merged, f, indent=2)
    logger.info("Done. Final best: %.4f", merged["best"])
    return merged


def read_yaml(path: Path) -> dict:
    """A YAML configuration file (needs PyYAML)."""
    try:
        import yaml
    except ImportError as e:
        raise RuntimeError(
            f"reading {path} needs PyYAML, which is not installed; call run_study "
            "with the configuration as a dict (EXAMPLE_CONFIGS has the examples')"
        ) from e
    with open(path) as f:
        return yaml.safe_load(f)


def load_config(name_or_path) -> dict:
    """A configuration by its name in :data:`EXAMPLE_CONFIGS`
    (``"mcmc_model"``), or else read from a YAML file."""
    if str(name_or_path) in EXAMPLE_CONFIGS:
        return EXAMPLE_CONFIGS[str(name_or_path)]
    return read_yaml(Path(name_or_path))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-s", "--seed", type=int, default=0)
    parser.add_argument("-c", "--benchmark-config", type=Path, required=True)
    parser.add_argument("-m", "--model-config", type=Path, required=True)
    parser.add_argument("-o", "--output", type=Path, default=Path("results"))
    parser.add_argument("--device", default=None, help="cpu, or the CUDA device if left out")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    return run_study(args.seed, load_config(args.benchmark_config),
                     load_config(args.model_config), args.output, args.device)


if __name__ == "__main__":
    main()
