"""Regression evaluation: NLPD, MSE and fit seconds over resampled runs.

Counterpart of ``examples/regression.py``: for each of ``num_runs``
resamples, fit the surrogate on ``num_train`` points and score it on
``num_test`` held-out points; one CSV row per run (the reference's columns,
plus ``mse_mean``, the MSE of the training mean, the bar a model must
clear). Configurations come as dicts (see
:data:`~bark_tpu_torch.benchmarks.study.EXAMPLE_CONFIGS`).

Usage (``-c``/``-m`` take a name of ``EXAMPLE_CONFIGS`` or, when PyYAML is
importable, a YAML file)::

    python -m bark_tpu_torch.benchmarks.regression -s 0 \
        -c examples/configs/regression_treefunction.yaml \
        -m examples/configs/model_bart.yaml -o results/ [--device cpu]
"""

from __future__ import annotations

import argparse
import csv
import logging
import time
from pathlib import Path

import numpy as np
import torch

from bark_tpu_torch.benchmarks import map_benchmark
from bark_tpu_torch.benchmarks.study import load_config
from bark_tpu_torch.fitting.bart import BARTParams
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.models.surrogate import BARKPriorSurrogate, BARKSurrogate
from bark_tpu_torch.utils.metrics import mse, nlpd

logger = logging.getLogger(__name__)


def build_surrogate(model_config: dict, domain, seed: int, device=None):
    """The surrogate of a model configuration: BARK, BARKPrior, LeafGP or
    BART."""
    name = model_config["model"]
    model_params = dict(model_config.get("model_params", {}))

    def fields_of(cls):
        keys = cls.__dataclass_fields__.keys()
        return cls(**{k: v for k, v in model_params.items() if k in keys})

    if name == "BARK":
        return BARKSurrogate(domain, fields_of(SamplerParams), seed=seed, device=device)
    if name == "BARKPrior":
        return BARKPriorSurrogate(domain, seed=seed, device=device, **model_params)
    if name == "LeafGP":
        from bark_tpu_torch.models.leafgp import LeafGPSurrogate

        return LeafGPSurrogate(domain, seed=seed, device=device, **model_params)
    if name == "BART":
        from bark_tpu_torch.models.bart import BARTSurrogate

        return BARTSurrogate(domain, fields_of(BARTParams), seed=seed, device=device)
    raise KeyError(name)


def run_regression(seed: int, benchmark_config: dict, model_config: dict, output,
                   device=None) -> dict:
    """Run the resamples, write ``regression_<tag>.csv`` under ``output`` and
    return the means of nlpd, mse, mse_mean and fit_s over the runs. A fit's
    seconds end with a device synchronisation when CUDA is in use."""
    benchmark = map_benchmark(benchmark_config["benchmark"],
                              **benchmark_config.get("benchmark_params", {}))
    domain = benchmark.domain
    num_train = benchmark_config.get("num_train", 50)
    num_test = benchmark_config.get("num_test", 200)
    num_runs = benchmark_config.get("num_runs", 20)

    rows = []
    rng = np.random.default_rng(seed)
    for run in range(num_runs):
        Xtr = domain.sample(num_train, rng)
        ytr = benchmark.f(Xtr)
        Xte = domain.sample(num_test, rng)
        yte = benchmark.f(Xte)

        surrogate = build_surrogate(model_config, domain, seed + run, device)
        t0 = time.perf_counter()
        surrogate.fit(Xtr, ytr)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        mu, std = surrogate.predict(Xte)
        row = {
            "run": run,
            "nlpd": nlpd(yte, mu, std**2),
            "mse": mse(yte, mu),
            "mse_mean": mse(yte, np.full_like(yte, ytr.mean())),
            "fit_s": fit_s,
        }
        rows.append(row)
        logger.info("run %d: nlpd=%.4f mse=%.4f (mean %.4f) fit=%.2fs", run, row["nlpd"],
                    row["mse"], row["mse_mean"], fit_s)

    output = Path(output)
    output.mkdir(parents=True, exist_ok=True)
    tag = f"{benchmark_config['benchmark']}_{model_config['model']}_seed={seed}"
    with open(output / f"regression_{tag}.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    summary = {k: float(np.mean([r[k] for r in rows]))
               for k in ("nlpd", "mse", "mse_mean", "fit_s")}
    logger.info("mean over %d runs: %s", num_runs, summary)
    return summary


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-s", "--seed", type=int, default=0)
    parser.add_argument("-c", "--benchmark-config", type=Path, required=True)
    parser.add_argument("-m", "--model-config", type=Path, required=True)
    parser.add_argument("-o", "--output", type=Path, default=Path("results"))
    parser.add_argument("--device", default=None, help="cpu, or the CUDA device if left out")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    return run_regression(args.seed, load_config(args.benchmark_config),
                          load_config(args.model_config), args.output, args.device)


if __name__ == "__main__":
    main()
