"""MCMC diagnostics: the MLL trace of every chain, and its convergence.

The port's twin of ``examples/mcmc_record_mll.py``: ``num_train`` random
points of the benchmark (y standardised), chains from empty forests (noise
0.1, scale 1) through ``run_bark_sampler_with_trace``, which records the
MLL at every sample. Saves ``mlls.npy`` (chains, samples) and
``noise_samples.npy``, and returns ``mll_trace_summary`` of the trace
(final mean, max, R-hat, ESS).

    python -m bark_tpu_torch.benchmarks.mcmc_record -s 0 \
        [-c mcmc_benchmark] [-m mcmc_model] [-o DIR] [--device cpu]

``-c``/``-m`` take a name of ``study.EXAMPLE_CONFIGS`` (by default the MCMC
pair of ``examples/configs/mcmc_*.yaml``: TreeFunction dim 5, N = 50, 4
chains x 500 steps) or a YAML file. Writes under
``results/port/mcmc_record/`` unless ``-o`` says otherwise.
"""

from __future__ import annotations

import argparse
import logging
import pathlib

import numpy as np
import torch

from bark_tpu_torch.benchmarks import map_benchmark
from bark_tpu_torch.benchmarks.study import load_config
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.fitting.sampler import BARKModel, run_bark_sampler_with_trace
from bark_tpu_torch.forest import create_empty_forest
from bark_tpu_torch.models.surrogate import resolve_device
from bark_tpu_torch.utils.diagnostics import mll_trace_summary

logger = logging.getLogger(__name__)

OUT_DIR = pathlib.Path(__file__).resolve().parents[2] / "results" / "port" / "mcmc_record"


def run_record(seed: int, benchmark_config: dict, model_config: dict, output,
               device=None) -> dict:
    """Run the chains, save the traces under ``output`` and return the
    summary. ``device=None`` means the CUDA device (an error without one)."""
    dev = resolve_device(device)
    benchmark = map_benchmark(benchmark_config["benchmark"],
                              **benchmark_config.get("benchmark_params", {}))
    domain = benchmark.domain
    rng = np.random.default_rng(seed)
    X = domain.sample(benchmark_config.get("num_train", 50), rng)
    y = benchmark.f(X)
    y_std = (y - y.mean()) / max(y.std(), 1e-6)

    keys = SamplerParams.__dataclass_fields__.keys()
    params = SamplerParams(**{k: v for k, v in model_config.get("model_params", {}).items()
                              if k in keys})
    c = params.num_chains
    model = BARKModel(
        create_empty_forest(params.num_trees, params.node_limit, (c,), dev),
        torch.full((c,), 0.1, dtype=torch.float32, device=dev),
        torch.ones((c,), dtype=torch.float32, device=dev),
    )
    samples, mlls = run_bark_sampler_with_trace(
        torch.Generator(device=dev).manual_seed(seed), model,
        torch.as_tensor(X, device=dev), torch.as_tensor(y_std, dtype=torch.float32, device=dev),
        torch.as_tensor(domain.bounds("bitmask"), device=dev),
        torch.as_tensor(domain.feature_types(), device=dev), params,
    )
    mlls = mlls.cpu().numpy()
    summary = mll_trace_summary(mlls)
    logger.info("MLL trace summary: %s", summary)

    output = pathlib.Path(output)
    output.mkdir(parents=True, exist_ok=True)
    np.save(output / "mlls.npy", mlls)
    np.save(output / "noise_samples.npy", samples.noise.cpu().numpy())
    logger.info("Saved traces to %s", output)
    return summary


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-s", "--seed", type=int, default=0)
    parser.add_argument("-c", "--benchmark-config", default="mcmc_benchmark")
    parser.add_argument("-m", "--model-config", default="mcmc_model")
    parser.add_argument("-o", "--output", type=pathlib.Path, default=OUT_DIR)
    parser.add_argument("--device", default=None, help="cpu, or the CUDA device if left out")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    return run_record(args.seed, load_config(args.benchmark_config),
                      load_config(args.model_config), args.output, args.device)


if __name__ == "__main__":
    main()
