"""Posterior-budget ablation: held-out NLPD over a chains x samples grid.

The port's twin of ``examples/regression_samples_ablation.py``: for each of
``num_runs`` train / test draws of the benchmark, a BARK surrogate fit for
every (number of chains, number of retained samples) and its held-out NLPD;
the (len(chains), len(samples)) grid of the NLPD averaged over the runs is
saved as ``nlpd_ablation_<benchmark>_seed=<s>.npy``.

    python -m bark_tpu_torch.benchmarks.samples_ablation -s 0 \
        [-c regression_treefunction] [--chains 1 2 4] [--samples 2 5 10] \
        [--num-runs 5] [-o DIR] [--device cpu]

``-c`` takes a name of ``study.EXAMPLE_CONFIGS`` or a YAML file. Writes
under ``results/port/samples_ablation/`` unless ``-o`` says otherwise.
"""

from __future__ import annotations

import argparse
import logging
import pathlib

import numpy as np

from bark_tpu_torch.benchmarks import map_benchmark
from bark_tpu_torch.benchmarks.study import load_config
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.models.surrogate import BARKSurrogate
from bark_tpu_torch.utils.metrics import nlpd

logger = logging.getLogger(__name__)

OUT_DIR = pathlib.Path(__file__).resolve().parents[2] / "results" / "port" / "samples_ablation"


def run_ablation(seed: int, benchmark_config: dict, output, chain_grid, sample_grid,
                 num_runs: int, device=None) -> np.ndarray:
    """Fill the NLPD grid, save it under ``output`` and return it.
    ``device=None`` means the CUDA device."""
    benchmark = map_benchmark(benchmark_config["benchmark"],
                              **benchmark_config.get("benchmark_params", {}))
    domain = benchmark.domain
    num_train = benchmark_config.get("num_train", 50)
    num_test = benchmark_config.get("num_test", 200)

    grid = np.zeros((len(chain_grid), len(sample_grid)))
    rng = np.random.default_rng(seed)
    for run in range(num_runs):
        Xtr = domain.sample(num_train, rng)
        ytr = benchmark.f(Xtr)
        Xte = domain.sample(num_test, rng)
        yte = benchmark.f(Xte)
        for i, num_chains in enumerate(chain_grid):
            for j, num_samples in enumerate(sample_grid):
                params = SamplerParams(num_chains=num_chains, num_samples=num_samples)
                surrogate = BARKSurrogate(domain, params, seed=seed + run, device=device)
                surrogate.fit(Xtr, ytr)
                mu, std = surrogate.predict(Xte)
                val = nlpd(yte, mu, std**2)
                grid[i, j] += val / num_runs
                logger.info("run %d chains=%d samples=%d nlpd=%.4f", run, num_chains,
                            num_samples, val)

    output = pathlib.Path(output)
    output.mkdir(parents=True, exist_ok=True)
    np.save(output / f"nlpd_ablation_{benchmark_config['benchmark']}_seed={seed}.npy", grid)
    logger.info("grid (chains x samples):\n%s", np.array_str(grid, precision=3))
    return grid


def main(argv=None) -> np.ndarray:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-s", "--seed", type=int, default=0)
    parser.add_argument("-c", "--benchmark-config", default="regression_treefunction")
    parser.add_argument("-o", "--output", type=pathlib.Path, default=OUT_DIR)
    parser.add_argument("--chains", type=int, nargs="+", default=[1, 2, 4])
    parser.add_argument("--samples", type=int, nargs="+", default=[2, 5, 10])
    parser.add_argument("--num-runs", type=int, default=5)
    parser.add_argument("--device", default=None, help="cpu, or the CUDA device if left out")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    return run_ablation(args.seed, load_config(args.benchmark_config), args.output,
                        args.chains, args.samples, args.num_runs, args.device)


if __name__ == "__main__":
    main()
