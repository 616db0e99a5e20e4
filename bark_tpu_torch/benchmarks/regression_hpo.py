"""Prior-hyperparameter grid search: held-out NLPD over an alpha x beta grid.

The port's twin of ``examples/regression_hpo.py``: one train / test draw of
the benchmark (``num_train`` / ``num_test`` points), then for every
(alpha, beta) of the depth prior p(split at depth d) = alpha (1 + d)^-beta
a BARK surrogate fit and its held-out NLPD. The (len(alphas), len(betas))
grid is saved as ``nlpd_hpo_<benchmark>_seed=<s>.npy``.

    python -m bark_tpu_torch.benchmarks.regression_hpo -s 0 \
        [-c regression_treefunction] [--alpha 0.45 0.65 0.85 0.95] \
        [--beta 0.5 1.0 2.0] [-o DIR] [--device cpu]

``-c`` takes a name of ``study.EXAMPLE_CONFIGS`` or a YAML file. Writes
under ``results/port/regression_hpo/`` unless ``-o`` says otherwise.
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

OUT_DIR = pathlib.Path(__file__).resolve().parents[2] / "results" / "port" / "regression_hpo"


def run_hpo(seed: int, benchmark_config: dict, alphas, betas, output, model_params=None,
            device=None) -> np.ndarray:
    """Fill the NLPD grid, save it under ``output`` and return it.
    ``model_params`` are further ``SamplerParams`` fields; ``device=None``
    means the CUDA device."""
    benchmark = map_benchmark(benchmark_config["benchmark"],
                              **benchmark_config.get("benchmark_params", {}))
    domain = benchmark.domain
    rng = np.random.default_rng(seed)
    Xtr = domain.sample(benchmark_config.get("num_train", 50), rng)
    ytr = benchmark.f(Xtr)
    Xte = domain.sample(benchmark_config.get("num_test", 200), rng)
    yte = benchmark.f(Xte)

    keys = SamplerParams.__dataclass_fields__.keys()
    fixed = {k: v for k, v in (model_params or {}).items() if k in keys}
    grid = np.zeros((len(alphas), len(betas)))
    for i, alpha in enumerate(alphas):
        for j, beta in enumerate(betas):
            params = SamplerParams(**fixed | {"alpha": float(alpha), "beta": float(beta)})
            surrogate = BARKSurrogate(domain, params, seed=seed, device=device)
            surrogate.fit(Xtr, ytr)
            mu, std = surrogate.predict(Xte)
            grid[i, j] = nlpd(yte, mu, std**2)
            logger.info("alpha=%.3g beta=%.3g nlpd=%.4f", alpha, beta, grid[i, j])

    output = pathlib.Path(output)
    output.mkdir(parents=True, exist_ok=True)
    path = output / f"nlpd_hpo_{benchmark_config['benchmark']}_seed={seed}.npy"
    np.save(path, grid)
    logger.info("grid saved: %s", path)
    return grid


def main(argv=None) -> np.ndarray:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-s", "--seed", type=int, default=0)
    parser.add_argument("-c", "--benchmark-config", default="regression_treefunction")
    parser.add_argument("-o", "--output", type=pathlib.Path, default=OUT_DIR)
    parser.add_argument("--alpha", type=float, nargs="+", default=[0.45, 0.65, 0.85, 0.95])
    parser.add_argument("--beta", type=float, nargs="+", default=[0.5, 1.0, 2.0])
    parser.add_argument("--device", default=None, help="cpu, or the CUDA device if left out")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    return run_hpo(args.seed, load_config(args.benchmark_config), args.alpha, args.beta,
                   args.output, device=args.device)


if __name__ == "__main__":
    main()
