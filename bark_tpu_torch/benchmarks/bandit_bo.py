"""Discrete-candidate bandit BO over the MAX-phase materials table.

The port's twin of ``examples/bandit_bo.py``: ``num_init`` random rows of
``MAXBandit``'s candidate table observed, then ``num_iter`` rounds of a UCB
bandit: fit a BARK surrogate (1 chain, warmup 50, 5 samples x 10 steps, 50
trees) on the observed rows, predict every remaining row (the dense
posterior) and observe the one of the lowest LCB (kappa 1.96). One CSV row
per round: iteration, picked row, its y, the best y so far and the regret
against the table's minimum.

    python -m bark_tpu_torch.benchmarks.bandit_bo -s 0 [-n 20] [-o DIR] [--device cpu]

Writes ``bandit_seed=<s>.csv`` under ``results/port/bandit_bo/`` unless
``-o`` says otherwise.
"""

from __future__ import annotations

import argparse
import csv
import logging
import pathlib

import numpy as np

from bark_tpu_torch.benchmarks import map_benchmark
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.models.surrogate import BARKSurrogate

logger = logging.getLogger(__name__)

OUT_DIR = pathlib.Path(__file__).resolve().parents[2] / "results" / "port" / "bandit_bo"


def run_bandit(seed: int, num_iter: int, output, num_init: int = 10, kappa: float = 1.96,
               device=None) -> list[dict]:
    """Run the bandit, write ``bandit_seed=<seed>.csv`` under ``output`` and
    return its rows. ``device=None`` means the CUDA device."""
    bench = map_benchmark("MAXBandit")
    candidates = bench.candidates.astype(np.float32)
    targets = bench.targets
    n = len(candidates)

    rng = np.random.default_rng(seed)
    observed = list(rng.choice(n, size=num_init, replace=False))
    params = SamplerParams(warmup_steps=50, num_samples=5, steps_per_sample=10, num_chains=1,
                           num_trees=50)
    surrogate = BARKSurrogate(bench.domain, params, seed=seed, device=device)

    rows = []
    for itr in range(num_iter):
        surrogate.fit(candidates[observed], targets[observed])
        remaining = np.setdiff1d(np.arange(n), observed)
        mu, std = surrogate.predict(candidates[remaining])
        pick = remaining[int(np.argmin(mu[:, 0] - kappa * std[:, 0]))]
        observed.append(int(pick))
        best = targets[observed].min()
        regret = best - targets.min()
        logger.info("iter %d: picked #%d y=%.3f best=%.3f regret=%.3f", itr, pick,
                    targets[pick], best, regret)
        rows.append({"iteration": itr, "picked": int(pick), "y": float(targets[pick]),
                     "best": float(best), "regret": float(regret)})

    output = pathlib.Path(output)
    output.mkdir(parents=True, exist_ok=True)
    with open(output / f"bandit_seed={seed}.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return rows


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-s", "--seed", type=int, default=0)
    parser.add_argument("-n", "--num-iter", type=int, default=20)
    parser.add_argument("-o", "--output", type=pathlib.Path, default=OUT_DIR)
    parser.add_argument("--device", default=None, help="cpu, or the CUDA device if left out")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    return run_bandit(args.seed, args.num_iter, args.output, device=args.device)


if __name__ == "__main__":
    main()
