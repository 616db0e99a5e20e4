"""The multi-fidelity BO study on CurrinExp2D.

The port's twin of ``run_study`` in ``examples/mf_bo.py``, with the same
protocol and records:

  1. fit a LeafMOGP (booster forest, fitted index-kernel and noise
     hyperparameters) on every (x, fidelity, y) observed so far;
  2. take the next x by the target-fidelity LCB (kappa 1.96) over a Sobol
     batch of candidates;
  3. take its fidelity by information gain per unit cost, with f* drawn
     from the target-fidelity joint posterior at the training sites;
  4. evaluate the benchmark there, pay the fidelity's cost, and repeat.

Each record holds the iteration, the fidelity, y, the cumulative cost and
the best target-fidelity value so far (the currency MF-BO optimizes).
"""

from __future__ import annotations

import numpy as np

from bark_tpu_torch.benchmarks import map_benchmark
from bark_tpu_torch.models.mogp import LeafMOGPSurrogate
from bark_tpu_torch.models.sampling import fstar_samples_mogp
from bark_tpu_torch.optimizer.fidelity import propose_fidelity_information_based


def run_study(seed: int, num_iter: int, num_init: int = 6, num_candidates: int = 256,
              kappa: float = 1.96, num_fstar: int = 16, surrogate_kwargs: dict | None = None,
              device=None) -> list[dict]:
    """``num_iter`` iterations from ``num_init`` points at alternating
    fidelities; returns one record per iteration. ``device=None`` means
    the CUDA device (an error without one)."""
    bench = map_benchmark("CurrinExp2D")
    costs = bench.fidelity_costs
    rng = np.random.default_rng(seed)

    X = bench.domain.sample(num_init, rng)
    fid = np.arange(num_init) % bench.num_fidelities
    y = bench.f_fidelity(X, fid)
    cum_cost = float(sum(costs[m] for m in fid))
    records = []

    def best_target():
        at_target = y[fid == 0]
        return float(at_target.min()) if at_target.size else float("nan")

    for it in range(num_iter):
        mogp = LeafMOGPSurrogate(
            bench.domain, num_tasks=bench.num_fidelities, seed=seed, device=device,
            **(surrogate_kwargs or {}),
        )
        mogp.fit(X, fid, y)

        cands = bench.domain.sample_sobol(num_candidates, seed=seed * 1000 + it)
        mu, sd = mogp.predict(cands, np.zeros(len(cands), np.int64))
        x_next = cands[int(np.argmin(mu - kappa * sd))][None, :]

        f_star = fstar_samples_mogp(mogp, X, num_fstar, rng)
        m_next = propose_fidelity_information_based(mogp, x_next, costs, f_star)

        y_next = bench.f_fidelity(x_next, [m_next])
        X = np.vstack([X, x_next])
        fid = np.concatenate([fid, [m_next]])
        y = np.concatenate([y, y_next])
        cum_cost += costs[m_next]
        records.append({
            "iter": it, "fidelity": int(m_next), "y": float(y_next[0]),
            "cum_cost": cum_cost, "best_target": best_target(),
        })
    return records
