"""The large-N BO study: the whole tell -> fit -> ask loop at N = 4080.

The port's twin of ``examples/bo_largen.py``, with its protocol and its
JSON: TreeFunction(dim=5, m=50, seed=1), ``n_init`` random points, then
``num_iter`` ask / evaluate / add iterations of ``make_strategy("BARK")``
with 4 chains x 4 samples (warmup 50, 10 steps a sample, 50 trees) and
``num_candidates`` x 3 rounds of search. Past padded N = 2048,
``acq_backend="auto"`` takes the factored acquisition and the surrogate's
``predict`` the leaf-space posterior, and the sampler's leaf refresh
factors through ``blocked_cholesky``. Each phase's seconds end with a device
synchronisation (:class:`~bark_tpu_torch.utils.timer.Timer`). The incumbent's
yardstick is the minimum of 200,000 random points, evaluated on the host.

    python -m bark_tpu_torch.benchmarks.bo_largen [--seed 0] [--n-init 4080] \
        [--num-iter 6] [--fit-style chains|tempered] [--out PATH] [--device cpu]

Writes ``results/port/bo_largen/study_n<n_init>_seed<seed>.json`` unless
``--out`` says otherwise. Without ``--device`` it runs on the CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

from bark_tpu_torch.benchmarks.tree_function import TreeFunction
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.models.surrogate import BARKSurrogate
from bark_tpu_torch.strategies.tree_kernel import make_strategy
from bark_tpu_torch.utils.timer import Timer

OUT_DIR = pathlib.Path(__file__).resolve().parents[2] / "results" / "port" / "bo_largen"
PROBE_POINTS = 200_000


def build(seed: int, num_candidates: int, num_chains: int, num_samples: int,
          acq_backend: str, fit_style: str, device=None):
    """The benchmark and the strategy of the study."""
    bench = TreeFunction(dim=5, m=50, function_seed=1)
    params = SamplerParams(warmup_steps=50, num_samples=num_samples, steps_per_sample=10,
                           num_chains=num_chains, num_trees=50)
    surrogate = BARKSurrogate(bench.domain, params, seed=seed, fit_style=fit_style,
                              device=device)
    strat = make_strategy("BARK", bench.domain, seed=seed, surrogate=surrogate,
                          num_candidates=num_candidates, num_rounds=3,
                          acq_backend=acq_backend)
    return bench, strat


def run_study(seed: int = 0, n_init: int = 4080, num_iter: int = 6,
              num_candidates: int = 4096, num_chains: int = 4, num_samples: int = 4,
              acq_backend: str = "auto", fit_style: str = "chains", device=None) -> dict:
    """One study; returns the reference's payload (config, probe minimum,
    initial fit seconds, one record per iteration). ``device=None`` means
    the CUDA device (an error without one)."""
    bench, strat = build(seed, num_candidates, num_chains, num_samples, acq_backend,
                         fit_style, device)
    probe = bench.domain.sample(PROBE_POINTS, np.random.default_rng(7))
    f_star_est = float(bench.f(probe).min())

    X = bench.domain.sample(n_init, np.random.default_rng(seed))
    y = bench.f(X)
    timer = Timer()
    with timer("fit"):
        strat.tell(X, y)  # the initial fit, warmup included
    fit0_s = timer["fit"]
    records = []
    for it in range(num_iter):
        timer = Timer()
        with timer("ask"):
            cand = strat.ask(1)
        y_new = bench.f(cand)
        with timer("fit"):
            strat.add(cand, y_new)  # warm-started refit on the grown set
        rec = {
            "iter": it,
            "n_train": int(len(strat.y)),
            # the proposed point: the objective is piecewise constant, so
            # distinct proposals can share y
            "candidate": [round(float(v), 6) for v in np.asarray(cand)[0]],
            "ask_s": round(timer["ask"], 3),
            "fit_s": round(timer["fit"], 3),
            "y_new": float(np.asarray(y_new).reshape(-1)[0]),
            "best_y": float(strat.y.min()),
            "best_minus_probe_min": float(strat.y.min() - f_star_est),
            # how far from stationarity the fit the ask consumed was
            "fit_diagnostics": strat.surrogate.fit_diagnostics,
        }
        records.append(rec)
        print(json.dumps(rec), flush=True)

    return {
        "config": {
            "benchmark": "TreeFunction(dim=5, m=50, seed=1)",
            "seed": seed,
            "n_init": n_init,
            "num_iter": num_iter,
            "num_candidates": num_candidates,
            "sampler": {"num_chains": num_chains, "num_samples": num_samples,
                        "steps_per_sample": 10, "warmup_steps": 50, "num_trees": 50},
            "acq_backend": acq_backend,
            "fit_style": fit_style,
        },
        "f_star_probe_200k": f_star_est,
        "initial_fit_s": round(fit0_s, 3),
        "iterations": records,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-init", type=int, default=4080)
    ap.add_argument("--num-iter", type=int, default=6)
    ap.add_argument("--num-candidates", type=int, default=4096)
    ap.add_argument("--fit-style", default="chains", choices=("chains", "tempered"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="cpu, or the CUDA device if left out")
    args = ap.parse_args(argv)
    result = run_study(seed=args.seed, n_init=args.n_init, num_iter=args.num_iter,
                       num_candidates=args.num_candidates, fit_style=args.fit_style,
                       device=args.device)
    out = pathlib.Path(args.out) if args.out else (
        OUT_DIR / f"study_n{args.n_init}_seed{args.seed}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(f"wrote {out}", flush=True)
    return result


if __name__ == "__main__":
    main()
