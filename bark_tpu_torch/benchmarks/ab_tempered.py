"""Tempered against plain chains on the metastable N=512 landscape, on the card.

    python3 bark_tpu_torch/benchmarks/ab_tempered.py [--rounds 2000] [--out FILE]

The configuration of the reference's ``tools/ab_tempered.py``: noiseless
TreeFunction(dim=5, m=50, seed=1), N=512 points, y standardised, m=50
trees, default ``SamplerParams`` (``auto`` takes the leaf tier, budget
R=256), every chain from an empty forest at noise 0.1. Two arms of equal
step work, 32 step computations a round:

  - plain: 32 independent chains (``run_bark_sampler_with_trace``, in
    chunks of 250 rounds, each warm-started from the last sample);
  - tempered: 4 ladders x 8 replicas (``run_parallel_tempering``, one call,
    the geometric ladder down to beta = 0.05), cold-chain traces.

Metrics, as the reference's: wall time of each arm; the first round at
which each chain's (cold) MLL passes a target, with the target the pooled
median of the final MLLs less 50, and the share of chains that pass it;
the same share at the reference's recorded target (798.85); split R-hat
and ESS of the second half of the noise trace; the tempered arm's swap
rate. Prints one JSON object and writes it to ``--out``. Needs a CUDA
device; it is not part of the tests or of ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N = 512
M = 50
PLAIN_CHAINS = 32
LADDERS = 4
REPLICAS = 8
BETA_MIN = 0.05
REFERENCE_TARGET = 798.854248046875  # results/ab_r5/tempered_n512.json


def make_data(torch, device, n: int = N, seed: int = 0):
    """(X, y, bounds, feat_types) of the noiseless TreeFunction landscape."""
    from bark_tpu_torch.benchmarks.tree_function import TreeFunction

    bench = TreeFunction(dim=5, cat_dim=0, num_cat=5, m=M, function_seed=1)
    X = bench.domain.sample(n, np.random.default_rng(seed))
    y = bench.f(X)
    y = (y - y.mean()) / y.std()
    return (
        torch.as_tensor(X, device=device),
        torch.as_tensor(y, dtype=torch.float32, device=device),
        torch.as_tensor(bench.domain.bounds("bitmask"), device=device),
        torch.as_tensor(bench.domain.feature_types(), device=device),
    )


def run_plain(torch, dev, rounds: int, chunk: int = 250):
    """(MLL trace (chains, rounds), noise trace, wall seconds)."""
    from bark_tpu_torch.fitting.params import SamplerParams
    from bark_tpu_torch.fitting.sampler import BARKModel, run_bark_sampler_with_trace
    from bark_tpu_torch.forest import Forest, create_empty_forest

    X, y, bounds, ft = make_data(torch, dev)
    params = SamplerParams(num_chains=PLAIN_CHAINS, num_trees=M)
    model = BARKModel(
        create_empty_forest(M, params.node_limit, (PLAIN_CHAINS,), dev),
        torch.full((PLAIN_CHAINS,), 0.1, device=dev),
        torch.ones(PLAIN_CHAINS, device=dev),
    )
    gen = torch.Generator(device=dev).manual_seed(0)
    mlls, noises = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = 0
    while done < rounds:
        n = min(chunk, rounds - done)
        p = params.with_(warmup_steps=0, num_samples=n, steps_per_sample=1)
        out, mll = run_bark_sampler_with_trace(gen, model, X, y, bounds, ft, p)
        model = BARKModel(Forest(*(f[:, -1] for f in out.forest)), out.noise[:, -1],
                          out.scale[:, -1])
        mlls.append(mll)
        noises.append(out.noise)
        done += n
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return torch.cat(mlls, 1).cpu().numpy(), torch.cat(noises, 1).cpu().numpy(), wall


def run_tempered(torch, dev, rounds: int):
    """(cold MLL trace (ladders, rounds), cold noise trace, wall seconds,
    mean swap rate)."""
    from bark_tpu_torch.fitting.params import SamplerParams
    from bark_tpu_torch.forest import create_empty_forest
    from bark_tpu_torch.parallel.tempering import run_parallel_tempering

    X, y, bounds, ft = make_data(torch, dev)
    params = SamplerParams(num_chains=LADDERS, num_trees=M)
    shape = (LADDERS, REPLICAS)
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = run_parallel_tempering(
        gen, create_empty_forest(M, params.node_limit, shape, dev),
        torch.full(shape, 0.1, device=dev), torch.ones(shape, device=dev), X, y, bounds, ft,
        params, num_replicas=REPLICAS, num_steps=rounds, beta_min=BETA_MIN,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (run.cold_mll.cpu().numpy(), run.samples.noise.cpu().numpy(), wall,
            float(run.swap_rate.mean()))


def summarise(mll_plain, noise_plain, wall_plain, mll_temp, noise_temp, wall_temp, swap,
              rounds: int) -> dict:
    from bark_tpu_torch.utils.diagnostics import effective_sample_size, gelman_rubin

    half = rounds // 2
    target = float(np.median(np.concatenate([mll_plain[:, -1], mll_temp[:, -1]]))) - 50.0

    def reached(mlls, level):
        hit = mlls >= level
        first = np.where(hit.any(1), hit.argmax(1), -1)
        return float((first >= 0).mean()), (
            float(np.median(first[first >= 0])) if (first >= 0).any() else -1.0)

    def arm(mlls, noise, wall):
        share, median_rounds = reached(mlls, target)
        x = np.asarray(noise, np.float64)[:, half:]
        return {
            "wall_s": wall,
            "r_hat_noise": float(gelman_rubin(x)),
            "ess_noise": float(effective_sample_size(x)),
            "noise_mean_2nd_half": float(x.mean()),
            "noise_sd_2nd_half": float(x.std()),
            "target_mll": target,
            "frac_chains_reached": share,
            "median_rounds_to_target": median_rounds,
            "frac_chains_reached_reference_target": reached(mlls, REFERENCE_TARGET)[0],
            "mll_mean_final": float(mlls[:, -1].mean()),
            "mll_best": float(mlls.max()),
        }

    return {
        "config": {
            "problem": f"noiseless TreeFunction(dim=5, m={M}, seed=1), N={N}, y standardised",
            "rounds": rounds, "plain_chains": PLAIN_CHAINS, "ladders": LADDERS,
            "replicas": REPLICAS, "beta_min": BETA_MIN,
            "equal_work": "32 step computations per round in both arms",
            "reference_target_mll": REFERENCE_TARGET,
        },
        "plain": arm(mll_plain, noise_plain, wall_plain),
        "tempered": {**arm(mll_temp, noise_temp, wall_temp), "swap_rate": swap},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2000)
    ap.add_argument("--out", type=Path, default=Path("results/ab_torch/tempered_n512.json"))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    if not torch.cuda.is_available():
        print("ab_tempered: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    mll_p, noise_p, wall_p = run_plain(torch, dev, args.rounds)
    print(f"[ab] plain: {args.rounds} rounds x {PLAIN_CHAINS} chains in {wall_p:.1f} s",
          flush=True)
    mll_t, noise_t, wall_t, swap = run_tempered(torch, dev, args.rounds)
    print(f"[ab] tempered: {args.rounds} rounds x {LADDERS} x {REPLICAS} in {wall_t:.1f} s, "
          f"swap rate {swap:.4f}", flush=True)
    payload = summarise(mll_p, noise_p, wall_p, mll_t, noise_t, wall_t, swap, args.rounds)
    payload["device"] = smi
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(payload, indent=1))
    print(json.dumps(payload), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
