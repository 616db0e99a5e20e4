"""Statistical parity of the port's sampler at stationarity, on the card.

    python -m bark_tpu_torch.benchmarks.stationary [--arms leaf@512,dense@200,chol@200,chol@512]
        [--out-dir results/port] [--chains 16] [--warmup 12000] [--samples 150] [--thin 8]

The protocol of the reference's ``tools/selfparity_stationary.py``, with its
numbers: TreeFunction(dim=5, m=50, seed=1) with observation noise at a 0.1
share of the variance, standardised, from ``numpy.random.default_rng(0)``;
16 chains from empty forests with over-dispersed noise inits (1.0 and 0.01
in turn); 12,000 warmup steps in calls of at most 250 steps, each
warm-started from the last sample; 150 samples thinned by 8 through
``run_bark_sampler_with_trace``; split R-hat and ESS of the noise and MLL
traces before any comparison; chain means as the independent units.

An arm is a lowering at an N, ``<tier>@<N>``: ``leaf`` (the shipped leaf
tier, pinned, which is what ``auto`` resolves to at N >= 256), ``dense``
(the shipped dense tier, pinned) or ``chol`` (the drift-free oracle,
``kernel_backend="chol"``). Every arm runs in a process of its own, all
started together (each is bound by the host's launch rate, so they share
the card well), and writes ``stationary_<tier>_n<N>.json`` to the output
directory when it ends. The parent then compares what is there and writes
``stationary.json``:

  - an arm converged if its R-hat(noise) <= 1.1 (the reference's arms
    reached 1.04-1.065);
  - at every N, the arms against the chol arm at that N, on the chain means
    of the noise, the leaves per tree and the leaf depth mean, with
    z = |a - b| / sqrt(se_a^2 + se_b^2) and the reference tool's gate
    z < 3 on the noise mean;
  - at N=512, each arm against the reference's recorded TPU numbers
    (``results/ab_r5/leaf_selfparity_stationary.json``): the noise mean
    against its chol oracle (0.100014, se 0.000465), the leaves per tree
    and leaf depth mean against its leaf and dense arms.

Needs a CUDA device unless ``--device cpu`` is given (the tests run a toy
size that way). Not part of the tests' default sizes or of
``chip_smoke.py``: the four arms take about half an hour of the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
REFERENCE = REPO / "results" / "ab_r5" / "leaf_selfparity_stationary.json"
N = 512
M = 50
NOISE_FRAC = 0.10  # noise share of the variance before standardising
GATE_Z = 3.0
GATE_RHAT = 1.1
TIERS = {
    "leaf": {"scan_style": "coeff", "refresh_style": "leaf"},
    "dense": {"scan_style": "plain", "refresh_style": "onesolve"},
    "chol": {"kernel_backend": "chol"},
}
METRICS = ("noise_mean", "leaves_per_tree", "leaf_depth_mean")


def make_data(n: int = N, seed: int = 0):
    """(X, y, bounds, feat_types) as numpy arrays, the reference tool's
    ``make_data`` at n rows: the same generator calls in the same order."""
    from bark_tpu_torch.benchmarks.tree_function import TreeFunction

    bench = TreeFunction(dim=5, cat_dim=0, num_cat=5, m=M, function_seed=1)
    rng = np.random.default_rng(seed)
    X = bench.domain.sample(n, rng)
    f = bench.f(X)
    sigma = np.sqrt(bench.f(X).var() * NOISE_FRAC / (1 - NOISE_FRAC))
    y = f + rng.normal(0.0, sigma, f.shape)
    y = (y - y.mean()) / y.std()
    return (
        X, y.astype(np.float32), bench.domain.bounds("bitmask"), bench.domain.feature_types(),
    )


def parse_arm(arm: str) -> tuple[str, int]:
    tier, n = arm.split("@")
    if tier not in TIERS:
        raise ValueError(f"unknown tier {tier!r} in arm {arm!r}; tiers: {sorted(TIERS)}")
    return tier, int(n)


def arm_file(out_dir: Path, arm: str) -> Path:
    tier, n = parse_arm(arm)
    return out_dir / f"stationary_{tier}_n{n}.json"


def run_arm(torch, dev, arm: str, seed: int, chains: int, warmup: int, samples: int,
            thin: int, chunk: int) -> dict:
    """Warm up and sample one arm; per-chain statistics and diagnostics."""
    from bark_tpu_torch.fitting.params import SamplerParams
    from bark_tpu_torch.fitting.sampler import (
        BARKModel, run_bark_sampler, run_bark_sampler_with_trace,
    )
    from bark_tpu_torch.forest import Forest, create_empty_forest
    from bark_tpu_torch.utils.diagnostics import effective_sample_size, gelman_rubin

    tier, n = parse_arm(arm)
    X, y, bounds, ft = (torch.as_tensor(a, device=dev) for a in make_data(n))
    base = SamplerParams(num_chains=chains, num_trees=M, **TIERS[tier])
    noise0 = torch.where(torch.arange(chains, device=dev) % 2 == 0, 1.0, 0.01)
    model = BARKModel(create_empty_forest(M, base.node_limit, (chains,), dev), noise0,
                      torch.ones(chains, device=dev))
    gen = torch.Generator(device=dev).manual_seed(seed)

    def last(out):
        return BARKModel(Forest(*(f[:, -1] for f in out.forest)), out.noise[:, -1],
                         out.scale[:, -1])

    t0 = time.perf_counter()
    trace = []
    done = 0
    while done < warmup:
        steps = min(chunk, warmup - done)
        p = base.with_(warmup_steps=0, num_samples=1, steps_per_sample=steps)
        model = last(run_bark_sampler(gen, model, X, y, bounds, ft, p))
        done += steps
        if done % 1000 < steps or done == warmup:
            noise = model.noise.mean().item()
            trace.append([done, noise])
            print(f"[{arm}] warmup {done}/{warmup} noise={noise:.4f} "
                  f"({time.perf_counter() - t0:.0f} s)", flush=True)
    outs, mlls = [], []
    got = 0
    while got < samples:
        s_n = min(max(chunk // thin, 1), samples - got)
        p = base.with_(warmup_steps=0, num_samples=s_n, steps_per_sample=thin)
        out, mll = run_bark_sampler_with_trace(gen, model, X, y, bounds, ft, p)
        model = last(out)
        outs.append(out)
        mlls.append(mll)
        got += s_n
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"[{arm}] {warmup} + {samples} x {thin} steps in {wall:.1f} s", flush=True)

    def cat(get):
        return torch.cat([get(o) for o in outs], 1).cpu().numpy()

    noise = cat(lambda o: o.noise).astype(np.float64)
    mll = torch.cat(mlls, 1).cpu().numpy().astype(np.float64)
    tmask = cat(lambda o: o.forest.is_leaf & o.forest.active)
    depth = cat(lambda o: o.forest.depth)
    depth_mean = (depth * tmask).sum((-2, -1)) / tmask.sum((-2, -1))
    return {
        "arm": arm, "tier": tier, "n": n, "seed": seed, "params": TIERS[tier],
        "per_chain": {
            "noise_mean": noise.mean(1).tolist(),
            "leaves_per_tree": tmask.sum(-1).mean(-1).mean(1).tolist(),
            "leaf_depth_mean": depth_mean.mean(1).tolist(),
        },
        "convergence": {
            "r_hat_noise": gelman_rubin(noise), "ess_noise": effective_sample_size(noise),
            "r_hat_mll": gelman_rubin(mll), "ess_mll": effective_sample_size(mll),
            "wall_s": wall, "ms_per_step": 1e3 * wall / (warmup + samples * thin),
            "noise_posterior_mean": float(noise.mean()),
            "converged": bool(gelman_rubin(noise) <= GATE_RHAT),
        },
        "warmup_noise_trace": trace,
    }


def mean_se(values) -> tuple[float, float]:
    v = np.asarray(values, np.float64)
    return float(v.mean()), float(v.std(ddof=1) / np.sqrt(len(v)))


def z_row(metric: str, name_a: str, a: tuple[float, float], name_b: str,
          b: tuple[float, float], gate: bool) -> dict:
    z = abs(a[0] - b[0]) / np.sqrt(a[1] ** 2 + b[1] ** 2 + 1e-300)
    return {"metric": metric, "a": name_a, "a_mean": a[0], "a_se": a[1],
            "b": name_b, "b_mean": b[0], "b_se": b[1], "z": float(z),
            "pass": bool(z < GATE_Z) if gate else None}


def compare(results: dict) -> list[dict]:
    """z rows: each arm against the chol arm at its N, and at N=512 against
    the reference's recorded numbers."""
    rows = []
    for arm, res in results.items():
        tier, n = parse_arm(arm)
        chol = results.get(f"chol@{n}")
        if tier != "chol" and chol is not None:
            for metric in METRICS:
                rows.append(z_row(metric, arm, mean_se(res["per_chain"][metric]), f"chol@{n}",
                                  mean_se(chol["per_chain"][metric]),
                                  gate=metric == "noise_mean"))
        if n != N:
            continue
        ref = json.loads(REFERENCE.read_text())["post_fix"]
        oracle = ref["leaf_vs_chol_oracle_noise_mean"]
        rows.append(z_row("noise_mean", arm, mean_se(res["per_chain"]["noise_mean"]),
                          "reference chol (TPU)", (oracle["chol"], oracle["chol_se"]), gate=True))
        for row in ref["rows_leaf_vs_dense"]:
            if row["metric"] == "noise_mean":
                continue
            for which in ("leaf", "dense"):
                rows.append(z_row(row["metric"], arm, mean_se(res["per_chain"][row["metric"]]),
                                  f"reference {which} (TPU)",
                                  (row[which], row[f"{which}_se"]), gate=False))
    return rows


def worker(args) -> int:
    import torch

    dev = torch.device(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)  # the arms run side by side
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    res = run_arm(torch, dev, args.worker, args.seed, args.chains, args.warmup, args.samples,
                  args.thin, args.chunk)
    res["config"] = {k: getattr(args, k) for k in ("chains", "warmup", "samples", "thin",
                                                   "chunk")}
    res["device"] = args.device_name
    path = arm_file(args.out_dir, args.worker)
    path.write_text(json.dumps(res, indent=1))
    print(f"[{args.worker}] {json.dumps(res['convergence'])} -> {path}", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arms", default="leaf@512,dense@200,chol@200,chol@512")
    ap.add_argument("--out-dir", type=Path, default=REPO / "results" / "port")
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--warmup", type=int, default=12000)
    ap.add_argument("--samples", type=int, default=150)
    ap.add_argument("--thin", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=250)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--seed", type=int, default=100, help=argparse.SUPPRESS)
    ap.add_argument("--device-name", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("stationary: needs a CUDA device (or --device cpu)", file=sys.stderr)
        return 1
    if args.device == "cuda":
        device_name = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    else:
        device_name = "cpu"
    print(device_name, flush=True)
    arms = args.arms.split(",")
    for arm in arms:
        parse_arm(arm)
    args.out_dir.mkdir(parents=True, exist_ok=True)
    common = ["--out-dir", str(args.out_dir), "--device", args.device,
              "--device-name", device_name]
    for k in ("chains", "warmup", "samples", "thin", "chunk"):
        common += [f"--{k}", str(getattr(args, k))]
    procs = []
    try:
        for i, arm in enumerate(arms):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "bark_tpu_torch.benchmarks.stationary",
                 "--worker", arm, "--seed", str(100 + i), *common], cwd=REPO))
        codes = [p.wait() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = {}
    for arm in arms:
        path = arm_file(args.out_dir, arm)
        if path.exists():
            results[arm] = json.loads(path.read_text())
    rows = compare(results)
    payload = {
        "protocol": "tools/selfparity_stationary.py: TreeFunction(dim=5, m=50, seed=1) + "
                    f"observation noise at a {NOISE_FRAC} variance share, standardised; "
                    "over-dispersed noise inits 1.0 / 0.01; chain means as units",
        "config": {"arms": arms, "chains": args.chains, "warmup": args.warmup,
                   "samples": args.samples, "thin": args.thin, "chunk": args.chunk},
        "device": device_name,
        "exit_codes": dict(zip(arms, codes)),
        "convergence": {arm: res["convergence"] for arm, res in results.items()},
        "gate": f"every arm R-hat(noise) <= {GATE_RHAT}; z < {GATE_Z} on the noise mean "
                "against a chol oracle",
        "rows": rows,
    }
    out = args.out_dir / "stationary.json"
    out.write_text(json.dumps(payload, indent=1))
    for row in rows:
        print(json.dumps(row), flush=True)
    print(f"wrote {out}", flush=True)
    return 0 if all(c == 0 for c in codes) else 1


if __name__ == "__main__":
    sys.exit(main())
