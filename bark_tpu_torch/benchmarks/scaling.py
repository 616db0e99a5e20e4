"""Chain-scaling report over ranks of a process group.

The port's twin of ``examples/scaling_report.py``, with the keys of its
JSON (``SCALING_r05.json``). Two measurements of the sharded sampler
(``parallel/sharding.sharded_run_sampler``, TreeFunction(dim=5, m=50,
seed=1), ``n_train`` points, 50 trees, ``num_steps`` steps after an untimed
run of the same length), each rank count started by ``graft_entry.launch``:

  1. weak scaling: ``chains_per_rank`` chains on every rank, full steps x
     chains per second over all ranks, and the ratio to one rank's rate;
  2. sharding overhead: ``total_chains`` split over the ranks, against the
     same chains on one rank.

A rate is chains x steps over the slowest rank's synchronised wall time.
With one card, two or more ranks share it (through Gloo, since NCCL
refuses two ranks on one GPU), as they share the host's cores on the CPU:
the payload is then labelled a dry run (``"dry_run": true``), and its
ratios measure contention on one device, not scaling across chips.

    python -m bark_tpu_torch.benchmarks.scaling [--ranks 1 2] \
        [--chains-per-rank 8] [--total-chains 16] [--num-steps 20] \
        [--n-train 50] [--note TEXT] [--out PATH] [--device cpu]

Writes ``results/port/scaling/scaling.json`` unless ``--out`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import time

import numpy as np
import torch

from bark_tpu_torch.models.surrogate import resolve_device

OUT = (pathlib.Path(__file__).resolve().parents[2] / "results" / "port" / "scaling"
       / "scaling.json")


def _data(n_train: int, device):
    from bark_tpu_torch.benchmarks.tree_function import TreeFunction

    bench = TreeFunction(dim=5, m=50, function_seed=1)
    X = bench.domain.sample(n_train, np.random.default_rng(0))
    y = bench.f(X)
    y = (y - y.mean()) / y.std()
    return (torch.as_tensor(X, device=device),
            torch.as_tensor(y, dtype=torch.float32, device=device),
            torch.as_tensor(bench.domain.bounds("bitmask"), device=device),
            torch.as_tensor(bench.domain.feature_types(), device=device))


def _rate(mesh, device, num_chains: int, num_steps: int, data) -> float:
    """chain-steps/s of ``num_chains`` chains split over the mesh's ranks:
    an untimed run, then a timed one; the slowest rank's time."""
    from bark_tpu_torch.fitting.params import SamplerParams
    from bark_tpu_torch.fitting.sampler import BARKModel
    from bark_tpu_torch.forest import create_empty_forest
    from bark_tpu_torch.parallel.distributed import all_reduce
    from bark_tpu_torch.parallel.sharding import shard_model, sharded_run_sampler

    X, y, bounds, ft = data
    params = SamplerParams(warmup_steps=0, num_samples=num_steps, steps_per_sample=1,
                           num_trees=50)
    model = shard_model(BARKModel(
        create_empty_forest(params.num_trees, params.node_limit, (num_chains,), device),
        torch.full((num_chains,), 0.1, dtype=torch.float32, device=device),
        torch.ones(num_chains, dtype=torch.float32, device=device),
    ), mesh)
    sharded_run_sampler(0, model, X, y, bounds, ft, params, mesh)
    all_reduce(torch.zeros(1, device=device), mesh)  # line the ranks up
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    sharded_run_sampler(1, model, X, y, bounds, ft, params, mesh)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = torch.tensor([time.perf_counter() - t0], dtype=torch.float64, device=device)
    slowest = float(all_reduce(elapsed, mesh, op=torch.distributed.ReduceOp.MAX))
    return num_chains * num_steps / slowest


def rank_rates(mesh, device, chains_per_rank: int, total_chains: int, num_steps: int,
               n_train: int) -> dict:
    """One rank of one rank count: the weak-scaling and the fixed-total
    rates (alike on every rank), and this rank's kernel launches."""
    from bark_tpu_torch.graft_entry import launch_counts, reset_launches

    reset_launches()
    data = _data(n_train, device)
    n = mesh.size()
    return {"weak": _rate(mesh, device, chains_per_rank * n, num_steps, data),
            "fixed": _rate(mesh, device, total_chains, num_steps, data),
            "launches": launch_counts()}


def run_scaling(ranks=(1, 2), chains_per_rank: int = 8, total_chains: int = 16,
                num_steps: int = 20, n_train: int = 50, note: str = "",
                device=None) -> dict:
    """Both measurements at each rank count of ``ranks``; the payload of
    ``SCALING_r05.json`` plus the device, the rank counts, rank 0's kernel
    launches at each count and the dry-run label."""
    from bark_tpu_torch.graft_entry import launch

    dev = resolve_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    rates = {}
    for n in ranks:
        shared = dev.type == "cuda" and n > cards
        out = launch(rank_rates, n, device=dev, backend="gloo" if shared else None,
                     chains_per_rank=chains_per_rank, total_chains=total_chains,
                     num_steps=num_steps, n_train=n_train)
        rates[n] = out[0]
        print(f"{n} rank(s): {json.dumps(out)}", flush=True)
    base = rates[ranks[0]]
    weak = [{"devices": n, "chains": chains_per_rank * n,
             "steps_per_s": round(r["weak"], 1),
             "efficiency": round(r["weak"] / (base["weak"] * n / ranks[0]), 3)}
            for n, r in rates.items()]
    fixed = [{"devices": n, "chains": total_chains, "steps_per_s": round(r["fixed"], 1),
              "vs_unsharded": round(r["fixed"] / base["fixed"], 3)}
             for n, r in rates.items()]
    dry_run = max(ranks) > cards
    return {
        "note": note,
        "platform": dev.type,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "dry_run": dry_run,
        "host_cores": os.cpu_count(),
        "devices": cards,
        "ranks": list(ranks),
        "launches_per_rank": {str(n): r["launches"] for n, r in rates.items()},
        "num_steps": num_steps,
        "n_train": n_train,
        "weak_scaling": {
            "chains_per_device": chains_per_rank,
            "caveat": (
                f"{max(ranks)} ranks on {cards} device(s): the ranks share a device and "
                "the host's cores, so this efficiency measures contention, not scaling "
                "across chips" if dry_run else
                "one rank per device"
            ),
            "results": weak,
        },
        "sharding_overhead": {
            "total_chains": total_chains,
            "meaning": (
                "same total chains on one rank vs split over n ranks; the sampler step "
                "exchanges nothing between ranks (only the diagnostics are reduced)"
            ),
            "results": fixed,
        },
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, nargs="+", default=[1, 2])
    parser.add_argument("--chains-per-rank", type=int, default=8)
    parser.add_argument("--total-chains", type=int, default=16)
    parser.add_argument("--num-steps", type=int, default=20)
    parser.add_argument("--n-train", type=int, default=50,
                        help=">= 256 runs the sampler's leaf tier")
    parser.add_argument("--note", default="", help="free-text provenance note")
    parser.add_argument("--out", type=pathlib.Path, default=OUT)
    parser.add_argument("--device", default=None, help="cpu, or the CUDA device if left out")
    args = parser.parse_args(argv)
    payload = run_scaling(tuple(args.ranks), args.chains_per_rank, args.total_chains,
                          args.num_steps, args.n_train, args.note, args.device)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(payload, indent=1))
    print(json.dumps(payload), flush=True)
    return payload


if __name__ == "__main__":
    main()
