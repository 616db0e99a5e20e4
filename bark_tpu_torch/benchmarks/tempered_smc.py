"""Parallel tempering and SMC over a BARK posterior.

The port's twin of ``examples/tempered_smc.py``, with its problem and its
JSON: TreeFunction(dim=3, m=20, seed=1), 40 random points (y
standardised), 20 trees.

  - PT: ``num_replicas`` replicas on a geometric ladder from empty forests
    for ``num_steps`` rounds; the swap rate and the cold chain's mean noise;
  - SMC: adaptive tempering of ``num_particles`` prior particles; the
    log-evidence, the schedule, the posterior mean noise and the last ESS.

``sharded=True`` runs both over ``ranks`` processes
(``graft_entry.launch``): PT with one replica per rank
(``run_parallel_tempering_sharded``), SMC with the particles split over the
ranks (``run_smc_sharded``). Gloo joins the ranks on the CPU, and on the
card whenever two ranks share one (NCCL refuses that); NCCL otherwise.
The sharded run follows its single-process counterparts exactly:
:func:`sharded_twin` computes what it must give.

    python -m bark_tpu_torch.benchmarks.tempered_smc -s 0 [--sharded [--ranks R]] \
        [--num-replicas 8] [--num-steps 200] [--num-particles 64] [-o OUT] [--device cpu]

Writes ``results/port/tempered_smc/tempered_smc_seed<s>[_sharded].json``
unless ``-o`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np
import torch

from bark_tpu_torch.benchmarks.tree_function import TreeFunction
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.forest import create_empty_forest
from bark_tpu_torch.models.surrogate import resolve_device
from bark_tpu_torch.parallel.smc import run_smc, run_smc_sharded
from bark_tpu_torch.parallel.tempering import (
    run_parallel_tempering,
    run_parallel_tempering_sharded,
)

OUT_DIR = pathlib.Path(__file__).resolve().parents[2] / "results" / "port" / "tempered_smc"


def problem(seed: int, device):
    """(X, y, bounds, feat_types, params) of the example."""
    bench = TreeFunction(dim=3, m=20, function_seed=1)
    rng = np.random.default_rng(seed)
    X = bench.domain.sample(40, rng)
    y = bench.f(X)
    y = (y - y.mean()) / y.std()
    return (torch.as_tensor(X, device=device),
            torch.as_tensor(y, dtype=torch.float32, device=device),
            torch.as_tensor(bench.domain.bounds("bitmask"), device=device),
            torch.as_tensor(bench.domain.feature_types(), device=device),
            SamplerParams(num_trees=20))


def _replicas(params, r: int, device):
    forest = create_empty_forest(params.num_trees, params.node_limit, (r,), device)
    return (forest, torch.full((r,), 0.1, dtype=torch.float32, device=device),
            torch.ones(r, dtype=torch.float32, device=device))


def _mean(t: torch.Tensor) -> float:
    """A float32 tensor's mean in float64 on the host, alike wherever it lies."""
    return float(t.detach().cpu().double().mean())


def _smc_summary(num_particles, log_evidence, betas, noise, ess) -> dict:
    betas = betas.cpu().numpy()
    return {
        "particles": num_particles,
        "log_evidence": float(log_evidence),
        "final_beta": float(betas[-1]),
        "tempering_rounds": int(np.sum(betas < 1.0)),
        "posterior_noise_mean": _mean(noise),
        "final_ess": float(ess[-1]),
    }


def run_single(seed: int, num_replicas: int = 8, num_steps: int = 200,
               num_particles: int = 64, device=None) -> dict:
    """PT and SMC in this process."""
    dev = resolve_device(device)
    X, y, bounds, ft, params = problem(seed, dev)
    run = run_parallel_tempering(
        torch.Generator(device=dev).manual_seed(seed), *_replicas(params, num_replicas, dev),
        X, y, bounds, ft, params, num_replicas=num_replicas, num_steps=num_steps,
    )
    smc = run_smc(torch.Generator(device=dev).manual_seed(seed + 1), X, y, bounds, ft,
                  params, num_particles=num_particles)
    return {
        "seed": seed, "sharded": False,
        "pt": {"replicas": num_replicas, "swap_rate": _mean(run.swap_rate),
               "cold_noise_mean": _mean(run.samples.noise)},
        "smc": _smc_summary(num_particles, smc.log_evidence, smc.betas, smc.model.noise,
                            smc.ess_trace),
    }


def rank_tempered(mesh, device, seed: int, num_steps: int, num_particles: int) -> dict:
    """One rank of the sharded run: its PT replica, its SMC particles and
    its kernel launches."""
    from bark_tpu_torch.fitting.sampler import BARKModel
    from bark_tpu_torch.graft_entry import launch_counts, reset_launches
    from bark_tpu_torch.parallel.sharding import shard_model

    reset_launches()
    X, y, bounds, ft, params = problem(seed, device)
    local = shard_model(BARKModel(*_replicas(params, mesh.size(), device)), mesh)
    pt = run_parallel_tempering_sharded(seed, local.forest, local.noise, local.scale, X, y,
                                        bounds, ft, params, mesh, num_steps=num_steps)
    smc = run_smc_sharded(torch.Generator(device=device).manual_seed(seed + 1), X, y, bounds,
                          ft, params, mesh, num_particles=num_particles)
    return {"pt": pt, "smc": smc, "launches": launch_counts()}


def run_sharded(seed: int, ranks: int, num_steps: int = 200, num_particles: int = 64,
                device=None, timeout: float = 900.0) -> dict:
    """PT with one replica per rank and SMC split over ``ranks`` processes;
    the results come from rank 0 (beta = 1) and every rank's particles."""
    from bark_tpu_torch.graft_entry import launch

    dev = resolve_device(device)
    shared_card = dev.type == "cuda" and ranks > torch.cuda.device_count()
    out = launch(rank_tempered, ranks, device=dev, backend="gloo" if shared_card else None,
                 timeout=timeout, seed=seed, num_steps=num_steps, num_particles=num_particles)
    pt, smc = out[0]["pt"], out[0]["smc"]
    return {
        "seed": seed, "sharded": True,
        "pt": {"replicas": ranks, "swap_rate": _mean(pt.swap_rate),
               "cold_noise_mean": _mean(pt.samples.noise)},
        "smc": _smc_summary(num_particles, smc.log_evidence, smc.betas,
                            torch.cat([r["smc"].model.noise for r in out]), smc.ess_trace),
        "ranks": [{"swap_rate": r["pt"].swap_rate, "mll": r["pt"].mll,
                   "noise": r["pt"].samples.noise, "launches": r["launches"]} for r in out],
    }


def sharded_twin(seed: int, ranks: int, num_steps: int = 200, num_particles: int = 64,
                 device=None) -> dict:
    """What :func:`run_sharded` must give, computed in this process: PT by
    ``graft_entry.single_process_pt`` (each replica stepped from its rank's
    draws, then the swaps), SMC by ``run_smc`` from the same generator; with
    the traces rank 0's PT must equal (``"traces"``: per round, the swap
    rate, and the cold chain's MLL and noise)."""
    from bark_tpu_torch.graft_entry import single_process_pt

    dev = resolve_device(device)
    X, y, bounds, ft, params = problem(seed, dev)
    mlls, rates, _, noises = single_process_pt(seed, ranks, *_replicas(params, ranks, dev),
                                               X, y, bounds, ft, params, num_steps)
    smc = run_smc(torch.Generator(device=dev).manual_seed(seed + 1), X, y, bounds, ft,
                  params, num_particles=num_particles)
    return {
        "seed": seed, "sharded": True,
        "pt": {"replicas": ranks, "swap_rate": _mean(rates),
               "cold_noise_mean": _mean(noises[:, 0])},
        "smc": _smc_summary(num_particles, smc.log_evidence, smc.betas, smc.model.noise,
                            smc.ess_trace),
        "traces": {"swap_rate": rates, "mll": mlls[:, 0], "noise": noises[:, 0]},
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-s", "--seed", type=int, default=0)
    parser.add_argument("--sharded", action="store_true")
    parser.add_argument("--ranks", type=int, default=None,
                        help="processes of --sharded (default: the CUDA devices; 2 on the CPU)")
    parser.add_argument("--num-replicas", type=int, default=8)
    parser.add_argument("--num-steps", type=int, default=200)
    parser.add_argument("--num-particles", type=int, default=64)
    parser.add_argument("-o", "--out", type=pathlib.Path, default=None)
    parser.add_argument("--device", default=None, help="cpu, or the CUDA device if left out")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    if args.sharded:
        ranks = args.ranks or (torch.cuda.device_count() if dev.type == "cuda" else 2)
        result = run_sharded(args.seed, ranks, args.num_steps, args.num_particles, dev)
        result.pop("ranks")
    else:
        result = run_single(args.seed, args.num_replicas, args.num_steps, args.num_particles,
                            dev)
    print(json.dumps(result))
    out = args.out or OUT_DIR / (
        f"tempered_smc_seed{args.seed}{'_sharded' if args.sharded else ''}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
