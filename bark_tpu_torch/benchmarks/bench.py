"""Headline benchmark: forest-MCMC steps/s/chip on TreeFunction.

The port's twin of the root ``bench.py``, with its protocol, its modes and
its output: full BARK MCMC steps (m=50 tree moves + 1 noise/scale move per
step) of 64 chains batched on one device, per second. On the port a "chip"
is one GPU (an H100 where the port is measured).

    python -m bark_tpu_torch.benchmarks.bench [--curve] [--curve-xl] \
        [--out FILE] [--device DEV]

The default mode prints ONE JSON line with exactly the reference's keys:
  {"metric": "forest_mcmc_steps_per_s_per_chip", "value": N, "unit":
   "steps/s/chip", "vs_baseline": N}

``vs_baseline`` is the ratio against the 1000 steps/s/chip target of
``BASELINE.md``. ``--curve`` runs N in {50, 200, 512, 1024} and the
mixed-categorical N=50 (2 of 5 features categorical with 5 levels),
``--curve-xl`` adds N in {2048, 4096, 8192}, in the reference's order, and
prints one JSON array; ``--out`` also writes the payload to a file. Logs go
to stderr, so stdout holds only the payload. Without ``--device`` it runs
on the CUDA device and raises without one; ``--device cpu`` is for tests.

The module imports only the four modules the reference's ``measure`` uses
(the benchmark, the parameters, the sampler and the forest), so the same
file can time an older tree of the package put first on ``sys.path``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from bark_tpu_torch.benchmarks.tree_function import TreeFunction
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.fitting.sampler import BARKModel, run_bark_sampler
from bark_tpu_torch.forest import Forest, create_empty_forest

TARGET = 1000.0  # north-star steps/s/chip (BASELINE.md)
HEADLINE_KEYS = ("metric", "value", "unit", "vs_baseline")
CURVE = (
    {"n_train": 50, "cat_dim": 0},
    {"n_train": 200, "cat_dim": 0},
    {"n_train": 512, "cat_dim": 0},
    {"n_train": 1024, "cat_dim": 0},
    {"n_train": 50, "cat_dim": 2},  # mixed-categorical variant
)
CURVE_XL = CURVE + (
    {"n_train": 2048, "cat_dim": 0},
    {"n_train": 4096, "cat_dim": 0},
    {"n_train": 8192, "cat_dim": 0},
)


def _device(device) -> torch.device:
    """``None`` -> the CUDA device, an error without one; never the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the benchmark runs on the GPU unless the caller "
                'asks for the CPU (device="cpu")'
            )
        return torch.device("cuda")
    return torch.device(device)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def problem(n_train: int, cat_dim: int = 0, num_chains: int = 64,
            steps_per_call: int = 50, **sampler_overrides):
    """The host-side data and parameters of one configuration, built as
    ``bench.py:50-67``: returns ``X``, ``y_std`` (float64), the bitmask
    bounds, the feature types and the :class:`SamplerParams`."""
    bench = TreeFunction(dim=5 - cat_dim, cat_dim=cat_dim, num_cat=5, m=50,
                         function_seed=1)
    X = bench.domain.sample(n_train, np.random.default_rng(0))
    y = bench.f(X)
    y_std = (y - y.mean()) / y.std()
    sampler_overrides.setdefault("num_trees", 50)
    params = SamplerParams(
        warmup_steps=0,
        num_samples=10,
        steps_per_sample=steps_per_call // 10,
        num_chains=num_chains,
        **sampler_overrides,
    )
    return X, y_std, bench.domain.bounds("bitmask"), bench.domain.feature_types(), params


def measure(n_train: int, cat_dim: int = 0, num_chains: int = 64,
            steps_per_call: int = 50, n_calls: int = 5, device=None,
            untimed_calls: int = 2, **sampler_overrides) -> dict:
    """Steady-state full-MCMC steps/s/chip at one (N, domain) configuration.

    Untimed calls first, one from the empty forests and (by default, as the
    reference) one more on their last sample, so the timed region is
    steady-state mixing; then ``n_calls`` sampler calls on that last sample
    between two device synchronisations, one before the clock starts and
    one at the end (the calls queue on the device as the reference's
    asynchronous dispatches do, except where the sampler itself waits for
    the device). ``sampler_overrides`` go to :class:`SamplerParams`, e.g.
    a lowering (``scan_style="lowrank"``).
    """
    dev = _device(device)
    X, y_std, bounds, ft, params = problem(n_train, cat_dim, num_chains, steps_per_call,
                                           **sampler_overrides)
    X = torch.as_tensor(X, device=dev)
    y = torch.as_tensor(y_std, dtype=torch.float32, device=dev)
    bounds = torch.as_tensor(bounds, device=dev)
    ft = torch.as_tensor(ft, device=dev)
    model = BARKModel(
        create_empty_forest(params.num_trees, params.node_limit, (num_chains,), dev),
        torch.full((num_chains,), 0.1, dtype=torch.float32, device=dev),
        torch.ones((num_chains,), dtype=torch.float32, device=dev),
    )

    def run(m, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return run_bark_sampler(gen, m, X, y, bounds, ft, params)

    samples = run(model, 0)
    warm_model = BARKModel(
        forest=Forest(*(f[:, -1] for f in samples.forest)),
        noise=samples.noise[:, -1],
        scale=samples.scale[:, -1],
    )
    for seed in range(1, untimed_calls):
        run(warm_model, seed)
    _sync(dev)

    t0 = time.perf_counter()
    for i in range(n_calls):
        run(warm_model, 2 + i)
    _sync(dev)
    dt = time.perf_counter() - t0

    steps_per_s = n_calls * num_chains * steps_per_call / dt
    return {
        "metric": "forest_mcmc_steps_per_s_per_chip",
        "value": round(steps_per_s, 2),
        "unit": "steps/s/chip",
        "vs_baseline": round(steps_per_s / TARGET, 3),
        "n_train": n_train,
        "cat_dim": cat_dim,
        "num_chains": num_chains,
    }


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--curve", action="store_true",
                        help="sweep N in {50,200,512,1024} + mixed-cat")
    parser.add_argument("--curve-xl", action="store_true",
                        help="also sweep N in {2048,4096,8192} (leaf refresh)")
    parser.add_argument("--out", default=None,
                        help="also write the result JSON to this file")
    parser.add_argument("--device", default=None,
                        help="cpu, or the CUDA device if left out")
    args = parser.parse_args(argv)
    dev = _device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    def run(config):
        res = measure(**config, device=dev)
        print(f"[bench] {json.dumps(res)} on {name}", file=sys.stderr, flush=True)
        return res

    if args.curve or args.curve_xl:
        payload = json.dumps([run(c) for c in (CURVE_XL if args.curve_xl else CURVE)])
    else:
        res = run({"n_train": 50})
        payload = json.dumps({k: res[k] for k in HEADLINE_KEYS})
    print(payload, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(payload + "\n")
    return payload


if __name__ == "__main__":
    main()
