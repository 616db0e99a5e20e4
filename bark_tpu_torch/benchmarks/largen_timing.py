"""Large-N latency of ``ask`` and of the posterior predict.

The port's twin of ``tools/time_ask_largen.py`` and
``tools/time_predict_largen.py``, with their records:

  - :func:`time_ask`: ``ask`` of a ``BARKPrior`` strategy (S = 16 prior
    draws of 50 trees, so the fit costs nothing and the acquisition is
    what is timed) on TreeFunction(dim=5, m=50, seed=1): the acquisition
    build and a full ``propose`` (4096 candidates x 4 rounds and the
    leaf-box centring), each cold and warm, then ``strategy.ask()``. The
    default sweep is N = 2048 dense and factored ("lowrank"), and 8192 and
    32768 factored;
  - :func:`time_predict`: ``forest_predict`` (dense), ``forest_predict_cg``
    and ``forest_predict_leaf`` under 4 prior forests (noise 0.1, scale 1)
    at 64 candidates, warm (the second call), at N = 2048, 8192 and 32768;
    the dense predict, which builds S x N x N, only at 2048.

Every time ends with a device synchronisation.

    python -m bark_tpu_torch.benchmarks.largen_timing [--ask-only | --predict-only] \
        [--ns 2048 8192 32768] [--out-dir DIR] [--device cpu]

Writes ``ask_latency.json`` and ``predict_latency.json`` under
``results/port/largen_timing/`` unless ``--out-dir`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

from bark_tpu_torch.benchmarks.tree_function import TreeFunction
from bark_tpu_torch.fitting.prior import draw_prior, sample_forest_prior
from bark_tpu_torch.models.gp import forest_predict, forest_predict_cg, forest_predict_leaf
from bark_tpu_torch.models.surrogate import BARKPriorSurrogate, resolve_device
from bark_tpu_torch.optimizer.acquisition import build_acquisition, build_acquisition_lr
from bark_tpu_torch.optimizer.search import draw_search, propose
from bark_tpu_torch.strategies.tree_kernel import TreeKernelStrategy
from bark_tpu_torch.utils.timer import Timer

OUT_DIR = pathlib.Path(__file__).resolve().parents[2] / "results" / "port" / "largen_timing"
ASK_SWEEP = ((2048, "dense"), (2048, "lowrank"), (8192, "lowrank"), (32768, "lowrank"))
PREDICT_NS = (2048, 8192, 32768)
PREDICT_FNS = {"dense": forest_predict, "cg": forest_predict_cg, "leaf": forest_predict_leaf}


def _bench():
    return TreeFunction(dim=5, m=50, function_seed=1)


def time_ask(n: int, backend: str, num_samples: int = 16, seed: int = 0, device=None) -> dict:
    """One record of ``ask_latency.json`` at N = ``n`` with the ``backend``
    acquisition ("dense" or "lowrank")."""
    bench = _bench()
    dom = bench.domain
    X = dom.sample(n, np.random.default_rng(seed))
    sur = BARKPriorSurrogate(dom, num_samples=num_samples, seed=seed, device=device)
    strat = TreeKernelStrategy(dom, surrogate=sur, seed=seed, acq_backend=backend)
    strat.tell(X, bench.f(X))
    dev = sur.device
    ft = torch.as_tensor(dom.feature_types(), device=dev)
    train_x, train_y = sur.train_data
    builder = build_acquisition_lr if backend == "lowrank" else build_acquisition
    rec = {"n": n, "backend": backend, "num_samples": num_samples, "num_trees": 50,
           "node_limit": sur.params.node_limit}

    timer = Timer()
    for phase in ("build_cold_s", "build_warm_s"):
        with timer(phase):
            acq = builder(sur.model, train_x, train_y, ft, sur.params.max_depth,
                          train_mask=sur.train_mask)
    for phase, s in (("propose_cold_s", 1), ("propose_warm_s", 2)):
        gen = torch.Generator(device=dev).manual_seed(s)
        draws = draw_search(gen, 4096, dom.dim, 4)
        with timer(phase):
            cand, val = propose(draws, acq, dom, ft, max_depth=sur.params.max_depth,
                                rng=np.random.default_rng(s))
    rec.update(timer)
    rec["ask_warm_s"] = rec["build_warm_s"] + rec["propose_warm_s"]
    rec["acq_value"] = float(val)
    with timer("strategy_ask_s"):
        out = strat.ask()
    rec["strategy_ask_s"] = timer["strategy_ask_s"]
    bounds = dom.bounds("ordinal")
    rec["in_domain"] = bool((out[0] >= bounds[:, 0] - 1e-9).all()
                            and (out[0] <= bounds[:, 1] + 1e-9).all())
    print(json.dumps(rec), flush=True)
    return rec


def time_predict(ns=PREDICT_NS, device=None) -> list[dict]:
    """The rows of ``predict_latency.json``: each backend's warm seconds at
    each N (dense only up to 2048), 64 candidates."""
    dev = resolve_device(device)
    bench = _bench()
    dom = bench.domain
    ft = torch.as_tensor(dom.feature_types(), device=dev)
    bounds = torch.as_tensor(dom.bounds("bitmask"), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    forest = sample_forest_prior(draw_prior(gen, 4, 50, device=dev), 50, bounds, ft)
    noise = torch.full((4,), 0.1, device=dev)
    scale = torch.ones(4, device=dev)
    rng = np.random.default_rng(0)
    C = torch.as_tensor(dom.sample(64, rng), dtype=torch.float32, device=dev)
    rows = []
    for n in ns:
        X_np = dom.sample(n, rng)
        X = torch.as_tensor(X_np, dtype=torch.float32, device=dev)
        y = torch.as_tensor(bench.f(X_np), dtype=torch.float32, device=dev)
        for name, fn in PREDICT_FNS.items():
            if name == "dense" and n > 2048:
                continue  # the S x N x N memory wall
            timer = Timer()
            for phase in ("cold", "warm"):
                with timer(phase):
                    fn(forest, noise, scale, X, y, C, ft)
            rows.append({"n": n, "backend": name, "warm_s": round(timer["warm"], 3)})
            print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    part = ap.add_mutually_exclusive_group()
    part.add_argument("--ask-only", action="store_true")
    part.add_argument("--predict-only", action="store_true")
    ap.add_argument("--ns", type=int, nargs="+", default=None,
                    help="keep only these N of both sweeps")
    ap.add_argument("--out-dir", type=pathlib.Path, default=OUT_DIR)
    ap.add_argument("--device", default=None, help="cpu, or the CUDA device if left out")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    keep = lambda n: args.ns is None or n in args.ns  # noqa: E731
    args.out_dir.mkdir(parents=True, exist_ok=True)
    out = {}
    t0 = time.perf_counter()
    if not args.predict_only:
        records = [time_ask(n, b, device=dev) for n, b in ASK_SWEEP if keep(n)]
        out["ask"] = {"device": name, "records": records}
        (args.out_dir / "ask_latency.json").write_text(json.dumps(out["ask"], indent=2))
    if not args.ask_only:
        out["predict"] = time_predict([n for n in PREDICT_NS if keep(n)], dev)
        (args.out_dir / "predict_latency.json").write_text(json.dumps(out["predict"], indent=1))
    print(f"wrote {sorted(out)} under {args.out_dir} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


if __name__ == "__main__":
    main()
