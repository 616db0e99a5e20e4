"""Repeated runs of the headline benchmark, of this checkout and another, in turns.

    python -m bark_tpu_torch.benchmarks.bench_turns [--runs 10] [--tree DIR] \
        [--points 50,200,512,1024,50c,2048,4096,8192] [--protocol K=V,...] \
        [--out FILE]

An A/B tool for a change to the sampler, on the card. Each run is one
process that calls :func:`bench.measure` (this checkout's
``bark_tpu_torch/benchmarks/bench.py``) at each point in order, as
``bench.py --curve-xl`` does; ``50c`` is the mixed-categorical N=50. With
``--tree DIR`` (another checkout of the repo, e.g. unpacked from
``git archive``), every run is a pair: the same file measures the same
points against the package under DIR, and the two sides take turns (this
checkout first in even runs, DIR first in odd ones), so both see the same
host. Writes every run's payload and, per point and side, the median,
quartiles and extremes of the rate, the pairs this checkout won, the tier
each point takes, the TPU's rate at that point from ``BENCH_CURVE_r05.json``
(a TPU's, not this card's) and the card's ``nvidia-smi`` line before and
after. Default output: ``results/port/bench/curve_xl.json``.

A point may pin a lowering of the sampler after a colon, as ``SamplerParams``
overrides separated by ``;`` (``512:scan_style=lowrank;refresh_style=pair``),
so one checkout's lowerings run in turns with its default within each run;
``--protocol`` gives ``measure``'s own arguments for every point
(``steps_per_call=20,n_calls=1,untimed_calls=1`` for short readings).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

from bark_tpu_torch.benchmarks.bench import CURVE_XL

REPO = pathlib.Path(__file__).resolve().parents[2]
BENCH = pathlib.Path(__file__).resolve().with_name("bench.py")
OUT = REPO / "results" / "port" / "bench" / "curve_xl.json"
TPU_CURVE = REPO / "BENCH_CURVE_r05.json"

# one process of one side: runs ``measure`` of the given bench.py file at each
# configuration, importing the package of the working directory
WORKER = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("bench_twin", sys.argv[1])
bench = importlib.util.module_from_spec(spec)
spec.loader.exec_module(bench)
configs = json.loads(sys.argv[2])
results = [bench.measure(**c, device=sys.argv[3] or None) for c in configs]
print(json.dumps({"package": sys.modules["bark_tpu_torch"].__file__, "results": results}))
"""


def _value(text: str):
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def _pairs(text: str, sep: str) -> dict:
    """``"a=1;b=x"`` -> ``{"a": 1, "b": "x"}``."""
    return {k: _value(v) for k, v in (kv.split("=", 1) for kv in text.split(sep) if kv)}


def parse_points(text: str) -> list[dict]:
    """``"50,200,50c,512:scan_style=lowrank"`` -> the configurations of
    ``bench.measure`` (N, the categorical variant, sampler overrides)."""
    configs = []
    for p in text.split(","):
        point, _, overrides = p.partition(":")
        configs.append({"n_train": int(point.rstrip("c")),
                        "cat_dim": 2 if point.endswith("c") else 0, **_pairs(overrides, ";")})
    return configs


def _overrides(config: dict) -> dict:
    return {k: v for k, v in config.items() if k not in ("n_train", "cat_dim")}


def point_name(config: dict) -> str:
    return (f"N={config['n_train']}" + (" cat" if config["cat_dim"] else "")
            + "".join(f" {k}={v}" for k, v in _overrides(config).items()))


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def run_side(tree: pathlib.Path, configs: list[dict], device: str | None = None) -> dict:
    """One process measuring ``configs`` against the package under ``tree``,
    on ``device`` (None: the card)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", WORKER, str(BENCH), json.dumps(configs), device or ""],
        cwd=tree, env=env, capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"bench under {tree} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    out = json.loads(proc.stdout.splitlines()[-1])
    out["package"] = os.path.relpath(out["package"], REPO)
    return {"seconds": round(seconds, 2), **out}


def spread(values: list[float]) -> dict:
    """Median, quartiles and extremes of one side's rates at one point."""
    q1, med, q3 = (statistics.quantiles(values, n=4, method="inclusive")
                   if len(values) > 1 else (values[0],) * 3)
    return {"runs": values, "median": round(med, 2), "q1": round(q1, 2),
            "q3": round(q3, 2), "min": min(values), "max": max(values)}


def tier(n: int, **overrides) -> dict:
    """The lowering the sampler resolves for N (and the sampler overrides)
    and its leaf budget R."""
    from bark_tpu_torch.fitting.params import SamplerParams
    from bark_tpu_torch.fitting.sampler import _leaf_budget, _resolve_styles

    params = _resolve_styles(SamplerParams(num_trees=50, **overrides), n)
    leaf = params.kernel_backend == "rank1" and params.refresh_style == "leaf"
    out = {"tier": "leaf" if leaf else "dense", "scan": params.scan_style,
           "refresh": params.refresh_style,
           "leaf_budget": _leaf_budget(params, n) if leaf else None}
    if overrides:
        out.update(backend=params.kernel_backend, hot_style=params.hot_style,
                   subspace_mode=params.subspace_mode)
    return out


def summarize(configs: list[dict], runs: list[dict], sides: list[str]) -> dict:
    tpu = {(r["n_train"], r["cat_dim"]): r["value"] for r in json.loads(TPU_CURVE.read_text())}
    points = {}
    for i, c in enumerate(configs):
        name = point_name(c)
        rates = {s: [run[s]["results"][i]["value"] for run in runs] for s in sides}
        # the TPU's rate is of its default lowering: none beside a pinned one
        tpu_value = None if _overrides(c) else tpu.get((c["n_train"], c["cat_dim"]))
        entry = {**tier(c["n_train"], **_overrides(c)), "tpu_value_bench_curve_r05": tpu_value,
                 **{s: spread(v) for s, v in rates.items()}}
        if len(sides) == 2:
            a, b = (rates[s] for s in sides)
            entry["pairs_won_by_" + sides[0]] = sum(x > y for x, y in zip(a, b))
            entry["median_ratio"] = round(statistics.median(a) / statistics.median(b), 4)
        points[name] = entry
    return points


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--tree", default=None, help="another checkout to take turns with")
    ap.add_argument("--points", default=",".join(
        f"{c['n_train']}{'c' if c['cat_dim'] else ''}" for c in CURVE_XL))
    ap.add_argument("--protocol", default="",
                    help="measure's arguments for every point, e.g. steps_per_call=20,n_calls=1")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    configs = parse_points(args.points)
    protocol = _pairs(args.protocol, ",")
    trees = {"this": REPO}
    if args.tree:
        trees["tree"] = pathlib.Path(args.tree).resolve()
    sides = list(trees)
    smi_before = nvidia_smi()
    print(f"[bench_turns] {smi_before}; {args.runs} run(s) of {args.points} on {sides}",
          file=sys.stderr, flush=True)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    runs = []
    for i in range(args.runs):
        order = sides if i % 2 == 0 else sides[::-1]
        run = {"order": order}
        for side in order:
            run[side] = run_side(trees[side], [{**c, **protocol} for c in configs])
            print(f"[bench_turns] run {i} {side} ({trees[side]}): {run[side]['seconds']} s; "
                  + ", ".join(f"{point_name(c)} {r['value']}"
                              for c, r in zip(configs, run[side]["results"])),
                  file=sys.stderr, flush=True)
        runs.append(run)
        # written after every run, so a run cut short keeps the runs before it
        payload = {
            "protocol": "bench.measure per point: 64 chains, 2 untimed calls, 5 timed "
                        "calls of 50 steps, one synchronisation at the end"
                        + (f"; but {args.protocol}" if protocol else ""),
            "trees": {s: os.path.relpath(p, REPO) for s, p in trees.items()},
            "nvidia_smi": [smi_before, nvidia_smi()],
            "points": summarize(configs, runs, sides),
            "runs": runs,
        }
        out.write_text(json.dumps(payload, indent=1))
    print(json.dumps(payload["points"]), flush=True)
    return payload


if __name__ == "__main__":
    main()
