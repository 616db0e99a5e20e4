"""Cross-seed BO-run summary and regret plot.

The port's twin of ``examples/plot_bo_runs.py`` over the study runner's CSVs
(``experiments_<benchmark>_<strategy>_seed=<s>.csv`` with a ``y`` column):
group the runs by benchmark and strategy, take each seed's best-so-far
trace, and report its mean and spread across seeds at the common length.
The JSON summary needs numpy only; the figure (mean +/- std bands, the
optimum's line) needs matplotlib and raises a RuntimeError naming it where
it is not installed (``--no-plots`` skips it).

    python -m bark_tpu_torch.benchmarks.plot_bo_runs results/regret_r2 \
        [--benchmark NAME] [--optimum -1.9] [--out FIG.png] [--summary-out S.json] \
        [--no-plots]

Writes ``bo_runs.png`` and ``bo_runs.json`` under ``results/port/plot_bo_runs/``
unless ``--out`` / ``--summary-out`` say otherwise; nothing is written into
the input directory.
"""

from __future__ import annotations

import argparse
import csv
import json
import pathlib
import re

import numpy as np

OUT = (pathlib.Path(__file__).resolve().parents[2] / "results" / "port" / "plot_bo_runs"
       / "bo_runs.png")

_PAT = re.compile(r"experiments_(?P<bench>.+)_(?P<strategy>[^_]+)_seed=(?P<seed>\d+)\.csv")


def load_runs(directory: pathlib.Path) -> dict:
    """{(benchmark, strategy): [each seed's best-so-far trace]} from the
    study CSVs of ``directory``."""
    runs = {}
    for path in sorted(pathlib.Path(directory).glob("experiments_*.csv")):
        m = _PAT.match(path.name)
        if not m:
            continue
        with open(path, newline="") as fh:
            ys = [float(row["y"]) for row in csv.DictReader(fh)]
        if not ys:
            continue
        best = np.minimum.accumulate(np.asarray(ys, np.float64))
        runs.setdefault((m["bench"], m["strategy"]), []).append(best)
    return runs


def aggregate(traces) -> tuple[np.ndarray, np.ndarray]:
    """Mean and standard deviation of the best-so-far traces across seeds,
    cut to the shortest."""
    n = min(len(t) for t in traces)
    arr = np.stack([t[:n] for t in traces])
    return arr.mean(axis=0), arr.std(axis=0, ddof=1 if len(traces) > 1 else 0)


def summarize(runs: dict, optimum: float | None = None) -> dict:
    """{"<benchmark>/<strategy>": seeds, iterations, final best mean and std
    (and the final regret's mean when the optimum is known)}."""
    summary = {}
    for (bench, strategy), traces in sorted(runs.items()):
        mean, std = aggregate(traces)
        entry = {"seeds": len(traces), "iterations": int(len(mean)),
                 "final_best_mean": float(mean[-1]), "final_best_std": float(std[-1])}
        if optimum is not None:
            entry["final_regret_mean"] = float(mean[-1] - optimum)
        summary[f"{bench}/{strategy}"] = entry
    return summary


def plot(runs: dict, out: pathlib.Path, optimum: float | None = None) -> None:
    """One figure of every run group's mean best-so-far with a +/- std band."""
    from bark_tpu_torch.utils.plots import pyplot, save_fig

    fig, ax = pyplot().subplots(figsize=(6, 4))
    for (_, strategy), traces in sorted(runs.items()):
        mean, std = aggregate(traces)
        x = np.arange(1, len(mean) + 1)
        ax.plot(x, mean, label=f"{strategy} ({len(traces)} seeds)")
        ax.fill_between(x, mean - std, mean + std, alpha=0.3)
    if optimum is not None:
        ax.axhline(optimum, linestyle="--", color="gray", label="optimum")
    ax.set_xlabel("iteration")
    ax.set_ylabel("best objective so far")
    ax.set_title(", ".join(sorted({b for b, _ in runs})))
    ax.legend()
    save_fig(fig, out)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("directory", type=pathlib.Path,
                    help="a study output directory with experiments_*.csv")
    ap.add_argument("--benchmark", default=None, help="keep only this benchmark")
    ap.add_argument("--optimum", type=float, default=None,
                    help="known optimum: the figure's line and the summary's regret")
    ap.add_argument("--out", type=pathlib.Path, default=OUT, help="figure path (.png)")
    ap.add_argument("--summary-out", type=pathlib.Path, default=None,
                    help="JSON summary path (default: the figure's, as .json)")
    ap.add_argument("--no-plots", action="store_true")
    args = ap.parse_args(argv)
    runs = load_runs(args.directory)
    if args.benchmark:
        runs = {k: v for k, v in runs.items() if k[0] == args.benchmark}
    if not runs:
        raise SystemExit(f"no experiments_*.csv runs found in {args.directory}")
    summary = summarize(runs, args.optimum)
    summary_path = args.summary_out or args.out.with_suffix(".json")
    summary_path.parent.mkdir(parents=True, exist_ok=True)
    summary_path.write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)
    if not args.no_plots:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        plot(runs, args.out, args.optimum)
    print(f"wrote {summary_path}{'' if args.no_plots else f' and {args.out}'}", flush=True)
    return summary


if __name__ == "__main__":
    main()
