"""A copy of the benchmark shrunk to a size the CPU tests can run.

The same cells, entries, metrics and limits, with fewer chains, trees,
steps, candidates and points, in a directory of its own (with its own
``BENCHMARK.json`` beside it), so that the tests drive the harness whole
without a card.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from perfbench.lib.registry import BENCH_DIR

ROWS = {"mcmc_n50": 16, "bo_n50": 12}


def make(dest: Path, bench_dir: Path = BENCH_DIR) -> Path:
    """Write the shrunk copy under ``dest``; returns its ``perfbench``."""
    root = bench_dir.parent
    out = Path(dest) / "perfbench"
    shutil.copytree(bench_dir, out, ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = json.loads((root / c["file"]).read_text())
        cfg["sampler"].update(num_trees=8, num_chains=3, num_samples=2, steps_per_sample=3)
        if cfg["entry"] == "bo":
            cfg["strategy"].update(num_candidates=64, num_rounds=2)
            cfg["sampler"].update(warmup_steps=10)
        (Path(dest) / c["file"]).write_text(json.dumps(cfg))
    for name, rows in ROWS.items():
        path = out / "traffic" / f"{name}.json"
        traffic = json.loads(path.read_text())
        traffic["n_train" if "n_train" in traffic else "n_init"] = rows
        traffic.update(episode=3)
        path.write_text(json.dumps(traffic))
    (Path(dest) / "BENCHMARK.json").write_text(json.dumps(spec))
    return out
