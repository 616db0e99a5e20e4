"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout names the cells, their
configurations and traffic mixes, and the per-layer metrics. Each part is a
file of its own under ``perfbench/``, found by name:

- ``configs/<config>.json`` (the file ``BENCHMARK.json`` gives), whose
  ``entry`` names ``entries/<family>.py``;
- ``traffic/<traffic>.json``;
- ``limits/<cell>.json``, the limit of each number the check compares;
- ``metrics/<metric>.py``, one reader per per-layer metric.

A later cell, mix, family or metric is a new file and a new entry in
``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    entry: ModuleType
    end_to_end: list[dict]
    per_layer: list[dict]


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def reports(metric: dict, cell: str, end_to_end: list[dict]) -> bool:
    """Does ``cell`` report ``metric``? A metric with ``workloads`` lists
    its cells; a per-layer one without goes wherever the end-to-end metric
    it moves is reported."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        moved = next((e for e in end_to_end if e["name"] == metric["moves"]), None)
        return moved is not None and reports(moved, cell, end_to_end)
    return True


def load_cell(name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``bench_dir/../BENCHMARK.json`` with its parts."""
    root = bench_dir.parent
    spec = _json(root / "BENCHMARK.json")
    work = next((w for w in spec["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf_entry = next(c for c in spec["configs"] if c["name"] == work["config"])
    config = _json(root / conf_entry["file"])
    traffic = _json(bench_dir / "traffic" / f"{work['traffic']}.json")
    limits = _json(bench_dir / "limits" / f"{name}.json")
    entry = load_module(bench_dir / "entries" / f"{config['entry']}.py",
                        f"perfbench_entry_{config['entry']}")
    e2e = [m for m in spec["end_to_end"] if reports(m, name, spec["end_to_end"])]
    per_layer = [m for m in spec["per_layer"] if reports(m, name, spec["end_to_end"])]
    return Cell(name, work["chips"], config, traffic, limits, entry, e2e, per_layer)


def metric_reader(metric: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return load_module(bench_dir / "metrics" / f"{metric}.py",
                       "perfbench_metric_" + metric.replace(".", "_"))
