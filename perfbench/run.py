"""One run of one cell of the benchmark of ``bark_tpu_torch`` on the GPU.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (import, CUDA context, data from the seed, warm-up of the cell's
shapes) counts as ``setup_s``, from the start of this script to the start
of the window. The window runs the cell's unit back to back (a closed loop)
until ``--seconds`` have passed and the last unit has finished (and at
least the entry's ``min_units``, so that the unit it checks has run), then
one synchronisation closes it. ``--trace 0`` reports the cell's end-to-end
metrics; ``--trace 1`` runs the same window with the harness's spans on,
then profiles a short steady part and counts the host's synchronisations,
and reports the per-layer metrics. Either way the outputs of the window are
judged against the float64 reference (``reference/``) once the window has
closed, memory has been read and the program's state is freed; the numbers
compared, each with its limit, are the last lines of standard error and the
last key of the result. A number that the cell's limits name and the check
did not compute makes the run not correct.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with ``--trace 1``
``breakdown``), then ``compared``. Without a CUDA device, or with fewer than
the cell asks for, it exits with code 2 and prints no result; if a module
named ``jax``, ``jaxlib``, ``flax`` or ``bark_tpu`` (whole top-level names)
is loaded when the window has closed, it exits with code 3 and prints none.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
if str(BENCH_DIR.parent) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR.parent))

# kernel caches at fixed places inside the checkout (the nvcc library of the
# port lands in bark_tpu_torch/_build/ by itself)
CACHES = {"TRITON_CACHE_DIR": BENCH_DIR / ".cache" / "triton",
          "TORCH_EXTENSIONS_DIR": BENCH_DIR / ".cache" / "torch_extensions"}
FORBIDDEN = ("jax", "jaxlib", "flax", "bark_tpu")
THREADS = 4


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``bark_tpu_torch`` is not ``bark_tpu``."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(argv=None, device=None, bench_dir: Path = BENCH_DIR) -> tuple[int, dict | None]:
    """One run; returns (exit code, result). ``device`` None means the CUDA
    device, checked against the cell's chips; tests pass the CPU."""
    args = parse(argv)
    for key, path in CACHES.items():
        os.environ[key] = str(path)
    import torch

    from perfbench.lib import registry, trace
    from perfbench.lib.seeds import sync

    cell = registry.load_cell(args.workload, bench_dir)
    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            print(f"[perfbench] {args.workload} needs {cell.chips} CUDA device(s), "
                  f"{have} available", file=sys.stderr)
            return 2, None
        device = torch.device("cuda", 0)
    torch.set_num_threads(THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    work = cell.entry.Workload(cell.config, cell.traffic, cell.limits, args.seed, device)
    work.setup()
    if args.trace and hasattr(work, "spans_on"):
        work.spans_on()
    sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - T_START
    ends = []
    while True:
        try:
            work.unit()
        except Exception:  # a unit that raises ends the window and fails the run
            traceback.print_exc()
            work.failed += 1
            break
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= args.seconds and work.attempted >= getattr(work, "min_units", 1):
            break
    sync(device)
    seconds = time.perf_counter() - t0
    units = [b - a for a, b in zip([0.0] + ends, ends)]
    print("[perfbench] unit seconds (host, no sync between): "
          + " ".join(f"{u:.3f}" for u in units), file=sys.stderr)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    metrics, extra_device, breakdown = {}, {}, None
    if args.trace:
        ctx = work.layer_context(seconds)
        ctx.update(work.traced(trace))
        for m in cell.per_layer:
            value = registry.metric_reader(m["name"], bench_dir).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        prof = ctx["trace"]
        extra_device = {"busy_s": prof.busy_s(), "window_s": prof.window_s}
        breakdown = trace.breakdown(prof, ctx.get("host_trace"))
        del ctx, prof
    else:
        e2e = dict(work.end_to_end(seconds), setup_s=(setup_s, "s"))
        for m in cell.end_to_end:
            if m["name"] in e2e:
                value, unit = e2e[m["name"]]
                metrics[m["name"]] = {"value": value, "unit": unit}

    work.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    compared = work.check(device)
    t_end = time.perf_counter()
    print(f"[perfbench] setup {setup_s:.1f} s, window {seconds:.1f} s, traced part "
          f"{t_check - t0 - seconds:.1f} s, check {t_end - t_check:.1f} s", file=sys.stderr)
    missing = sorted(set(cell.limits) - {c["name"] for c in compared})
    if missing:
        print(f"[perfbench] not compared, so not correct: {', '.join(missing)}",
              file=sys.stderr)
    correct = (work.attempted > 0 and work.failed == 0 and not missing
               and all(c["value"] <= c["limit"] for c in compared))

    found = forbidden_modules()
    if found:
        print(f"[perfbench] forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3, None
    result = {
        "correct": correct, "attempted": work.attempted, "failed": work.failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": cell.chips if cuda else 0, "memory_peak_bytes": peak,
                   **extra_device},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                          for c in compared}
    for c in compared:
        print(f"[compared] {c['name']} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0, result


def main(argv=None) -> int:
    code, result = run(argv)
    if result is not None:
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
