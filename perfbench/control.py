"""The readings that a cell's limits are set from: the program's and the
control's, on many seeds in one process.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 --seconds 5 [--out FILE]

For each seed: the cell's set-up and a window of ``--seconds`` (at the
cell's own load), then each number the check compares, read twice from the
same outputs: once for the program, and once for the control, the float64
reference put in the program's place and computed in TF32, the precision
just below the program's float32 with TF32 off. Prints one JSON line a
seed; the benchmark's own runs never run this. Needs the CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR.parent))


def readings(workload: str, seeds, seconds: float, device=None, precision: str = "tf32",
             bench_dir: Path = BENCH_DIR):
    """Yield, per seed, the worst of each number over the kept outputs,
    for the program and for the control."""
    import torch

    from perfbench.lib import registry
    from perfbench.lib.seeds import sync, worse

    cell = registry.load_cell(workload, bench_dir)
    device = device or torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in seeds:
        work = cell.entry.Workload(cell.config, cell.traffic, cell.limits, seed, device)
        t0 = time.perf_counter()
        work.setup()
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        while (time.perf_counter() - t0 < seconds
               or work.attempted < getattr(work, "min_units", 1)):
            work.unit()
        sync(device)
        work.release()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out = {"seed": seed, "setup_s": setup_s, "units": work.attempted,
               "failed": work.failed, "program": {}, "control": {}}
        for claim in work.claims:
            for side, prec in (("program", "program"), ("control", precision)):
                for k, v in work.readings(claim, device, prec).items():
                    out[side][k] = worse(v, out[side].get(k))
        yield out
        del work
        gc.collect()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("[control] no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    for line in readings(args.workload, seeds, args.seconds):
        text = json.dumps({"workload": args.workload, **line})
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
