"""Kernel times on the card: device time, call time, bounds, and the K1 timing.

    python3 bark_tpu_torch/benchmarks/kernel_timing.py [--tree DIR] [--out FILE] [--sweep]

Times K1 (the leaf-agreement Gram, ``ops/gram.py``) at the dense tier's
(64, 50, 50) and (64, 200, 200), called as the sampler calls it (the same
leaves and mask twice), and at the predict-shaped (64, 1024, 200); m = 50
trees, ids below node_limit = 64. For each shape it prints one JSON line
with the kernel's device time, its call time, the bf16 one-hot product
(``torch.bmm``, its counts checked against the plain version), the bound
and the share of it. ``--tree`` imports ``bark_tpu_torch`` from another
checkout, so that one call can time two trees in turns; ``--sweep`` also
times each tile of the launch plan. Needs a CUDA device.

Two times, in milliseconds per call:

- ``device_ms``: the kernels' own duration from ``torch.profiler`` (the sum
  of the matching device kernels over ``calls`` calls, divided by calls;
  ``kernel_ms`` splits it by kernel);
- ``call_ms``: the median over 25 repetitions of CUDA events around 10
  calls back to back, the host's enqueueing included.

Bounds use one H100 SXM's published peaks: 3.35 TB/s of HBM, 67 TFLOP/s
float32 outside the tensor cores (the table's only non-tensor rate; a K1
compare-and-add counts as two operations).
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
K1_SHAPES = ((64, 50, 50), (64, 200, 200), (64, 1024, 200))
K1_TREES = 50
K1_NODE_LIMIT = 64


def bound(bytes_: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """(least ms, what binds): the larger of bytes over HBM and ops over peak."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(b: int, n: int, mcols: int, m: int, symmetric: bool, masked: bool):
    """K1's bound: each distinct input read once (one leaves tensor and one
    mask for a symmetric call), the float32 Gram written once; N * M * m
    compare-and-adds."""
    reads = b * n * m + (0 if symmetric else b * mcols * m)
    if masked:
        reads += n + (0 if symmetric else mcols)
    return bound(4.0 * (reads + b * n * mcols), 2.0 * b * n * mcols * m)


def k2_bound(b: int, n: int):
    """K2's bound: A read once, L and E written once; 2 n^3 / 3 flops."""
    return bound(3 * 4.0 * b * n * n, b * 2.0 * n**3 / 3.0)


def call_ms(torch, fn, reps: int = 25, inner: int = 10, warmup: int = 5) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` calls / inner."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(torch, fn, match: str | None = None, calls: int = 20):
    """(ms per call, kernels per call, {kernel: ms per call}) from
    ``torch.profiler``: the device kernels whose name contains ``match`` (all
    of them when None) over ``calls`` calls. (None, 0, {}) when the profiler
    saw no device kernel.

    The profiler sometimes drops events. So each kernel's time per call is
    its mean duration over the events that were captured, times its launches
    per call, taken as captured / calls rounded to the nearest whole number
    (at least 1): right for a kernel launched k times a call while fewer
    than calls / 2 of its k * calls events are lost.
    """
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_ms, per_call_total, split = 0.0, 0, {}
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")) or ev.count == 0:
            continue
        if match is not None and match not in ev.key:
            continue
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        per_call = max(1, round(ev.count / calls))
        ms = us / ev.count * per_call / 1e3
        total_ms += ms
        per_call_total += per_call
        short = re.search(r"::(\w+(?:<[^>]*>)?)", ev.key)
        name = short.group(1) if short else ev.key[:40]
        split[name] = split.get(name, 0.0) + ms
    if per_call_total == 0:
        return None, 0, {}
    return total_ms, per_call_total, split


def onehot_bf16(torch, leaves, node_limit: int):
    """(B, N, m) ids -> (B, N, m * node_limit) bf16 one-hot."""
    b, n, m = leaves.shape
    hot = torch.nn.functional.one_hot(leaves.long(), node_limit)
    return hot.reshape(b, n, m * node_limit).to(torch.bfloat16)


def time_k1(torch, gram, l1, l2, mask1, mask2, node_limit: int,
            plain_reps: int = 25, plain_inner: int = 10) -> dict:
    """Device and call time of ``gram.gram_cuda`` on these
    arguments; the bf16 one-hot ``torch.bmm`` on the same leaves (built
    outside the timed region; its counts must equal the plain version's
    times m); the bound and the share of it. ``plain_reps`` x
    ``plain_inner`` calls time the plain version (fewer at a large shape,
    where one call takes tens of ms)."""
    b, n, m = l1.shape
    mcols = l2.shape[1]
    symmetric = l1 is l2 and mask1 is mask2
    run = lambda: gram.gram_cuda(l1, l2, mask1, mask2)  # noqa: E731
    dev, per_call, split = device_ms(torch, run, "gram")
    call = call_ms(torch, run)
    plain = call_ms(torch, lambda: gram.gram_plain(l1, l2, mask1, mask2),
                    reps=plain_reps, inner=plain_inner, warmup=2)
    a = onehot_bf16(torch, l1, node_limit)
    bt = onehot_bf16(torch, l2, node_limit).transpose(1, 2).contiguous()
    counts = torch.bmm(a, bt)
    want = torch.round(gram.gram_plain(l1, l2) * m)
    torch.cuda.synchronize()
    if not torch.equal(counts.float(), want):
        raise RuntimeError(f"one-hot bmm counts differ from the plain version at {tuple(l1.shape)}")
    lib_dev, _, _ = device_ms(torch, lambda: torch.bmm(a, bt))
    del a, bt, counts
    bound_ms, bound_by = k1_bound(b, n, mcols, m, symmetric, mask1 is not None)
    return {
        "shape": [b, n, mcols], "m": m, "symmetric": symmetric,
        "device_ms": dev, "kernels_per_call": per_call, "kernel_ms": split,
        "call_ms": call, "plain_ms": plain, "library_ms": lib_dev,
        "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / dev,
    }


def time_k2(torch, fn, plain_fn, batch: int, n: int, match: str | None = None,
            reps: int = 25, inner: int = 10) -> dict:
    """Device and call time of ``fn`` (a K2 call, or ``blocked_cholesky`` with
    its matmuls: ``match`` None sums every device kernel of the call), the
    plain version's call time and its device time (cuSOLVER, the library
    row), and K2's bound at (batch, n, n)."""
    dev, per_call, _ = device_ms(torch, fn, match)
    call = call_ms(torch, fn, reps=reps, inner=inner)
    plain = call_ms(torch, plain_fn, reps=reps, inner=inner)
    lib, _, _ = device_ms(torch, plain_fn)
    bound_ms, bound_by = k2_bound(batch, n)
    return {
        "shape": [batch, n, n], "device_ms": dev, "kernels_per_call": per_call,
        "call_ms": call, "plain_ms": plain, "library_ms": lib, "bound_ms": bound_ms,
        "bound_by": bound_by, "share_of_bound": None if dev is None else bound_ms / dev,
    }


def k1_arguments(torch, shape, dev, seed: int = 0):
    """Leaves and mask as the timed calls take them: the same leaves and
    all-ones mask twice at a square shape (the sampler's call), two leaves
    tensors and no mask otherwise."""
    import numpy as np

    b, n, mcols = shape
    rng = np.random.default_rng(seed)
    ids = lambda rows: torch.as_tensor(  # noqa: E731
        rng.integers(0, K1_NODE_LIMIT, (b, rows, K1_TREES)), dtype=torch.int32, device=dev
    )
    if n == mcols:
        leaves, mask = ids(n), torch.ones(n, device=dev)
        return leaves, leaves, mask, mask
    return ids(n), ids(mcols), None, None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose bark_tpu_torch is timed")
    ap.add_argument("--out", default=None, help="also append the JSON lines here")
    ap.add_argument("--sweep", action="store_true", help="time every tile of the plan")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("kernel_timing: no CUDA device", file=sys.stderr)
        return 1
    from bark_tpu_torch.ops import gram

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    lines = []
    for shape in K1_SHAPES:
        l1, l2, m1, m2 = k1_arguments(torch, shape, dev)
        got = gram.gram_cuda(l1, l2, m1, m2)
        if not torch.equal(got, gram.gram_plain(l1, l2, m1, m2)):
            raise RuntimeError(f"K1 differs from its plain version at {shape}")
        row = {"tree": args.tree, "card": smi,
               **time_k1(torch, gram, l1, l2, m1, m2, K1_NODE_LIMIT)}
        if args.sweep and hasattr(gram, "launch_plan"):
            b, n, mcols = shape
            chosen = gram.launch_plan(b, n, mcols, K1_TREES, symmetric=row["symmetric"])
            row["tile"] = chosen.tile
            row["tiles"] = {}
            for tile, _ in gram.TILES:
                plan = gram.launch_plan(b, n, mcols, K1_TREES, symmetric=row["symmetric"],
                                        tile=tile)
                run = lambda: gram.launch(plan, l1, l2, m1, m2)  # noqa: E731
                if not torch.equal(run(), got):
                    raise RuntimeError(f"K1 tile {tile} differs at {shape}")
                row["tiles"][tile] = device_ms(torch, run, "gram")[0]
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
