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
  ``kernel_ms`` splits it by kernel). Where every profiler capture misses
  the kernels, CUDA events around ``calls`` calls queued behind a device
  spin take its place (``event_ms``), and ``device_source`` says which;
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
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
K1_SHAPES = ((64, 50, 50), (64, 200, 200), (64, 1024, 200))
K1_TREES = 50
K1_NODE_LIMIT = 64
_CAPTURES = 3  # profiler captures device_ms takes before it refuses a short one


def bound(bytes_: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """(least ms, what binds): the larger of bytes over HBM and ops over peak."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(b: int, n: int, mcols: int, m: int, symmetric: bool, masked: bool):
    """K1's bound: each distinct input read once (one leaves tensor and one
    mask for a symmetric call), the float32 Gram written once; N * M * m
    compare-and-adds, or N (N + 1) / 2 * m for a symmetric call, whose
    lower triangle is a mirror of the upper."""
    reads = b * n * m + (0 if symmetric else b * mcols * m)
    if masked:
        reads += n + (0 if symmetric else mcols)
    pairs = n * (n + 1) / 2 if symmetric else n * mcols
    return bound(4.0 * (reads + b * n * mcols), 2.0 * b * pairs * m)


def k2_bound(b: int, n: int):
    """K2's bound: A read once, L and E written once; 2 n^3 / 3 flops."""
    return bound(3 * 4.0 * b * n * n, b * 2.0 * n**3 / 3.0)


def k3_bound(c: int, n: int, m: int):
    """K3's bound for c chains of m moves at N rows: K^-1, y, the patterns and
    the per-chain and per-move scalars read once, the accepts and log alphas
    written once; 8 m N^2 flops a chain (two products of K^-1 with the
    move's rank-2 indicator and the rank-2 update, as
    ``perfbench/roofline/counts.dense_step_flops`` counts the scan)."""
    reads = 4.0 * (c * n * n + n + c * m * n * 2 + 4 * c + 2 * c * m)
    return bound(reads + 5.0 * c * m, 8.0 * c * m * n * n)


def k4_bound(c: int, m: int, node_limit: int, n: int, d: int):
    """K4's bound for c chains of m trees: the packed trees read and the
    proposed ones written (32 B a slot each way), the noise read (6 uniforms
    and node_limit Gumbels a tree), the current leaves read and both leaf
    tensors written (4 B a point a tree each), X, the bounds and the feature
    types read once, log q, move and node written; no flops counted."""
    trees = c * m
    bytes_ = 4.0 * (trees * (16 * node_limit + 6 + node_limit + 3 * n + 3) + n * d + 3 * d)
    return bound(bytes_, 0.0)


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


def device_ms(torch, fn, match: str | None = None, calls: int = 20,
              launches: int | None = None):
    """(ms per call, kernels per call, {kernel: ms per call}) from
    ``torch.profiler``: the device kernels whose name contains ``match`` (all
    of them when None) over ``calls`` calls (see :func:`summarise_events`).
    ``launches`` is the number of such kernels one call launches, where the
    caller knows it: a capture that holds fewer than half of them is taken
    again, up to ``_CAPTURES`` captures, and then refused."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(_CAPTURES):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        try:
            return summarise_events(prof.key_averages(), calls, match, launches)
        except RuntimeError as err:
            if attempt + 1 == _CAPTURES:
                raise RuntimeError(f"{err} (in each of {_CAPTURES} captures)") from None
            print(f"kernel_timing: {err}; capturing again", file=sys.stderr, flush=True)


def event_ms(torch, fn, calls: int = 20, reps: int = 3) -> float:
    """ms per call from CUDA events around ``calls`` calls, the median of
    ``reps``. A device spin (``torch.cuda._sleep``) ahead of the start event
    lasts twice the host's time to queue the calls, so the events time the
    device running them back to back, not the host launching them. It
    covers every kernel ``fn`` launches."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    khz = getattr(torch.cuda.get_device_properties(torch.cuda.current_device()),
                  "clock_rate", 0) or 2_000_000
    spin = min(int(2 * host_s * khz * 1e3) + 1_000_000, 2_000_000_000)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def kernel_time(torch, fn, match: str | None = None, launches: int | None = None):
    """(ms per call, kernels per call, {kernel: ms}, source): ``device_ms``,
    or ``event_ms`` where every profiler capture came up short or empty
    (kernels per call is then ``launches``, the split empty). ``source`` is
    "profiler" or "events"."""
    try:
        got = device_ms(torch, fn, match, launches=launches)
        if got[0] is not None:
            return (*got, "profiler")
        err = f"the profiler captured no device kernel ({match or 'any'})"
    except RuntimeError as exc:
        err = str(exc)
    print(f"kernel_timing: {err}; timing with CUDA events", file=sys.stderr, flush=True)
    return event_ms(torch, fn), launches, {}, "events"


def summarise_events(events, calls: int, match: str | None = None,
                     launches: int | None = None):
    """Device time per call from profiler averages (``key_averages()``:
    objects with ``key``, ``count``, ``device_type`` and
    ``device_time_total`` in us, or ``cuda_time_total`` in older torch).

    The profiler sometimes drops events. So each kernel's time per call is
    its mean duration over the events that were captured, times its launches
    per call, taken as captured / calls rounded to the nearest whole number
    (at least 1): right for a kernel launched k times a call while fewer
    than calls / 2 of its k * calls events are lost. With ``launches`` (the
    device kernels one call launches) a capture of fewer than half of the
    ``launches * calls`` events raises, rather than time what it missed.
    Returns (None, 0, {}) when no device kernel matched and no count was
    expected.
    """
    total_ms, per_call_total, captured, split = 0.0, 0, 0, {}
    for ev in events:
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
        captured += ev.count
        short = re.search(r"::(\w+(?:<[^>]*>)?)", ev.key)
        name = short.group(1) if short else ev.key[:40]
        split[name] = split.get(name, 0.0) + ms
    if launches is not None and captured < 0.5 * launches * calls:
        raise RuntimeError(
            f"the profiler captured {captured} of the {launches * calls} device kernels "
            f"{calls} calls launch ({match or 'any'}): too few to time"
        )
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
    # a plane pass per distinct leaves tensor, then the Gram kernel
    dev, per_call, split, source = kernel_time(torch, run, "gram", (1 if l1 is l2 else 2) + 1)
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
    # at least one device kernel a call: an empty capture is taken again
    lib_dev, _, _, lib_source = kernel_time(torch, lambda: torch.bmm(a, bt), launches=1)
    del a, bt, counts
    bound_ms, bound_by = k1_bound(b, n, mcols, m, symmetric, mask1 is not None)
    return {
        "shape": [b, n, mcols], "m": m, "symmetric": symmetric,
        "device_ms": dev, "kernels_per_call": per_call, "kernel_ms": split,
        "call_ms": call, "plain_ms": plain, "library_ms": lib_dev,
        "device_source": source, "library_source": lib_source,
        "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / dev,
    }


def time_k2(torch, fn, plain_fn, batch: int, n: int, match: str | None = None,
            reps: int = 25, inner: int = 10, launches: int | None = None) -> dict:
    """Device and call time of ``fn`` (a K2 call, or ``blocked_cholesky`` with
    its matmuls: ``match`` None sums every device kernel of the call), the
    plain version's call time and its device time (cuSOLVER, the library
    row), and K2's bound at (batch, n, n). ``launches``: the matching
    kernels of one call (one K2 launch when ``match`` names K2)."""
    if launches is None and match is not None:
        launches = 1
    dev, per_call, _, source = kernel_time(torch, fn, match, launches)
    call = call_ms(torch, fn, reps=reps, inner=inner)
    plain = call_ms(torch, plain_fn, reps=reps, inner=inner)
    lib, _, _, lib_source = kernel_time(torch, plain_fn, launches=1)
    bound_ms, bound_by = k2_bound(batch, n)
    return {
        "shape": [batch, n, n], "device_ms": dev, "kernels_per_call": per_call,
        "call_ms": call, "plain_ms": plain, "library_ms": lib, "bound_ms": bound_ms,
        "device_source": source, "library_source": lib_source,
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
