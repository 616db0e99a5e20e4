"""Reductions shared by the per-layer metric readers (``metrics/*.py``).

A reader takes the traced run's context (``ctx``: the profiled part's
:class:`~perfbench.lib.trace.Trace`, the entry's counts and the harness's
spans) and returns its number, or None where the run has nothing for it to
read; the harness then leaves the metric out.
"""

from __future__ import annotations

import statistics
import sys

from perfbench.lib.trace import K1_KERNELS, K2_KERNELS
from perfbench.roofline.counts import bound_s, k1_work, k2_work
from perfbench.roofline.peaks import FP32_FLOPS_PER_S


def span_mean(ctx: dict, name: str) -> float | None:
    values = ctx.get("spans", {}).get(name)
    return statistics.fmean(values) if values else None


def roofline(ctx: dict, kernel: str) -> float | None:
    """A kernel's share of its roofline in the profiled part, in %: the sum
    of its launches' bounds at their logical sizes over the sum of its
    device time (K1: the plane pass and the Gram kernel of each launch)."""
    trace = ctx.get("trace")
    if trace is None:
        return None
    if kernel == "k1":
        launches = trace.k1
        events = trace.named(K1_KERNELS)
        counted = len([e for e in events if "planes" not in e.name])
        bound = sum(bound_s(*k1_work(r["b"], r["n"], r["mcols"], r["m"], r["symmetric"],
                                     r["masked"])) for r in launches)
    else:
        launches = trace.k2
        events = trace.named(K2_KERNELS)
        counted = len(events)
        bound = sum(bound_s(*k2_work(r["rows"])) for r in launches)
    if not launches:
        return None
    if counted != len(launches):
        print(f"[perfbench] {kernel}: {counted} kernels traced for {len(launches)} launches; "
              "no roofline share", file=sys.stderr)
        return None
    device_s = sum(e.dur_ns for e in events) / 1e9
    return 100.0 * bound / device_s


def idle_share(ctx: dict) -> float | None:
    trace = ctx.get("trace")
    if trace is None or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def launches_per_step(ctx: dict) -> float | None:
    trace = ctx.get("trace")
    if trace is None or not ctx.get("profiled_steps"):
        return None
    return len(trace.kernels()) / ctx["profiled_steps"]


def mfu(flops: float | None, seconds: float | None) -> float | None:
    """Floating-point work over time against float32 peak, in %."""
    if not flops or not seconds:
        return None
    return 100.0 * flops / seconds / FP32_FLOPS_PER_S
