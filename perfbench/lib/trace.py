"""What a traced run reads: the device trace of a short steady part, the
launches of K1 and K2 in it with their logical sizes, a second capture of
the same part with the host's operations (for the breakdown alone), and
the host's synchronisations in a whole unit.

The trace is held in memory (``torch.profiler``'s raw events) and reduced
to plain tuples; nothing is written to disk.
"""

from __future__ import annotations

import sys
import time
import warnings
from dataclasses import dataclass, field

import torch

K1_KERNELS = ("gram_kernel", "gram_planes_kernel")
K2_KERNELS = ("chol_inv_kernel",)
_COPIES = ("Memcpy", "Memset")


@dataclass
class Event:
    name: str
    start_ns: int
    dur_ns: int


@dataclass
class Trace:
    """A profiled part: device events (kernels, copies and fills), the host
    operations beside them, the host seconds it took, and what the
    launch recorders saw."""

    device: list[Event]
    host: list[Event]
    window_s: float
    k1: list[dict] = field(default_factory=list)
    k2: list[dict] = field(default_factory=list)

    def kernels(self) -> list[Event]:
        return [e for e in self.device if not e.name.startswith(_COPIES)]

    def named(self, names) -> list[Event]:
        return [e for e in self.device if any(n in e.name for n in names)]

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device events' intervals, sorted."""
        spans = sorted((e.start_ns, e.start_ns + e.dur_ns) for e in self.device)
        out: list[list[int]] = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9


class LaunchRecorder:
    """Wraps the program's K1 launch (``ops.gram.launch``) and K2 launch
    (``ops.chol.chol_inv_cuda``) in their modules while it is entered, and
    records each call's sizes in order. It keeps the masks of K1 and the
    input of K2 by reference, so that the rows holding data are counted
    after the profiled part, off its clock; it forwards the call and its
    counter untouched."""

    def __init__(self):
        self.k1: list[dict] = []
        self.k2: list[dict] = []
        self._saved = []

    def __enter__(self):
        from bark_tpu_torch.ops import chol, gram

        launch, chol_inv_cuda = gram.launch, chol.chol_inv_cuda

        def k1(plan, l1, l2, mask1=None, mask2=None):
            b, n, m = l1.shape
            self.k1.append({"b": b, "n": n, "mcols": l2.shape[1], "m": m,
                            "symmetric": bool(plan.symmetric), "mask1": mask1, "mask2": mask2})
            return launch(plan, l1, l2, mask1, mask2)

        def k2(a):
            self.k2.append({"a": a})
            return chol_inv_cuda(a)

        # the launch counts itself through its module's global name, which
        # names the wrapper while it is in place
        k2.launches = chol_inv_cuda.launches
        self._saved = [(gram, "launch", launch), (chol, "chol_inv_cuda", chol_inv_cuda)]
        gram.launch, chol.chol_inv_cuda = k1, k2
        return self

    def __exit__(self, *exc):
        chol, _, chol_inv_cuda = self._saved[1]
        chol_inv_cuda.launches = chol.chol_inv_cuda.launches
        for module, name, fn in self._saved:
            setattr(module, name, fn)
        return False

    def logical(self) -> tuple[list[dict], list[dict]]:
        """The launches with the rows that hold data: a K1 input's rows are
        those its mask keeps (all rows without a mask); a K2 matrix's rows
        are those with an entry off the diagonal (a row of the caller's
        padding, or an unused leaf slot, holds its diagonal alone)."""
        k1 = []
        for r in self.k1:
            rows = lambda mask, n: n if mask is None else int((mask[..., :n] != 0).sum(-1).max())  # noqa: E731
            k1.append({"b": r["b"], "n": rows(r["mask1"], r["n"]),
                       "mcols": rows(r["mask2"], r["mcols"]), "m": r["m"],
                       "symmetric": r["symmetric"], "masked": r["mask1"] is not None})
        k2 = []
        for r in self.k2:
            a = r["a"]
            off = a - torch.diag_embed(torch.diagonal(a, dim1=-2, dim2=-1))
            rows = (off != 0).any(-1).sum(-1)
            k2.append({"rows": [int(x) for x in rows.cpu()]})
        self.k1, self.k2 = [], []
        return k1, k2


def _events(prof) -> tuple[list[Event], list[Event]]:
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        ev = Event(e.name(), int(e.start_ns()), int(e.duration_ns()))
        (device if "CUDA" in str(e.device_type()) else host).append(ev)
    return device, host


def profile(fn, attempts: int = 3) -> Trace:
    """Run ``fn`` under ``torch.profiler``, the device's activity alone (no
    host operations, which would lengthen the part), with the launch
    recorders on, from one synchronisation to the next. The profiler at
    times drops a part's device events: a capture whose K1 or K2 events do
    not match the recorded launches one for one is taken again, up to
    ``attempts``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for attempt in range(attempts):
        torch.cuda.synchronize()
        with LaunchRecorder() as rec, torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        device, host = _events(prof)
        k1, k2 = rec.logical()
        trace = Trace(device, host, window_s, k1, k2)
        k1_events = len([e for e in trace.named(("gram_kernel",)) if "planes" not in e.name])
        k2_events = len(trace.named(K2_KERNELS))
        if (k1_events, k2_events) == (len(k1), len(k2)) and trace.device:
            return trace
        print(f"[perfbench] profile attempt {attempt + 1}: {k1_events} K1 and {k2_events} K2 "
              f"kernels captured for {len(k1)} and {len(k2)} launches", file=sys.stderr)
    return trace


def host_capture(fn, stop_hook=None) -> Trace:
    """A second capture, for the breakdown alone: ``fn`` under
    ``torch.profiler`` with the host's operations beside the device's. With
    ``stop_hook``, the capture ends early: ``stop_hook(stop)`` is handed the
    function that ends it, and ``fn`` runs on past it unprofiled."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    prof = torch_profile(activities=[ProfilerActivity.CUDA, ProfilerActivity.CPU])
    span = {}

    def stop():
        if "s" not in span:
            torch.cuda.synchronize()
            span["s"] = time.perf_counter() - span["t0"]
            prof.stop()

    if stop_hook is not None:
        stop_hook(stop)
    torch.cuda.synchronize()
    prof.start()
    span["t0"] = time.perf_counter()
    fn()
    stop()
    device, host = _events(prof)
    return Trace(device, host, span["s"])


def count_syncs(fn) -> int:
    """The host's synchronisations with the device inside ``fn``, from
    CUDA's sync debug mode (one warning each)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(w.message) for w in caught)


def breakdown(trace: Trace, host_trace: Trace | None = None, top: int = 10) -> dict:
    """The device operations that took most time in ``trace``, summed by
    name, and the longest idle stretches of ``host_trace`` (the capture
    with the host's operations; ``trace`` itself without one) summed by the
    host operation running across their middle (the innermost one;
    ``python`` where none was)."""
    ops: dict[str, float] = {}
    for e in trace.device:
        ops[e.name] = ops.get(e.name, 0.0) + e.dur_ns / 1e9
    named = trace if host_trace is None else host_trace
    busy = named.busy_intervals()
    host = sorted(named.host, key=lambda e: e.start_ns)
    gaps: dict[str, float] = {}
    stretches = sorted(((a + b) // 2, b - a) for (_, a), (b, _) in zip(busy, busy[1:]))
    active: list[Event] = []
    i = 0
    for mid, length in stretches:
        while i < len(host) and host[i].start_ns <= mid:
            active.append(host[i])
            i += 1
        active = [e for e in active if e.start_ns + e.dur_ns >= mid]
        name = max(active, key=lambda e: e.start_ns).name if active else "python"
        gaps[name] = gaps.get(name, 0.0) + length / 1e9
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}
