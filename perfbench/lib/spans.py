"""The program's own spans in the capture that holds the host's operations
beside the device's (``ctx["host_trace"]``), and what falls in each.

``bark_tpu_torch`` opens its spans (names starting ``bark.``) with
``utils/profiling.annotate`` while a profiler records: ``bark.step`` with
``bark.step.propose``, ``bark.step.scan`` and ``bark.step.refresh`` inside
it; ``bark.ask`` with ``bark.ask.build`` and ``bark.ask.search``. They are
host operations of the same capture, so they share the device events'
clock. A program without them gives None for every reading here.

Attribution, for the readers of ``metrics/``:

- a launch (a runtime call named ``cudaLaunch*`` or ``cuLaunch*``) or a
  synchronising call (:data:`SYNCS`) belongs to the innermost span that
  contains its start;
- an idle stretch between two of the device's busy intervals belongs to the
  innermost span open at its midpoint (the rule of ``trace.breakdown``);
- "a step" is a ``bark.step`` span of the capture, "an ask" a ``bark.ask``;
- a span's self time is its duration less the part its child spans cover.
"""

from __future__ import annotations

import bisect

from perfbench.lib.trace import Event, Trace

PREFIX = "bark."
LAUNCHES = ("cudaLaunch", "cuLaunch")
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                   "cudaMemcpy"})


class Spans:
    """The ``bark.`` spans of one capture, sorted by start, and the
    innermost one open at a time."""

    def __init__(self, trace: Trace):
        self.trace = trace
        self.spans = sorted((e for e in trace.host if e.name.startswith(PREFIX)),
                            key=lambda e: e.start_ns)
        self._starts = [e.start_ns for e in self.spans]

    def __bool__(self) -> bool:
        return bool(self.spans)

    def count(self, name: str) -> int:
        return sum(e.name == name for e in self.spans)

    def innermost(self, t: int) -> Event | None:
        """The innermost span open at ``t``: of the spans that contain it
        (they nest), the one that started last."""
        i = bisect.bisect_right(self._starts, t)
        for e in reversed(self.spans[:i]):
            if e.start_ns + e.dur_ns >= t:
                return e
        return None

    def within(self, t: int, name: str) -> bool:
        """Is ``t`` inside a span named ``name``?"""
        i = bisect.bisect_right(self._starts, t)
        return any(e.name == name and e.start_ns + e.dur_ns >= t for e in self.spans[:i])

    def calls(self, kind: str) -> list[Event]:
        """The capture's launches (``kind`` "launches") or synchronising
        calls ("syncs") on the host."""
        if kind == "launches":
            return [e for e in self.trace.host if e.name.startswith(LAUNCHES)]
        return [e for e in self.trace.host if e.name in SYNCS]

    def calls_by_span(self, kind: str) -> dict[str | None, int]:
        """Launches or synchronising calls by the innermost span that
        contains their start (None: outside every span)."""
        out: dict[str | None, int] = {}
        for e in self.calls(kind):
            span = self.innermost(e.start_ns)
            key = span.name if span is not None else None
            out[key] = out.get(key, 0) + 1
        return out

    def idle_ns_by_span(self) -> dict[str | None, int]:
        """The device's idle stretches, in ns, by the innermost span open at
        their midpoint (None: outside every span)."""
        busy = self.trace.busy_intervals()
        out: dict[str | None, int] = {}
        for (_, a), (b, _) in zip(busy, busy[1:]):
            span = self.innermost((a + b) // 2)
            key = span.name if span is not None else None
            out[key] = out.get(key, 0) + (b - a)
        return out

    def self_ns(self, name: str) -> int:
        """The summed self time of the spans named ``name``: each one's
        duration less the union of the spans nested inside it."""
        total = 0
        for i, e in enumerate(self.spans):
            if e.name != name:
                continue
            end = e.start_ns + e.dur_ns
            covered, reach = 0, e.start_ns
            for c in self.spans[i + 1:]:
                if c.start_ns > end:
                    break
                a, b = max(c.start_ns, reach), min(c.start_ns + c.dur_ns, end)
                if b > a:
                    covered += b - a
                    reach = b
            total += e.dur_ns - covered
        return total


def of(ctx: dict) -> Spans | None:
    """The spans of the run's host capture, or None where it holds none."""
    trace = ctx.get("host_trace")
    if trace is None:
        return None
    spans = Spans(trace)
    return spans if spans else None


def _per(ctx: dict, root: str, total) -> float | None:
    """``total(spans)`` over the number of ``root`` spans in the run's host
    capture; None where it holds none."""
    spans = of(ctx)
    count = spans.count(root) if spans is not None else 0
    return total(spans) / count if count else None


def per_step(ctx: dict, kind: str, span: str) -> float | None:
    """Launches or synchronising calls (``kind``) whose innermost span is
    ``span``, a step."""
    return _per(ctx, "bark.step", lambda s: s.calls_by_span(kind).get(span, 0))


def idle_ms_per_step(ctx: dict, span: str) -> float | None:
    """The device's idle ms under ``span`` (innermost), a step."""
    return _per(ctx, "bark.step", lambda s: s.idle_ns_by_span().get(span, 0) / 1e6)


def self_ms_per_ask(ctx: dict, span: str) -> float | None:
    """The self time of ``span`` in ms, an ask."""
    return _per(ctx, "bark.ask", lambda s: s.self_ns(span) / 1e6)


def launches_in_steps(ctx: dict) -> float | None:
    """Every launch inside a ``bark.step`` span (its children's too), a step."""
    return _per(ctx, "bark.step", lambda s: sum(s.within(e.start_ns, "bark.step")
                                                 for e in s.calls("launches")))
