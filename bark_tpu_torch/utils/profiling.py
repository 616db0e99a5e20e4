"""Tracing and profiling hooks: device traces, annotations, throughput.

Counterpart of ``bark_tpu/utils/profiling.py`` on ``torch.profiler``:

  - :func:`trace` records the host and, where there is a GPU, the device
    timeline of the enclosed block and writes it as a Chrome trace (open
    in Perfetto or ``chrome://tracing``); the profile object is yielded,
    so ``key_averages()`` gives the time by kernel;
  - :func:`annotate` names a region (``record_function``), so BO phases
    (fit, acquire, predict) show in the trace;
  - :class:`ThroughputMeter` measures units per second across calls and
    synchronises the CUDA device at both ends of a timed region, since
    PyTorch returns before the device has finished.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block; write ``log_dir/trace.json``.

    Usage::

        with profiling.trace("traces/fit") as prof:
            samples = run_bark_sampler(...)
        print(prof.key_averages().table(sort_by="cuda_time_total"))
    """
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str):
    """A named region of a trace (``torch.profiler.record_function``)."""
    with record_function(name):
        yield


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class ThroughputMeter:
    """Units per second: ``meter.start(); ...; meter.stop(n_units)``.

    Both ends synchronise the CUDA device, so a region counts the device
    work launched inside it and none from before; ``rate`` is the total
    over every region."""

    def __init__(self):
        self.total_units = 0.0
        self.total_seconds = 0.0
        self._t0 = None

    def start(self):
        _sync()
        self._t0 = time.perf_counter()
        return self

    def stop(self, n_units: float) -> float:
        _sync()
        dt = time.perf_counter() - self._t0
        self.total_units += n_units
        self.total_seconds += dt
        return n_units / dt

    @property
    def rate(self) -> float:
        return self.total_units / max(self.total_seconds, 1e-12)
