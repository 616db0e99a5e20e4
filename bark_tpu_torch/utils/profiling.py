"""Tracing hooks: device traces and the program's own spans.

Counterpart of ``bark_tpu/utils/profiling.py`` on ``torch.profiler``:

  - :func:`trace` records the host and, where there is a GPU, the device
    timeline of the enclosed block and writes it as a Chrome trace (open
    in Perfetto or ``chrome://tracing``); the profile object is yielded,
    so ``key_averages()`` gives the time by kernel;
  - :func:`annotate` names a region of the host's work. The program opens
    its spans with it: ``bark.step`` (one sampler step of ``run_chain``)
    with ``bark.step.propose`` (the proposal batch), ``bark.step.scan``
    (the move scan) and ``bark.step.refresh`` (the noise move and the new
    state) inside it, and ``bark.ask`` (one ask of ``TreeKernelStrategy``)
    with ``bark.ask.build`` (the acquisition state) and ``bark.ask.search``.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

TRACE_FILE = "trace.json"
_OFF = contextlib.nullcontext()


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


def annotate(name: str):
    """A named span of the host's work, recorded while a ``torch.profiler``
    records; a shared null context (one flag check) otherwise.

    The span is a plain host operation of the capture (``cpu_op``, not a
    user annotation), so the profiler mirrors nothing of it onto the
    device's timeline; it nests by containment on its thread, with its
    start and end on the profiler's clock."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)
