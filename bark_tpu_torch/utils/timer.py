"""Phase-keyed wall timers and the BO-trace logger.

Counterpart of ``bark_tpu/utils/timer.py``: the study runner records fit and
optimize seconds per iteration with a dict-based context-manager
:class:`Timer`. Device work is launched asynchronously, so a phase's clock
stops after ``torch.cuda.synchronize()`` when CUDA has been initialised (the
reference waits on ``jax.effects_barrier()``).
"""

from __future__ import annotations

import contextlib
import time

import torch


class Timer(dict):
    """``with timer("fit"): ...`` accumulates seconds per phase."""

    @contextlib.contextmanager
    def __call__(self, key: str, sync: bool = True):
        start = time.perf_counter()
        try:
            yield self
        finally:
            if sync and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self[key] = self.get(key, 0.0) + (time.perf_counter() - start)


class BOLogger:
    """Records the BO trace: proposals, observations, best-so-far, times."""

    def __init__(self):
        self.candidates = []
        self.observations = []
        self.best = []
        self.times = []

    def log_iteration(self, candidate, y, timer: Timer):
        self.candidates.append(candidate)
        y = float(y)
        self.observations.append(y)
        prev = self.best[-1] if self.best else float("inf")
        self.best.append(min(prev, y))
        self.times.append(dict(timer))

    def as_rows(self):
        for i, (y, b, t) in enumerate(zip(self.observations, self.best, self.times)):
            yield {"iteration": i, "y": y, "best": b, **t}
