"""Seeds drawn from the run's ``--seed``, and small device helpers."""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for the part named by ``tags`` (strings or whole
    numbers) of the run seeded ``seed``: the same seed and tags give the
    same value, any seed up to 2**64 is taken whole."""
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF]
    for t in tags:
        words.append(zlib.crc32(t.encode()) if isinstance(t, str) else int(t) & 0xFFFFFFFF)
    return int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0] >> np.uint64(1))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def worse(a: float, b: float | None) -> float:
    """The larger of two readings; NaN, which no limit admits, wins."""
    if b is None or math.isnan(a):
        return a
    if math.isnan(b):
        return b
    return max(a, b)
