"""Benchmark base class and registry.

Counterpart of ``bark_tpu/benchmarks/base.py``: each benchmark provides
``.domain`` and ``.f(X)``, where ``f`` takes ordinal-encoded points ``(N, D)``
(the encoding the surrogates train on; dict input goes through
``Domain.transform``) and returns ``(N,)`` outputs. Registered names resolve
through :func:`map_benchmark`; a name of the reference's registry that the
port does not have yet raises ``NotImplementedError`` naming the ROADMAP
item that brings it.
"""

from __future__ import annotations

import numpy as np

from bark_tpu_torch.domain import Domain

BENCHMARK_MAP: dict[str, type] = {}

#: names of the reference's registry still to be ported (ROADMAP.md queue 1)
NOT_PORTED = ("CCOBench", "DatasetBenchmark", "MAXBandit", "SVRBench", "ToyReaction",
              "XGBoostMNIST")


def register_benchmark(name: str):
    def deco(cls):
        BENCHMARK_MAP[name] = cls
        cls.name = name
        return cls

    return deco


def map_benchmark(name: str, **kwargs):
    """Instantiate a registered benchmark by name."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"benchmark {name!r} is not ported yet (ROADMAP.md queue 1); the port "
            f"has {sorted(BENCHMARK_MAP)}"
        )
    return BENCHMARK_MAP[name](**kwargs)


class Benchmark:
    """A black-box objective over a mixed domain (minimization)."""

    name: str = "benchmark"

    def __init__(self, domain: Domain):
        self._domain = domain

    @property
    def domain(self) -> Domain:
        return self._domain

    def _f(self, X: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def f(self, X) -> np.ndarray:
        """Evaluate at ordinal-encoded points (accepts dict input too)."""
        X = self.domain.transform(X)
        return np.asarray(self._f(np.asarray(X, np.float64))).reshape(-1)

    def get_optima(self) -> tuple[np.ndarray, float] | None:
        """Return (argmin as ordinal-encoded (D,), min value) if known."""
        return None
