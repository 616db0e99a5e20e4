"""Benchmark base class and registry.

Counterpart of ``bark_tpu/benchmarks/base.py``: each benchmark provides
``.domain`` and ``.f(X)``, where ``f`` takes ordinal-encoded points ``(N, D)``
(the encoding the surrogates train on; dict input goes through
``Domain.transform``) and returns ``(N,)`` outputs. Registered names resolve
through :func:`map_benchmark`, which covers every name of the reference's
registry. Benchmarks that train a model per evaluation import sklearn,
pandas or xgboost when they are built, through :func:`require_package`.
"""

from __future__ import annotations

import importlib

import numpy as np

from bark_tpu_torch.domain import Domain

BENCHMARK_MAP: dict[str, type] = {}


def require_package(module: str, what: str):
    """Import ``module`` or raise naming its package, where it is not
    installed: nothing switches to another objective quietly."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise RuntimeError(f"{what} needs {module.split('.')[0]}, which is not installed") from e


def register_benchmark(name: str):
    def deco(cls):
        BENCHMARK_MAP[name] = cls
        cls.name = name
        return cls

    return deco


def map_benchmark(name: str, **kwargs):
    """Instantiate a registered benchmark by name."""
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
