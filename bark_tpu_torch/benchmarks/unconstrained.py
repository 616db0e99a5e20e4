"""Continuous synthetic benchmarks (numpy only): Friedman, Rastrigin,
StyblinskiTang, Schwefel, all minimization.

Counterpart of ``bark_tpu/benchmarks/unconstrained.py``; a test holds each
equal to the original.
"""

from __future__ import annotations

import numpy as np

from bark_tpu_torch.benchmarks.base import Benchmark, register_benchmark
from bark_tpu_torch.domain import ContinuousInput, Domain


def _cont_domain(dim, lo, hi):
    return Domain([ContinuousInput(f"x_{i}", (lo, hi)) for i in range(dim)])


@register_benchmark("Friedman")
class Friedman(Benchmark):
    """Friedman's MARS test function."""

    def __init__(self, dim=10, **kwargs):
        assert dim >= 5
        self.dim = dim
        super().__init__(_cont_domain(dim, 0.0, 1.0))

    def _f(self, X):
        return (
            10 * np.sin(np.pi * X[:, 0] * X[:, 1])
            + 20 * (X[:, 2] - 0.5) ** 2
            + 10 * X[:, 3]
            + 5 * X[:, 4]
        )


@register_benchmark("Rastrigin")
class Rastrigin(Benchmark):
    """Rastrigin on (-4, 5)^dim; optimum 0 at the origin."""

    def __init__(self, dim=10, **kwargs):
        self.dim = dim
        super().__init__(_cont_domain(dim, -4.0, 5.0))

    def _f(self, X):
        return np.sum(X**2 - 10.0 * np.cos(2.0 * np.pi * X), axis=1) + 10.0 * self.dim

    def get_optima(self):
        return np.zeros(self.dim, np.float32), 0.0


@register_benchmark("StyblinskiTang")
class StyblinskiTang(Benchmark):
    """Styblinski-Tang on (-5, 5)^dim; optimum -39.16616 per dim at -2.903534."""

    def __init__(self, dim=10, **kwargs):
        self.dim = dim
        super().__init__(_cont_domain(dim, -5.0, 5.0))

    def _f(self, X):
        return 0.5 * np.sum(X**4 - 16 * X**2 + 5 * X, axis=1)

    def get_optima(self):
        x = np.full(self.dim, -2.903534, np.float32)
        return x, -39.16616 * self.dim


@register_benchmark("Schwefel")
class Schwefel(Benchmark):
    """Schwefel on (-500, 500)^dim."""

    def __init__(self, dim=10, **kwargs):
        self.dim = dim
        super().__init__(_cont_domain(dim, -500.0, 500.0))

    def _f(self, X):
        f = np.sum(X * np.sin(np.sqrt(np.abs(X))), axis=1)
        return 418.9829 * self.dim - f
