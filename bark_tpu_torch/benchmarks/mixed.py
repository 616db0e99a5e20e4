"""Mixed integer/categorical/continuous benchmarks (numpy only):
DiscreteAckley, DiscreteRosenbrock, PressureVessel, CombinationFunc2.

Counterpart of ``bark_tpu/benchmarks/mixed.py``; a test holds each equal to
the original.
"""

from __future__ import annotations

import numpy as np

from bark_tpu_torch.benchmarks.base import Benchmark, register_benchmark
from bark_tpu_torch.constraints import FunctionalInequalityConstraint
from bark_tpu_torch.domain import (
    CategoricalInput,
    ContinuousInput,
    Domain,
    build_integer_input,
)


@register_benchmark("DiscreteAckley")
class DiscreteAckley(Benchmark):
    """Binary + continuous Ackley; binaries map {0,1}->{-1,1}."""

    def __init__(self, discrete_dim=10, cont_dim=3, **kwargs):
        self.discrete_dim = discrete_dim
        self.dim = discrete_dim + cont_dim
        super().__init__(
            Domain(
                [
                    *(
                        build_integer_input(key=f"x_{i}", bounds=(0, 1))
                        for i in range(discrete_dim)
                    ),
                    *(
                        ContinuousInput(f"x_{i + discrete_dim}", (-1.0, 1.0))
                        for i in range(cont_dim)
                    ),
                ]
            )
        )

    def _f(self, X):
        x_int = 2 * X[:, : self.discrete_dim] - 1
        z = np.concatenate([x_int, X[:, self.discrete_dim :]], axis=1)
        a, b, c, d = 20.0, 0.2, 2 * np.pi, self.dim
        return (
            -a * np.exp(-b * np.sqrt(np.sum(z**2, axis=1) / d))
            - np.exp(np.sum(np.cos(c * z), axis=1) / d)
            + a
            + np.e
        )

    def get_optima(self):
        x = np.zeros(self.dim, np.float32)
        x[: self.discrete_dim] = 0  # maps to -1... optimum is at z=0: x_int=0.5
        # the true optimum z=0 is unattainable for the binary dims; the known
        # best has all binaries equal (z=+-1 pattern not exactly 0)
        return None


@register_benchmark("DiscreteRosenbrock")
class DiscreteRosenbrock(Benchmark):
    """Rosenbrock with integer dims in [-1, 2] scaled by 5."""

    def __init__(self, discrete_dim=6, cont_dim=4, **kwargs):
        self.discrete_dim = discrete_dim
        self.dim = discrete_dim + cont_dim
        super().__init__(
            Domain(
                [
                    *(
                        build_integer_input(key=f"x_{i}", bounds=(-1, 2))
                        for i in range(discrete_dim)
                    ),
                    *(
                        ContinuousInput(f"x_{i + discrete_dim}", (-5.0, 10.0))
                        for i in range(cont_dim)
                    ),
                ]
            )
        )

    def _f(self, X):
        z = np.concatenate(
            [5 * X[:, : self.discrete_dim], X[:, self.discrete_dim :]], axis=1
        )
        return np.sum(
            100 * (z[:, 1:] - z[:, :-1] ** 2) ** 2 + (1 - z[:, :-1]) ** 2, axis=1
        )


@register_benchmark("PressureVessel")
class PressureVessel(Benchmark):
    """Pressure vessel design: integer thicknesses (x 0.0625 inch) with
    linear + volumetric functional constraints; known optimum 6061.0778."""

    def __init__(self, **kwargs):
        def _pv_func(x):
            return -np.pi * x[3] * x[2] ** 2 - (4 / 3) * np.pi * x[2] ** 3

        super().__init__(
            Domain(
                [
                    build_integer_input(key="x_0", bounds=(1, 99)),
                    build_integer_input(key="x_1", bounds=(1, 99)),
                    ContinuousInput("x_2", (10.0, 200.0)),
                    ContinuousInput("x_3", (10.0, 200.0)),
                ],
                constraints=(
                    FunctionalInequalityConstraint(
                        func=lambda x: -x[2] * 0.0625 + x[0] * 0.0193, rhs=0.0
                    ),
                    FunctionalInequalityConstraint(
                        func=lambda x: -x[3] * 0.0625 + x[0] * 0.00954, rhs=0.0
                    ),
                    FunctionalInequalityConstraint(func=_pv_func, rhs=-1_296_000),
                ),
            )
        )

    def _f(self, X):
        return (
            0.6224 * (0.0625 * X[:, 0]) * X[:, 2] * X[:, 3]
            + 1.7781 * (0.0625 * X[:, 1]) * X[:, 2] ** 2
            + 3.1661 * X[:, 3] * (0.0625 * X[:, 0]) ** 2
            + 19.84 * X[:, 2] * (0.0625 * X[:, 0]) ** 2
        )

    def get_optima(self):
        return np.array([13, 7, 42.09127, 176.7466], np.float32), 6061.0778


@register_benchmark("CombinationFunc2")
class CombinationFunc2(Benchmark):
    """Categorical selection over {Rosenbrock, Camel, Beale} pairs summed on
    shared continuous inputs."""

    FUNCS = ("ros", "cam", "bea")

    def __init__(self, **kwargs):
        super().__init__(
            Domain(
                [
                    CategoricalInput("func_0", self.FUNCS),
                    CategoricalInput("func_1", self.FUNCS),
                    ContinuousInput("x_0", (-1.0, 1.0)),
                    ContinuousInput("x_1", (-1.0, 1.0)),
                ]
            )
        )

    @staticmethod
    def _rosenbrock(x):
        return np.sum(
            100 * (x[:, 1:] - x[:, :-1] ** 2) ** 2 + (1 - x[:, :-1]) ** 2, axis=1
        )

    @staticmethod
    def _camel(x):
        return (
            4 * x[:, 0] ** 2
            - 2.1 * x[:, 0] ** 4
            + x[:, 0] ** 6 / 3
            + x[:, 0] * x[:, 1]
            - 4 * x[:, 1] ** 2
            + 4 * x[:, 1] ** 4
        )

    @staticmethod
    def _beale(x):
        return (
            (1.5 - x[:, 0] + x[:, 0] * x[:, 1]) ** 2
            + (2.25 - x[:, 0] + x[:, 0] * x[:, 1] ** 2) ** 2
            + (2.625 - x[:, 0] + x[:, 0] * x[:, 1] ** 3) ** 2
        )

    def _f(self, X):
        x = X[:, 2:]
        table = np.stack(
            [self._rosenbrock(x), self._camel(x), self._beale(x)], axis=1
        )  # (N, 3)
        f0 = table[np.arange(len(x)), X[:, 0].astype(int)]
        f1 = table[np.arange(len(x)), X[:, 1].astype(int)]
        return f0 + f1
