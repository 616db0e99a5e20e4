"""Hartmann 6-D (numpy only): standard coefficients, global minimum -3.32237
at the known point. Counterpart of ``bark_tpu/benchmarks/hartmann.py``.
"""

from __future__ import annotations

import numpy as np

from bark_tpu_torch.benchmarks.base import Benchmark, register_benchmark
from bark_tpu_torch.domain import ContinuousInput, Domain

_ALPHA = np.array([1.0, 1.2, 3.0, 3.2])
_A = np.array(
    [
        [10, 3, 17, 3.5, 1.7, 8],
        [0.05, 10, 17, 0.1, 8, 14],
        [3, 3.5, 1.7, 10, 17, 8],
        [17, 8, 0.05, 10, 0.1, 14],
    ]
)
_P = 1e-4 * np.array(
    [
        [1312, 1696, 5569, 124, 8283, 5886],
        [2329, 4135, 8307, 3736, 1004, 9991],
        [2348, 1451, 3522, 2883, 3047, 6650],
        [4047, 8828, 8732, 5743, 1091, 381],
    ]
)


@register_benchmark("Hartmann")
class Hartmann(Benchmark):
    def __init__(self, dim: int = 6, **kwargs):
        assert dim == 6, "Hartmann is defined for 6 dimensions"
        self.dim = dim
        super().__init__(
            Domain([ContinuousInput(f"x_{i}", (0.0, 1.0)) for i in range(6)])
        )

    def _f(self, X):
        inner = np.sum(_A[None] * (X[:, None, :] - _P[None]) ** 2, axis=-1)
        return -np.sum(_ALPHA[None] * np.exp(-inner), axis=-1)

    def get_optima(self):
        x = np.array(
            [0.20169, 0.150011, 0.476874, 0.275332, 0.311652, 0.6573], np.float32
        )
        return x, -3.32237
