"""Multi-fidelity benchmarks (numpy only).

Counterpart of ``bark_tpu/benchmarks/multi_fidelity.py``: CurrinExp2D, the
Currin exponential in two dimensions, whose low fidelity is the mean of the
high-fidelity function over four corners shifted by 0.05 (clipped to the
unit square). A test holds it equal to the original.
"""

from __future__ import annotations

import numpy as np

from bark_tpu_torch.benchmarks.base import register_benchmark
from bark_tpu_torch.domain import ContinuousInput, Domain


def _currin(x0, x1):
    prod1 = 1 - np.exp(-1 / (2 * (x1 + 1e-5)))
    prod2 = (2300 * x0**3 + 1900 * x0**2 + 2092 * x0 + 60) / (
        100 * x0**3 + 500 * x0**2 + 4 * x0 + 20
    )
    return -prod1 * prod2 / 10


@register_benchmark("CurrinExp2D")
class CurrinExp2D:
    """Two-fidelity Currin exponential (minimization): fidelity 0 is the
    ground truth, fidelity 1 the local average, at a quarter of the cost."""

    num_fidelities = 2
    fidelity_costs = (1.0, 0.25)

    def __init__(self, **kwargs):
        self.domain = Domain(
            [ContinuousInput("x_0", (0.0, 1.0)), ContinuousInput("x_1", (0.0, 1.0))]
        )

    def f(self, X) -> np.ndarray:
        """The target fidelity at ordinal-encoded points ``(N, 2)``: ``(N,)``."""
        X = np.asarray(self.domain.transform(X), np.float64)
        return np.asarray(_currin(X[:, 0], X[:, 1])).reshape(-1)

    def f_fidelity(self, X, fidelity) -> np.ndarray:
        """Evaluate at per-row fidelities (0 = truth, 1 = local average)."""
        X = self.domain.transform(X).astype(np.float64)
        fidelity = np.asarray(fidelity, np.int64).reshape(-1)
        deltas = 0.05 * np.array([[1, 1], [1, -1], [-1, 1], [-1, -1]])
        x_tilde = np.clip(X[:, None, :] + deltas[None], 0, 1)
        low = _currin(x_tilde[..., 0], x_tilde[..., 1]).mean(axis=1)
        high = _currin(X[:, 0], X[:, 1])
        return np.where(fidelity == 0, high, low)
