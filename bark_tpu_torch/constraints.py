"""Constraint data model for mixed domains (numpy only).

Copy of ``bark_tpu/constraints.py`` (importing anything from ``bark_tpu``
imports JAX; ``tests/test_torch_strategy.py`` holds the two equal). The
consumer is the sampled acquisition search
(:mod:`bark_tpu_torch.optimizer.search`), which uses
``violation(X) -> (N,)`` for penalty terms and feasibility filtering. Every
constraint has the form ``expr(x) <= rhs`` (inequality) or
``expr(x) == rhs`` (equality).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np


class Constraint:
    """Base: ``expr(X) - rhs``; violation is the positive part (or |.|)."""

    rhs: float
    is_equality: bool = False

    def expr(self, X: np.ndarray, keys: list[str]) -> np.ndarray:
        raise NotImplementedError

    def violation(self, X: np.ndarray, keys: list[str]) -> np.ndarray:
        """Nonnegative violation magnitude per row of ordinal-encoded X."""
        g = self.expr(X, keys) - self.rhs
        return np.abs(g) if self.is_equality else np.maximum(g, 0.0)

    def satisfied(self, X: np.ndarray, keys: list[str], tol: float = 1e-6):
        return self.violation(X, keys) <= tol


@dataclass
class LinearInequalityConstraint(Constraint):
    """``sum_i c_i x_i <= rhs`` over named features (BoFire semantics)."""

    features: Sequence[str]
    coefficients: Sequence[float]
    rhs: float
    is_equality: bool = False

    def expr(self, X, keys):
        idx = [keys.index(f) for f in self.features]
        c = np.asarray(self.coefficients, np.float64)
        return X[:, idx] @ c


@dataclass
class LinearEqualityConstraint(LinearInequalityConstraint):
    is_equality: bool = True


@dataclass
class QuadraticInequalityConstraint(Constraint):
    """``x^T Q x (pairwise) + c^T x <= rhs``.

    Features and coefficients are paired per quadratic term.
    """

    features: Sequence[tuple[str, str]]
    coefficients: Sequence[float]
    rhs: float
    linear_features: Sequence[str] = field(default_factory=tuple)
    linear_coefficients: Sequence[float] = field(default_factory=tuple)
    is_equality: bool = False

    def expr(self, X, keys):
        out = np.zeros(X.shape[0], np.float64)
        for (fa, fb), c in zip(self.features, self.coefficients):
            out += c * X[:, keys.index(fa)] * X[:, keys.index(fb)]
        for f, c in zip(self.linear_features, self.linear_coefficients):
            out += c * X[:, keys.index(f)]
        return out


@dataclass
class QuadraticEqualityConstraint(QuadraticInequalityConstraint):
    is_equality: bool = True


@dataclass
class FunctionalInequalityConstraint(Constraint):
    """``func(x) <= rhs`` for an arbitrary per-point callable.

    ``func`` receives the per-row feature vector (ordinal encoding).
    """

    func: Callable[[np.ndarray], float]
    rhs: float
    is_equality: bool = False

    def expr(self, X, keys):
        return np.array([float(self.func(row)) for row in X], np.float64)


@dataclass
class FunctionalEqualityConstraint(FunctionalInequalityConstraint):
    is_equality: bool = True


@dataclass
class NChooseKConstraint(Constraint):
    """At most ``max_count`` (and at least ``min_count``) of the named
    features may be nonzero (BoFire NChooseK semantics)."""

    features: Sequence[str]
    max_count: int
    min_count: int = 0
    none_also_valid: bool = True
    rhs: float = 0.0
    is_equality: bool = False

    def violation(self, X, keys):
        idx = [keys.index(f) for f in self.features]
        nonzero = (np.abs(X[:, idx]) > 1e-9).sum(axis=1)
        over = np.maximum(nonzero - self.max_count, 0)
        under = np.maximum(self.min_count - nonzero, 0)
        if self.none_also_valid:
            under = np.where(nonzero == 0, 0, under)
        return (over + under).astype(np.float64)

    def expr(self, X, keys):
        raise NotImplementedError("NChooseK has no smooth expression")


def total_violation(
    constraints, X: np.ndarray, keys: list[str]
) -> np.ndarray:
    """Sum of violations across constraints: ``(N,)`` nonnegative."""
    if not constraints:
        return np.zeros(X.shape[0], np.float64)
    return np.sum([c.violation(X, keys) for c in constraints], axis=0)


def is_feasible(constraints, X: np.ndarray, keys: list[str], tol=1e-6):
    return total_violation(constraints, X, keys) <= tol
