"""Mixed-feature input domain (numpy only).

The part of ``bark_tpu/domain.py`` the sampler, the surrogate and the
acquisition search use: typed inputs lowered to the two arrays the sampler
consumes,

  - ``bounds(encoding)``: ``(D, 2)`` float32; a categorical feature's upper
    bound is the bitmask ``(1 << n_cats) - 1`` for tree splits
    (``"bitmask"``) or ``n_cats - 1`` for data (``"ordinal"``);
  - ``feature_types()``: ``(D,)`` int32 with Cat=0, Int=1, Cont=2,

and :meth:`Domain.sample`, which consumes the numpy generator exactly as the
reference does, so the same seed gives the same points. Data is ordinal
encoded: a categorical entry is the category index
(:meth:`Domain.transform`); :meth:`Domain.round` projects arbitrary points
back onto the domain. A domain may carry constraints
(:mod:`bark_tpu_torch.constraints`). :class:`Standardize` is the y scaler
of the surrogate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from bark_tpu_torch.forest import FEAT_CAT, FEAT_CONT, FEAT_INT, MAX_CATEGORIES


@dataclass(frozen=True)
class ContinuousInput:
    key: str
    bounds: tuple[float, float]


@dataclass(frozen=True)
class IntegerInput:
    """Integer-valued input over an inclusive range."""

    key: str
    bounds: tuple[int, int]


@dataclass(frozen=True)
class CategoricalInput:
    key: str
    categories: tuple[str, ...]

    def __post_init__(self):
        if len(self.categories) > MAX_CATEGORIES:
            raise ValueError(
                f"Categorical feature {self.key!r} has {len(self.categories)} "
                f"categories; bitmask thresholds support at most {MAX_CATEGORIES}."
            )


AnyInput = ContinuousInput | IntegerInput | CategoricalInput


@dataclass(frozen=True)
class ContinuousOutput:
    key: str
    minimize: bool = True


@dataclass(frozen=True)
class Domain:
    inputs: tuple[AnyInput, ...]
    outputs: tuple[ContinuousOutput, ...] = (ContinuousOutput("y"),)
    constraints: tuple = ()

    def __init__(self, inputs: Sequence[AnyInput], outputs=None, constraints=()):
        object.__setattr__(self, "inputs", tuple(inputs))
        if outputs is None:
            outputs = (ContinuousOutput("y"),)
        object.__setattr__(self, "outputs", tuple(outputs))
        object.__setattr__(self, "constraints", tuple(constraints))

    @property
    def dim(self) -> int:
        return len(self.inputs)

    @property
    def input_keys(self) -> list[str]:
        return [f.key for f in self.inputs]

    def feature_types(self) -> np.ndarray:
        """Cat=0 / Int=1 / Cont=2 per feature."""
        codes = []
        for f in self.inputs:
            if isinstance(f, CategoricalInput):
                codes.append(FEAT_CAT)
            elif isinstance(f, IntegerInput):
                codes.append(FEAT_INT)
            else:
                codes.append(FEAT_CONT)
        return np.array(codes, dtype=np.int32)

    def bounds(self, encoding: str = "bitmask") -> np.ndarray:
        """``(D, 2)`` float32 bounds (see the module docstring)."""
        rows = []
        for f in self.inputs:
            if isinstance(f, CategoricalInput):
                n = len(f.categories)
                ub = float((1 << n) - 1) if encoding == "bitmask" else float(n - 1)
                rows.append((0.0, ub))
            else:
                rows.append((float(f.bounds[0]), float(f.bounds[1])))
        return np.array(rows, dtype=np.float32)

    def transform(self, X) -> np.ndarray:
        """DataFrame/dict/array of raw inputs -> ordinal-encoded ``(N, D)``.

        Categorical string labels become category indices; numerics pass
        through. An already-encoded numpy array is returned as float32.
        """
        if isinstance(X, np.ndarray):
            return X.astype(np.float32)
        cols = []
        for f in self.inputs:
            col = np.asarray(X[f.key])
            if isinstance(f, CategoricalInput) and col.dtype.kind in ("U", "S", "O"):
                lookup = {c: i for i, c in enumerate(f.categories)}
                col = np.array([lookup[v] for v in col])
            cols.append(col.astype(np.float32))
        return np.stack(cols, axis=1)

    def sample(self, n: int, rng: np.random.Generator | None = None) -> np.ndarray:
        """Uniform random ordinal-encoded points: ``(n, D)`` float32."""
        rng = rng or np.random.default_rng()
        cols = []
        for f in self.inputs:
            if isinstance(f, CategoricalInput):
                cols.append(rng.integers(0, len(f.categories), size=n))
            elif isinstance(f, IntegerInput):
                cols.append(rng.integers(f.bounds[0], f.bounds[1] + 1, size=n))
            else:
                cols.append(rng.uniform(f.bounds[0], f.bounds[1], size=n))
        return np.stack(cols, axis=1).astype(np.float32)

    def round(self, X: np.ndarray) -> np.ndarray:
        """Project arbitrary points onto the domain (clip + round discretes)."""
        X = np.array(X, dtype=np.float32, copy=True)
        for i, f in enumerate(self.inputs):
            if isinstance(f, CategoricalInput):
                X[:, i] = np.clip(np.round(X[:, i]), 0, len(f.categories) - 1)
            elif isinstance(f, IntegerInput):
                X[:, i] = np.clip(np.round(X[:, i]), f.bounds[0], f.bounds[1])
            else:
                X[:, i] = np.clip(X[:, i], f.bounds[0], f.bounds[1])
        return X


@dataclass
class Standardize:
    """Train-time y standardization with exact inverse for mu/var (float64
    numpy)."""

    mean: float = 0.0
    std: float = 1.0

    def __call__(self, y: np.ndarray, train: bool) -> np.ndarray:
        if train:
            self.mean = float(y.mean())
            self.std = float(max(y.std(), 1e-6))
        return (y - self.mean) / self.std

    def untransform(self, y):
        return y * self.std + self.mean

    def untransform_mu_var(self, mu, var):
        return self.untransform(mu), var * self.std**2
