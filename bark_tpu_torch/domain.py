"""Mixed-feature input domain (numpy only).

The part of ``bark_tpu/domain.py`` the sampler and its data generator use:
typed inputs lowered to the two arrays the sampler consumes,

  - ``bounds(encoding)``: ``(D, 2)`` float32; a categorical feature's upper
    bound is the bitmask ``(1 << n_cats) - 1`` for tree splits
    (``"bitmask"``) or ``n_cats - 1`` for data (``"ordinal"``);
  - ``feature_types()``: ``(D,)`` int32 with Cat=0, Int=1, Cont=2,

and :meth:`Domain.sample`, which consumes the numpy generator exactly as the
reference does, so the same seed gives the same points. Data is ordinal
encoded: a categorical entry is the category index.
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
class Domain:
    inputs: tuple[AnyInput, ...]

    def __init__(self, inputs: Sequence[AnyInput]):
        object.__setattr__(self, "inputs", tuple(inputs))

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
