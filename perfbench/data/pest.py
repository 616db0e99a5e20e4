"""PestControl and its domain, frozen, in NumPy.

A copy of ``bark_tpu_torch/benchmarks/pest.py`` (the HEBO/MCBO pest task:
25 stages, each choosing "do nothing" or one of 4 pesticides) and of
``Domain.sample``/``bounds``/``feature_types`` for its 25 categorical inputs
of 5 levels: the same simulator constants and the same NumPy generator calls
in the same order, so a seed gives the same points and f(x) as the port's.
It imports nothing of the port; ``test_perfbench_pest.py`` holds the two
equal.

The objective is stochastic: every call advances one generator, which
:meth:`PestControl.reseed` sets anew, so that the benchmark can replay an
episode's objective values from the run's seed.
"""

from __future__ import annotations

import numpy as np

FEAT_CAT = 0
CATEGORIES = ("do nothing", "pesticide 1", "pesticide 2", "pesticide 3", "pesticide 4")


def score(x: np.ndarray, rng: np.random.Generator) -> float:
    """One simulated score of the action sequence ``x``: the price paid
    plus, over the stages, the share of 100 simulations above the
    infestation threshold."""
    U = 0.1
    n_stages = x.size
    n_simulations = 100

    init_alpha, init_beta = 1.0, 30.0
    spread_alpha, spread_beta = 1.0, 17.0 / 3.0
    control_alpha = 1.0
    control_price_max_discount = {1: 0.2, 2: 0.3, 3: 0.3, 4: 0.0}
    tolerance_develop_rate = {1: 1 / 7, 2: 2.5 / 7, 3: 2 / 7, 4: 0.5 / 7}
    control_price = {1: 1.0, 2: 0.8, 3: 0.7, 4: 0.5}
    control_beta = {1: 2 / 7, 2: 3 / 7, 3: 3 / 7, 4: 5 / 7}

    payed_price_sum = 0.0
    above_threshold = 0.0
    curr = rng.beta(init_alpha, init_beta, size=(n_simulations,))
    for i in range(n_stages):
        spread_rate = rng.beta(spread_alpha, spread_beta, size=(n_simulations,))
        a = int(x[i])
        if a > 0:
            control_rate = rng.beta(control_alpha, control_beta[a], size=(n_simulations,))
            nxt = (1.0 - control_rate) * curr
            control_beta[a] += tolerance_develop_rate[a] / float(n_stages)
            payed = control_price[a] * (
                1.0 - control_price_max_discount[a] / float(n_stages) * float(np.sum(x == a)))
        else:
            nxt = spread_rate * (1 - curr) + curr
            payed = 0.0
        payed_price_sum += payed
        above_threshold += float(np.mean(curr > U))
        curr = nxt
    return payed_price_sum + above_threshold


class PestControl:
    """f(x) for ``n_stages`` categorical inputs of 5 levels, ordinal-encoded
    (level i is the number i)."""

    num_cat = len(CATEGORIES)

    def __init__(self, n_stages: int = 25, seed: int | None = None):
        self.n_stages = n_stages
        self.reseed(seed)

    def reseed(self, seed: int | None) -> None:
        self._rng = np.random.default_rng(seed)

    def feature_types(self) -> np.ndarray:
        return np.full(self.n_stages, FEAT_CAT, np.int32)

    def bounds(self, encoding: str = "bitmask") -> np.ndarray:
        """``(D, 2)`` float32: [0, 2^k - 1] (bitmask) or [0, k - 1]
        (ordinal) for each input."""
        ub = float((1 << self.num_cat) - 1) if encoding == "bitmask" else float(self.num_cat - 1)
        return np.tile(np.array([[0.0, ub]], np.float32), (self.n_stages, 1))

    def sample(self, n: int, rng: np.random.Generator) -> np.ndarray:
        """Uniform points ``(n, D)`` float32 (the port's ``Domain.sample``:
        a column per input, in order)."""
        cols = [rng.integers(0, self.num_cat, size=n) for _ in range(self.n_stages)]
        return np.stack(cols, axis=1).astype(np.float32)

    def f(self, X) -> np.ndarray:
        X = np.asarray(X, np.float32).astype(np.float64)
        return np.array([score(row.astype(np.int64), self._rng) for row in X]).reshape(-1)
