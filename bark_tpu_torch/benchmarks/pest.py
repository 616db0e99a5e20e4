"""Pest-control simulator: 25 stages x 5 categorical actions (numpy only).

Counterpart of ``bark_tpu/benchmarks/pest.py`` (the public HEBO/MCBO pest
task): stochastic pest-spread dynamics where each stage chooses one of 4
pesticides (with tolerance development and bulk discounts) or does nothing;
the score is the total price plus the fraction of simulations above the
infestation threshold. The noise comes from one numpy Generator made from
``seed`` at construction and advanced by every call, as in the original.
"""

from __future__ import annotations

import numpy as np

from bark_tpu_torch.benchmarks.base import Benchmark, register_benchmark
from bark_tpu_torch.domain import CategoricalInput, Domain


def _pest_control_score(x: np.ndarray, rng: np.random.Generator) -> float:
    """One simulated score of the action sequence ``x`` (the original's
    dynamics constants)."""
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
            control_rate = rng.beta(
                control_alpha, control_beta[a], size=(n_simulations,)
            )
            nxt = (1.0 - control_rate) * curr
            control_beta[a] += tolerance_develop_rate[a] / float(n_stages)
            payed = control_price[a] * (
                1.0
                - control_price_max_discount[a]
                / float(n_stages)
                * float(np.sum(x == a))
            )
        else:
            nxt = spread_rate * (1 - curr) + curr
            payed = 0.0
        payed_price_sum += payed
        above_threshold += float(np.mean(curr > U))
        curr = nxt
    return payed_price_sum + above_threshold


@register_benchmark("PestControl")
class PestControl(Benchmark):
    categories = (
        "do nothing",
        "pesticide 1",
        "pesticide 2",
        "pesticide 3",
        "pesticide 4",
    )

    def __init__(self, n_stages: int = 25, seed: int | None = None, **kwargs):
        self._n_stages = n_stages
        self._pest_rng = np.random.default_rng(seed)
        super().__init__(
            Domain(
                [
                    CategoricalInput(f"stage_{i + 1}", self.categories)
                    for i in range(n_stages)
                ]
            )
        )

    def _f(self, X):
        return np.array(
            [
                _pest_control_score(row.astype(np.int64), self._pest_rng)
                for row in X
            ]
        )
