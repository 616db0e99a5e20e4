"""Multi-fidelity BO strategy: the LeafMOGP surrogate, the acquisition
search and the information-gain choice of fidelity.

Counterpart of ``bark_tpu/strategies/multi_fidelity.py``:

  1. ``tell(X, fidelities, y)`` refits the multi-task tree GP on every
     observation (booster forest, then the index-kernel and noise
     hyperparameters by the exact MLL);
  2. ``ask()`` minimizes the target-fidelity LCB with the search and
     leaf-box centring of the BARK strategy (:func:`build_acquisition_mogp`
     and :func:`~bark_tpu_torch.optimizer.search.propose`), then picks the
     fidelity by information gain per unit cost at the chosen x.

The search's device randomness comes from a ``torch.Generator`` through
:func:`~bark_tpu_torch.optimizer.search.draw_search`, as in
:class:`~bark_tpu_torch.strategies.tree_kernel.TreeKernelStrategy`; the
host half (centring, f* draws) consumes a numpy generator as the reference
does. A constrained proposal passes the search's float32 feasibility gate.
"""

from __future__ import annotations

import numpy as np
import torch

from bark_tpu_torch.domain import Domain
from bark_tpu_torch.models.mogp import LeafMOGPSurrogate
from bark_tpu_torch.models.sampling import fstar_samples_mogp
from bark_tpu_torch.optimizer.acquisition import DEFAULT_KAPPA, build_acquisition_mogp
from bark_tpu_torch.optimizer.fidelity import propose_fidelity_information_based
from bark_tpu_torch.optimizer.search import draw_search, propose, sample_feasible
from bark_tpu_torch.strategies.capabilities import validate_domain
from bark_tpu_torch.strategies.tree_kernel import TreeKernelStrategy


class MultiFidelityStrategy:
    """Ask/tell MF-BO loop; ``ask`` returns ``(x (1, D), fidelity int)``.

    ``device=None`` means the CUDA device (an error without one); pass
    ``device="cpu"`` for the CPU.
    """

    # the search and centring of TreeKernelStrategy: the same capabilities
    SUPPORTED_FEATURES = TreeKernelStrategy.SUPPORTED_FEATURES
    SUPPORTED_CONSTRAINTS = TreeKernelStrategy.SUPPORTED_CONSTRAINTS

    def __init__(
        self,
        domain: Domain,
        fidelity_costs: list[float],
        surrogate: LeafMOGPSurrogate | None = None,
        kappa: float = DEFAULT_KAPPA,
        seed: int = 0,
        num_candidates: int = 2048,
        num_rounds: int = 3,
        num_fstar: int = 16,
        device=None,
    ):
        validate_domain(type(self), domain)
        self.domain = domain
        self.fidelity_costs = list(fidelity_costs)
        self.num_tasks = len(self.fidelity_costs)
        self.surrogate = surrogate or LeafMOGPSurrogate(
            domain, num_tasks=self.num_tasks, seed=seed, device=device
        )
        self.device = self.surrogate.device
        self.kappa = kappa
        self.num_candidates = num_candidates
        self.num_rounds = num_rounds
        self.num_fstar = num_fstar
        self._rng = np.random.default_rng(seed)
        self._generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self._feat_types = torch.as_tensor(domain.feature_types(), device=self.device)
        self.X: np.ndarray | None = None
        self.fid: np.ndarray | None = None
        self.y: np.ndarray | None = None

    def tell(self, X, fidelities, y) -> None:
        self.X = self.domain.transform(X)
        self.fid = np.asarray(fidelities, np.int64).reshape(-1)
        self.y = np.asarray(y, np.float64).reshape(-1)
        if self.has_sufficient_experiments():
            self.surrogate.fit(self.X, self.fid, self.y)

    def add(self, X_new, fid_new, y_new) -> None:
        X_new = self.domain.transform(X_new)
        fid_new = np.asarray(fid_new, np.int64).reshape(-1)
        y_new = np.asarray(y_new, np.float64).reshape(-1)
        if self.X is None:
            self.tell(X_new, fid_new, y_new)
        else:
            self.tell(
                np.vstack([self.X, X_new]),
                np.concatenate([self.fid, fid_new]),
                np.concatenate([self.y, y_new]),
            )

    def has_sufficient_experiments(self) -> bool:
        """Every task observed at least once, and more than one point."""
        if self.y is None or len(self.y) <= 1:
            return False
        return len(np.unique(self.fid)) == self.num_tasks

    def ask(self) -> tuple[np.ndarray, int]:
        """The next (candidate, fidelity); a random x at the fidelities in
        turn (by the number of observations) until the surrogate is fitted."""
        if not self.has_sufficient_experiments() or self.surrogate.train is None:
            x = sample_feasible(self.domain, 1, self._rng)
            n_obs = 0 if self.y is None else len(self.y)
            return x, int(n_obs % self.num_tasks)

        acq = build_acquisition_mogp(self.surrogate)
        draws = draw_search(
            self._generator, self.num_candidates, self.domain.dim, self.num_rounds,
            device=self.device,
        )
        x, _ = propose(draws, acq, self.domain, self._feat_types, kappa=self.kappa,
                       rng=self._rng)
        f_star = fstar_samples_mogp(self.surrogate, self.X, self.num_fstar, self._rng)
        fid = propose_fidelity_information_based(
            self.surrogate, x, self.fidelity_costs, f_star
        )
        return x[None, :], int(fid)

    def predict(self, X, fidelities):
        return self.surrogate.predict(X, fidelities)
