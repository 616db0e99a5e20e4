"""Ask/tell BO strategy around the BARK surrogate and the acquisition search.

Counterpart of ``bark_tpu/strategies/tree_kernel.py``: ``tell`` fits the
surrogate on all experiments; ``ask`` builds the acquisition over the
posterior samples (kappa = 1.96) and proposes the leaf-box center of the
optimum. Numpy/ordinal arrays in and out (dict/DataFrame input through
``Domain.transform``).

One difference from the reference is deliberate. Its ``ask`` catches every
exception and proposes a random candidate, which here would hide a kernel
that failed to build or launch. This ``ask`` catches only
:class:`~bark_tpu_torch.optimizer.search.AcquisitionFailure` (every score of
a batch non-finite), counts it in ``fallbacks``, and lets everything else
reach the caller.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from bark_tpu_torch.constraints import (
    FunctionalInequalityConstraint,
    LinearInequalityConstraint,
    NChooseKConstraint,
    QuadraticInequalityConstraint,
)
from bark_tpu_torch.domain import (
    CategoricalInput,
    ContinuousInput,
    Domain,
    IntegerInput,
)
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.models.bart import BARTSurrogate
from bark_tpu_torch.models.leafgp import LeafGPSurrogate
from bark_tpu_torch.models.surrogate import (
    BARKPriorSurrogate,
    BARKSurrogate,
    _BARKSurrogateBase,
)
from bark_tpu_torch.optimizer.acquisition import (
    DEFAULT_KAPPA,
    LR_THRESHOLD,
    build_acquisition,
    build_acquisition_lr,
    build_acquisition_ts,
    draw_acquisition_ts,
)
from bark_tpu_torch.optimizer.search import (
    AcquisitionFailure,
    draw_search,
    propose,
    sample_feasible,
)
from bark_tpu_torch.strategies.baselines import (
    EntmootStrategy,
    GridUCBStrategy,
    RelaxedGPStrategy,
    smac_strategy,
)
from bark_tpu_torch.strategies.capabilities import validate_domain
from bark_tpu_torch.utils.profiling import annotate

logger = logging.getLogger(__name__)

class TreeKernelStrategy:
    """The BO loop: alternate surrogate MCMC fits with acquisition search."""

    # Declared capabilities, validated at construction. The penalty-guided
    # search and the constrained leaf-box centering handle every constraint
    # family of bark_tpu_torch.constraints (subclasses included: equality
    # forms ride their inequality bases).
    SUPPORTED_FEATURES = (ContinuousInput, IntegerInput, CategoricalInput)
    SUPPORTED_CONSTRAINTS = (
        LinearInequalityConstraint,
        QuadraticInequalityConstraint,
        FunctionalInequalityConstraint,
        NChooseKConstraint,
    )

    def __init__(
        self,
        domain: Domain,
        surrogate: _BARKSurrogateBase | None = None,
        params: SamplerParams | None = None,
        kappa: float = DEFAULT_KAPPA,
        seed: int = 0,
        num_candidates: int = 4096,
        num_rounds: int = 4,
        acq_backend: str = "auto",
        dedup: bool = True,
        device=None,
    ):
        if acq_backend not in ("auto", "dense", "lowrank", "thompson"):
            raise ValueError(f"unknown acq_backend: {acq_backend!r}")
        validate_domain(type(self), domain)
        self.domain = domain
        self.surrogate = surrogate or BARKSurrogate(domain, params, seed=seed, device=device)
        self.device = self.surrogate.device
        self.kappa = kappa
        self.num_candidates = num_candidates
        self.num_rounds = num_rounds
        self.acq_backend = acq_backend
        self.dedup = dedup
        self._rng = np.random.default_rng(seed)
        self._generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self._feat_types = torch.as_tensor(domain.feature_types(), device=self.device)
        self.X: np.ndarray | None = None
        self.y: np.ndarray | None = None
        self._last_proposal: np.ndarray | None = None
        self.fallbacks = 0  # asks answered at random after an AcquisitionFailure
        self.duplicate_asks = 0  # asks whose first point repeated a train row or the last proposal
        self.random_asks = 0  # of those, asks answered at random: the Thompson point repeated too

    # --- tell ------------------------------------------------------------

    def tell(self, X, y) -> None:
        """Record experiments (the full history) and refit the surrogate."""
        X = self.domain.transform(X)
        y = np.asarray(y, np.float64).reshape(-1)
        self.X, self.y = X, y
        if self.has_sufficient_experiments():
            self.surrogate.fit(X, y)

    def add(self, X_new, y_new) -> None:
        """Append new experiments to the history and refit."""
        X_new = self.domain.transform(X_new)
        y_new = np.asarray(y_new, np.float64).reshape(-1)
        if self.X is None:
            self.tell(X_new, y_new)
        else:
            self.tell(
                np.vstack([self.X, X_new]), np.concatenate([self.y, y_new])
            )

    def has_sufficient_experiments(self) -> bool:
        return self.y is not None and len(self.y) > 1

    # --- ask -------------------------------------------------------------

    def ask(self, candidate_count: int = 1) -> np.ndarray:
        """Propose the next candidate, ordinal-encoded ``(1, D)``."""
        if candidate_count != 1:
            raise ValueError("BARK proposes single candidates")
        with annotate("bark.ask"):
            if not self.has_sufficient_experiments() or not self.surrogate.is_fitted:
                return sample_feasible(self.domain, 1, self._rng)

            try:
                candidate = self._propose_once(use_ts=self.acq_backend == "thompson")
                if self.dedup and self._is_duplicate(candidate):
                    # The leaf-box-centered LCB optimum is piecewise constant:
                    # once the incumbent's box dominates, every ask re-centers
                    # the same point and the BO loop stalls. A Thompson draw
                    # from the exact leaf-space posterior breaks the tie by
                    # optimizing a different (sampled) objective.
                    self.duplicate_asks += 1
                    with annotate("bark.ask.dedup"):
                        candidate = self._propose_once(use_ts=True)
                        if self._is_duplicate(candidate):
                            self.random_asks += 1
                            logger.info(
                                "Duplicate proposal persisted through the Thompson "
                                "fallback; proposing a feasible random candidate."
                            )
                            candidate = sample_feasible(self.domain, 1, self._rng)[0]
            except AcquisitionFailure:
                self.fallbacks += 1
                logger.warning(
                    "Failed to optimize the acquisition, proposing a random candidate.",
                    exc_info=True,
                )
                return sample_feasible(self.domain, 1, self._rng)
            self._last_proposal = candidate
            return candidate[None, :]

    def _propose_once(self, use_ts: bool) -> np.ndarray:
        """One acquisition build + search; returns the (D,) candidate."""
        sur = self.surrogate
        train_x, train_y = sur.train_data
        args = (sur.model, train_x, train_y, self._feat_types, sur.params.max_depth)
        with annotate("bark.ask.build"):
            if use_ts:
                # one exact posterior function draw per ask (the leaf-space
                # closed form); fresh draws give the exploration distribution
                forest = sur.model.forest
                r = forest.num_trees * ((forest.node_limit + 1) // 2)
                pick, eps = draw_acquisition_ts(
                    self._generator, sur.model.noise.numel(), r, self.device
                )
                acq = build_acquisition_ts(pick, eps, *args, train_mask=sur.train_mask)
            else:
                # the factored build never forms (S, N, N): past the dense
                # memory wall it is the only way ask() completes at all
                use_lr = self.acq_backend == "lowrank" or (
                    self.acq_backend == "auto" and train_x.shape[0] > LR_THRESHOLD
                )
                build = build_acquisition_lr if use_lr else build_acquisition
                acq = build(*args, train_mask=sur.train_mask)
        with annotate("bark.ask.search"):
            draws = draw_search(
                self._generator, self.num_candidates, self.domain.dim, self.num_rounds,
                device=self.device,
            )
            candidate, _ = propose(
                draws,
                acq,
                self.domain,
                self._feat_types,
                kappa=self.kappa,
                max_depth=sur.params.max_depth,
                rng=self._rng,
                seeds=self._warm_start_seeds(),
            )
        return np.asarray(candidate)

    def _is_duplicate(self, candidate: np.ndarray, rel_tol: float = 1e-6) -> bool:
        """Does ``candidate`` (ordinal ``(D,)``) replicate a train row or the
        previous proposal within per-dimension relative tolerance?"""
        refs = []
        if self.X is not None and len(self.X):
            refs.append(np.asarray(self.X, np.float64))
        if self._last_proposal is not None:
            refs.append(np.asarray(self._last_proposal, np.float64)[None, :])
        if not refs:
            return False
        refs = np.vstack(refs)
        bounds = np.asarray(self.domain.bounds("ordinal"), np.float64)
        span = np.maximum(bounds[:, 1] - bounds[:, 0], 1e-12)
        rel = np.abs(refs - np.asarray(candidate, np.float64)[None, :]) / span
        return bool((rel.max(axis=1) <= rel_tol).any())

    def _warm_start_seeds(self, n_jitter: int = 3) -> np.ndarray | None:
        """Round-0 elites: the incumbent best X, the previous proposal, and
        jittered copies of each (where BO last looked and where the
        incumbent sits)."""
        anchors = []
        if self.y is not None and len(self.y):
            anchors.append(self.X[int(np.argmin(self.y))])
        if self._last_proposal is not None:
            anchors.append(self._last_proposal)
        if not anchors:
            return None
        anchors = np.stack(anchors).astype(np.float32)
        bounds = self.domain.bounds("ordinal")
        span = bounds[:, 1] - bounds[:, 0]
        jit = np.repeat(anchors, n_jitter, axis=0)
        jit = jit + self._rng.normal(0.0, 0.05, jit.shape) * span[None, :]
        return self.domain.round(np.vstack([anchors, jit]))

    def predict(self, X) -> tuple[np.ndarray, np.ndarray]:
        return self.surrogate.predict(X)


class RandomStrategy:
    """Uniform-random baseline (feasible by rejection sampling)."""

    # rejection sampling is type-agnostic: everything supported
    SUPPORTED_FEATURES = None
    SUPPORTED_CONSTRAINTS = None

    def __init__(self, domain: Domain, seed: int = 0):
        self.domain = domain
        self._rng = np.random.default_rng(seed)
        self.X = None
        self.y = None

    def tell(self, X, y) -> None:
        self.X = self.domain.transform(X)
        self.y = np.asarray(y, np.float64).reshape(-1)

    def add(self, X_new, y_new) -> None:
        X_new = self.domain.transform(X_new)
        y_new = np.asarray(y_new, np.float64).reshape(-1)
        if self.X is None:
            self.X, self.y = X_new, y_new
        else:
            self.X = np.vstack([self.X, X_new])
            self.y = np.concatenate([self.y, y_new])

    def ask(self, candidate_count: int = 1) -> np.ndarray:
        return sample_feasible(self.domain, candidate_count, self._rng)


def make_strategy(name: str, domain: Domain, seed: int = 0, device=None, **kwargs):
    """Strategy registry, the reference's names:

      - ``"BARK"`` / ``"TreeKernel"``, ``"BARKPrior"`` (the BO loop on
        :class:`BARKPriorSurrogate`), ``"LeafGP"`` (the BO loop on a
        :class:`~bark_tpu_torch.models.leafgp.LeafGPSurrogate`; its
        ``num_boost_round``, ``max_depth`` and ``node_limit`` go to the
        surrogate), ``"LeafMOGP"`` (the
        :class:`~bark_tpu_torch.strategies.multi_fidelity.MultiFidelityStrategy`,
        which takes ``fidelity_costs``);
      - ``"BART"`` / ``"BARTGrid"`` (grid UCB over a
        :class:`~bark_tpu_torch.models.bart.BARTSurrogate`, which takes
        ``bart_params``), ``"GridUCB"`` (grid UCB over BARK),
        ``"RelaxedSobo"`` / ``"Sobo"`` / ``"RelaxedGP"``, ``"SMAC"`` and
        ``"Entmoot"`` (these two raise ``RuntimeError`` without their
        packages), from :mod:`bark_tpu_torch.strategies.baselines`;
      - ``"Random"``.

    ``device`` goes to the surrogate (None = the CUDA device); the random,
    SMAC and Entmoot baselines touch no device.
    """
    if name in ("BARK", "TreeKernel"):
        return TreeKernelStrategy(domain, seed=seed, device=device, **kwargs)
    if name == "BARKPrior":
        sur = BARKPriorSurrogate(domain, seed=seed, device=device)
        return TreeKernelStrategy(domain, surrogate=sur, seed=seed, **kwargs)
    if name == "LeafGP":
        sur = kwargs.pop("surrogate", None) or LeafGPSurrogate(
            domain, seed=seed, device=device,
            **{k: kwargs.pop(k) for k in ("num_boost_round", "max_depth", "node_limit")
               if k in kwargs},
        )
        return TreeKernelStrategy(domain, surrogate=sur, seed=seed, **kwargs)
    if name == "LeafMOGP":
        from bark_tpu_torch.strategies.multi_fidelity import MultiFidelityStrategy

        return MultiFidelityStrategy(domain, seed=seed, device=device, **kwargs)
    if name == "Random":
        return RandomStrategy(domain, seed=seed)
    if name in ("BART", "BARTGrid"):
        sur = kwargs.pop("surrogate", None) or BARTSurrogate(
            domain, kwargs.pop("bart_params", None), seed=seed, device=device
        )
        return GridUCBStrategy(domain, surrogate=sur, seed=seed, **kwargs)
    if name == "GridUCB":
        return GridUCBStrategy(domain, seed=seed, device=device, **kwargs)
    if name in ("RelaxedSobo", "Sobo", "RelaxedGP"):
        return RelaxedGPStrategy(domain, seed=seed, device=device, **kwargs)
    if name == "SMAC":
        return smac_strategy(domain, **kwargs)
    if name == "Entmoot":
        return EntmootStrategy(domain, **kwargs)
    raise KeyError(f"Unknown strategy: {name}")
