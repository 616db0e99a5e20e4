"""Surrogate layer: the trainable BARK model over a Domain.

Counterpart of ``bark_tpu/models/surrogate.py``: a surrogate is built from a
:class:`~bark_tpu_torch.domain.Domain` and
:class:`~bark_tpu_torch.fitting.params.SamplerParams`, consumes
ordinal-encoded numpy arrays and returns numpy predictions. As in the
reference,

  - y is standardized at fit time and un-standardized at predict;
  - the training set is padded to a 32-row bucket with a row mask (padded
    rows are inert in the kernel, the MLL and the posterior);
  - the sampler warm-starts from each chain's most recent posterior sample
    and skips warmup after the first fit;
  - predictions collapse the per-sample Gaussians by moment matching and
    add observation noise per sample.

The entry points take numpy arrays, so they cannot follow a tensor's device:
the surrogate takes ``device``. ``None`` means the CUDA device and raises
without one; the CPU is used only when asked for (``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch

from bark_tpu_torch.domain import Domain, Standardize
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.fitting.sampler import (
    BARKModel,
    _leaf_budget,
    _resolve_styles,
    run_bark_sampler,
)
from bark_tpu_torch.forest import Forest, create_empty_forest
from bark_tpu_torch.models.gp import (
    forest_predict,
    forest_predict_leaf,
    mixture_of_gaussians_as_normal,
)
from bark_tpu_torch.utils.diagnostics import effective_sample_size, gelman_rubin


def resolve_device(device) -> torch.device:
    """``None`` -> the CUDA device (an error without one); anything else is
    taken as given. No caller looks for a GPU and carries on without one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless the caller "
                'asks for the CPU (device="cpu")'
            )
        return torch.device("cuda")
    return torch.device(device)


def bucket_size(n: int, bucket: int = 32) -> int:
    """Round n up to a padding bucket, so shapes change rarely during BO."""
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


class _BARKSurrogateBase:
    #: padded training-set size past which ``predict`` switches from the
    #: dense posterior (S x N x N kernels) to the exact leaf-space path
    #: (:func:`forest_predict_leaf`), which builds nothing N x N. (The name
    #: is the reference's, from its earlier conjugate-gradient switch.)
    cg_threshold: int = 2048

    def __init__(self, domain: Domain, params: SamplerParams,
                 predict_backend: str = "auto", device=None):
        if predict_backend not in ("auto", "dense", "cg", "leaf"):
            raise ValueError(f"unknown predict_backend: {predict_backend!r}")
        if predict_backend == "cg":
            raise NotImplementedError(
                'predict_backend="cg": forest_predict_cg and ops/iterative.py '
                "are not ported yet (ROADMAP.md queue 1 item 6)"
            )
        self.device = resolve_device(device)
        self.domain = domain
        self.params = params
        self.predict_backend = predict_backend
        self.scaler = Standardize()
        self.model: BARKModel | None = None
        self.train_data: tuple[torch.Tensor, torch.Tensor] | None = None
        self.train_mask: torch.Tensor | None = None
        self._bounds = torch.as_tensor(domain.bounds("bitmask"), device=self.device)
        self._feat_types = torch.as_tensor(domain.feature_types(), device=self.device)

    @property
    def is_fitted(self) -> bool:
        return self.model is not None

    def predict(
        self, X, batched: bool = False, predict_observed: bool = True
    ) -> tuple[np.ndarray, np.ndarray]:
        """Posterior mean and standard deviation, shape ``([S,] N, 1)``."""
        candidates = torch.as_tensor(self.domain.transform(X), device=self.device)
        train_x, train_y = self.train_data
        backend = self.predict_backend
        if backend == "auto":
            backend = "leaf" if train_x.shape[0] > self.cg_threshold else "dense"
        predict_fn = {"dense": forest_predict, "leaf": forest_predict_leaf}[backend]
        mu, var = predict_fn(
            self.model.forest,
            self.model.noise,
            self.model.scale,
            train_x,
            train_y,
            candidates,
            self._feat_types,
            self.params.max_depth,
            train_mask=self.train_mask,
        )
        mu, var = self.scaler.untransform_mu_var(mu.cpu().numpy(), var.cpu().numpy())
        if predict_observed:
            noise_flat = self.model.noise.cpu().numpy().reshape(-1, 1)
            var = var + noise_flat * self.scaler.std**2
        if not batched:
            mu, var = mixture_of_gaussians_as_normal(mu, var)
        return mu[..., None], np.sqrt(var[..., None])

    def function_samples(
        self, X, eps: np.ndarray | None = None, num_draws: int = 1
    ) -> np.ndarray:
        """Posterior-predictive function draws at ``X``: ``(S*num_draws, N)``.

        One independent marginal Gaussian draw per posterior sample per
        point, in original (un-standardized) y units, observation noise
        included. ``eps`` holds the standard normals, ``(num_draws, S, N)``;
        None draws them from a numpy generator seeded with 0.
        """
        mu, std = self.predict(X, batched=True, predict_observed=True)
        mu, std = mu[..., 0], std[..., 0]  # (S, N)
        if eps is None:
            eps = np.random.default_rng(0).standard_normal((num_draws,) + mu.shape)
        draws = mu[None] + std[None] * np.asarray(eps)
        return draws.reshape(-1, mu.shape[-1])

    def _store_train_data(self, X, y):
        """Standardize y and pad (X, y) to a bucket size with a row mask."""
        X = self.domain.transform(X)
        y = np.asarray(y, np.float64).reshape(-1)
        y_std = self.scaler(y, train=True)
        n = X.shape[0]
        n_pad = bucket_size(n)
        X_pad = np.zeros((n_pad, X.shape[1]), np.float32)
        X_pad[:n] = X
        X_pad[n:] = X[0] if n else 0.0  # valid in-domain filler rows
        y_pad = np.zeros((n_pad,), np.float32)
        y_pad[:n] = y_std
        mask = np.zeros((n_pad,), np.float32)
        mask[:n] = 1.0
        self.train_data = (
            torch.as_tensor(X_pad, device=self.device),
            torch.as_tensor(y_pad, device=self.device),
        )
        self.train_mask = torch.as_tensor(mask, device=self.device)


class BARKSurrogate(_BARKSurrogateBase):
    """Fully-Bayesian BARK surrogate (MCMC over forest and noise).

    ``fit_style="chains"`` runs independent MH chains
    (:func:`run_bark_sampler`), batched over the chain dimension;
    ``"tempered"`` (parallel tempering) is not ported yet. After every fit,
    ``fit_diagnostics`` holds split-R-hat and ESS over the sampled noise
    trace (chains x samples), so a caller can see how far from stationarity
    the fit budget left the posterior.
    """

    def __init__(self, domain: Domain, params: SamplerParams | None = None,
                 seed: int = 0, predict_backend: str = "auto",
                 fit_style: str = "chains", device=None):
        if fit_style not in ("chains", "tempered"):
            raise ValueError(f"unknown fit_style: {fit_style!r}")
        if fit_style == "tempered":
            raise NotImplementedError(
                'fit_style="tempered": parallel tempering (parallel/) is not '
                "ported yet (ROADMAP.md queue 1 item 9)"
            )
        super().__init__(domain, params or SamplerParams(),
                         predict_backend=predict_backend, device=device)
        self.fit_style = fit_style
        self.fit_diagnostics: dict | None = None
        self._generator = torch.Generator(device=self.device).manual_seed(seed)

    def _check_leaf_budget(self, start: BARKModel, params, n: int) -> None:
        """Refuse a warm-start forest the leaf-space refresh cannot pack.

        The sampler's capacity guard only blocks new grows; an initial
        forest whose leaf total already exceeds the resolved leaf budget
        would poison its chain's MLL with NaN. Here a real error with a fix
        is possible; it fires only on warm starts with a smaller budget or
        custom deep priors.
        """
        resolved = _resolve_styles(params, n)
        if resolved.refresh_style != "leaf":
            return
        budget = _leaf_budget(resolved, n)
        totals = (start.forest.is_leaf & start.forest.active).sum((-2, -1))
        worst = int(totals.max())
        if worst > budget:
            raise ValueError(
                f"warm-start forest has up to {worst} total leaves but the "
                f"leaf-space refresh budget is {budget} at padded N={n}; "
                "raise SamplerParams.leaf_budget to fit this state"
            )

    def _init_state(self) -> BARKModel:
        """Empty forests, noise 0.1, scale 1.0."""
        c = self.params.num_chains
        forest = create_empty_forest(
            self.params.num_trees, self.params.node_limit, (c,), self.device
        )
        return BARKModel(
            forest=forest,
            noise=torch.full((c,), 0.1, dtype=torch.float32, device=self.device),
            scale=torch.ones((c,), dtype=torch.float32, device=self.device),
        )

    def fit(self, X, y):
        self._store_train_data(X, y)
        if not self.is_fitted:
            start = self._init_state()
            params = self.params
        else:
            # warm start from each chain's most recent sample; skip warmup
            start = BARKModel(
                forest=Forest(*(t[:, -1] for t in self.model.forest)),
                noise=self.model.noise[:, -1],
                scale=self.model.scale[:, -1],
            )
            params = self.params.with_(warmup_steps=0)
        train_x, train_y = self.train_data
        self._check_leaf_budget(start, params, train_x.shape[0])
        self.model = run_bark_sampler(
            self._generator, start, train_x, train_y, self._bounds,
            self._feat_types, params, mask=self.train_mask,
        )
        self._record_fit_diagnostics()
        return self

    def _record_fit_diagnostics(self):
        """Split-R-hat / ESS over the sampled noise trace."""
        noise = self.model.noise.cpu().numpy().astype(np.float64)
        self.fit_diagnostics = {
            "r_hat_noise": float(gelman_rubin(noise)),
            "ess_noise": float(effective_sample_size(noise)),
            "noise_mean": float(noise.mean()),
        }
