"""BART surrogate over a Domain: the native sum-of-trees posterior.

Counterpart of ``bark_tpu/models/bart.py``, backed by the Gibbs sampler of
:mod:`bark_tpu_torch.fitting.bart`. The classic scaling convention: y is
min-max scaled to [-0.5, 0.5], the leaf prior is sigma_mu = 0.5/(k sqrt(m)),
and the inverse-gamma noise prior's rate is calibrated at fit time so that
P(sigma2 < var(y_scaled)) = 0.9. Interface-compatible with the BARK
surrogates (fit / predict / function_samples / is_fitted), so it drops into
:class:`~bark_tpu_torch.strategies.baselines.GridUCBStrategy`.

``device=None`` means the CUDA device and raises without one; pass
``device="cpu"`` for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from bark_tpu_torch.domain import Domain
from bark_tpu_torch.fitting.bart import (
    BARTParams,
    BARTSamples,
    BARTState,
    bart_predict_samples,
    run_bart_sampler,
)
from bark_tpu_torch.forest import route_tree, unpack_forest
from bark_tpu_torch.models.surrogate import bucket_size, normals_for, resolve_device


class _MinMaxHalf:
    """y <-> [-0.5, 0.5] min-max scaling (classic BART convention)."""

    def __init__(self):
        self.y_min = 0.0
        self.range = 1.0

    def __call__(self, y: np.ndarray, train: bool = False) -> np.ndarray:
        if train:
            self.y_min = float(y.min()) if y.size else 0.0
            self.range = float(y.max() - y.min()) if y.size else 1.0
            if self.range <= 0.0:
                self.range = 1.0
        return (y - self.y_min) / self.range - 0.5

    def untransform_mu_var(self, mu, var):
        return (mu + 0.5) * self.range + self.y_min, var * self.range**2


def _invgamma_rate_for_quantile(shape: float, x: float, q: float = 0.9) -> float:
    """Rate b of InvGamma(shape, b) such that P(sigma2 < x) = q (scipy)."""
    from scipy.stats import invgamma

    return x / float(invgamma.ppf(q, shape))


class BARTSurrogate:
    """Fully-Bayesian sum-of-trees surrogate (native BART Gibbs sampler)."""

    def __init__(self, domain: Domain, params: BARTParams | None = None, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.domain = domain
        self.params = params or BARTParams()
        self.scaler = _MinMaxHalf()
        self.samples: BARTSamples | None = None
        self._state: BARTState | None = None
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._bounds = torch.as_tensor(domain.bounds("bitmask"), device=self.device)
        self._feat_types = torch.as_tensor(domain.feature_types(), device=self.device)

    @property
    def is_fitted(self) -> bool:
        return self.samples is not None

    def _store_train_data(self, X, y):
        """Scale y and pad (X, y) to a 32-row bucket with a row mask; set the
        noise prior's rate from the scaled data."""
        X = self.domain.transform(X)
        y = np.asarray(y, np.float64).reshape(-1)
        y_std = self.scaler(y, train=True)
        n = X.shape[0]
        n_pad = bucket_size(n)
        X_pad = np.zeros((n_pad, X.shape[1]), np.float32)
        X_pad[:n] = X
        X_pad[n:] = X[0] if n else 0.0
        y_pad = np.zeros((n_pad,), np.float32)
        y_pad[:n] = y_std
        mask = np.zeros((n_pad,), np.float32)
        mask[:n] = 1.0
        self.train_data = (torch.as_tensor(X_pad, device=self.device),
                           torch.as_tensor(y_pad, device=self.device))
        self.train_mask = torch.as_tensor(mask, device=self.device)
        sighat2 = float(np.var(y_std)) if n > 1 else 1.0
        self._noise_rate = float(np.float32(_invgamma_rate_for_quantile(
            self.params.noise_prior_shape, max(sighat2, 1e-8))))

    def _warm_state(self, X: torch.Tensor) -> BARTState | None:
        """The final chains' trees, leaf values and sigma2, with the leaves
        and f_total rebuilt by routing the new padded X."""
        if self._state is None:
            return None
        leaves = route_tree(unpack_forest(self._state.packed), X, self._feat_types,
                            self.params.max_depth)  # (C, m, N)
        g = torch.gather(self._state.leaf_values, -1, leaves.long())
        return BARTState(self._state.packed, self._state.leaf_values, leaves, g.sum(-2),
                         self._state.sigma2)

    def fit(self, X, y):
        self._store_train_data(X, y)
        train_x, train_y = self.train_data
        init_state = self._warm_state(train_x)
        params = self.params.with_(warmup_steps=0) if init_state is not None else self.params
        self.samples, self._state = run_bart_sampler(
            self._generator, train_x, train_y, self._bounds, self._feat_types, params,
            self._noise_rate, mask=self.train_mask, init_state=init_state,
        )
        return self

    def _flat_samples(self):
        s = self.samples
        return (s.packed.flatten(0, 1), s.leaf_values.flatten(0, 1), s.sigma2.reshape(-1))

    def predict(
        self, X, batched: bool = False, predict_observed: bool = True
    ) -> tuple[np.ndarray, np.ndarray]:
        """Posterior mean and std, shape ``([S,] N, 1)``: per-sample means
        moment-matched across draws; observation noise adds each sample's
        sigma2."""
        candidates = torch.as_tensor(self.domain.transform(X), dtype=torch.float32,
                                     device=self.device)
        packed, leaf_values, sigma2 = self._flat_samples()
        f = bart_predict_samples(packed, leaf_values, candidates, self._feat_types,
                                 self.params.max_depth)  # (S, N), scaled units
        f = f.cpu().numpy().astype(np.float64)
        var_obs = sigma2.cpu().numpy().astype(np.float64)[:, None] * np.ones_like(f)
        mu_s, var_s = self.scaler.untransform_mu_var(
            f, var_obs if predict_observed else np.zeros_like(f)
        )
        if batched:
            return mu_s[..., None], np.sqrt(var_s)[..., None]
        mu = mu_s.mean(axis=0)
        var = var_s.mean(axis=0) + mu_s.var(axis=0)
        return mu[:, None], np.sqrt(var)[:, None]

    def function_samples(self, X, eps=None, num_draws: int = 1) -> np.ndarray:
        """Posterior-predictive draws ``(S*num_draws, N)`` in original units.
        ``eps`` holds the standard normals, ``(num_draws, S, N)``, or is a
        numpy Generator to draw them from (None: ``default_rng(0)``)."""
        mu, std = self.predict(X, batched=True, predict_observed=True)
        mu, std = mu[..., 0], std[..., 0]
        draws = mu[None] + std[None] * normals_for(eps, (num_draws,) + mu.shape)
        return draws.reshape(-1, mu.shape[-1])
