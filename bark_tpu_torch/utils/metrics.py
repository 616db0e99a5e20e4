"""Prediction-quality metrics (numpy only): Gaussian log-likelihood, NLPD,
MSE. Copy of ``bark_tpu/utils/metrics.py``; a test holds the two equal."""

from __future__ import annotations

import numpy as np


def gaussian_log_likelihood(y: np.ndarray, mu: np.ndarray, var: np.ndarray):
    """Pointwise Gaussian log-density of y under N(mu, var)."""
    y, mu, var = (np.asarray(a, np.float64).reshape(-1) for a in (y, mu, var))
    return -0.5 * (np.log(2 * np.pi * var) + (y - mu) ** 2 / var)


def nlpd(y: np.ndarray, mu: np.ndarray, var: np.ndarray) -> float:
    """Negative log predictive density, averaged over points."""
    return float(-np.mean(gaussian_log_likelihood(y, mu, var)))


def mse(y: np.ndarray, mu: np.ndarray) -> float:
    y, mu = np.asarray(y).reshape(-1), np.asarray(mu).reshape(-1)
    return float(np.mean((y - mu) ** 2))
