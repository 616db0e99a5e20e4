"""MCMC convergence diagnostics: split-R-hat, ESS, MLL trace summary.

Numpy-only copy of ``bark_tpu/utils/diagnostics.py``, held equal to it by
``tests/test_torch_strategy.py``.
"""

from __future__ import annotations

import numpy as np


def gelman_rubin(chains: np.ndarray) -> float:
    """Split-R-hat over ``(num_chains, num_samples)`` scalar draws."""
    chains = np.asarray(chains, np.float64)
    c, n = chains.shape
    if n < 4:
        return float("nan")
    half = n // 2
    split = chains[:, : 2 * half].reshape(2 * c, half)
    m, n = split.shape
    chain_means = split.mean(axis=1)
    grand = chain_means.mean()
    B = n / (m - 1) * np.sum((chain_means - grand) ** 2)
    W = split.var(axis=1, ddof=1).mean()
    var_plus = (n - 1) / n * W + B / n
    return float(np.sqrt(var_plus / max(W, 1e-300)))


def effective_sample_size(chains: np.ndarray, max_lag: int | None = None) -> float:
    """ESS via initial-monotone autocorrelation sums (Geyer)."""
    chains = np.asarray(chains, np.float64)
    c, n = chains.shape
    if n < 4:
        return float("nan")
    max_lag = max_lag or n - 2
    centered = chains - chains.mean(axis=1, keepdims=True)
    var = centered.var(axis=1).mean()
    if var <= 0:
        return float(c * n)

    # mean autocorrelation across chains per lag
    rho = np.empty(max_lag)
    for lag in range(1, max_lag + 1):
        cov = np.mean(
            [np.mean(ch[:-lag] * ch[lag:]) for ch in centered]
        )
        rho[lag - 1] = cov / var

    # Geyer initial positive sequence on pair sums
    tau = 1.0
    for k in range(0, max_lag - 1, 2):
        pair = rho[k] + rho[k + 1]
        if pair < 0:
            break
        tau += 2 * pair
    return float(c * n / tau)


def mll_trace_summary(mll_trace: np.ndarray) -> dict:
    """Summary of per-chain MLL traces ``(chains, samples)``."""
    mll_trace = np.atleast_2d(np.asarray(mll_trace, np.float64))
    return {
        "final_mean": float(mll_trace[:, -1].mean()),
        "max": float(mll_trace.max()),
        "r_hat": gelman_rubin(mll_trace),
        "ess": effective_sample_size(mll_trace),
    }
