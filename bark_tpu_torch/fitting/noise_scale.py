"""Noise/scale hyperparameter random-walk proposals and priors.

Counterpart of ``bark_tpu/fitting/noise_scale.py``. The walk's two standard
normals are arguments (``z_noise``, ``z_scale``) instead of draws inside a
key, so the same normals give the same proposal in both packages. All
functions are elementwise over the chain dimension.
"""

from __future__ import annotations

import math

import torch

from bark_tpu_torch.fitting.params import SamplerParams

# the reference's effective step sizes (noise, scale)
NOISE_STEP = 1.0
SCALE_STEP = 1e-8


def half_normal_logpdf(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``scale`` is the variance."""
    log_normal = -0.5 * (x**2) / scale - 0.5 * math.log(scale)
    return torch.where(x >= 0, log_normal, -torch.inf)


def inverse_gamma_logpdf(x: torch.Tensor, shape: float, rate: float) -> torch.Tensor:
    """Inverse-gamma log density with scale ``1 / rate``."""
    scale = 1.0 / rate
    return (
        -(shape + 1) * torch.log(x)
        - scale / x
        - math.lgamma(shape)
        + shape * math.log(scale)
    )


def _propose_log(z: torch.Tensor, cur: torch.Tensor, step_size: float) -> torch.Tensor:
    """Random walk in log space."""
    return torch.exp(torch.log(cur + 1e-30) + step_size * z)


def _propose_softplus(
    z: torch.Tensor, cur: torch.Tensor, step_size: float
) -> torch.Tensor:
    """Random walk in inverse-softplus space."""
    t = torch.log(torch.expm1(cur)) + step_size * z
    return torch.log1p(torch.exp(t))


def _softplus_log_q_sq(old, new, step_var):
    """The reference's softplus proposal-density expression (kept only for
    ``q_ratio_style="reference"``; not a valid Hastings ratio)."""
    return (
        (torch.log(torch.expm1(old)) - torch.log(torch.expm1(new))) ** 2 / step_var
        + torch.log(-torch.expm1(-old))
        - torch.log(-torch.expm1(-new))
    )


def _softplus_log_jac_ratio(old, new):
    """Correct softplus-walk Hastings ratio, log q(old|new) - log q(new|old):
    only the Jacobian of the inverse softplus survives."""
    return -torch.log(-torch.expm1(-old)) + torch.log(-torch.expm1(-new))


def get_noise_scale_proposal(
    z_noise: torch.Tensor,
    z_scale: torch.Tensor,
    noise: torch.Tensor,
    scale: torch.Tensor,
    params: SamplerParams,
) -> tuple[tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Joint (noise, scale) proposal with log q-ratio + log prior-ratio.

    ``z_noise``/``z_scale`` are the walk's standard normals (the reference
    draws them from the two halves of its key).
    """
    correct = params.q_ratio_style == "correct"
    if params.use_softplus_transform:
        if not params.sample_scale:
            # default: noise-only softplus walk + inverse-gamma prior
            new_noise = _propose_softplus(z_noise, noise, NOISE_STEP)
            log_q = (
                _softplus_log_jac_ratio(noise, new_noise)
                if correct
                else -_softplus_log_q_sq(noise, new_noise, NOISE_STEP**2)
            )
            log_prior = inverse_gamma_logpdf(
                new_noise, params.gamma_prior_shape, params.gamma_prior_rate
            ) - inverse_gamma_logpdf(
                noise, params.gamma_prior_shape, params.gamma_prior_rate
            )
            return (new_noise, scale), log_q + log_prior

        # joint softplus walk + half-normal priors
        new_noise = _propose_softplus(z_noise, noise, NOISE_STEP)
        new_scale = _propose_softplus(z_scale, scale, SCALE_STEP)
        if correct:
            log_q = _softplus_log_jac_ratio(noise, new_noise) + (
                _softplus_log_jac_ratio(scale, new_scale)
            )
        else:
            log_q = _softplus_log_q_sq(noise, new_noise, NOISE_STEP**2) + (
                _softplus_log_q_sq(scale, new_scale, SCALE_STEP**2)
            )
        log_prior = (
            half_normal_logpdf(new_noise, 1.0)
            + half_normal_logpdf(new_scale, 5.0)
            - half_normal_logpdf(noise, 1.0)
            - half_normal_logpdf(scale, 5.0)
        )
        return (new_noise, new_scale), log_q + log_prior

    if not params.sample_scale:
        raise NotImplementedError(
            "You must sample the scale parameter in the log space"
        )

    # log-space walk + half-normal priors
    new_noise = _propose_log(z_noise, noise, NOISE_STEP)
    new_scale = _propose_log(z_scale, scale, SCALE_STEP)
    log_q = (
        -torch.log(noise) - torch.log(scale) + torch.log(new_noise) + torch.log(new_scale)
    )
    log_prior = (
        half_normal_logpdf(new_noise, 1.0)
        + half_normal_logpdf(new_scale, 5.0)
        - half_normal_logpdf(noise, 1.0)
        - half_normal_logpdf(scale, 5.0)
    )
    return (new_noise, new_scale), log_q + log_prior
