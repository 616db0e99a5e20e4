"""Prior and proposal diagnostics of the noise hyperparameter.

The port's twin of ``examples/priors_and_proposals.py``, over the port's own
proposal machinery (``fitting/noise_scale.py``), with its JSON summary:

  1. the log-space random walk ``exp(log x + s z)`` is lognormal(s, scale=x):
     10,000 draws, the z-score of their log mean and their log spread;
  2. a prior-only MH chain: ``get_noise_scale_proposal`` with no likelihood,
     so the accept ratio is the proposal's log q-ratio + log prior-ratio, on
     ``chains`` chains for ``steps`` steps; its stationary law must be the
     inverse-gamma prior. Run under the default Hastings ratio
     (``q_ratio_style="correct"``) and, for contrast, the reference's.
  3. figures (needs matplotlib; a RuntimeError naming it where it is not
     installed, ``--no-plots`` skips them): the proposal histogram against
     the lognormal density, the noise and scale prior densities, the MH
     chain's histogram against the analytic prior.

Every draw is a tensor from one explicit generator, on the device.

    python -m bark_tpu_torch.benchmarks.priors_and_proposals [--steps 4000] \
        [--chains 64] [--out PATH] [--no-plots] [--device cpu]

Writes ``priors_and_proposals.json`` and the figures under
``results/port/priors_and_proposals/`` unless ``--out`` names the JSON
(the figures go beside it).
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np
import torch

from bark_tpu_torch.fitting.noise_scale import _propose_log, get_noise_scale_proposal
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.models.surrogate import resolve_device

OUT = (pathlib.Path(__file__).resolve().parents[2] / "results" / "port"
       / "priors_and_proposals" / "priors_and_proposals.json")


def lognormal_proposal_check(generator: torch.Generator, x0: float = 1.0, step: float = 0.1,
                             n: int = 10_000) -> dict:
    """``n`` draws of the log-space walk from ``x0`` against the analytic
    lognormal: the z-score of the mean of their standardised logs, and
    their standard deviation (1 if the walk is lognormal)."""
    dev = generator.device
    z = torch.randn(n, generator=generator, device=dev)
    draws = _propose_log(z, torch.full((n,), x0, device=dev), step).double().cpu().numpy()
    zs = (np.log(draws) - np.log(x0)) / step
    return {"proposal_log_mean_z": float(zs.mean() * np.sqrt(n)),
            "proposal_log_std": float(zs.std(ddof=1)), "draws": draws}


def prior_only_mh_chain(generator: torch.Generator, params: SamplerParams, steps: int,
                        chains: int, init: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """MH on the noise prior alone through the sampler's proposal; returns
    the (chains, steps) noise trace and accept flags."""
    dev = generator.device
    z = torch.randn((steps, chains), generator=generator, device=dev)
    log_u = torch.log(torch.rand((steps, chains), generator=generator, device=dev))
    noise = torch.full((chains,), init, device=dev)
    scale = torch.ones(chains, device=dev)
    trace, accepts = [], []
    for t in range(steps):
        (new_noise, _), log_alpha = get_noise_scale_proposal(z[t], z[t], noise, scale, params)
        accept = log_u[t] <= torch.clamp_max(log_alpha, 0.0)
        noise = torch.where(accept, new_noise, noise)
        trace.append(noise)
        accepts.append(accept)
    return (torch.stack(trace, 1).double().cpu().numpy(),
            torch.stack(accepts, 1).cpu().numpy())


def inverse_gamma_moments(shape: float, rate: float, q=(0.1, 0.5, 0.9)):
    """Mean and quantiles of InvGamma(shape, scale=1/rate)."""
    import scipy.stats as stats

    dist = stats.invgamma(shape, scale=1.0 / rate)
    return float(dist.mean()), [float(dist.ppf(p)) for p in q]


def run_study(steps: int = 4000, chains: int = 64, burn_frac: float = 0.25, seed: int = 0,
              device=None) -> tuple[dict, dict]:
    """The JSON summary, and the arrays the figures need."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    prop = lognormal_proposal_check(gen)
    defaults = SamplerParams()
    mean_an, q_an = inverse_gamma_moments(defaults.gamma_prior_shape, defaults.gamma_prior_rate)
    burn = int(steps * burn_frac)

    def mh_summary(style):
        traces, accepts = prior_only_mh_chain(gen, SamplerParams(q_ratio_style=style), steps,
                                              chains)
        post = traces[:, burn:]
        chain_means = post.mean(axis=1)  # the independent units of the z-score
        se = chain_means.std(ddof=1) / np.sqrt(len(chain_means))
        return post, {
            "mh_accept_rate": float(accepts[:, burn:].mean()),
            "noise_prior_mean_empirical": float(chain_means.mean()),
            "noise_prior_mean_z": float(abs(chain_means.mean() - mean_an) / max(se, 1e-12)),
            "noise_prior_quantiles_empirical": [float(np.quantile(post, p))
                                                for p in (0.1, 0.5, 0.9)],
        }

    # the default ratio must reproduce the analytic prior; the reference's
    # ratio is kept for contrast (its bias halves the prior's upper tail)
    post, correct_stats = mh_summary("correct")
    _, reference_stats = mh_summary("reference")
    summary = {
        "config": {
            "steps": steps, "chains": chains, "burn": burn,
            "prior": f"InvGamma(shape={defaults.gamma_prior_shape}, "
                     f"scale=1/{defaults.gamma_prior_rate})",
        },
        "proposal_lognormal": {k: v for k, v in prop.items() if k != "draws"},
        "noise_prior_mean_analytic": mean_an,
        "noise_prior_quantiles_analytic": q_an,
        "default_correct_ratio": correct_stats,
        "reference_ratio_for_contrast": reference_stats,
    }
    return summary, {"draws": prop["draws"], "post": post}


def plot(arrays: dict, out_dir: pathlib.Path) -> None:
    """The three figures (needs matplotlib)."""
    import scipy.stats as stats

    from bark_tpu_torch.fitting.noise_scale import half_normal_logpdf, inverse_gamma_logpdf
    from bark_tpu_torch.utils.plots import pyplot, save_fig

    plt = pyplot()
    defaults = SamplerParams()
    draws, post = arrays["draws"], arrays["post"]
    fig, ax = plt.subplots(figsize=(5, 3.2))
    ax.hist(draws, bins=40, density=True, alpha=0.6)
    t = np.linspace(1e-3, draws.max(), 400)
    ax.plot(t, stats.lognorm(s=0.1, scale=1.0).pdf(t))
    ax.set_title("log-space proposal vs lognormal density")
    save_fig(fig, out_dir / "proposal_lognormal.png")

    fig, ax = plt.subplots(figsize=(5, 3.2))
    t = np.linspace(1e-3, 3.0, 400)
    tt = torch.as_tensor(t)
    ax.plot(t, np.exp(inverse_gamma_logpdf(tt, defaults.gamma_prior_shape,
                                           defaults.gamma_prior_rate).numpy()),
            label="noise prior (InvGamma)")
    ax.plot(t, np.exp(half_normal_logpdf(tt, 5.0).numpy()), label="scale prior (HalfNormal)")
    ax.legend()
    save_fig(fig, out_dir / "prior_densities.png")

    fig, ax = plt.subplots(figsize=(5, 3.2))
    ax.hist(post.reshape(-1), bins=60, density=True, alpha=0.6, range=(0.0, 3.0))
    ax.plot(t, stats.invgamma(defaults.gamma_prior_shape,
                              scale=1.0 / defaults.gamma_prior_rate).pdf(t),
            label="analytic prior")
    ax.legend()
    ax.set_title("prior-only MH chain vs analytic inverse-gamma")
    save_fig(fig, out_dir / "noise_mh_vs_prior.png")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--burn-frac", type=float, default=0.25)
    ap.add_argument("--out", type=pathlib.Path, default=OUT)
    ap.add_argument("--no-plots", action="store_true")
    ap.add_argument("--device", default=None, help="cpu, or the CUDA device if left out")
    args = ap.parse_args(argv)
    summary, arrays = run_study(args.steps, args.chains, args.burn_frac, device=args.device)
    print(json.dumps(summary), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(summary, indent=1))
    if not args.no_plots:
        plot(arrays, args.out.parent)
    return summary


if __name__ == "__main__":
    main()
