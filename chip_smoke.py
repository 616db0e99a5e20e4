#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, builds the port's CUDA kernels from
``bark_tpu_torch/csrc`` and drives its main path, the forest-MCMC sampler
in both of its tiers, in phases:

  1. device: the card's name and power limit (nvidia-smi); full-float32
     matmuls (TF32 off);
  2. build: nvcc for sm_90a, build seconds and the ptxas report, which
     must show no register spills;
  3. K1 (leaf-agreement Gram) against its plain version on leaves routed
     through prior forests, exact equality (``torch.equal``): (64, 50, 50)
     and (64, 200, 200) on the symmetric path (the same leaves and mask
     twice) unmasked, with a 0/1 mask and with a float mask; the sampler's
     tree-major view; (3, 77, 130) masked and unmasked; the predict-shaped
     (64, 1024, 200); m = 37 (a partial 32-tree word); node_limit = 300 (16 planes,
     ids up to 299). Then at (64, 50, 50) and (64, 200, 200) as the
     sampler calls it and at (64, 1024, 200): device time (torch.profiler),
     call time, the plain version's,
     the bf16 one-hot ``torch.bmm`` (counts checked), the bound and the
     share of it (``bark_tpu_torch/benchmarks/kernel_timing.py``);
  4. K2 (batched Cholesky with inverse, one launch for any BK <= 256)
     against its plain version on refresh-shaped SPD batches (128, n, n),
     n in {50, 128, 200, 256}: |L - L_plain| <= 1e-4 (2e-4 at n=256, the
     reference's bound for its blocked path) and |E L - I| <= 5e-4; kernel
     and plain times at each shape; a zero pivot (a zero row and column)
     and a negative one (a negated matrix) give NaN over all of that
     matrix's L and E on both versions, and the rest of the batch stays
     finite and within the bound; device time, cuSOLVER's (the plain
     version) and the bytes bound at each shape. Then leaf-shaped batches A = Z^T Z +
     (nu/gamma) I (Z the compact leaf indicator of prior forests routed at
     N=1024): K2 at (128, 256, 256) for nu/gamma in {5, 0.05}, and
     ``blocked_cholesky`` (two K2 launches, host-blocked at 256) at
     (128, 384, 384) and (128, 512, 512), against the plain version with
     the relative bound |L - L_plain| / max |L_plain| <= 5e-4 (float32
     against float64 gives up to 6e-5 on such batches at nu/gamma = 0.05)
     and |E L - I| <= 5e-4; on the blocked path a zero pivot in the second
     block, one in the first and a negated matrix each poison that whole
     matrix on both versions;
  5. the slice: TreeFunction(dim=5, m=50, seed=1), 64 chains from empty
     forests, one untimed ``run_bark_sampler`` call (10 samples x 5 steps)
     and one timed call from its last sample, at N=50 and at N=200. Checks:
     finite MLL and noise, a tree-move accept rate strictly in (0, 1), both
     kernels launched during the timed run, K2 once per init and refresh
     (steps + 1 launches: no factorization is blocked on the host), final
     leaves equal to a fresh routing, carried K^-1 / logdet equal to a
     plain rebuild (rtol 1e-3 / atol 2e-3 and rtol 1e-4 / atol 1e-3), and
     one step replayed on the CPU with the plain versions from the same
     state and draws giving the same accept decisions (up to near-ties,
     |log u - min(log a, 0)| < 1e-3);
  6. the leaf slice: the same configuration at N=1024 (leaf budget R=256,
     one K2 launch per factorization) and N=4096 (R=384, two), which
     ``auto`` resolves to the leaf tier (coefficient-space move scan with
     the capacity guard, leaf-space refresh). Checks: finite MLL, a
     tree-move accept rate in (0, 1), every chain's leaf total <= R, K2
     launched (steps + 1) times per 256-block and K1 not at all, final
     leaves equal to a fresh routing, the carried factor L of A and logdet
     equal to a plain rebuild from a fresh Z (relative 5e-4; rtol 1e-4 /
     atol 1e-3); at N=1024, Z Z^T equal to m times the plain Gram, each
     chain's MLL equal to the dense MLL computed in float64 from
     gamma Z Z^T + nu I (|diff| <= 1e-4 |mll| + 1e-3), and one step
     replayed on the CPU deciding alike up to near-ties.

  7. predict and acquisition at full width: TreeFunction(dim=5, m=50,
     seed=1), 200 observations (bucket 224), 16 chains x 8 samples, so
     S = 128 posterior samples. ``BARKSurrogate.fit``, ``predict`` at 1024
     held-out points, ``build_acquisition`` and one ``evaluate_acquisition``
     at B = 4096. Checks: K_XX (128, 224, 224), K_xX (128, 1024, 224) and
     k_vec (128, 4096, 224) equal their plain versions (``torch.equal``);
     the factor of K within K2's bound (|L - L_plain| <= 2e-4,
     |E L - I| <= 5e-4) and K^-1 within 1e-3 of the plain one's largest
     entry; the routing on the card equal to the CPU's; mu and var of every
     sample against a float64 dense posterior computed on the CPU from the
     same forests (|diff| <= 1e-3 + 1e-3 |value|); the LCB against the same
     oracle (the same bound); held-out MSE under the mean predictor's; K1
     and K2 launches per call as the code predicts (fit: steps + 1 each;
     predict: 2 and 1; build: 1 and 1; score: 1 and 0; one more K2 launch
     per jitter escalation, which ``robust_cholesky`` counts). Then a second
     fit at N = 4096 with 4 chains (S = 32), where ``auto`` takes the
     leaf-space predict and, through ``TreeKernelStrategy.ask``, the
     factored build (K1 never launched, K2 seven times per (32, 1600,
     1600) factorization, r = 1600 padded to 7 blocks of 256): leaf predict
     and factored LCB against a float64 dense oracle on the card on 256
     candidates, the Thompson build with fixed draws against its float64
     formula (1e-3 of theta's largest entry), and ``blocked_cholesky``
     against cuSOLVER at (32, 1600, 1600). Times of each call, both kernels
     at the new shapes, and the peak device memory;
  8. the BO loop: (a) TreeFunction(dim=2, m=10, seed=1), 8 initial points,
     2 chains x 8 samples of 20 trees, 1024 candidates x 3 rounds, 45
     iterations through ``make_strategy("BARK", ...)`` on the default (CUDA)
     device, for seeds 0, 1 and 2. Required of every seed: each ask in the
     domain, ``fallbacks == 0`` and the best y after the loop strictly
     below the best of the 8 initial points (unless those already hold the
     grid minimum). Printed: the
     iteration at which each seed reaches the minimum of a 400 x 400 grid
     (within 1e-6), and the best of a ``RandomStrategy`` run of the same
     budget. (b) five iterations at full width (dim=5, m=50, 4 chains x 8
     samples, 4096 candidates x 4 rounds, from 50 observations): seconds
     per iteration split into fit, build, score and centring, and both
     kernels' launches per iteration against the count the code predicts.

The whole run takes about six minutes of command time on an H100 (the sampler's
step is bound by the host's launch rate, so the time follows the host; the
sampler paths keep their 64 chains, which cost the host no more than 32).

Prints what each phase found, then one JSON line with each kernel's launch
count on the N=50 run and on each path ("launches_by_path": the sampler's
four sizes, "predict", "acquisition" and "bo_iteration"), error, times
at the headline shape ("ms" is the device time; "call_ms", "plain_ms",
"library_ms", "bound_ms" and "bound_by" beside it) and at each timed shape
under "times", the
nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises: the exit code is
then non-zero and no result line is printed. Without CUDA it exits 1.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np

SLICE_CHAINS = 64
SLICE_TREES = 50
DENSE_NS = (50, 200)
LEAF_NS = (1024, 4096)
LEAF_CHECK_N = 1024  # the leaf size with the float64 dense MLL and the CPU replay
NEAR_TIE = 1e-3
REL_BOUND = 5e-4  # |L - L_plain| / max |L_plain| on leaf-shaped A


PREDICT_N = 200  # observations of the full-width predict (bucket 224)
PREDICT_CHAINS = 16  # x 8 samples: S = 128 posterior samples
PREDICT_POINTS = 1024  # held-out points
ACQ_BATCH = 4096  # candidates of one scored batch
BIG_N = 4096  # observations of the leaf-space predict and the factored build
BO_SEEDS = (0, 1, 2)
BO_ITERATIONS = 45
ORACLE_ATOL = ORACLE_RTOL = 1e-3  # float32 posterior against the float64 oracle


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def rel_err(torch, got, want) -> float:
    """Largest |got - want| / max |want| over the matrices of a batch."""
    num = (got - want).abs().amax((-2, -1))
    return (num / want.abs().amax((-2, -1))).max().item()


def replay_on_cpu(torch, tag, state, X, y, bounds, ft, params, num_trees):
    """One step on the card and on the CPU (plain versions) from the same
    state and draws: each chain decides every move alike, or parts at a
    near-tie (|log u - min(log a, 0)| < NEAR_TIE) after which it is not
    compared further."""
    from bark_tpu_torch.fitting.sampler import draw_step, step_with_info

    chains = state.noise.shape[0]
    draws = draw_step(torch.Generator().manual_seed(7), chains, params)
    _, dev_info = step_with_info(state, X, y, bounds, ft, params, draws.to(X.device))
    _, cpu_info = step_with_info(
        state.to("cpu"), X.cpu(), y.cpu(), bounds.cpu(), ft.cpu(), params, draws,
    )
    # a chain's moves are sequential: after its first differing decision
    # (which must be a near-tie) the two runs of that chain part ways
    log_u = torch.log(draws.proposal.u_accept)
    gap = (log_u - torch.clamp_max(cpu_info.tree_log_alpha, 0.0)).abs()
    differ = dev_info.tree_accepts.cpu() != cpu_info.tree_accepts
    hyper_gap = (torch.log(draws.u_hyper)
                 - torch.clamp_max(cpu_info.hyper_log_alpha, 0.0)).abs()
    hyper_differ = dev_info.hyper_accept.cpu() != cpu_info.hyper_accept
    parted = 0
    for c in range(chains):
        js = torch.nonzero(differ[c]).flatten()
        if js.numel():
            parted += 1
            j = int(js[0])
            require(gap[c, j].item() < NEAR_TIE,
                    f"{tag}: chain {c} move {j} decided differently on the card "
                    f"and the CPU away from a near-tie (gap {gap[c, j].item()})")
        elif hyper_differ[c]:
            require(hyper_gap[c].item() < NEAR_TIE,
                    f"{tag}: chain {c} noise move decided differently away "
                    f"from a near-tie (gap {hyper_gap[c].item()})")
    log(f"[{tag}] card vs CPU replay of one step: {parted} of {chains} chains "
        f"parted at a near-tie, the rest decided all {num_trees} tree moves "
        f"alike; noise moves differ in {int(hyper_differ.sum())} chains")


def oracle_posterior(torch, train_leaves, cand_leaves, mask, y, noise, scale, n_null=None):
    """Float64 dense posterior of every sample from leaf ids, by plain
    compares on the tensors' device: (mu, var), each (S, B). With ``n_null``
    the agreement is rescaled to leave out the null trees, as the
    acquisition does."""
    s, n, m = train_leaves.shape
    mask = mask.double()
    y = y.double()
    eye = torch.eye(n, dtype=torch.float64, device=mask.device)
    mus, vars_ = [], []
    for i in range(s):
        tl, cl = train_leaves[i], cand_leaves[i]
        gram = (tl[:, None, :] == tl[None, :, :]).sum(-1).double() / m
        k = (cl[:, None, :] == tl[None, :, :]).sum(-1).double() / m
        if n_null is not None:
            rest = max(m - float(n_null[i]), 1.0)
            gram = (gram - float(n_null[i]) / m) * (m / rest)
            k = (k - float(n_null[i]) / m) * (m / rest)
        gram = gram * mask[:, None] * mask[None, :]
        sc, nu = scale[i].double(), 1e-6 + noise[i].double()
        k = sc * k * mask[None, :]
        chol = torch.linalg.cholesky(sc * gram + nu * eye)
        sol = torch.cholesky_solve(k.T, chol)  # K^-1 k^T, (N, B)
        mus.append(k @ torch.cholesky_solve(y[:, None], chol)[:, 0])
        vars_.append(sc - (k * sol.T).sum(-1))
    return torch.stack(mus), torch.stack(vars_)


def within(torch, got, want, atol, rtol) -> tuple[bool, float]:
    """(all |got - want| <= atol + rtol |want|, the largest |got - want|)."""
    diff = (got.double().cpu() - want.double().cpu()).abs()
    return bool((diff <= atol + rtol * want.double().cpu().abs()).all()), diff.max().item()


def phase_predict_acquisition(torch, dev, smi, tf):
    """Phase 7 (see the module docstring). Returns the launches by path and
    the kernel times at the new shapes."""
    from bark_tpu_torch.benchmarks.kernel_timing import time_k1, time_k2
    from bark_tpu_torch.fitting.params import SamplerParams
    from bark_tpu_torch.forest import (
        compact_leaf_indicator, flatten_batch, gram_from_leaves, num_null_trees, route_forest,
    )
    from bark_tpu_torch.models.gp import forest_predict, forest_predict_leaf
    from bark_tpu_torch.models.surrogate import BARKSurrogate
    from bark_tpu_torch.ops import gram as gram_module
    from bark_tpu_torch.ops.chol import MAX_BLOCK, chol_inv_cuda, chol_inv_plain
    from bark_tpu_torch.ops.gram import gram_cuda, gram_plain
    from bark_tpu_torch.ops.linalg import (
        JITTER, blocked_cholesky, kernel_matrix, robust_chol_inv_logdet, robust_cholesky,
    )
    from bark_tpu_torch.optimizer.acquisition import (
        DEFAULT_KAPPA, build_acquisition, build_acquisition_lr, build_acquisition_ts,
        evaluate_acquisition,
    )
    from bark_tpu_torch.strategies.tree_kernel import TreeKernelStrategy

    def zero():
        gram_cuda.launches = chol_inv_cuda.launches = robust_cholesky.escalations = 0

    def counts():
        return {"gram": gram_cuda.launches, "chol_inv": chol_inv_cuda.launches}

    peaks = {}

    def timed(fn, what=None):
        """Run one call of the path: (result, seconds, launches, jitter
        escalations); its peak device memory goes to ``peaks[what]``."""
        zero()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if what:
            peaks[what] = round(torch.cuda.max_memory_allocated() / 2**20)
        return out, dt, counts(), robust_cholesky.escalations

    def lcb_of(mu, var):
        return (mu - DEFAULT_KAPPA * var.clamp_min(1e-12).sqrt()).mean(0)

    launches, times = {}, {}
    rng = np.random.default_rng(7)
    dom = tf.domain
    X, Xt = dom.sample(PREDICT_N, rng), dom.sample(PREDICT_POINTS, rng)
    y, yt = tf.f(X), tf.f(Xt)
    params = SamplerParams(num_chains=PREDICT_CHAINS, num_samples=8, steps_per_sample=5,
                           warmup_steps=50)
    steps = params.warmup_steps + params.num_samples * params.steps_per_sample
    samples = params.num_chains * params.num_samples
    m, node_limit, depth = params.num_trees, params.node_limit, params.max_depth

    sur = BARKSurrogate(dom, params, seed=0)
    require(sur.device.type == "cuda", "the surrogate's default device is the card")
    _, fit_s, c, _ = timed(lambda: sur.fit(X, y))
    launches["fit N=200"] = c
    require(c == {"gram": steps + 1, "chol_inv": steps + 1},
            f"fit in the dense tier: K1 and K2 once per init and refresh ({steps + 1}), got {c}")
    log(f"[predict] fit: {PREDICT_N} observations (bucket {sur.train_data[0].shape[0]}), "
        f"{params.num_chains} chains x {params.num_samples} samples, {steps} steps in "
        f"{fit_s:.2f} s on {smi}; launches {c}; {sur.fit_diagnostics}")

    (mu, std), predict_s, c, esc = timed(lambda: sur.predict(Xt), "predict")
    launches["predict"] = c
    require(c == {"gram": 2, "chol_inv": 1 + esc},
            f"predict: 2 K1 calls and 1 K2 call (+{esc} escalations), got {c}")
    mse, base = float(np.mean((mu[:, 0] - yt) ** 2)), float(np.mean((yt - y.mean()) ** 2))
    require(np.isfinite(mu).all() and np.isfinite(std).all() and mu.shape == (PREDICT_POINTS, 1),
            "predict: finite (points, 1) mean and std")
    require(mse < base, f"predict: held-out MSE {mse} under the mean predictor's {base}")
    log(f"[predict] predict at {PREDICT_POINTS} held-out points, S={samples}: {predict_s * 1e3:.1f} ms; "
        f"launches {c}, {esc} jitter escalations; MSE {mse:.4f} vs mean predictor {base:.4f}")

    # the pieces of that call, each against its plain version
    train_x, train_y = sur.train_data
    mask, ft = sur.train_mask, sur._feat_types
    flat = flatten_batch(sur.model.forest)
    noise, scale = sur.model.noise.reshape(-1), sur.model.scale.reshape(-1)
    cand = torch.as_tensor(Xt, device=dev)
    tl = route_forest(flat, train_x, ft, depth).contiguous()
    cl = route_forest(flat, cand, ft, depth).contiguous()
    K_XX = gram_from_leaves(tl, tl, mask, mask, node_limit)
    K_xX = gram_from_leaves(cl, tl, None, mask, node_limit)
    require(torch.equal(K_XX, gram_plain(tl, tl, mask, mask)),
            f"K_XX {tuple(K_XX.shape)} equals its plain version")
    require(torch.equal(K_xX, gram_plain(cl, tl, None, mask)),
            f"K_xX {tuple(K_xX.shape)} equals its plain version")
    K = kernel_matrix(K_XX, noise, scale)
    L, E = blocked_cholesky(K)
    Lp, Ep = chol_inv_plain(K)
    n_pad = K.shape[-1]
    err_l = (L - Lp).abs().max().item()
    resid = (E @ L - torch.eye(n_pad, device=dev)).abs().max().item()
    require(err_l <= 2e-4, f"predict K2 ({samples},{n_pad},{n_pad}): |L - L_plain| = {err_l} <= 2e-4")
    require(resid <= 5e-4, f"predict K2: |E L - I| = {resid} <= 5e-4")
    K_inv, _ = robust_chol_inv_logdet(K)
    K_inv_p = Ep.transpose(1, 2) @ Ep
    err_inv = rel_err(torch, K_inv, K_inv_p)
    require(err_inv <= 1e-3, f"predict: |K_inv - plain| / max |plain| = {err_inv} <= 1e-3")
    log(f"[predict] K_XX {tuple(K_XX.shape)} and K_xX {tuple(K_xX.shape)} exact; K2 at "
        f"({samples},{n_pad},{n_pad}): |L-L_plain| {err_l:.3e}, |EL-I| {resid:.3e}, "
        f"|K_inv-plain|/max {err_inv:.3e}; noise {noise.min().item():.4f}-{noise.max().item():.4f}")

    # float64 dense oracle on the CPU from the same forests (own routing)
    cpu = torch.device("cpu")
    flat_c, ft_c = flat.to(cpu), ft.cpu()
    tl_c = route_forest(flat_c, train_x.cpu(), ft_c, depth)
    cl_c = route_forest(flat_c, cand.cpu(), ft_c, depth)
    require(torch.equal(tl_c, tl.cpu()) and torch.equal(cl_c, cl.cpu()),
            "predict: routing on the card equals routing on the CPU")
    mu_s, var_s = forest_predict(
        sur.model.forest, sur.model.noise, sur.model.scale, train_x, train_y, cand, ft, depth,
        train_mask=mask,
    )
    mu64, var64 = oracle_posterior(
        torch, tl_c, cl_c, mask.cpu(), train_y.cpu(), noise.cpu(), scale.cpu())
    ok_mu, err_mu = within(torch, mu_s, mu64, ORACLE_ATOL, ORACLE_RTOL)
    ok_var, err_var = within(torch, var_s, var64.clamp_min(1e-12), ORACLE_ATOL, ORACLE_RTOL)
    require(ok_mu and ok_var,
            f"predict against the float64 oracle: |mu diff| {err_mu}, |var diff| {err_var} "
            f"within {ORACLE_ATOL} + {ORACLE_RTOL} |value|")
    log(f"[predict] mu and var of {samples} samples x {PREDICT_POINTS} points against the float64 dense "
        f"posterior (CPU): max |mu diff| {err_mu:.3e}, max |var diff| {err_var:.3e}")

    acq, build_s, c, esc = timed(
        lambda: build_acquisition(sur.model, train_x, train_y, ft, depth, train_mask=mask),
        "build_acquisition")
    build_counts = c
    require(c == {"gram": 1, "chol_inv": 1 + esc},
            f"build_acquisition: 1 K1 call and 1 K2 call (+{esc} escalations), got {c}")
    batch = torch.as_tensor(dom.sample(ACQ_BATCH, rng), device=dev)
    lcb, score_s, c, _ = timed(lambda: evaluate_acquisition(acq, batch, ft, depth),
                                f"score B={ACQ_BATCH}")
    require(c == {"gram": 1, "chol_inv": 0}, f"evaluate_acquisition: 1 K1 call, got {c}")
    launches["acquisition"] = {k: build_counts[k] + c[k] for k in c}
    cb = route_forest(acq.forest, batch, ft, depth).contiguous()
    k_vec = gram_from_leaves(cb, acq.train_leaves, None, mask, node_limit)
    require(torch.equal(k_vec, gram_plain(cb, acq.train_leaves, None, mask)),
            f"k_vec {tuple(k_vec.shape)} equals its plain version")
    n_null = num_null_trees(flat)
    mu64, var64 = oracle_posterior(
        torch, tl_c, route_forest(flat_c, batch.cpu(), ft_c, depth), mask.cpu(), train_y.cpu(),
        noise.cpu(), scale.cpu(), n_null.cpu())
    ok_lcb, err_lcb = within(torch, lcb, lcb_of(mu64, var64), ORACLE_ATOL, ORACLE_RTOL)
    require(bool(torch.isfinite(lcb).all()) and ok_lcb,
            f"LCB at B={ACQ_BATCH} against the float64 oracle: max |diff| {err_lcb}")
    log(f"[acquisition] build_acquisition ({samples},{n_pad},{n_pad}): {build_s * 1e3:.1f} ms, "
        f"launches {build_counts}; evaluate_acquisition at B={ACQ_BATCH}: {score_s * 1e3:.1f} ms, "
        f"launches {c}; k_vec {tuple(k_vec.shape)} exact; LCB against the float64 oracle "
        f"(CPU): max |diff| {err_lcb:.3e}; null trees per sample {int(n_null.min())}-"
        f"{int(n_null.max())}; on {smi}")

    # both kernels at this path's shapes
    for name, args, reps in (
        (f"({samples},{n_pad},{n_pad})", (tl, tl, mask, mask), (25, 10)),
        (f"({samples},{PREDICT_POINTS},{n_pad})", (cl, tl, None, mask), (10, 3)),
        (f"({samples},{ACQ_BATCH},{n_pad})", (cb, acq.train_leaves, None, mask), (5, 2)),
    ):
        t = time_k1(torch, gram_module, *args, node_limit, *reps)
        require(t["device_ms"] is not None, f"K1 {name}: the profiler saw the kernel")
        times[("gram", name)] = t
        log(f"[K1] {name}{' symmetric' if t['symmetric'] else ''}: device {t['device_ms']} ms "
            f"({t['kernels_per_call']} kernels a call: {t['kernel_ms']}), call {t['call_ms']:.5f}, plain {t['plain_ms']:.5f}; bf16 "
            f"one-hot bmm {t['library_ms']} ms device; bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}), {100 * t['share_of_bound']:.1f}% of it, on {smi}")
    t = time_k2(torch, lambda: chol_inv_cuda(K), lambda: chol_inv_plain(K), samples, n_pad,
                "chol_inv_kernel")
    require(t["device_ms"] is not None, "K2 at the predict shape: the profiler saw the kernel")
    times[("chol_inv", f"({samples},{n_pad},{n_pad})")] = t
    log(f"[K2] ({samples},{n_pad},{n_pad}): device {t['device_ms']:.5f} ms, call "
        f"{t['call_ms']:.5f}, plain {t['plain_ms']:.5f} call / {t['library_ms']} device "
        f"(cuSOLVER); bound {t['bound_ms']:.5f} ms ({t['bound_by']}), "
        f"{100 * t['share_of_bound']:.1f}% of it, on {smi}")
    log(f"[predict] peak device memory of each call at S={samples}, MiB: {peaks}")
    peaks.clear()
    del K_XX, K_xX, K, L, E, Lp, Ep, K_inv, K_inv_p, k_vec, acq, cb, cl, tl

    # ---- N = 4096, S = 32: the leaf-space predict and the factored build
    X4 = dom.sample(BIG_N, rng)
    y4 = tf.f(X4)
    params4 = params.with_(num_chains=4)
    s4 = params4.num_chains * params4.num_samples
    sur4 = BARKSurrogate(dom, params4, seed=1)
    _, fit_s, c, _ = timed(lambda: sur4.fit(X4, y4))
    launches["fit N=4096"] = c
    require(c == {"gram": 0, "chol_inv": 2 * (steps + 1)},
            f"fit at N={BIG_N} (leaf tier, R=384): 2 K2 launches per init and refresh, got {c}")
    r = m * ((node_limit + 1) // 2)
    blocks = -(-r // MAX_BLOCK)
    (mu, std), predict_s, c, _ = timed(lambda: sur4.predict(Xt), "leaf predict")
    launches["predict N=4096"] = c
    require(c == {"gram": 0, "chol_inv": blocks},
            f"leaf predict: no K1 call and {blocks} K2 launches (r={r}), got {c}")
    mse = float(np.mean((mu[:, 0] - yt) ** 2))
    require(mse < base, f"leaf predict: held-out MSE {mse} under the mean predictor's {base}")
    log(f"[predict N=4096] fit {steps} steps x {params4.num_chains} chains in {fit_s:.2f} s; "
        f"auto -> leaf-space predict at {PREDICT_POINTS} points, S={s4}: {predict_s * 1e3:.1f} ms, "
        f"launches {c}; MSE {mse:.4f} vs {base:.4f}; on {smi}")

    train_x, train_y = sur4.train_data
    mask = sur4.train_mask
    flat = flatten_batch(sur4.model.forest)
    noise, scale = sur4.model.noise.reshape(-1), sur4.model.scale.reshape(-1)
    sub = cand[:256]
    tl = route_forest(flat, train_x, ft, depth)
    cl = route_forest(flat, sub, ft, depth)
    mu_s, var_s = forest_predict_leaf(
        sur4.model.forest, sur4.model.noise, sur4.model.scale, train_x, train_y, sub, ft, depth,
        train_mask=mask,
    )
    mu64, var64 = oracle_posterior(torch, tl, cl, mask, train_y, noise, scale)
    ok_mu, err_mu = within(torch, mu_s, mu64, ORACLE_ATOL, ORACLE_RTOL)
    ok_var, err_var = within(torch, var_s, var64, ORACLE_ATOL, ORACLE_RTOL)
    require(ok_mu and ok_var and bool((var_s > 0).all()),
            f"leaf predict against the float64 dense oracle: |mu diff| {err_mu}, "
            f"|var diff| {err_var} within {ORACLE_ATOL} + {ORACLE_RTOL} |value|")
    log(f"[predict N=4096] leaf predict against the float64 dense posterior (card, 256 "
        f"points): max |mu diff| {err_mu:.3e}, max |var diff| {err_var:.3e}; "
        f"noise {noise.min().item():.4f}-{noise.max().item():.4f}")

    # auto takes the factored build: one ask through the strategy
    strat = TreeKernelStrategy(dom, surrogate=sur4, seed=1, num_candidates=ACQ_BATCH,
                               num_rounds=1)
    strat.X, strat.y = dom.transform(X4), y4
    used = []
    import bark_tpu_torch.strategies.tree_kernel as tk

    real_lr, real_ts = tk.build_acquisition_lr, tk.build_acquisition_ts
    tk.build_acquisition_lr = lambda *a, **k: (used.append("lr"), real_lr(*a, **k))[1]
    tk.build_acquisition_ts = lambda *a, **k: (used.append("ts"), real_ts(*a, **k))[1]
    try:
        point, ask_s, c, esc = timed(lambda: strat.ask(1))
    finally:
        tk.build_acquisition_lr, tk.build_acquisition_ts = real_lr, real_ts
    lo, hi = dom.bounds("ordinal").T
    require(used[:1] == ["lr"] and strat.fallbacks == 0,
            f"ask at padded N=4096: auto takes the factored build (builds used: {used})")
    require(c == {"gram": 0, "chol_inv": blocks * (len(used) + esc)},
            f"ask at N=4096: no K1 call, {blocks} K2 launches per build {used} and "
            f"escalation ({esc}), got {c}")
    require(bool((lo <= point[0]).all() and (point[0] <= hi).all()), "ask at N=4096 in the domain")
    log(f"[acquisition N=4096] ask through TreeKernelStrategy: builds {used}, "
        f"{ask_s:.2f} s, launches {c}")

    acq_lr, build_s, c, esc = timed(
        lambda: build_acquisition_lr(sur4.model, train_x, train_y, ft, depth, train_mask=mask),
        "build_acquisition_lr")
    require(c == {"gram": 0, "chol_inv": blocks * (1 + esc)},
            f"build_acquisition_lr: {blocks} K2 launches (+{esc} escalations), got {c}")
    launches["acquisition N=4096"] = c
    lcb, score_s, c, _ = timed(lambda: evaluate_acquisition(acq_lr, batch, ft, depth),
                                f"factored score B={ACQ_BATCH}")
    require(c == {"gram": 0, "chol_inv": 0}, f"factored scoring launches no kernel, got {c}")
    n_null = num_null_trees(flat)
    mu64, var64 = oracle_posterior(
        torch, tl, route_forest(flat, batch[:256], ft, depth), mask, train_y, noise, scale, n_null)
    ok_lcb, err_lcb = within(torch, lcb[:256], lcb_of(mu64, var64), ORACLE_ATOL, ORACLE_RTOL)
    require(bool(torch.isfinite(lcb).all()) and ok_lcb,
            f"factored LCB against the float64 dense oracle: max |diff| {err_lcb}")
    log(f"[acquisition N=4096] build_acquisition_lr (S={s4}, r={r}): {build_s * 1e3:.1f} ms, "
        f"{blocks} K2 launches; scoring B={ACQ_BATCH}: {score_s * 1e3:.1f} ms; LCB against the "
        f"float64 dense oracle (card, 256 candidates): max |diff| {err_lcb:.3e}")
    del acq_lr

    # Thompson build with fixed draws against its float64 formula
    pick = 5
    eps = torch.randn(r, generator=torch.Generator().manual_seed(3)).to(dev)
    acq_ts, ts_s, c, _ = timed(
        lambda: build_acquisition_ts(pick, eps, sur4.model, train_x, train_y, ft, depth,
                                     train_mask=mask))
    require(c == {"gram": 0, "chol_inv": blocks}, f"build_acquisition_ts: {blocks} K2 launches, got {c}")
    chosen = type(flat)(*(f[pick : pick + 1] for f in flat))
    Z = (compact_leaf_indicator(chosen, tl[pick : pick + 1], (node_limit + 1) // 2)[0]
         * mask[:, None]).double()
    nu, gamma = JITTER + noise[pick].double(), scale[pick].double() / m
    A = Z.T @ Z + (nu / gamma) * torch.eye(r, dtype=torch.float64, device=dev)
    La = torch.linalg.cholesky(A)
    theta64 = torch.cholesky_solve((Z.T @ (train_y.double() * mask.double()))[:, None], La)[:, 0]
    theta64 = theta64 + nu.sqrt() * torch.linalg.solve_triangular(
        La.T, eps.double()[:, None], upper=True)[:, 0]
    err_theta = ((acq_ts.theta.double() - theta64).abs().max() / theta64.abs().max()).item()
    require(err_theta <= 1e-3, f"Thompson theta against its float64 formula: {err_theta} <= 1e-3")
    ts_scores = evaluate_acquisition(acq_ts, batch, ft, depth)
    require(bool(torch.isfinite(ts_scores).all()), "Thompson scores finite")
    log(f"[acquisition N=4096] build_acquisition_ts (r={r}): {ts_s * 1e3:.1f} ms, {blocks} K2 "
        f"launches; |theta - float64| / max |theta| {err_theta:.3e}")

    # the (S, r, r) factorization against cuSOLVER
    Zs = compact_leaf_indicator(flat, tl, (node_limit + 1) // 2) * mask[:, None]
    A32 = (Zs.transpose(1, 2) @ Zs
           + ((JITTER + noise) / (scale / m))[:, None, None] * torch.eye(r, device=dev))
    del Zs
    Lb, Eb = blocked_cholesky(A32)
    Lp, _ = chol_inv_plain(A32)
    err_l = rel_err(torch, Lb, Lp)
    resid = (Eb @ Lb - torch.eye(r, device=dev)).abs().max().item()
    require(err_l <= REL_BOUND, f"blocked_cholesky ({s4},{r},{r}): |L - L_plain| / max = {err_l}")
    require(resid <= 5e-3, f"blocked_cholesky ({s4},{r},{r}): |E L - I| = {resid} <= 5e-3")
    del Lb, Eb, Lp
    t = time_k2(torch, lambda: blocked_cholesky(A32), lambda: chol_inv_plain(A32), s4, r,
                None, reps=5, inner=2)
    require(t["device_ms"] is not None, "blocked_cholesky: the profiler saw its kernels")
    times[("chol_inv", f"({s4},{r},{r}) blocked")] = t
    log(f"[K2] ({s4},{r},{r}) leaf-space factor through blocked_cholesky ({blocks} launches): "
        f"|L-L_plain|/max|L| {err_l:.3e}, |EL-I| {resid:.3e}; device {t['device_ms']:.3f} ms "
        f"({t['kernels_per_call']:.0f} kernels a call), call {t['call_ms']:.3f}, cuSOLVER "
        f"{t['plain_ms']:.3f} call / {t['library_ms']} device; bound {t['bound_ms']:.3f} ms "
        f"({t['bound_by']}), {100 * t['share_of_bound']:.1f}% of it, on {smi}")
    log(f"[predict N=4096] peak device memory of each call at S={s4}, MiB: {peaks}")
    return launches, times


def phase_bo_loop(torch, dev, smi):
    """Phase 8 (see the module docstring). Returns the launches of one
    full-width BO iteration."""
    import bark_tpu_torch.optimizer.search as search
    import bark_tpu_torch.strategies.tree_kernel as tk
    from bark_tpu_torch.benchmarks import map_benchmark
    from bark_tpu_torch.fitting.params import SamplerParams
    from bark_tpu_torch.ops.chol import chol_inv_cuda
    from bark_tpu_torch.ops.gram import gram_cuda
    from bark_tpu_torch.ops.linalg import robust_cholesky
    from bark_tpu_torch.strategies.tree_kernel import make_strategy

    # (a) the documented flow, on the default device
    bench = map_benchmark("TreeFunction", dim=2, m=10, function_seed=1)
    lo, hi = bench.domain.bounds("ordinal").T
    axis = (np.arange(400) + 0.5) / 400
    grid = np.stack(np.meshgrid(axis, axis), -1).reshape(-1, 2).astype(np.float32)
    grid_min = float(bench.f(grid).min())
    params = SamplerParams(warmup_steps=50, num_samples=8, steps_per_sample=5,
                           num_chains=2, num_trees=20)
    for seed in BO_SEEDS:
        X = bench.domain.sample(8, np.random.default_rng(seed))
        y = bench.f(X)
        s = make_strategy("BARK", bench.domain, seed=seed, params=params,
                          num_candidates=1024, num_rounds=3)
        require(s.device.type == "cuda", "make_strategy's default device is the card")
        gram_cuda.launches = chol_inv_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.tell(X, y)
        reached = 0 if y.min() <= grid_min + 1e-6 else None
        for i in range(BO_ITERATIONS):
            c = s.ask(1)
            require(c.shape == (1, 2) and bool((lo <= c[0]).all() and (c[0] <= hi).all()),
                    f"BO seed {seed} iteration {i}: the ask {c} lies in the domain")
            s.add(c, bench.f(c))
            if reached is None and s.y.min() <= grid_min + 1e-6:
                reached = i + 1
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rnd = make_strategy("Random", bench.domain, seed=seed)
        rnd.tell(X, y)
        for _ in range(BO_ITERATIONS):
            c = rnd.ask(1)
            rnd.add(c, bench.f(c))
        require(s.fallbacks == 0, f"BO seed {seed}: no random fallback ({s.fallbacks})")
        require(gram_cuda.launches > 0 and chol_inv_cuda.launches > 0,
                f"BO seed {seed}: both kernels launched")
        if reached != 0:
            require(s.y.min() < y.min(),
                    f"BO seed {seed}: best y {s.y.min()} below the initial best {y.min()}")
        found = ("not reached" if reached is None else "already among the initial points"
                 if reached == 0 else f"reached at iteration {reached}")
        log(f"[BO seed {seed}] {BO_ITERATIONS} iterations in {dt:.1f} s "
            f"({dt / BO_ITERATIONS:.2f} s each) on {smi}: best y {s.y.min():.6f} (initial "
            f"{y.min():.6f}, grid minimum {grid_min:.6f}, "
            f"{found}); Random "
            f"strategy {rnd.y.min():.6f}; fallbacks {s.fallbacks}; launches K1 "
            f"{gram_cuda.launches}, K2 {chol_inv_cuda.launches}; {s.surrogate.fit_diagnostics}")

    # (b) five iterations at full width, split by part
    bench = map_benchmark("TreeFunction", dim=5, m=50, function_seed=1)
    lo, hi = bench.domain.bounds("ordinal").T
    params = SamplerParams(num_chains=4, num_samples=8, steps_per_sample=5, warmup_steps=50)
    steps = params.num_samples * params.steps_per_sample
    rounds = 4
    s = make_strategy("BARK", bench.domain, seed=0, params=params, num_candidates=ACQ_BATCH,
                      num_rounds=rounds)
    X = bench.domain.sample(50, np.random.default_rng(0))
    s.tell(X, bench.f(X))
    spent = {"build": 0.0, "score": 0.0, "centre": 0.0}
    calls = {"dense": 0, "ts": 0}

    def clocked(part, fn, tally=None):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[part] += time.perf_counter() - t0
            if tally:
                calls[tally] += 1
            return out
        return run

    patched = [
        (tk, "build_acquisition", clocked("build", tk.build_acquisition, "dense")),
        (tk, "build_acquisition_ts", clocked("build", tk.build_acquisition_ts, "ts")),
        (search, "evaluate_acquisition", clocked("score", search.evaluate_acquisition)),
        (search, "_leaf_box", clocked("centre", search._leaf_box)),
        (search, "_box_center", clocked("centre", search._box_center)),
    ]
    originals = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
    rows, per_iter = [], None
    try:
        for mod, name, fn in patched:
            setattr(mod, name, fn)
        for i in range(5):
            for k in spent:
                spent[k] = 0.0
            calls["dense"] = calls["ts"] = 0
            gram_cuda.launches = chol_inv_cuda.launches = robust_cholesky.escalations = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c = s.ask(1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            s.add(c, bench.f(c))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            require(bool((lo <= c[0]).all() and (c[0] <= hi).all()),
                    f"full-width BO iteration {i}: the ask lies in the domain")
            per_iter = {"gram": gram_cuda.launches, "chol_inv": chol_inv_cuda.launches}
            # fit: init + every refresh; dense build: 1 + 1; dense search: a K1
            # call per scored batch; a Thompson build: 7 K2 launches (r = 1600)
            want = {
                "gram": steps + 1 + calls["dense"] * (1 + 1 + rounds),
                "chol_inv": steps + 1 + calls["dense"] + 7 * calls["ts"]
                + robust_cholesky.escalations,
            }
            require(per_iter == want, f"full-width BO iteration {i}: launches {per_iter}, "
                                      f"the code predicts {want} ({calls})")
            rows.append({"ask_s": t1 - t0, "fit_s": t2 - t1, **spent})
            log(f"[BO full width] iteration {i}: {t2 - t0:.2f} s = fit {t2 - t1:.2f} + ask "
                f"{t1 - t0:.2f} (build {spent['build']:.3f}, score {spent['score']:.3f}, "
                f"centring {spent['centre']:.3f}); builds {calls}; launches {per_iter}")
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    require(s.fallbacks == 0, f"full-width BO: no random fallback ({s.fallbacks})")
    med = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
    log(f"[BO full width] dim 5, m 50, S={params.num_chains * params.num_samples}, {ACQ_BATCH} "
        f"candidates x {rounds + 1} batches, N=50-54 (bucket 64), medians of 5 on {smi}: "
        f"{med['ask_s'] + med['fit_s']:.2f} s per iteration = fit {med['fit_s']:.2f} + build "
        f"{med['build']:.3f} + score {med['score']:.3f} + centring {med['centre']:.3f} + other "
        f"{med['ask_s'] - med['build'] - med['score'] - med['centre']:.3f}")
    return per_iter


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1

    # --- 1. device ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)")

    from bark_tpu_torch.benchmarks.tree_function import (
        TreeFunction,
        sample_tree_structure_from_prior,
    )
    from bark_tpu_torch.fitting.params import SamplerParams
    from bark_tpu_torch.fitting.sampler import (
        BARKModel,
        _leaf_budget,
        _leaf_Z,
        run_bark_sampler,
        run_chain,
    )
    from bark_tpu_torch.fitting.traversal import terminal_mask
    from bark_tpu_torch.forest import Forest, create_empty_forest, route_forest
    from bark_tpu_torch.ops import _build
    from bark_tpu_torch.ops.chol import MAX_BLOCK, chol_inv_cuda, chol_inv_plain
    from bark_tpu_torch.benchmarks.kernel_timing import call_ms, time_k1, time_k2
    from bark_tpu_torch.ops import gram as gram_module
    from bark_tpu_torch.ops.gram import (
        gram_cuda,
        gram_plain,
        is_symmetric_call,
        launch_plan,
    )
    from bark_tpu_torch.ops.linalg import JITTER, blocked_cholesky, kernel_matrix

    # --- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.load_library()
    log(f"[build] {lib.path.name}: nvcc {lib.build_seconds:.2f} s "
        f"(load {time.perf_counter() - t0:.2f} s) from "
        f"{[s.name for s in _build.sources()]}")
    for line in lib.build_log.splitlines():
        if "registers" in line or "bytes stack" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")
        spills = re.findall(r"(\d+) bytes spill", line)
        require(all(int(v) == 0 for v in spills), f"no register spills: {line.strip()}")

    # --- data: leaves routed through prior forests -------------------------
    tf = TreeFunction(dim=5, m=SLICE_TREES, function_seed=1)
    ft = torch.as_tensor(tf.domain.feature_types(), device=dev)
    bounds = torch.as_tensor(tf.domain.bounds("bitmask"), device=dev)
    rng = np.random.default_rng(0)

    def prior_forests(count: int) -> Forest:
        trees = [
            sample_tree_structure_from_prior(SLICE_TREES, 5, rng) for _ in range(count)
        ]
        return Forest(*(torch.stack(f).to(dev) for f in zip(*trees)))

    X_of = {}

    def routed(forests: Forest, n: int) -> torch.Tensor:
        X_of[n] = torch.as_tensor(tf.domain.sample(n, rng), device=dev)
        return route_forest(forests, X_of[n], ft).contiguous()  # (B, n, m)

    forests64 = prior_forests(SLICE_CHAINS)
    leaves = {n: routed(forests64, n) for n in (50, 128, 200)}

    # --- 3. K1 against its plain version -----------------------------------
    def rand_mask(*shape):
        return torch.as_tensor(
            (rng.uniform(size=shape) > 0.2).astype(np.float32), device=dev
        )

    forests3 = prior_forests(3)
    l77, l130 = routed(forests3, 77), routed(forests3, 130)
    leaves[1024] = routed(forests64, 1024)
    # (name, l1, l2, mask1, mask2, node_limit); the same tensor twice takes
    # the symmetric path, as the sampler's calls do
    k1_cases = []
    for n in (50, 200):
        ln = leaves[n]
        k1_cases.append((f"({SLICE_CHAINS},{n},{n}) symmetric", ln, ln, None, None, 64))
        mask = rand_mask(n)
        k1_cases.append((f"({SLICE_CHAINS},{n},{n}) symmetric masked", ln, ln, mask, mask, 64))
        fmask = torch.as_tensor(rng.uniform(0.1, 3.0, (SLICE_CHAINS, n)).astype(np.float32),
                                device=dev)
        k1_cases.append((f"({SLICE_CHAINS},{n},{n}) symmetric float mask", ln, ln, fmask,
                         fmask, 64))
    tree_major = route_forest(forests64, X_of[200], ft)  # the sampler's strided view
    k1_cases.append((f"({SLICE_CHAINS},200,200) tree-major view", tree_major, tree_major,
                     None, None, 64))
    k1_cases.append(("(3,77,130)", l77, l130, None, None, 64))
    k1_cases.append(("(3,77,130) masked", l77, l130, rand_mask(3, 77), rand_mask(130), 64))
    k1_cases.append((f"({SLICE_CHAINS},1024,200) predict-shaped", leaves[1024], leaves[200],
                     None, None, 64))
    l37 = leaves[200][..., :37].contiguous()
    k1_cases.append((f"({SLICE_CHAINS},200,200) m=37", l37, l37, None, None, 64))
    wide = torch.as_tensor(rng.integers(0, 300, (SLICE_CHAINS, 200, SLICE_TREES)),
                           dtype=torch.int32, device=dev)
    k1_cases.append((f"({SLICE_CHAINS},200,200) node_limit=300", wide, wide, None, None, 300))
    k1_cases.append(("(3,77,130) node_limit=300 masked", wide[:3, :77], wide[:3, 70:],
                     rand_mask(77), rand_mask(3, 130), 300))
    k1_err = 0.0
    for name, a, b, m1, m2, nl in k1_cases:
        got = gram_cuda(a, b, m1, m2, nl)
        want = gram_plain(a, b, m1, m2)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        k1_err = max(k1_err, err)
        require(torch.equal(got, want), f"K1 {name} equals its plain version (max err {err})")
        plan = launch_plan(a.shape[0], a.shape[1], b.shape[1], a.shape[2], nl,
                           is_symmetric_call(a, b, m1, m2))
        log(f"[K1] {name}: exact; {plan.planes} bit planes, tile {plan.tile}, "
            f"{plan.jobs} jobs{' (symmetric)' if plan.symmetric else ''}")

    # timed as the sampler calls it (the same leaves and all-ones mask twice)
    # and at the predict shape: device and call time, the bf16
    # one-hot product, the bound
    k1_times = {}
    for n, mcols in ((50, 50), (200, 200), (1024, 200)):
        if n == mcols:
            ones = torch.ones(n, device=dev)
            args = (leaves[n], leaves[n], ones, ones)
        else:
            args = (leaves[n], leaves[mcols], None, None)
        t = time_k1(torch, gram_module, *args, 64)
        name = f"({SLICE_CHAINS},{n},{mcols})"
        k1_times[name] = t
        log(f"[K1] {name}{' symmetric' if t['symmetric'] else ''}: device "
            f"{t['device_ms']} ms ({t['kernels_per_call']} kernels a call: {t['kernel_ms']}), "
            f"call {t['call_ms']:.5f}, plain {t['plain_ms']:.5f}; bf16 one-hot bmm "
            f"{t['library_ms']} ms device; bound {t['bound_ms']:.5f} ms ({t['bound_by']}), "
            f"{100 * t['share_of_bound']:.1f}% of it, on {smi}")
        require(t["device_ms"] is not None, f"K1 {name}: the profiler saw the kernel")

    # --- 4. K2 against its plain version -----------------------------------
    def spd_batch(n: int) -> torch.Tensor:
        ln = leaves[n]
        gram = gram_plain(ln, ln)
        return torch.cat(
            [
                kernel_matrix(gram, torch.full((SLICE_CHAINS,), noise, device=dev),
                              torch.ones(SLICE_CHAINS, device=dev))
                for noise in (0.1, 0.01)
            ]
        ).contiguous()  # (128, n, n)

    leaves[256] = routed(forests64, 256)
    k2_err = 0.0
    k2_times = {}
    for n in (50, 128, 200, 256):
        K = spd_batch(n)
        eye = torch.eye(n, device=dev)
        name = f"(128,{n},{n})"
        bound = 2e-4 if n > 200 else 1e-4
        L, E = chol_inv_cuda(K)
        Lp, Ep = chol_inv_plain(K)
        torch.cuda.synchronize()
        err_l = (L - Lp).abs().max().item()
        resid = (E @ L - eye).abs().max().item()
        err_e = (E - Ep).abs().max().item()
        k2_err = max(k2_err, err_l)
        require(err_l <= bound, f"K2 {name}: |L - L_plain| = {err_l} <= {bound}")
        require(resid <= 5e-4, f"K2 {name}: |E L - I| = {resid} <= 5e-4")
        require(torch.equal(torch.triu(L, 1), torch.zeros_like(L)), f"K2 {name}: L lower")
        require(torch.equal(torch.triu(E, 1), torch.zeros_like(E)), f"K2 {name}: E lower")
        t = time_k2(torch, lambda: chol_inv_cuda(K), lambda: chol_inv_plain(K), K.shape[0], n,
                    "chol_inv_kernel")
        require(t["device_ms"] is not None, f"K2 {name}: the profiler saw the kernel")
        k2_times[name] = t
        log(f"[K2] {name}: |L-L_plain| {err_l:.3e}, |EL-I| {resid:.3e}, "
            f"|E-E_plain| {err_e:.3e}; kernel device {t['device_ms']:.5f} ms, call "
            f"{t['call_ms']:.5f}, plain {t['plain_ms']:.5f} call / {t['library_ms']} device "
            f"(cuSOLVER); bound {t['bound_ms']:.5f} ms ({t['bound_by']}), "
            f"{100 * t['share_of_bound']:.1f}% of it, on {smi}")
        if n in (50, 256):
            # pivot faults: matrix 3 exactly singular (a zero row and
            # column), matrix 7 negated; each poisoned whole, no other
            bad = K.clone()
            bad[3, n // 2, :] = 0.0
            bad[3, :, n // 2] = 0.0
            bad[7] = -bad[7]
            good = [i for i in range(bad.shape[0]) if i not in (3, 7)]
            L, E = chol_inv_cuda(bad)
            Lp, Ep = chol_inv_plain(bad)
            torch.cuda.synchronize()
            for which, (l_, e_) in (("kernel", (L, E)), ("plain", (Lp, Ep))):
                for i in (3, 7):
                    require(bool(torch.isnan(l_[i]).all() and torch.isnan(e_[i]).all()),
                            f"K2 {name} {which}: matrix {i} all NaN")
                require(bool(torch.isfinite(l_[good]).all() and torch.isfinite(e_[good]).all()),
                        f"K2 {name} {which}: the rest of the batch finite")
            err_good = (L[good] - Lp[good]).abs().max().item()
            require(err_good <= bound, f"K2 {name} faults: rest |L - L_plain| {err_good}")
            log(f"[K2] {name} with a zero and a negative pivot: both matrices all "
                f"NaN on kernel and plain, the other {len(good)} finite "
                f"(|L-L_plain| {err_good:.3e})")

    # K2 and its blocked path on leaf-shaped A = Z^T Z + (nu/gamma) I
    forests128 = prior_forests(2 * SLICE_CHAINS)
    leaves_leaf = routed(forests128, LEAF_CHECK_N)
    ones = torch.ones(LEAF_CHECK_N, device=dev)

    def leaf_A(budget: int, ratio: float) -> torch.Tensor:
        Z, _ = _leaf_Z(forests128, leaves_leaf, budget, ones)
        eye = torch.eye(budget, device=dev)
        return (Z.transpose(1, 2) @ Z + ratio * eye).contiguous()  # (128, R, R)

    def check_factor(name, L, E, Lp, n, rows=slice(None)):
        err = rel_err(torch, L[rows], Lp[rows])
        resid = (E[rows] @ L[rows] - torch.eye(n, device=dev)).abs().max().item()
        require(err <= REL_BOUND, f"K2 {name}: |L - L_plain| / max |L_plain| = {err} <= {REL_BOUND}")
        require(resid <= 5e-4, f"K2 {name}: |E L - I| = {resid} <= 5e-4")
        require(torch.equal(torch.tril(L[rows]), L[rows]), f"K2 {name}: L lower")
        return err, resid

    k2_leaf_err = 0.0
    for ratio in (5.0, 0.05):
        A = leaf_A(MAX_BLOCK, ratio)
        name = f"({A.shape[0]},{MAX_BLOCK},{MAX_BLOCK}) leaf nu/gamma={ratio}"
        L, E = chol_inv_cuda(A)
        Lp, _ = chol_inv_plain(A)
        torch.cuda.synchronize()
        err, resid = check_factor(name, L, E, Lp, MAX_BLOCK)
        k2_leaf_err = max(k2_leaf_err, err)
        ms = call_ms(torch, lambda: chol_inv_cuda(A))
        plain_ms = call_ms(torch, lambda: chol_inv_plain(A))
        k2_times[name] = {"call_ms": ms, "plain_ms": plain_ms}
        log(f"[K2] {name}: |L-L_plain|/max|L| {err:.3e}, |EL-I| {resid:.3e}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms on {smi}")
    for r in (384, 512):
        A = leaf_A(r, 0.05)
        name = f"({A.shape[0]},{r},{r}) leaf blocked"
        before = chol_inv_cuda.launches
        L, E = blocked_cholesky(A)
        Lp, _ = chol_inv_plain(A)
        torch.cuda.synchronize()
        blocks = chol_inv_cuda.launches - before
        require(blocks == 2, f"K2 {name}: two launches (256-blocks), got {blocks}")
        err, resid = check_factor(name, L, E, Lp, r)
        k2_leaf_err = max(k2_leaf_err, err)
        ms = call_ms(torch, lambda: blocked_cholesky(A))
        plain_ms = call_ms(torch, lambda: chol_inv_plain(A))
        k2_times[name] = {"call_ms": ms, "plain_ms": plain_ms}
        # pivot faults: a zero row and column in the second diagonal block
        # (matrix 3) and in the first (matrix 5), a negated matrix (7)
        bad = A.clone()
        for i, row in ((3, r - 40), (5, 60)):
            bad[i, row, :] = 0.0
            bad[i, :, row] = 0.0
        bad[7] = -bad[7]
        good = [i for i in range(bad.shape[0]) if i not in (3, 5, 7)]
        L, E = blocked_cholesky(bad)
        Lp, Ep = chol_inv_plain(bad)
        torch.cuda.synchronize()
        for which, (l_, e_) in (("blocked", (L, E)), ("plain", (Lp, Ep))):
            for i in (3, 5, 7):
                require(bool(torch.isnan(l_[i]).all() and torch.isnan(e_[i]).all()),
                        f"K2 {name} {which}: matrix {i} all NaN")
            require(bool(torch.isfinite(l_[good]).all() and torch.isfinite(e_[good]).all()),
                    f"K2 {name} {which}: the rest of the batch finite")
        err_good, _ = check_factor(f"{name} faults", L, E, Lp, r, good)
        log(f"[K2] {name}: 2 launches; |L-L_plain|/max|L| {err:.3e}, |EL-I| "
            f"{resid:.3e}; blocked {ms:.4f} ms, plain {plain_ms:.4f} ms on {smi}; "
            f"zero pivots in blocks 2 and 1 and a negated matrix all NaN on both, "
            f"the other {len(good)} within the bound ({err_good:.3e})")

    # --- 5. the dense slice, 6. the leaf slice -----------------------------
    launches = {}
    rates = {}

    def drive(n: int):
        """One untimed and one timed call of the sampler at N=n (64 chains
        from empty forests); returns the timed run, the launches during it
        and the data."""
        X_np = tf.domain.sample(n, np.random.default_rng(0))
        y_np = tf.f(X_np)
        y_np = (y_np - y_np.mean()) / y_np.std()
        X = torch.as_tensor(X_np, device=dev)
        y = torch.as_tensor(y_np, dtype=torch.float32, device=dev)
        params = SamplerParams(
            warmup_steps=0, num_samples=10, steps_per_sample=5,
            num_chains=SLICE_CHAINS, num_trees=SLICE_TREES,
        )
        model = BARKModel(
            create_empty_forest(SLICE_TREES, params.node_limit, (SLICE_CHAINS,), dev),
            torch.full((SLICE_CHAINS,), 0.1, device=dev),
            torch.ones(SLICE_CHAINS, device=dev),
        )
        gen = torch.Generator(device=dev).manual_seed(n)
        t0 = time.perf_counter()
        samples = run_bark_sampler(gen, model, X, y, bounds, ft, params)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        warm = BARKModel(
            Forest(*(f[:, -1] for f in samples.forest)),
            samples.noise[:, -1], samples.scale[:, -1],
        )

        gram_cuda.launches = 0
        chol_inv_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = run_chain(gen, warm, X, y, bounds, ft, params)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {"gram": gram_cuda.launches, "chol_inv": chol_inv_cuda.launches}
        steps = params.num_samples * params.steps_per_sample
        rate = SLICE_CHAINS * steps / dt
        rates[n] = rate
        acc = run.tree_accept_rate.mean().item()
        log(f"[slice N={n}] untimed call {cold:.2f} s; timed call {steps} steps x "
            f"{SLICE_CHAINS} chains in {dt:.3f} s = {rate:.1f} chain-steps/s "
            f"on {smi}; tree accept {acc:.4f}, noise accept "
            f"{run.hyper_accept_rate.mean().item():.4f}; launches {counts}")
        require(bool(torch.isfinite(run.mll).all()), f"N={n}: finite MLL")
        require(bool(torch.isfinite(run.samples.noise).all()), f"N={n}: finite noise")
        require(0.0 < acc < 1.0, f"N={n}: tree accept rate {acc} in (0, 1)")
        return run, counts, steps, params, X, y

    for n in DENSE_NS:
        run, counts, steps, params, X, y = drive(n)
        launches[f"dense N={n}"] = counts
        require(counts["gram"] > 0 and counts["chol_inv"] > 0,
                f"N={n}: both kernels launched on the main path {counts}")
        require(counts["chol_inv"] == steps + 1,
                f"N={n}: K2 launched once per init and refresh ({steps + 1}), "
                f"got {counts['chol_inv']}")

        state = run.state
        fresh = route_forest(state.forest, X, ft)
        require(torch.equal(fresh, state.leaves), f"N={n}: leaves equal a fresh routing")
        # independent rebuild with the plain versions (no kernel)
        K = kernel_matrix(gram_plain(fresh, fresh), state.noise, state.scale)
        Lr = torch.linalg.cholesky(K)
        Er = torch.linalg.solve_triangular(
            Lr, torch.eye(n, device=dev).expand_as(K), upper=False
        )
        K_inv = Er.transpose(-1, -2) @ Er
        logdet = 2.0 * torch.log(torch.diagonal(Lr, dim1=-2, dim2=-1)).sum(-1)
        torch.testing.assert_close(state.kern.K_inv, K_inv, rtol=1e-3, atol=2e-3)
        torch.testing.assert_close(state.kern.K_logdet, logdet, rtol=1e-4, atol=1e-3)
        log(f"[slice N={n}] leaves == fresh routing; |K_inv - rebuild| "
            f"{(state.kern.K_inv - K_inv).abs().max().item():.3e}, |logdet - rebuild| "
            f"{(state.kern.K_logdet - logdet).abs().max().item():.3e}")

        replay_on_cpu(torch, f"slice N={n}", state, X, y, bounds, ft, params, SLICE_TREES)

    for n in LEAF_NS:
        run, counts, steps, params, X, y = drive(n)
        launches[f"leaf N={n}"] = counts
        budget = _leaf_budget(params, n)
        blocks = -(-budget // MAX_BLOCK)
        require(counts["gram"] == 0, f"N={n}: the leaf tier builds no Gram (K1 {counts['gram']})")
        require(counts["chol_inv"] == blocks * (steps + 1),
                f"N={n}: K2 launched {blocks} time(s) per init and refresh at R={budget} "
                f"({blocks * (steps + 1)}), got {counts['chol_inv']}")
        state = run.state
        require(state.kern.K_inv is None and state.kern.L.shape == (SLICE_CHAINS, budget, budget),
                f"N={n}: the leaf tier carries the (R, R) factor, R={budget}")
        totals = terminal_mask(state.forest).sum((1, 2))
        require(bool((totals <= budget).all()),
                f"N={n}: every chain's leaf total <= R={budget} (max {int(totals.max())})")
        fresh = route_forest(state.forest, X, ft)
        require(torch.equal(fresh, state.leaves), f"N={n}: leaves equal a fresh routing")
        # rebuild with the plain versions from a fresh Z
        Z, _ = _leaf_Z(state.forest, fresh, budget, torch.ones(n, device=dev))
        nu, gamma = JITTER + state.noise, state.scale / SLICE_TREES
        eye = torch.eye(budget, device=dev)
        Lr = torch.linalg.cholesky(Z.transpose(1, 2) @ Z + (nu / gamma)[:, None, None] * eye)
        logdet = (n * torch.log(nu) + budget * torch.log(gamma / nu)
                  + 2.0 * torch.log(torch.diagonal(Lr, dim1=-2, dim2=-1)).sum(-1))
        err = rel_err(torch, state.kern.L, Lr)
        require(err <= REL_BOUND, f"N={n}: |L - rebuild| / max |L| = {err} <= {REL_BOUND}")
        torch.testing.assert_close(state.kern.K_logdet, logdet, rtol=1e-4, atol=1e-3)
        log(f"[slice N={n}] leaf tier, R={budget}: leaf totals {int(totals.min())}-"
            f"{int(totals.max())}; leaves == fresh routing; |L - rebuild|/max|L| "
            f"{err:.3e}, |logdet - rebuild| "
            f"{(state.kern.K_logdet - logdet).abs().max().item():.3e}")
        if n != LEAF_CHECK_N:
            continue
        # the two tiers compute one likelihood: Z Z^T is m times the plain
        # Gram, and the leaf-space MLL is the dense one, here in float64
        ZZt = Z @ Z.transpose(1, 2)
        require(torch.equal(ZZt, torch.round(gram_plain(fresh, fresh) * SLICE_TREES)),
                f"N={n}: Z Z^T == m * gram")
        K = gamma.double()[:, None, None] * ZZt.double() + torch.diag_embed(
            nu.double()[:, None].expand(-1, n))
        Lk = torch.linalg.cholesky(K)
        yb = y.double()[None, :, None].expand(SLICE_CHAINS, n, 1)
        z = torch.linalg.solve_triangular(Lk, yb, upper=False)[..., 0]
        dense = 0.5 * (-(z * z).sum(-1)
                       - 2.0 * torch.log(torch.diagonal(Lk, dim1=-2, dim2=-1)).sum(-1))
        diff = (state.mll.double() - dense).abs()
        require(bool((diff <= 1e-4 * dense.abs() + 1e-3).all()),
                f"N={n}: leaf MLL equals the dense float64 MLL (max diff {diff.max().item()})")
        log(f"[slice N={n}] Z Z^T == m * gram; leaf MLL vs dense float64 MLL: max "
            f"|diff| {diff.max().item():.3e} (|mll| {dense.abs().min().item():.1f}-"
            f"{dense.abs().max().item():.1f})")
        replay_on_cpu(torch, f"slice N={n}", state, X, y, bounds, ft, params, SLICE_TREES)

    log(f"[rates] chain-steps/s of the timed call: "
        f"{json.dumps({f'N={n}': round(r, 1) for n, r in rates.items()})} on {smi}")
    # --- 7. predict and acquisition, 8. the BO loop --------------------------
    path_launches, path_times = phase_predict_acquisition(torch, dev, smi, tf)
    launches.update(path_launches)
    for (kernel, name), t in path_times.items():
        (k1_times if kernel == "gram" else k2_times)[name] = t
    launches["bo_iteration"] = phase_bo_loop(torch, dev, smi)

    k1 = k1_times[f"({SLICE_CHAINS},50,50)"]
    k2 = k2_times["(128,50,50)"]
    k1_keys = ("device_ms", "kernel_ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
               "bound_by", "share_of_bound", "symmetric")
    kernels = [
        {"name": "gram", "route": "cuda", "source": "bark_tpu_torch/csrc/gram.cu",
         "replaces": "bark_tpu/ops/pallas_gram.py:40",
         "launches": launches[f"dense N={DENSE_NS[0]}"]["gram"],
         "launches_by_path": {p: c["gram"] for p, c in launches.items()},
         "max_abs_err": k1_err, "ms": k1["device_ms"], "device_ms": k1["device_ms"],
         "call_ms": k1["call_ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"],
         "times": {name: {k: t[k] for k in k1_keys} for name, t in k1_times.items()}},
        {"name": "chol_inv", "route": "cuda", "source": "bark_tpu_torch/csrc/chol_inv.cu",
         "replaces": "bark_tpu/ops/pallas_chol.py:55",
         "launches": launches[f"dense N={DENSE_NS[0]}"]["chol_inv"],
         "launches_by_path": {p: c["chol_inv"] for p, c in launches.items()},
         "max_abs_err": k2_err, "max_rel_err_leaf": k2_leaf_err,
         "ms": k2["device_ms"], "device_ms": k2["device_ms"], "call_ms": k2["call_ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": k2["library_ms"], "times": k2_times},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
