#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, builds the port's CUDA kernels from
``bark_tpu_torch/csrc`` and drives its main path, the dense-tier
forest-MCMC sampler, in phases:

  1. device: the card's name and power limit (nvidia-smi); full-float32
     matmuls (TF32 off);
  2. build: nvcc for sm_90a, build seconds and the ptxas report;
  3. K1 (leaf-agreement Gram) against its plain version on leaves routed
     through prior forests: exact equality; kernel and plain times;
  4. K2 (batched Cholesky with inverse) against its plain version on
     refresh-shaped SPD batches, and the blocked N=200 factorization:
     |L - L_plain| <= 1e-4 and |E L - I| <= 5e-4; kernel and plain times;
  5. the slice: TreeFunction(dim=5, m=50, seed=1), 64 chains from empty
     forests, one untimed ``run_bark_sampler`` call (10 samples x 5 steps)
     and one timed call from its last sample, at N=50 and at N=200. Checks:
     finite MLL and noise, a tree-move accept rate strictly in (0, 1), both
     kernels launched during the timed run, final leaves equal to a fresh
     routing, carried K^-1 / logdet equal to a plain rebuild (rtol 1e-3 /
     atol 2e-3 and rtol 1e-4 / atol 1e-3), and one step replayed on the
     CPU with the plain versions from the same state and draws giving the
     same accept decisions (up to near-ties, |log u - min(log a, 0)| < 1e-3).

Prints what each phase found, then one JSON line with each kernel's launch
count, error and times, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises: the exit code is
then non-zero and no result line is printed. Without CUDA it exits 1.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SLICE_CHAINS = 64
SLICE_TREES = 50
NEAR_TIE = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(torch, fn, reps: int = 25, inner: int = 10, warmup: int = 5) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` calls / inner."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


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
        draw_step,
        run_bark_sampler,
        run_chain,
        step_with_info,
    )
    from bark_tpu_torch.forest import Forest, create_empty_forest, route_forest
    from bark_tpu_torch.ops import _build
    from bark_tpu_torch.ops.chol import chol_inv_cuda, chol_inv_plain
    from bark_tpu_torch.ops.gram import gram_cuda, gram_plain
    from bark_tpu_torch.ops.linalg import blocked_cholesky, kernel_matrix

    # --- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.load_library()
    log(f"[build] {lib.path.name}: nvcc {lib.build_seconds:.2f} s "
        f"(load {time.perf_counter() - t0:.2f} s) from "
        f"{[s.name for s in _build.sources()]}")
    for line in lib.build_log.splitlines():
        if "registers" in line or "bytes stack" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")

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

    def routed(forests: Forest, n: int) -> torch.Tensor:
        X = torch.as_tensor(tf.domain.sample(n, rng), device=dev)
        return route_forest(forests, X, ft).contiguous()  # (B, n, m)

    forests64 = prior_forests(SLICE_CHAINS)
    leaves = {n: routed(forests64, n) for n in (50, 128, 200)}

    # --- 3. K1 against its plain version -----------------------------------
    def rand_mask(*shape):
        return torch.as_tensor(
            (rng.uniform(size=shape) > 0.2).astype(np.float32), device=dev
        )

    forests3 = prior_forests(3)
    l77, l130 = routed(forests3, 77), routed(forests3, 130)
    k1_cases = []
    for n in (50, 200):
        ln = leaves[n]
        k1_cases.append((f"({SLICE_CHAINS},{n},{n})", ln, ln, None, None))
        mask = rand_mask(n)
        k1_cases.append((f"({SLICE_CHAINS},{n},{n}) masked", ln, ln, mask, mask))
    k1_cases.append(("(3,77,130)", l77, l130, None, None))
    k1_cases.append(("(3,77,130) masked", l77, l130, rand_mask(3, 77), rand_mask(130)))
    k1_err = 0.0
    k1_times = {}
    for name, a, b, m1, m2 in k1_cases:
        got = gram_cuda(a, b, m1, m2)
        want = gram_plain(a, b, m1, m2)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        k1_err = max(k1_err, err)
        require(torch.equal(got, want), f"K1 {name} equals its plain version (max err {err})")
        ms = cuda_ms(torch, lambda: gram_cuda(a, b, m1, m2))
        plain_ms = cuda_ms(torch, lambda: gram_plain(a, b, m1, m2))
        k1_times[name] = (ms, plain_ms)
        log(f"[K1] {name}: exact; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")

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

    k2_err = 0.0
    k2_times = {}
    for n in (50, 128, 200):
        K = spd_batch(n)
        eye = torch.eye(n, device=dev)
        if n <= 128:
            name = f"(128,{n},{n})"
            L, E = chol_inv_cuda(K)
            run_k, run_p = (lambda: chol_inv_cuda(K)), (lambda: chol_inv_plain(K))
        else:
            name = f"(128,{n},{n}) blocked"
            L, E = blocked_cholesky(K)
            run_k, run_p = (lambda: blocked_cholesky(K)), (lambda: chol_inv_plain(K))
        Lp, Ep = chol_inv_plain(K)
        torch.cuda.synchronize()
        err_l = (L - Lp).abs().max().item()
        resid = (E @ L - eye).abs().max().item()
        err_e = (E - Ep).abs().max().item()
        k2_err = max(k2_err, err_l)
        require(err_l <= 1e-4, f"K2 {name}: |L - L_plain| = {err_l} <= 1e-4")
        require(resid <= 5e-4, f"K2 {name}: |E L - I| = {resid} <= 5e-4")
        require(torch.equal(torch.triu(L, 1), torch.zeros_like(L)), f"K2 {name}: L lower")
        ms, plain_ms = cuda_ms(torch, run_k), cuda_ms(torch, run_p)
        k2_times[name] = (ms, plain_ms)
        log(f"[K2] {name}: |L-L_plain| {err_l:.3e}, |EL-I| {resid:.3e}, "
            f"|E-E_plain| {err_e:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")

    # --- 5. the slice ----------------------------------------------------
    launches = {}
    for n in (50, 200):
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
        if n == 50:
            launches = counts
        steps = params.num_samples * params.steps_per_sample
        rate = SLICE_CHAINS * steps / dt
        acc = run.tree_accept_rate.mean().item()
        log(f"[slice N={n}] untimed call {cold:.2f} s; timed call {steps} steps x "
            f"{SLICE_CHAINS} chains in {dt:.3f} s = {rate:.1f} chain-steps/s "
            f"on {smi}; tree accept {acc:.4f}, noise accept "
            f"{run.hyper_accept_rate.mean().item():.4f}; launches {counts}")
        require(bool(torch.isfinite(run.mll).all()), f"N={n}: finite MLL")
        require(bool(torch.isfinite(run.samples.noise).all()), f"N={n}: finite noise")
        require(0.0 < acc < 1.0, f"N={n}: tree accept rate {acc} in (0, 1)")
        require(counts["gram"] > 0 and counts["chol_inv"] > 0,
                f"N={n}: both kernels launched on the main path {counts}")

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

        # one step on the card and on the CPU from the same state and draws
        draws = draw_step(torch.Generator().manual_seed(7), SLICE_CHAINS, params)
        dev_state, dev_info = step_with_info(state, X, y, bounds, ft, params, draws.to(dev))
        cpu_state, cpu_info = step_with_info(
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
        for c in range(SLICE_CHAINS):
            js = torch.nonzero(differ[c]).flatten()
            if js.numel():
                parted += 1
                j = int(js[0])
                require(gap[c, j].item() < NEAR_TIE,
                        f"N={n}: chain {c} move {j} decided differently on the card "
                        f"and the CPU away from a near-tie (gap {gap[c, j].item()})")
            elif hyper_differ[c]:
                require(hyper_gap[c].item() < NEAR_TIE,
                        f"N={n}: chain {c} noise move decided differently away "
                        f"from a near-tie (gap {hyper_gap[c].item()})")
        log(f"[slice N={n}] card vs CPU replay of one step: {parted} of "
            f"{SLICE_CHAINS} chains parted at a near-tie, the rest decided all "
            f"{SLICE_TREES} tree moves alike; noise moves differ in "
            f"{int(hyper_differ.sum())} chains")

    k1_ms, k1_plain = k1_times[f"({SLICE_CHAINS},50,50)"]
    k2_ms, k2_plain = k2_times["(128,50,50)"]
    kernels = [
        {"name": "gram", "route": "cuda", "source": "bark_tpu_torch/csrc/gram.cu",
         "replaces": "bark_tpu/ops/pallas_gram.py:40", "launches": launches["gram"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "chol_inv", "route": "cuda", "source": "bark_tpu_torch/csrc/chol_inv.cu",
         "replaces": "bark_tpu/ops/pallas_chol.py:55", "launches": launches["chol_inv"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
