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

Prints what each phase found, then one JSON line with each kernel's launch
count on the N=50 run and on each path ("launches_by_path"), error, times
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
    from bark_tpu_torch.benchmarks.kernel_timing import (
        call_ms,
        device_ms,
        k2_bound,
        time_k1,
    )
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
        ms = call_ms(torch, lambda: chol_inv_cuda(K))
        plain_ms = call_ms(torch, lambda: chol_inv_plain(K))
        dev_ms, _, _ = device_ms(torch, lambda: chol_inv_cuda(K), "chol_inv_kernel")
        lib_ms, _, _ = device_ms(torch, lambda: chol_inv_plain(K))
        bound_ms, bound_by = k2_bound(K.shape[0], n)
        require(dev_ms is not None, f"K2 {name}: the profiler saw the kernel")
        k2_times[name] = {"device_ms": dev_ms, "call_ms": ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by}
        log(f"[K2] {name}: |L-L_plain| {err_l:.3e}, |EL-I| {resid:.3e}, "
            f"|E-E_plain| {err_e:.3e}; kernel device {dev_ms:.5f} ms, call {ms:.5f}, "
            f"plain {plain_ms:.5f} call / {lib_ms} device (cuSOLVER); bound "
            f"{bound_ms:.5f} ms ({bound_by}), {100 * bound_ms / dev_ms:.1f}% of it, on {smi}")
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
