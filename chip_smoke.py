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
     sampler calls it and at (64, 1024, 200): device time (torch.profiler,
     or CUDA events where its captures miss the kernels), call time, the
     plain version's,
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
     device, for seed 0. Required of every seed: each ask in the
     domain, ``fallbacks == 0`` and the best y after the loop strictly
     below the best of the 8 initial points (unless those already hold the
     grid minimum). Printed: the
     iteration at which each seed reaches the minimum of a 400 x 400 grid
     (within 1e-6), and the best of a ``RandomStrategy`` run of the same
     budget. (b) five iterations at full width (dim=5, m=50, 4 chains x 8
     samples, 4096 candidates x 4 rounds, from 50 observations): seconds
     per iteration split into fit, build, score and centring, and both
     kernels' launches per iteration against the count the code predicts;
  9. tempered fitting: (a) parallel tempering (``run_parallel_tempering``) on the noiseless
     TreeFunction(dim=5, m=50, seed=1) at N=512 (the data of
     ``benchmarks/ab_tempered.py``), 4 ladders x 8 replicas = 32 chain rows
     with a temperature each, 150 rounds from empty forests in the leaf tier
     (R=256). Checks: every ladder's betas a permutation of the geometric
     ladder in every round, a swap rate in (0, 1), a finite cold MLL, K2
     once per init and round and K1 never, final leaves equal to a fresh
     routing, the carried factor of A equal to a plain rebuild (relative
     5e-4), a step at beta = 1 on every row equal to the plain step
     (``torch.equal``), one round replayed on the CPU deciding alike (the
     step up to near-ties, the swap exactly from the same MLLs), and K2 at
     the round's (64, 256, 256) against its plain version. Printed: ms per
     round and the share of ladders whose cold MLL passed the reference's
     target 798.85. (b) SMC (``run_smc``) at N=200 in the dense tier, 64
     particles from the prior, 16 rounds x 2 mutation steps. Checks: beta
     non-decreasing and reaching 1, a finite log-evidence, weights summing
     to 1 (1e-4), K1 and K2 each 1 + 16 x 2 times, one round replayed on the
     CPU (beta within 1e-6, ancestors alike or parted at a reported near-tie,
     each mutation step's decisions up to near-ties), K1 and K2 at the
     mutation step's shapes against their plain versions. (c) three
     full-width BO iterations (the configuration of 8 b) on
     ``BARKSurrogate(fit_style="tempered", num_replicas=8)``: no fallback,
     every ask in the domain, the launches the code predicts, a swap rate in
     [0, 1]; seconds per iteration split as in 8 b;
 10. the drift-free oracle, posterior sampling and the CG predict: (a)
     ``kernel_backend="chol"`` at N=50, 200 and 512, 16 chains, 5 steps from
     empty forests: K1 once (init) and K2 once per factorization and
     256-block, (1 + 5 (m + 1)) x blocks; finite MLL, a tree accept rate in
     (0, 1), leaves equal to a fresh routing, the carried K equal to a
     rebuild from the plain Gram (1e-5 + 1e-5 |value|), one step replayed on
     the CPU deciding alike up to near-ties, and K2 (the blocked path at
     512) at the move shape against its plain version, timed; ms a step. (b)
     chol against rank1 at N=50, 64 chains warmed 10 steps: one step from one
     state with the same draws; at least 95% of the chains decide every move
     alike. (c) ``models/sampling.py`` at the width of a BO fit: S=32
     (4 chains x 8 samples), N=224, 1024 points, 256 draws:
     ``leaf_function_samples`` (K2 seven times, r=1600) with the empirical
     mean and variance of every point within 5 standard errors of
     ``forest_predict_leaf`` (the variance on the Wilson-Hilferty cube-root
     scale), the dense and leaf f* samplers agreeing as the reference's test
     asks (means and standard deviations within 0.2), Nystrom with the
     inducing set = the training set reproducing K_XX to 1e-3; K1 and K2 at
     these shapes against their plain versions, timed; ms per call. (d)
     ``forest_predict_cg`` at N=4096, S=32, 256 candidates: no kernel launch,
     mu and var against ``forest_predict_leaf`` and, on 4 samples, the
     float64 dense oracle (1e-3 + 1e-3 |value|), and
     ``BARKSurrogate(predict_backend="cg").predict`` against the leaf
     backend; CG trips and ms;
 11. the booster forests, one forest (G = 1) in both kernels: (a) LeafGP
     at full width on TreeFunction(dim=5, m=50, seed=1), 200 observations,
     a 50-round depth-3 booster with 64 node slots (the native C++ booster,
     built by g++ at first use): ``LeafGPSurrogate.fit`` (K1 once, Adam
     through the library Cholesky), ``predict`` at 1024 held-out points,
     ``build_acquisition`` and one scored batch of 4096, then five
     iterations of ``make_strategy("LeafGP")`` at 4096 candidates x 4
     rounds split into booster, hyperparameters, build, score and centring.
     Checks: the Gram equal to its plain version (``torch.equal``), the
     factor within K2's bound, mu, var and the LCB against a float64 dense
     posterior on the CPU (1e-3 + 1e-3 |value|), held-out MSE under the
     mean predictor's, the fitted MLL not below Adam's start, the launches
     the code predicts, no fallback. (b) the documented flow on LeafGP:
     TreeFunction(dim=2, m=10, seed=1), 8 initial points, 20 iterations,
     1024 candidates x 3 rounds, seeds 0 and 1: every ask in the domain,
     the best y below the initial best unless those hold the grid minimum.
     (c) ``benchmarks/mf_bo.run_study`` at the example's defaults (seed 0,
     6 initial points, 10 iterations, 256 candidates, 16 f*): fidelities in
     {0, 1}, the cost strictly growing, the target incumbent never worse,
     11 K1 launches an iteration. (d) one ``MultiFidelityStrategy.ask`` at
     N = 300 (CurrinExp2D, 150 points at each fidelity, 2048 candidates x
     3 rounds, 16 f*), split into fit, build, score, f* and the choice of
     fidelity: K2 through ``blocked_cholesky`` (2 launches), the
     target-fidelity LCB and ``_posterior_joint`` against float64 oracles
     on the CPU, the fidelity equal to a CPU replay from the same state and
     numpy seed. K1 and K2 timed at the single-forest shapes.

 12. BART, the baselines and the study runners (no new kernel): (a) BART at
     the published defaults (50 trees, 100 warmup + 50 sample sweeps) on
     TreeFunction(dim=5, m=50, seed=1): two cold ``BARTSurrogate.fit`` at
     N=200 from one seed (equal samples and states), a warm refit at N=201,
     ``predict`` at 1024 held-out points (MSE under the mean predictor's),
     ``run_bart_sampler`` with 4 chains at N=4096, then five sweeps from one
     set of ``BARTDraws`` on the card and replayed on the CPU, deciding alike
     up to reported near-ties; cached leaves equal a fresh routing, f_total
     the sum of leaf values (1e-5 relative), finite sigma2, a tree accept
     rate in (0, 1), and no K1 or K2 launch. (b) ``run_regression`` on
     ``regression_treefunction.yaml``'s settings (2 of its 5 runs) for BART
     and BARK: MSE under the mean predictor's. (c) ``run_study`` on the
     example configurations (``EXAMPLE_CONFIGS``) at their ``num_init``:
     TreeFunction dim 5 with BART (5 iterations), StyblinskiTang dim 5 with
     RelaxedGP (10),
     PestControl with BARTGrid (5), G6 and PressureVessel with BARK at
     ``model_bark.yaml`` (3 each) and StyblinskiTang with GridUCB over BARK
     (3; GridUCB refuses the constrained PressureVessel, as the reference's
     does): the reference's CSV columns, every ask in the domain, the best y
     never rising, no fallback. (d) one ``GridUCBStrategy.ask`` over BARK at
     full width (4 chains x 8 samples, 50 observations, the 16,384-point
     Sobol grid): 2 K1 and 1 K2 launches, the argmax equal to a CPU replay
     from the same posterior and normals (or within 1e-5 of the card's
     maximum), K1 at (32,16384,64) and (32,64,64) symmetric exact and K2 at
     (32,64,64) within phase 4's bound, each timed.

 13. the sharded paths (no new kernel), checkpoints, profiling and the
     last benchmarks: (a) a one-rank NCCL group in this process
     (``initialize_distributed`` through a file in a temporary directory):
     ``sharded_run_sampler`` at full width (64 chains, m=50, N=50, 10 steps)
     equal to ``run_chain`` from the rank's generator, with K1 and K2 once per
     init and refresh; 5 x 4096 candidates scored by
     ``evaluate_acquisition_sharded`` against an S = 128, N = 224 posterior,
     bit-equal to ``evaluate_acquisition``, one K1 launch a batch. (b) two
     Gloo ranks on this card, spawned by ``graft_entry.dryrun_multichip``
     (NCCL refuses two ranks on one GPU): the sharded sampler (32 chains a
     rank) with its diagnostics alike on both ranks and each block equal to
     ``run_chain``; the leaf tier at N=512; PT with 2 replicas at N=512 (leaf
     tier, K2 once per init and round) equal to ``pt_swap_states`` driving the
     same replicas in this process; SMC with 2 x 8 particles against
     ``run_smc`` from the same generator (betas within 1e-5, log-evidence
     within 1e-5 relative); the row-sharded CG predict within 1e-5 of
     ``forest_predict_cg``; sharded scoring within 1e-6 (bit-equality
     reported). Any failing rank fails the run. (c) a checkpoint round trip of
     the S = 128 surrogate predicts alike. (d) ``utils.profiling.trace`` of
     3 steps names K1's and K2's kernels. (e) CCOBench, MAXBandit and
     ToyReaction evaluate; SVRBench, XGBoostMNIST and DatasetBenchmark raise
     naming the package they need. K1 at the per-rank scoring shape
     (128, 2048, 224) and K2 at the per-rank refresh shape (64, 50, 50),
     timed.

 14. the forest Gram API and the drivers of ``benchmarks/`` that twin the
     reference's last scripts (no new kernel). Each path runs with the
     counts set to 0 just before it and read just after, and a recorder
     that keeps the first input of each K1 and K2 shape it launches; every
     recorded shape is then held against the plain version on that input
     (K1 exact; K2 |L - L_plain| / max |L_plain| <= 5e-4 and |E L - I| <=
     5e-4), and each kernel's most launched shape on the path timed. (a)
     ``forest_gram_matrix`` and the batched and no-null forms at 16 prior
     forests x (4096, 224) rows: one K1 launch a call, equal to the plain
     Gram (the no-null form to its rescaling). (b) ``bo_largen.run_study`` at
     the reference's configuration (N=4080, 4096 candidates x 3 rounds, 4
     chains x 4 samples, m=50, seed 0), the initial fit and 2 iterations:
     a finite, non-increasing incumbent, finite ``fit_diagnostics``, no
     random fallback, every ask through ``build_acquisition_lr`` at padded
     N > 2048 and a predict through ``forest_predict_leaf``, K2 launched and
     K1 not; the ask split into the factored build, the scored batches and
     the centring. (c) ``largen_timing`` at N=8192: one lowrank ask (S=16)
     and the CG and leaf predicts. (d) ``mcmc_record`` at the MCMC
     configuration pair (N=50, 4 chains x 500 steps): finite MLLs of shape
     (4, 500), an R-hat, K1 at (4,50,50) and K2 at (8,50,50). (e)
     ``tempered_smc`` in one process (8 replicas x 200 rounds, 64
     particles) and sharded on one NCCL rank: rank 0's swap, MLL and noise
     traces equal to ``graft_entry.single_process_pt``'s bit for bit, the
     SMC to ``run_smc``'s within 1e-5. (f) ``bandit_bo`` (3 iterations),
     ``regression_hpo`` (a 2 x 2 grid), ``samples_ablation`` (one run of a
     2 x 2 grid), ``priors_and_proposals`` (1000 steps x 64 chains; a
     lognormal walk and the reference ratio's halved tail), ``scaling`` (1
     and 2 ranks, 10 steps, a dry run: two Gloo ranks share the card) and
     ``plot_bo_runs``'s summary over ``results/regret_r2``; without
     matplotlib its figure must raise naming it.

 15. ``bark_tpu_torch/benchmarks/bench.py``, the twin of the root
     ``bench.py`` (no new kernel), at the reference's protocol (64 chains,
     two untimed calls, five timed calls of 50 steps) on the points the
     slices leave out: the default mode (N=50), its line's keys exactly
     the reference's four (three runs in a row before the cut in
     ``CUTS``); the categorical N=50 (2 of 5 features, 5 levels); N=512
     (the leaf tier at R=256). Each rate is printed beside the TPU's at the
     same point (``BENCH_CURVE_r05.json``) and the nvidia-smi line, and
     must be finite and positive. The counts are set to 0 just before the
     first timed call and read after the last: K1 and K2 once per init and
     step at N=50 (255 each), the categorical run as the continuous one
     (same counts and shapes), K2 alone at N=512 (255); each shape's first
     input held against the plain version as in phase 14. At N=50 and 512
     one more call under torch.profiler gives the card's busy share (the
     kernels' summed time over the timed window's mean call), and another
     under CUDA's sync debug mode counts the host's synchronisations.

 16. the sampler's lowerings (no new kernel) at the width of ``bench.py``'s
     twin (dim 5, m=50, 64 chains, node_limit 64): at N=50 the proposal
     lowerings (``hot_style`` scatter, select, doubling; ``subspace_mode``
     carry) and the kernel-side ones (batched with select proposals, the
     aug, lowrank and coeff scans, the factor, leaf and pair refreshes, the
     chol and woodbury backends); at N=512 lowrank, coeff, factor, pair and
     batched. For each, from one shared state (the default, 20 steps from
     empty forests) and one list of draws: (a) five steps against the
     default's, bit-identical forests, leaves and accepts for the proposal
     lowerings, and for the kernel-side ones each step taken from the
     default's state (its carry built for the lowering) with at least 99% of
     the tree decisions the default's and the MLL within rtol 1e-4 / atol
     1e-3 where a chain's decisions agree; (b) after 50 free steps, the
     leaves equal a fresh routing and the carry (K^-1, L of K or of A, K,
     the subspaces) a float64 rebuild; (c) K1's and K2's launches in those
     50 steps and their init exactly as the lowering implies, each shape's
     first input held against the plain version as in phase 14; (d)
     steps/s/chip through ``bench.measure`` (one untimed and one timed call
     of 20 steps) beside the default's, and the host's synchronisations of
     one step (CUDA's sync debug mode).

 17. K3, the dense move scan as one kernel (``csrc/move_scan.cu``): (a) at
     (64, 50), (4, 64) with 10 pad rows and (8, 255), each from a state 20
     steps from empty forests, beta 1.0 and one per chain in (0, 1]: one
     launch a scan, every chain deciding each move as the twin (the torch
     loop, ``sampler._scan_plain_loop``) until a near-tie (u within 1e-5 of
     the twin's or the float64 loop's acceptance probability) or a move the
     float64 loop decides otherwise, the same moves vetoed, log alphas no
     farther from the float64 loop's than 1e-4 beyond the twin's and, at
     N <= 64, within 1e-4 of the twin's; (b) ``run_chain`` at N=50, 64
     chains, 50 steps: K3 50 launches, K1 and K2 51 each; (c) device, call
     and bound at (64, 50) and (4, 64), beside the twin's call; (d)
     stationarity: from one state 100 steps warm, 500 steps with the kernel
     and 500 with the twin (independent draws, 64 chains, N=50), the tree
     accept rate and the mean leaves a tree within 4 standard errors of the
     difference (chain c of each arm from warm chain c: paired).
 18. K4, the proposal batch as one kernel (``csrc/propose.cu``): (a) at
     the four cells' shapes, (64 chains x 50 trees, N 50, D 5) continuous
     and with 2 categorical inputs, (4 x 50, padded N 64) and (4 x 50, N
     128, D 25) all categorical, each from a state 20 steps from empty
     forests: one launch a batch, every field equal to the twin's
     (``sampler._propose_torch``) but log q, within 8 float32 ulps; (b)
     ``run_chain`` at N=50, 64 chains, 50 steps: K4 50 launches; (c) device,
     call and bound at each shape, beside the twin's call.

The whole run takes eleven to nineteen minutes of command time on an H100 (the sampler's
step is bound by the host's launch rate, so the time follows the host; the
sampler paths keep their 64 chains, which cost the host no more than 32).

Prints what each phase found, then one JSON line with each kernel's launch
count on the N=50 run and on each path ("launches_by_path": the sampler's
four sizes, "predict", "acquisition", "bo_iteration", "tempered N=512", "smc
N=200", "tempered_bo", "chol N=50/200/512", "leaf_function_samples",
"generate_fstar_samples", "nystrom", "predict cg N=4096", and the booster
forests' "leafgp fit N=200", "leafgp predict", "leafgp acquisition",
"leafgp_bo_iteration", "leafgp loop seed 0/1", "mf_study", "mf fit N=300"
and "mf ask N=300", phase 12's "bart fit N=200", "bart N=4096",
"regression BART/BARK", "study <benchmark> <model>" and "griducb ask", and
phase 13's "sharded sampler N=50, 1 NCCL rank", "sharded scoring ..., 1 NCCL
rank" and "sharded <part>, Gloo rank <r> of 2" for the sampler, leaf, PT,
SMC, scoring and CG parts, and phase 14's "forest gram api", "bo_largen
N=4080", "largen ask lowrank N=8192", "largen predict N=8192", "mcmc_record
N=50", "tempered_smc single", "tempered_smc sharded, 1 NCCL rank",
"bandit_bo", "regression_hpo", "samples_ablation", "priors_and_proposals"
and "scaling, <n> rank(s), rank 0", phase 15's "bench N=50", "bench N=50
cat" and "bench N=512", and phase 16's "lowering <name> N=<n>"; K3's
"run_chain N=50" of phase 17), error, times
at the headline shape ("ms" is the device time; "call_ms", "plain_ms",
"library_ms", "bound_ms" and "bound_by" beside it; K4's "run_chain N=50" of
phase 18) and at each timed shape
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

SCRIPT_T0 = time.perf_counter()  # the script's clock, for phase 16's rates
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
BO_SEEDS = (0,)
BO_ITERATIONS = 45
ORACLE_ATOL = ORACLE_RTOL = 1e-3  # float32 posterior against the float64 oracle
PT_N, PT_LADDERS, PT_REPLICAS, PT_ROUNDS, BETA_MIN = 512, 4, 8, 150, 0.05
SMC_N, SMC_PARTICLES, SMC_ROUNDS, SMC_MUTATIONS = 200, 64, 16, 2
TEMPERED_BO_ITERATIONS = 3
CHOL_NS, CHOL_CHAINS, CHOL_STEPS = (50, 200, 512), 16, 5
AGREE_N, AGREE_CHAINS = 50, 64
SAMPLING_N, SAMPLING_POINTS, SAMPLING_DRAWS = 224, 1024, 256  # S = 4 chains x 8 samples
CG_N, CG_CANDIDATES, CG_ORACLE_SAMPLES = 4096, 256, 4
LEAFGP_N, LEAFGP_POINTS, LEAFGP_ITERATIONS, LEAFGP_ROUNDS = 200, 1024, 5, 4
LEAFGP_LOOP_SEEDS, LEAFGP_LOOP_ITERATIONS = (0, 1), 20
MF_ITERATIONS, MF_PER_FIDELITY = 10, 150
DIST_SEED = 13
DIST_STEPS = dict(warmup_steps=0, num_samples=2, steps_per_sample=5)  # 10 steps
DIST_FIT_CHAINS, DIST_FIT_N = 16, 200  # x 8 samples: S = 128 at bucket 224
DIST_BATCH, DIST_BATCHES = 4096, 5
DIST_PT_N, DIST_PT_ROUNDS = 512, 10
DIST_SMC = dict(n_points=50, num_particles=16, num_rounds=8, mutation_steps=2)
DIST_CG_CANDIDATES = 256
TRACE_STEPS = 3


#: depth cut from earlier phases so that the whole run, phase 14 included,
#: stays well inside its time limit on a slow host
CUTS = ("phase 8 a: seed 0 (seeds 1 and 2 dropped: seed 2's initial points hold the "
        "grid minimum, seed 1 improves at its first ask); phase 9 a: 150 PT rounds (was "
        "300); phase 11: the MF study 10 iterations (was 20); phase 12: 2 regression runs "
        "(was 3), studies TreeFunction/BART 5 iterations (was 10) and "
        "StyblinskiTang/RelaxedGP 10 (was 20); phase 15: the default mode once (was three "
        "times in a row; the whole script ran to 1,042 s on a slow host before phase 15, "
        "which adds ~90 s and each more run ~20 s)")


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def rel_err(torch, got, want) -> float:
    """Largest |got - want| / max |want| over the matrices of a batch."""
    num = (got - want).abs().amax((-2, -1))
    return (num / want.abs().amax((-2, -1))).max().item()


def compare_decisions(torch, tag, draws, dev_info, cpu_info, num_trees, parted=None):
    """Each chain decides every move of a step alike on the card and on the
    CPU, or parts at a near-tie (|log u - min(log a, 0)| < NEAR_TIE) after
    which it is not compared further. ``parted`` is the set of chains that
    parted at an earlier step; returns it with this step's added."""
    chains = dev_info.hyper_accept.shape[0]
    parted = set() if parted is None else parted
    log_u = torch.log(draws.proposal.u_accept.cpu())
    gap = (log_u - torch.clamp_max(cpu_info.tree_log_alpha, 0.0)).abs()
    differ = dev_info.tree_accepts.cpu() != cpu_info.tree_accepts
    hyper_gap = (torch.log(draws.u_hyper.cpu())
                 - torch.clamp_max(cpu_info.hyper_log_alpha, 0.0)).abs()
    hyper_differ = dev_info.hyper_accept.cpu() != cpu_info.hyper_accept
    before = len(parted)
    for c in range(chains):
        if c in parted:
            continue
        js = torch.nonzero(differ[c]).flatten()
        if js.numel():
            parted.add(c)
            j = int(js[0])
            require(gap[c, j].item() < NEAR_TIE,
                    f"{tag}: chain {c} move {j} decided differently on the card "
                    f"and the CPU away from a near-tie (gap {gap[c, j].item()})")
        elif hyper_differ[c]:
            parted.add(c)
            require(hyper_gap[c].item() < NEAR_TIE,
                    f"{tag}: chain {c} noise move decided differently away "
                    f"from a near-tie (gap {hyper_gap[c].item()})")
    log(f"[{tag}] card vs CPU replay of one step: {len(parted) - before} of {chains} chains "
        f"parted at a near-tie, the rest decided all {num_trees} tree moves "
        f"and the noise move alike")
    return parted


def replay_on_cpu(torch, tag, state, X, y, bounds, ft, params, num_trees, beta=1.0):
    """One step on the card and on the CPU (plain versions) from the same
    state and draws, at inverse temperature ``beta`` (a float or one per
    chain): the decisions agree as :func:`compare_decisions` asks. Returns
    the card's new state."""
    from bark_tpu_torch.fitting.sampler import draw_step, step_with_info

    chains = state.noise.shape[0]
    draws = draw_step(torch.Generator().manual_seed(7), chains, params)
    beta_cpu = beta.cpu() if torch.is_tensor(beta) else beta
    new, dev_info = step_with_info(state, X, y, bounds, ft, params, draws.to(X.device),
                                   beta=beta)
    _, cpu_info = step_with_info(
        state.to("cpu"), X.cpu(), y.cpu(), bounds.cpu(), ft.cpu(), params, draws, beta=beta_cpu,
    )
    compare_decisions(torch, tag, draws, dev_info, cpu_info, num_trees)
    return new


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
        require(t["device_ms"] > 0, f"K1 {name}: a device time")
        times[("gram", name)] = t
        log(f"[K1] {name}{' symmetric' if t['symmetric'] else ''}: device {t['device_ms']} ms "
            f"({t['kernels_per_call']} kernels a call: {t['kernel_ms']}), call {t['call_ms']:.5f}, plain {t['plain_ms']:.5f}; bf16 "
            f"one-hot bmm {t['library_ms']} ms device; bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}), {100 * t['share_of_bound']:.1f}% of it, on {smi}")
    t = time_k2(torch, lambda: chol_inv_cuda(K), lambda: chol_inv_plain(K), samples, n_pad,
                "chol_inv_kernel")
    require(t["device_ms"] > 0, "K2 at the predict shape: a device time")
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
    require(t["device_ms"] > 0, "blocked_cholesky: a device time")
    times[("chol_inv", f"({s4},{r},{r}) blocked")] = t
    log(f"[K2] ({s4},{r},{r}) leaf-space factor through blocked_cholesky ({blocks} launches): "
        f"|L-L_plain|/max|L| {err_l:.3e}, |EL-I| {resid:.3e}; device {t['device_ms']:.3f} ms "
        f"({t['kernels_per_call']} kernels a call, {t['device_source']}), call {t['call_ms']:.3f}, "
        f"cuSOLVER "
        f"{t['plain_ms']:.3f} call / {t['library_ms']} device; bound {t['bound_ms']:.3f} ms "
        f"({t['bound_by']}), {100 * t['share_of_bound']:.1f}% of it, on {smi}")
    log(f"[predict N=4096] peak device memory of each call at S={s4}, MiB: {peaks}")
    return launches, times


def full_width_iterations(torch, s, bench, iterations, rounds, fit_launches, tag,
                          fit_parts=()):
    """``iterations`` BO iterations (``ask`` + ``add``, the refit included)
    of strategy ``s``, each timed and split into fit, build, score and
    centring, and the parts of the refit named in ``fit_parts`` ((module,
    function name, part) clocked where the refit calls them); both kernels'
    launches per iteration must be what the code predicts: the refit's
    ``fit_launches`` (the sampler's K1 and K2 once per init and round), a
    dense build 1 + 1, a K1 call per scored batch, 7 K2 launches a Thompson
    build (r = 1600). Returns (launches of the last iteration, medians of
    the parts in seconds)."""
    import bark_tpu_torch.optimizer.search as search
    import bark_tpu_torch.strategies.tree_kernel as tk
    from bark_tpu_torch.ops.chol import chol_inv_cuda
    from bark_tpu_torch.ops.gram import gram_cuda
    from bark_tpu_torch.ops.linalg import robust_cholesky

    lo, hi = bench.domain.bounds("ordinal").T
    spent = {"build": 0.0, "score": 0.0, "centre": 0.0, **{p: 0.0 for _, _, p in fit_parts}}
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
        *((mod, name, clocked(part, getattr(mod, name))) for mod, name, part in fit_parts),
    ]
    originals = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
    rows, per_iter = [], None
    try:
        for mod, name, fn in patched:
            setattr(mod, name, fn)
        for i in range(iterations):
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
                    f"{tag} iteration {i}: the ask lies in the domain")
            per_iter = {"gram": gram_cuda.launches, "chol_inv": chol_inv_cuda.launches}
            # fit: init + every refresh; dense build: 1 + 1; dense search: a K1
            # call per scored batch; a Thompson build: 7 K2 launches (r = 1600)
            want = {
                "gram": fit_launches["gram"] + calls["dense"] * (1 + 1 + rounds),
                "chol_inv": fit_launches["chol_inv"] + calls["dense"] + 7 * calls["ts"]
                + robust_cholesky.escalations,
            }
            require(per_iter == want, f"{tag} iteration {i}: launches {per_iter}, "
                                      f"the code predicts {want} ({calls})")
            rows.append({"ask_s": t1 - t0, "fit_s": t2 - t1, **spent})
            refit = "".join(f", {p} {spent[p]:.3f}" for _, _, p in fit_parts)
            log(f"[{tag}] iteration {i}: {t2 - t0:.2f} s = fit {t2 - t1:.2f}{refit} + ask "
                f"{t1 - t0:.2f} (build {spent['build']:.3f}, score {spent['score']:.3f}, "
                f"centring {spent['centre']:.3f}); builds {calls}; launches {per_iter}")
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    require(s.fallbacks == 0, f"{tag}: no random fallback ({s.fallbacks})")
    med = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
    return per_iter, med


def phase_bo_loop(torch, dev, smi):
    """Phase 8 (see the module docstring). Returns the launches of one
    full-width BO iteration."""
    from bark_tpu_torch.benchmarks import map_benchmark
    from bark_tpu_torch.fitting.params import SamplerParams
    from bark_tpu_torch.ops.chol import chol_inv_cuda
    from bark_tpu_torch.ops.gram import gram_cuda
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
    params = SamplerParams(num_chains=4, num_samples=8, steps_per_sample=5, warmup_steps=50)
    steps = params.num_samples * params.steps_per_sample
    rounds = 4
    s = make_strategy("BARK", bench.domain, seed=0, params=params, num_candidates=ACQ_BATCH,
                      num_rounds=rounds)
    X = bench.domain.sample(50, np.random.default_rng(0))
    s.tell(X, bench.f(X))
    per_iter, med = full_width_iterations(torch, s, bench, 5, rounds,
                                          {"gram": steps + 1, "chol_inv": steps + 1},
                                          "BO full width")
    log(f"[BO full width] dim 5, m 50, S={params.num_chains * params.num_samples}, {ACQ_BATCH} "
        f"candidates x {rounds + 1} batches, N=50-54 (bucket 64), medians of 5 on {smi}: "
        f"{med['ask_s'] + med['fit_s']:.2f} s per iteration = fit {med['fit_s']:.2f} + build "
        f"{med['build']:.3f} + score {med['score']:.3f} + centring {med['centre']:.3f} + other "
        f"{med['ask_s'] - med['build'] - med['score'] - med['centre']:.3f}")
    return per_iter


def phase_tempered(torch, dev, smi):
    """Phase 9 (see the module docstring). Returns the launches by path and
    the kernel times at the new shapes."""
    import bark_tpu_torch.strategies.tree_kernel as tk
    from bark_tpu_torch.benchmarks import map_benchmark
    from bark_tpu_torch.benchmarks.ab_tempered import REFERENCE_TARGET, make_data
    from bark_tpu_torch.benchmarks.kernel_timing import time_k1, time_k2
    from bark_tpu_torch.fitting.params import SamplerParams
    from bark_tpu_torch.fitting.prior import draw_prior, sample_forest_prior
    from bark_tpu_torch.fitting.sampler import (
        _leaf_budget, _leaf_Z, draw_step, init_chain_state, step_with_info,
    )
    from bark_tpu_torch.forest import create_empty_forest, route_forest
    from bark_tpu_torch.models.surrogate import BARKSurrogate
    from bark_tpu_torch.ops import gram as gram_module
    from bark_tpu_torch.ops.chol import MAX_BLOCK, chol_inv_cuda, chol_inv_plain
    from bark_tpu_torch.ops.gram import gram_cuda, gram_plain
    from bark_tpu_torch.ops.linalg import JITTER, kernel_matrix
    from bark_tpu_torch.parallel.smc import draw_smc_round, run_smc, smc_round
    from bark_tpu_torch.parallel.tempering import geometric_ladder, run_parallel_tempering, swap_move

    def zero():
        gram_cuda.launches = chol_inv_cuda.launches = 0

    def counts():
        return {"gram": gram_cuda.launches, "chol_inv": chol_inv_cuda.launches}

    launches, times = {}, {}

    # ---- (a) parallel tempering at N = 512, leaf tier
    X, y, bounds, ft = make_data(torch, dev, PT_N)
    params = SamplerParams(num_trees=SLICE_TREES)
    shape, rows = (PT_LADDERS, PT_REPLICAS), PT_LADDERS * PT_REPLICAS
    budget = _leaf_budget(params, PT_N)
    blocks = -(-budget // MAX_BLOCK)
    gen = torch.Generator(device=dev).manual_seed(PT_N)
    zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = run_parallel_tempering(
        gen, create_empty_forest(SLICE_TREES, params.node_limit, shape, dev),
        torch.full(shape, 0.1, device=dev), torch.ones(shape, device=dev), X, y, bounds, ft,
        params, num_replicas=PT_REPLICAS, num_steps=PT_ROUNDS, beta_min=BETA_MIN,
        keep=slice(-1, None))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c = counts()
    launches[f"tempered N={PT_N}"] = c
    require(c == {"gram": 0, "chol_inv": blocks * (PT_ROUNDS + 1)},
            f"PT at N={PT_N} (leaf tier, R={budget}): no K1 call and {blocks} K2 launch(es) "
            f"per init and round ({blocks * (PT_ROUNDS + 1)}), got {c}")
    ladder = torch.sort(geometric_ladder(PT_REPLICAS, BETA_MIN, dev)).values
    require(torch.equal(torch.sort(run.betas, -1).values, ladder.expand_as(run.betas)),
            "PT: every ladder's betas are a permutation of the ladder in every round")
    swap = run.swap_rate.mean().item()
    require(0.0 < swap < 1.0, f"PT: swap rate {swap} in (0, 1)")
    require(bool(torch.isfinite(run.cold_mll[:, -1]).all()), "PT: the cold MLL is finite")
    passed = (run.cold_mll >= REFERENCE_TARGET).any(1).float().mean().item()
    state = run.state.chains
    require(torch.equal(route_forest(state.forest, X, ft), state.leaves),
            "PT: final leaves equal a fresh routing")
    ones = torch.ones(PT_N, device=dev)
    Z, _ = _leaf_Z(state.forest, state.leaves, budget, ones)
    eye = torch.eye(budget, device=dev)
    ratio = (JITTER + state.noise) / (state.scale / SLICE_TREES)
    Lr = torch.linalg.cholesky(Z.transpose(1, 2) @ Z + ratio[:, None, None] * eye)
    err = rel_err(torch, state.kern.L, Lr)
    require(err <= REL_BOUND, f"PT: carried |L - rebuild| / max |L| = {err} <= {REL_BOUND}")
    log(f"[PT N={PT_N}] {PT_LADDERS} ladders x {PT_REPLICAS} replicas = {rows} rows, leaf "
        f"tier R={budget}: {PT_ROUNDS} rounds from empty forests in {dt:.2f} s = "
        f"{dt / PT_ROUNDS * 1e3:.1f} ms a round (init included) on {smi}; launches {c}; "
        f"swap rate {swap:.4f}; cold MLL at the end {run.cold_mll[:, -1].tolist()}; "
        f"{passed:.2f} of the ladders passed the reference's target {REFERENCE_TARGET:.2f}; "
        f"leaves == fresh routing; |L - rebuild|/max|L| {err:.3e}")

    # beta = 1 on every row is the plain step, bit for bit
    draws = draw_step(torch.Generator(device=dev).manual_seed(11), rows, params, dev)
    plain, _ = step_with_info(state, X, y, bounds, ft, params, draws)
    cold, _ = step_with_info(state, X, y, bounds, ft, params, draws,
                             beta=torch.ones(rows, device=dev))
    require(all(torch.equal(a, b) for a, b in zip(plain.forest, cold.forest))
            and torch.equal(plain.leaves, cold.leaves) and torch.equal(plain.mll, cold.mll),
            "PT: a step at beta = 1 on every row equals the plain step")
    # one round replayed on the CPU: the tempered step decides alike, and
    # the swap decides alike from the same MLLs
    new = replay_on_cpu(torch, f"PT N={PT_N}", state, X, y, bounds, ft, params, SLICE_TREES,
                        beta=run.state.betas.reshape(-1))
    u = torch.rand(shape, generator=torch.Generator().manual_seed(12))
    mlls = new.mll.reshape(shape)
    parity = PT_ROUNDS % 2
    on_card = swap_move(u.to(dev), run.state.betas, mlls, parity)
    require(torch.equal(on_card.cpu(), swap_move(u, run.state.betas.cpu(), mlls.cpu(), parity)),
            "PT: the swap decides alike on the card and the CPU")
    # K2 at the round's shape: both configurations of every row's A
    A = Z.transpose(1, 2) @ Z + ratio[:, None, None] * eye
    A2 = torch.cat([A, Z.transpose(1, 2) @ Z + 1.05 * ratio[:, None, None] * eye]).contiguous()
    L, E = chol_inv_cuda(A2)
    Lp, _ = chol_inv_plain(A2)
    err = rel_err(torch, L, Lp)
    resid = (E @ L - torch.eye(budget, device=dev)).abs().max().item()
    require(err <= REL_BOUND and resid <= 5e-4,
            f"K2 at the PT shape {tuple(A2.shape)}: |L - L_plain| / max {err}, |E L - I| {resid}")
    t = time_k2(torch, lambda: chol_inv_cuda(A2), lambda: chol_inv_plain(A2), A2.shape[0],
                budget, "chol_inv_kernel")
    name = f"({A2.shape[0]},{budget},{budget}) PT"
    times[("chol_inv", name)] = t
    log(f"[K2] {name}: |L-L_plain|/max|L| {err:.3e}, |EL-I| {resid:.3e}; device "
        f"{t['device_ms']:.5f} ms, call {t['call_ms']:.5f}, plain {t['plain_ms']:.5f} call / "
        f"{t['library_ms']} device (cuSOLVER); bound {t['bound_ms']:.5f} ms ({t['bound_by']}), "
        f"{100 * t['share_of_bound']:.1f}% of it, on {smi}")
    del run, state, new, Z, A, A2, L, E, Lp, Lr

    # ---- (b) SMC at N = 200, dense tier
    tf = map_benchmark("TreeFunction", dim=5, m=SLICE_TREES, function_seed=1)
    X_np = tf.domain.sample(SMC_N, np.random.default_rng(0))
    y_np = tf.f(X_np)
    X = torch.as_tensor(X_np, device=dev)
    y = torch.as_tensor((y_np - y_np.mean()) / y_np.std(), dtype=torch.float32, device=dev)
    bounds = torch.as_tensor(tf.domain.bounds("bitmask"), device=dev)
    ft = torch.as_tensor(tf.domain.feature_types(), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SMC_N)
    zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_smc(gen, X, y, bounds, ft, params, num_particles=SMC_PARTICLES,
                  num_rounds=SMC_ROUNDS, mutation_steps=SMC_MUTATIONS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c = counts()
    launches[f"smc N={SMC_N}"] = c
    want = 1 + SMC_ROUNDS * SMC_MUTATIONS
    require(c == {"gram": want, "chol_inv": want},
            f"SMC at N={SMC_N} (dense tier): K1 and K2 once per init and mutation step "
            f"({want}), got {c}")
    betas = res.betas.cpu()
    require(bool((betas[1:] >= betas[:-1]).all()) and betas[-1].item() == 1.0,
            f"SMC: beta non-decreasing and reaching 1: {betas.tolist()}")
    require(bool(torch.isfinite(res.log_evidence)), "SMC: finite log-evidence")
    w_sum = torch.exp(res.log_weights).sum().item()
    require(abs(w_sum - 1.0) <= 1e-4, f"SMC: weights sum to 1 ({w_sum})")
    # the prior alone, for its share of the run
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prior = draw_prior(gen, SMC_PARTICLES, SLICE_TREES, params.node_limit,
                       params.gamma_prior_shape, dev)
    sample_forest_prior(prior, SLICE_TREES, bounds, ft, params.alpha, params.beta,
                        params.node_limit, params.max_depth)
    torch.cuda.synchronize()
    prior_s = time.perf_counter() - t1
    log(f"[SMC N={SMC_N}] {SMC_PARTICLES} particles from the prior, {SMC_ROUNDS} rounds x "
        f"{SMC_MUTATIONS} mutation steps in {dt:.2f} s (the prior {prior_s:.3f} s) on {smi}; "
        f"launches {c}; betas {[round(b, 4) for b in betas.tolist()]}; ESS "
        f"{[round(e, 1) for e in res.ess_trace.tolist()]}; log-evidence "
        f"{res.log_evidence.item():.3f}; weights sum {w_sum:.6f}")

    # one round replayed on the CPU from the final particles, at beta 0.5 and
    # a resample threshold that makes it resample
    chains = init_chain_state(res.model.forest, res.model.noise, res.model.scale, X, y, ft,
                              params, bounds=bounds)
    draws = draw_smc_round(torch.Generator().manual_seed(13), SMC_PARTICLES, SMC_MUTATIONS,
                           params)
    args = dict(target_ess=0.6, resample_threshold=0.9)
    half = torch.tensor(0.5)
    log_w = torch.zeros(SMC_PARTICLES)
    on_card = smc_round(chains, half.to(dev), log_w.to(dev), torch.zeros((), device=dev),
                        draws.to(dev), X, y, bounds, ft, params, **args)
    on_cpu = smc_round(chains.to("cpu"), half, log_w, torch.zeros(()), draws, X.cpu(), y.cpu(),
                       bounds.cpu(), ft.cpu(), params, **args)
    require(abs(on_card.beta.item() - on_cpu.beta.item()) <= 1e-6,
            f"SMC replay: beta {on_card.beta.item()} on the card, {on_cpu.beta.item()} on the CPU")
    if torch.equal(on_card.ancestors.cpu(), on_cpu.ancestors):
        parted = set()
        for k, step_draws in enumerate(draws.steps):
            parted = compare_decisions(torch, f"SMC replay step {k}", step_draws,
                                       on_card.infos[k], on_cpu.infos[k], SLICE_TREES, parted)
    else:
        w = torch.softmax((on_cpu.beta - half) * chains.mll.cpu(), 0)
        pos = (torch.arange(SMC_PARTICLES) + draws.u_resample) / SMC_PARTICLES
        tie = (torch.cumsum(w, 0)[:, None] - pos[None, :]).abs().min().item()
        require(tie < 1e-6, f"SMC replay: ancestors differ away from a tie ({tie})")
        log(f"[SMC replay] ancestors part at a near-tie ({tie:.2e}); steps not compared")
    log(f"[SMC replay] one round at beta 0.5 -> {on_card.beta.item():.6f}: resampled "
        f"{not torch.equal(on_cpu.ancestors, torch.arange(SMC_PARTICLES))}, ancestors alike")

    # both kernels at the mutation step's shapes
    leaves = chains.leaves.contiguous()
    unit = torch.ones(SMC_N, device=dev)
    got = gram_cuda(leaves, leaves, unit, unit, params.node_limit)
    require(torch.equal(got, gram_plain(leaves, leaves, unit, unit)),
            f"K1 at the SMC shape {tuple(got.shape)} equals its plain version")
    t = time_k1(torch, gram_module, leaves, leaves, unit, unit, params.node_limit)
    name = f"({SMC_PARTICLES},{SMC_N},{SMC_N}) SMC"
    times[("gram", name)] = t
    log(f"[K1] {name} symmetric: exact; device {t['device_ms']} ms ({t['kernels_per_call']} "
        f"kernels a call), call {t['call_ms']:.5f}, plain {t['plain_ms']:.5f}; bf16 one-hot bmm "
        f"{t['library_ms']} ms device; bound {t['bound_ms']:.5f} ms ({t['bound_by']}), "
        f"{100 * t['share_of_bound']:.1f}% of it, on {smi}")
    K = torch.cat([kernel_matrix(got, chains.noise * f, chains.scale) for f in (1.0, 1.1)])
    K = K.contiguous()
    L, E = chol_inv_cuda(K)
    Lp, _ = chol_inv_plain(K)
    err_l = (L - Lp).abs().max().item()
    resid = (E @ L - torch.eye(SMC_N, device=dev)).abs().max().item()
    require(err_l <= 1e-4 and resid <= 5e-4,
            f"K2 at the SMC shape {tuple(K.shape)}: |L - L_plain| {err_l}, |E L - I| {resid}")
    t = time_k2(torch, lambda: chol_inv_cuda(K), lambda: chol_inv_plain(K), K.shape[0], SMC_N,
                "chol_inv_kernel")
    name = f"({K.shape[0]},{SMC_N},{SMC_N}) SMC"
    times[("chol_inv", name)] = t
    log(f"[K2] {name}: |L-L_plain| {err_l:.3e}, |EL-I| {resid:.3e}; device "
        f"{t['device_ms']:.5f} ms, call {t['call_ms']:.5f}, plain {t['plain_ms']:.5f} call / "
        f"{t['library_ms']} device (cuSOLVER); bound {t['bound_ms']:.5f} ms ({t['bound_by']}), "
        f"{100 * t['share_of_bound']:.1f}% of it, on {smi}")
    del res, chains, on_card, on_cpu, K, L, E, Lp

    # ---- (c) a tempered BO loop at full width
    bo_params = SamplerParams(num_chains=4, num_samples=8, steps_per_sample=5, warmup_steps=50)
    rounds = 4
    sur = BARKSurrogate(tf.domain, bo_params, seed=0, fit_style="tempered",
                        num_replicas=PT_REPLICAS)
    s = tk.TreeKernelStrategy(tf.domain, surrogate=sur, seed=0, num_candidates=ACQ_BATCH,
                              num_rounds=rounds)
    require(s.device.type == "cuda", "the tempered strategy runs on the card")
    X0 = tf.domain.sample(50, np.random.default_rng(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.tell(X0, tf.f(X0))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    steps = bo_params.num_samples * bo_params.steps_per_sample
    per_iter, med = full_width_iterations(torch, s, tf, TEMPERED_BO_ITERATIONS, rounds,
                                          {"gram": steps + 1, "chol_inv": steps + 1},
                                          "tempered BO")
    launches["tempered_bo"] = per_iter
    diag = sur.fit_diagnostics
    require(0.0 <= diag["swap_rate"] <= 1.0, f"tempered BO: swap rate {diag['swap_rate']}")
    log(f"[tempered BO] dim 5, m 50, {bo_params.num_chains} ladders x {PT_REPLICAS} replicas, "
        f"S={bo_params.num_chains * bo_params.num_samples}, {ACQ_BATCH} candidates x "
        f"{rounds + 1} batches, N=50-52 (bucket 64), first fit ({bo_params.warmup_steps + steps} "
        f"rounds) {first_s:.2f} s; medians of {TEMPERED_BO_ITERATIONS} on {smi}: "
        f"{med['ask_s'] + med['fit_s']:.2f} s per iteration = fit {med['fit_s']:.2f} + build "
        f"{med['build']:.3f} + score {med['score']:.3f} + centring {med['centre']:.3f}; "
        f"{diag}")
    return launches, times


def phase_oracle_sampling_cg(torch, dev, smi, tf):
    """Phase 10 (see the module docstring). Returns the launches by path and
    the kernel times at the new shapes."""
    from bark_tpu_torch.benchmarks.kernel_timing import time_k1, time_k2
    from bark_tpu_torch.fitting.params import SamplerParams
    from bark_tpu_torch.fitting.sampler import (
        BARKModel, draw_step, init_chain_state, run_bark_sampler, run_chain, step_with_info,
    )
    from bark_tpu_torch.forest import (
        Forest, compact_leaf_indicator, create_empty_forest, flatten_batch, route_forest,
    )
    from bark_tpu_torch.models.gp import forest_predict_cg, forest_predict_leaf
    from bark_tpu_torch.models.sampling import (
        construct_nystrom_features, generate_fstar_samples, generate_fstar_samples_leaf,
        leaf_function_samples, nystrom_samples,
    )
    from bark_tpu_torch.models.surrogate import BARKSurrogate
    from bark_tpu_torch.ops import gram as gram_module
    from bark_tpu_torch.ops.chol import MAX_BLOCK, chol_inv_cuda, chol_inv_plain
    from bark_tpu_torch.ops.gram import gram_cuda, gram_plain
    from bark_tpu_torch.ops.iterative import cg_solve
    from bark_tpu_torch.ops.linalg import blocked_cholesky, kernel_matrix

    def zero():
        gram_cuda.launches = chol_inv_cuda.launches = 0

    def counts():
        return {"gram": gram_cuda.launches, "chol_inv": chol_inv_cuda.launches}

    def timed(fn):
        """(result, seconds, launches) of one call."""
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, counts()

    def log_k1(name, t):
        log(f"[K1] {name}{' symmetric' if t['symmetric'] else ''}: exact; device "
            f"{t['device_ms']} ms ({t['kernels_per_call']} kernels a call), call "
            f"{t['call_ms']:.5f}, plain {t['plain_ms']:.5f}; bf16 one-hot bmm {t['library_ms']} "
            f"ms device; bound {t['bound_ms']:.5f} ms ({t['bound_by']}), "
            f"{100 * t['share_of_bound']:.1f}% of it, on {smi}")

    def log_k2(name, t, err, resid):
        log(f"[K2] {name}: |L-L_plain| {err:.3e}, |EL-I| {resid:.3e}; device "
            f"{t['device_ms']:.5f} ms ({t['kernels_per_call']} kernels a call, "
            f"{t['device_source']}), call "
            f"{t['call_ms']:.5f}, plain {t['plain_ms']:.5f} call / {t['library_ms']} device "
            f"(cuSOLVER); bound {t['bound_ms']:.5f} ms ({t['bound_by']}), "
            f"{100 * t['share_of_bound']:.1f}% of it, on {smi}")

    def check_k2(name, K, bound_abs):
        """K2 (or blocked_cholesky above 256) against its plain version on
        the batch K, then timed; ``bound_abs`` None takes the relative bound."""
        n = K.shape[-1]
        factor = (lambda: chol_inv_cuda(K)) if n <= MAX_BLOCK else (lambda: blocked_cholesky(K))
        L, E = factor()
        Lp, _ = chol_inv_plain(K)
        err = (rel_err(torch, L, Lp) if bound_abs is None
               else (L - Lp).abs().max().item())
        resid = (E @ L - torch.eye(n, device=dev)).abs().max().item()
        bound = REL_BOUND if bound_abs is None else bound_abs
        require(err <= bound and resid <= 5e-3,
                f"K2 {name}: |L - L_plain| {err} <= {bound}, |E L - I| {resid} <= 5e-3")
        small = n <= MAX_BLOCK and K.shape[0] * n * n < 2**24
        t = time_k2(torch, factor, lambda: chol_inv_plain(K), K.shape[0], n,
                    "chol_inv_kernel" if n <= MAX_BLOCK else None,
                    *((25, 10) if small else (5, 2)))
        require(t["device_ms"] > 0, f"K2 {name}: a device time")
        times[("chol_inv", name)] = t
        log_k2(name, t, err, resid)

    launches, times = {}, {}
    dom = tf.domain
    ft = torch.as_tensor(dom.feature_types(), device=dev)
    bounds = torch.as_tensor(dom.bounds("bitmask"), device=dev)

    def data(n, seed=0):
        X_np = dom.sample(n, np.random.default_rng(seed))
        y_np = tf.f(X_np)
        return (torch.as_tensor(X_np, device=dev),
                torch.as_tensor((y_np - y_np.mean()) / y_np.std(), dtype=torch.float32,
                                device=dev))

    # ---- (a) the chol backend, the drift-free oracle
    for n in CHOL_NS:
        X, y = data(n)
        params = SamplerParams(warmup_steps=0, num_samples=CHOL_STEPS, steps_per_sample=1,
                               num_chains=CHOL_CHAINS, num_trees=SLICE_TREES,
                               kernel_backend="chol")
        model = BARKModel(
            create_empty_forest(SLICE_TREES, params.node_limit, (CHOL_CHAINS,), dev),
            torch.full((CHOL_CHAINS,), 0.1, device=dev), torch.ones(CHOL_CHAINS, device=dev))
        gen = torch.Generator(device=dev).manual_seed(n)
        run, dt, c = timed(lambda: run_chain(gen, model, X, y, bounds, ft, params))
        launches[f"chol N={n}"] = c
        blocks = -(-n // MAX_BLOCK)
        want = {"gram": 1, "chol_inv": blocks * (1 + CHOL_STEPS * (SLICE_TREES + 1))}
        require(c == want, f"chol N={n}: K1 once (init) and K2 {blocks} time(s) per "
                           f"factorization, init + {CHOL_STEPS} x (m + 1): {want}, got {c}")
        state = run.state
        acc = run.tree_accept_rate.mean().item()
        require(bool(torch.isfinite(run.mll).all()), f"chol N={n}: finite MLL")
        require(0.0 < acc < 1.0, f"chol N={n}: tree accept rate {acc} in (0, 1)")
        fresh = route_forest(state.forest, X, ft)
        require(torch.equal(fresh, state.leaves), f"chol N={n}: leaves equal a fresh routing")
        K_r = kernel_matrix(gram_plain(fresh, fresh), state.noise, state.scale)
        ok, err_k = within(torch, state.kern.K, K_r, 1e-5, 1e-5)
        require(ok, f"chol N={n}: carried K equals a fresh rebuild (max |diff| {err_k})")
        log(f"[chol N={n}] {CHOL_CHAINS} chains, {CHOL_STEPS} steps from empty forests in "
            f"{dt:.3f} s = {dt / CHOL_STEPS * 1e3:.1f} ms a step (init included) on {smi}; "
            f"launches {c}; tree accept {acc:.4f}; leaves == fresh routing; "
            f"|K - rebuild| {err_k:.3e}")
        replay_on_cpu(torch, f"chol N={n}", state, X, y, bounds, ft, params, SLICE_TREES)
        check_k2(f"({CHOL_CHAINS},{n},{n}) chol move", state.kern.K.contiguous(),
                 None if n > MAX_BLOCK else (2e-4 if n > 200 else 1e-4))
        del run, state, K_r

    # ---- (b) chol against rank1: one step from one state with the same draws
    X, y = data(AGREE_N)
    rank1 = SamplerParams(num_trees=SLICE_TREES, num_chains=AGREE_CHAINS, warmup_steps=10,
                          num_samples=1, steps_per_sample=1)
    chol = rank1.with_(kernel_backend="chol")
    empty = BARKModel(
        create_empty_forest(SLICE_TREES, rank1.node_limit, (AGREE_CHAINS,), dev),
        torch.full((AGREE_CHAINS,), 0.1, device=dev), torch.ones(AGREE_CHAINS, device=dev))
    warm = run_bark_sampler(torch.Generator(device=dev).manual_seed(16), empty, X, y, bounds,
                            ft, rank1)
    forest = Forest(*(f[:, -1] for f in warm.forest))
    draws = draw_step(torch.Generator(device=dev).manual_seed(17), AGREE_CHAINS, rank1, dev)
    infos = [
        step_with_info(init_chain_state(forest, warm.noise[:, -1], warm.scale[:, -1], X, y, ft,
                                        p, bounds=bounds), X, y, bounds, ft, p, draws)[1]
        for p in (rank1, chol)
    ]
    same_tree = infos[0].tree_accepts == infos[1].tree_accepts
    alike = same_tree.all(1) & (infos[0].hyper_accept == infos[1].hyper_accept)
    share_chains = alike.float().mean().item()
    share_moves = same_tree.float().mean().item()
    require(share_chains >= 0.95, f"chol vs rank1 at N={AGREE_N}: {share_chains:.4f} of "
                                  f"{AGREE_CHAINS} chains alike in every move (>= 0.95)")
    log(f"[chol vs rank1 N={AGREE_N}] one step from one state, same draws, {AGREE_CHAINS} "
        f"chains: {share_moves:.4f} of tree moves decided alike, {share_chains:.4f} of chains "
        f"alike in every move")

    # ---- (c) posterior function sampling at the width of a BO fit
    rng = np.random.default_rng(21)
    Xs = dom.sample(SAMPLING_N, rng)
    params = SamplerParams(num_chains=4, num_samples=8, steps_per_sample=5, warmup_steps=50)
    sur = BARKSurrogate(dom, params, seed=2).fit(Xs, tf.f(Xs))
    train_x, train_y = sur.train_data
    require(train_x.shape[0] == SAMPLING_N, f"sampling: N={SAMPLING_N} needs no padding")
    model, depth = sur.model, params.max_depth
    s_count = params.num_chains * params.num_samples
    r = SLICE_TREES * ((params.node_limit + 1) // 2)
    blocks = -(-r // MAX_BLOCK)
    Xe = torch.as_tensor(dom.sample(SAMPLING_POINTS, rng), device=dev)
    gen = torch.Generator(device=dev).manual_seed(22)
    D = SAMPLING_DRAWS
    eps = torch.randn(s_count, r, D, generator=gen, device=dev)
    draws_, leaf_s, c = timed(lambda: leaf_function_samples(model, train_x, train_y, Xe, ft, eps,
                                                           depth))
    launches["leaf_function_samples"] = c
    require(c == {"gram": 0, "chol_inv": blocks},
            f"leaf_function_samples: no K1 call and {blocks} K2 launches (r={r}), got {c}")
    mu, var = forest_predict_leaf(model.forest, model.noise, model.scale, train_x, train_y, Xe,
                                  ft, depth)
    z_mu = ((draws_.mean(1) - mu) / torch.sqrt(var / D)).abs().max().item()
    # the sample variance on the Wilson-Hilferty cube-root scale, where it is
    # normal: (s^2/var)^(1/3) ~ N(1 - 2/(9k), 2/(9k)) with k = D - 1 degrees
    k = D - 1
    wh = ((draws_.var(1) / var) ** (1 / 3) - (1 - 2 / (9 * k))) / (2 / (9 * k)) ** 0.5
    z_var = wh.abs().max().item()
    require(z_mu <= 5.0 and z_var <= 5.0,
            f"leaf_function_samples: empirical mean and variance of {D} draws within 5 se of "
            f"forest_predict_leaf at {s_count} x {SAMPLING_POINTS} points (max |z| {z_mu:.2f}, "
            f"{z_var:.2f})")
    z = torch.randn(s_count, SAMPLING_N, D, generator=gen, device=dev)
    fs_dense, dense_s, c_dense = timed(lambda: generate_fstar_samples(model, train_x, train_y,
                                                                      ft, z, depth))
    require(c_dense == {"gram": 1, "chol_inv": 1},
            f"generate_fstar_samples: one K1 and one K2 call, got {c_dense}")
    launches["generate_fstar_samples"] = c_dense
    eps_f = torch.randn(s_count, r, D, generator=gen, device=dev)
    fs_leaf, fleaf_s, c = timed(lambda: generate_fstar_samples_leaf(model, train_x, train_y, ft,
                                                                    eps_f, depth))
    require(c == {"gram": 0, "chol_inv": blocks},
            f"generate_fstar_samples_leaf: {blocks} K2 launches, got {c}")
    d_mean = abs(fs_leaf.mean().item() - fs_dense.mean().item())
    d_std = abs(fs_leaf.std().item() - fs_dense.std().item())
    require(bool(torch.isfinite(fs_dense).all() and torch.isfinite(fs_leaf).all())
            and d_mean < 0.2 and d_std < 0.2,
            f"f* samplers: leaf and dense agree (|mean diff| {d_mean}, |std diff| {d_std} < 0.2)")
    feats, nys_s, c = timed(lambda: construct_nystrom_features(model, train_x, train_x, ft,
                                                               depth))
    require(c == {"gram": 2, "chol_inv": 0}, f"Nystrom features: two K1 calls, got {c}")
    launches["nystrom"] = c
    flat = flatten_batch(model.forest)
    tl = route_forest(flat, train_x, ft, depth).contiguous()
    K_XX = model.scale.reshape(-1)[:, None, None] * gram_plain(tl, tl)
    err_n = (feats @ feats.transpose(1, 2) - K_XX).abs().max().item()
    require(err_n <= 1e-3, f"Nystrom with inducing = train reproduces K_XX: {err_n} <= 1e-3")
    feats_e, nys_e_s, _ = timed(lambda: construct_nystrom_features(model, train_x, Xe, ft,
                                                                   depth))
    w = torch.randn(s_count, feats_e.shape[-1], D, generator=gen, device=dev)
    nd, nd_s, _ = timed(lambda: nystrom_samples(feats_e, w))
    require(nd.shape == (s_count, D, SAMPLING_POINTS) and bool(torch.isfinite(nd).all()),
            "nystrom_samples: finite (S, draws, points)")
    log(f"[sampling] S={s_count}, N={SAMPLING_N}, {SAMPLING_POINTS} points, {D} draws on {smi}: "
        f"leaf_function_samples {leaf_s * 1e3:.2f} ms (max |z| mean {z_mu:.2f}, variance "
        f"{z_var:.2f}); generate_fstar_samples {dense_s * 1e3:.2f} ms, _leaf "
        f"{fleaf_s * 1e3:.2f} ms (mean {fs_dense.mean().item():.4f} / "
        f"{fs_leaf.mean().item():.4f}, std {fs_dense.std().item():.4f} / "
        f"{fs_leaf.std().item():.4f}); Nystrom on the train set {nys_s * 1e3:.2f} ms "
        f"(|phi phi^T - K_XX| {err_n:.3e}), at {SAMPLING_POINTS} points {nys_e_s * 1e3:.2f} ms, "
        f"nystrom_samples {nd_s * 1e3:.2f} ms")
    # the kernels at these shapes
    for name, args in ((f"({s_count},{SAMPLING_N},{SAMPLING_N}) f*", (tl, tl, None, None)),
                       (f"({s_count},{SAMPLING_POINTS},{SAMPLING_N}) Nystrom K_xZ",
                        (route_forest(flat, Xe, ft, depth).contiguous(), tl, None, None))):
        got = gram_cuda(*args, params.node_limit)
        require(torch.equal(got, gram_plain(*args)), f"K1 {name} equals its plain version")
        t = time_k1(torch, gram_module, *args, params.node_limit, 10, 3)
        require(t["device_ms"] > 0, f"K1 {name}: a device time")
        times[("gram", name)] = t
        log_k1(name, t)
    nu = 1e-6 + model.noise.reshape(-1)
    K_s = (K_XX + nu[:, None, None] * torch.eye(SAMPLING_N, device=dev)).contiguous()
    check_k2(f"({s_count},{SAMPLING_N},{SAMPLING_N}) f*", K_s, 2e-4)
    Zs = compact_leaf_indicator(flat, tl, (params.node_limit + 1) // 2)
    gamma = model.scale.reshape(-1) / SLICE_TREES
    A = (Zs.transpose(1, 2) @ Zs + (nu / gamma)[:, None, None] * torch.eye(r, device=dev))
    check_k2(f"({s_count},{r},{r}) leaf_function_samples", A.contiguous(), None)
    del draws_, feats, feats_e, nd, w, eps, eps_f, z, A, Zs, K_s

    # ---- (d) predict_backend="cg" against "leaf"
    X4 = dom.sample(CG_N, rng)
    params4 = SamplerParams(num_chains=4, num_samples=8, steps_per_sample=2, warmup_steps=20)
    sur4 = BARKSurrogate(dom, params4, seed=3, predict_backend="cg").fit(X4, tf.f(X4))
    train_x, train_y = sur4.train_data
    mask, model = sur4.train_mask, sur4.model
    C_np = dom.sample(CG_CANDIDATES, rng)
    C = torch.as_tensor(C_np, device=dev)
    args = (model.forest, model.noise, model.scale, train_x, train_y, C, ft, depth)
    (mu_c, var_c), cg_s, c = timed(lambda: forest_predict_cg(*args, train_mask=mask))
    trips = cg_solve.trips
    launches[f"predict cg N={CG_N}"] = c
    require(c == {"gram": 0, "chol_inv": 0}, f"cg predict: no kernel launch (products), got {c}")
    (mu_l, var_l), leaf_s, _ = timed(lambda: forest_predict_leaf(*args, train_mask=mask))
    ok_mu, err_mu = within(torch, mu_c, mu_l, ORACLE_ATOL, ORACLE_RTOL)
    ok_var, err_var = within(torch, var_c, var_l, ORACLE_ATOL, ORACLE_RTOL)
    require(ok_mu and ok_var, f"cg against leaf predict at N={CG_N}: |mu diff| {err_mu}, "
                              f"|var diff| {err_var} within {ORACLE_ATOL} + {ORACLE_RTOL} |value|")
    flat = flatten_batch(model.forest)
    pick = slice(0, CG_ORACLE_SAMPLES)
    tl = route_forest(flat, train_x, ft, depth)[pick]
    cl = route_forest(flat, C, ft, depth)[pick]
    mu64, var64 = oracle_posterior(torch, tl, cl, mask, train_y, model.noise.reshape(-1)[pick],
                                   model.scale.reshape(-1)[pick])
    ok_mu, err_mu64 = within(torch, mu_c[pick], mu64, ORACLE_ATOL, ORACLE_RTOL)
    ok_var, err_var64 = within(torch, var_c[pick], var64, ORACLE_ATOL, ORACLE_RTOL)
    require(ok_mu and ok_var, f"cg predict against the float64 dense oracle: |mu diff| "
                              f"{err_mu64}, |var diff| {err_var64}")
    mu_s, sd_s = sur4.predict(C_np)
    sur4.predict_backend = "leaf"
    mu_sl, sd_sl = sur4.predict(C_np)
    ok, err_sur = within(torch, torch.as_tensor(mu_s), torch.as_tensor(mu_sl), 1e-3, 1e-3)
    ok_sd, err_sd = within(torch, torch.as_tensor(sd_s), torch.as_tensor(sd_sl), 1e-3, 1e-3)
    require(ok and ok_sd, f"BARKSurrogate cg against leaf: |mu| {err_sur}, |std| {err_sd}")
    log(f"[predict cg N={CG_N}] S={model.noise.numel()}, {CG_CANDIDATES} "
        f"candidates on {smi}: cg {cg_s * 1e3:.1f} ms in {trips} CG trips, leaf "
        f"{leaf_s * 1e3:.1f} ms; cg vs leaf max |mu diff| {err_mu:.3e}, |var diff| "
        f"{err_var:.3e}; vs float64 on {CG_ORACLE_SAMPLES} samples {err_mu64:.3e} / "
        f"{err_var64:.3e}; through BARKSurrogate.predict |mu| {err_sur:.3e}, |std| {err_sd:.3e}")
    return launches, times


def mll64(torch, gram, y, noise, scale):
    """Float64 MLL (up to the constant) of y under scale * gram + (jitter +
    noise) I, on the CPU."""
    g, y = gram.double().cpu(), y.double().cpu()
    L = torch.linalg.cholesky(scale * g + (1e-6 + noise) * torch.eye(len(y), dtype=torch.float64))
    z = torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0]
    return float(-0.5 * ((z * z).sum() + 2.0 * torch.log(torch.diagonal(L)).sum()))


def mogp_oracle(torch, train_leaves, tasks, y, B, noise, new_leaves, new_tasks):
    """Float64 joint posterior (mu, cov) of the multi-task GP at the new
    points, by plain compares on the CPU; ``noise`` is per task."""
    m = train_leaves.shape[-1]
    tl, nl, t, tn = (a.cpu() for a in (train_leaves, new_leaves, tasks, new_tasks))
    B = B.double().cpu()

    def agree(a, b):
        return (a[:, None, :] == b[None, :, :]).sum(-1).double() / m

    K = agree(tl, tl) * B[t[:, None], t[None, :]] + torch.diag(1e-6 + noise.double().cpu()[t])
    k = agree(nl, tl) * B[tn[:, None], t[None, :]]
    chol = torch.linalg.cholesky(K)
    mu = k @ torch.cholesky_solve(y.double().cpu()[:, None], chol)[:, 0]
    cov = agree(nl, nl) * B[tn[:, None], tn[None, :]] - k @ torch.cholesky_solve(k.T, chol)
    return mu, cov


def phase_booster_forests(torch, dev, smi):
    """Phase 11 (see the module docstring). Returns the launches by path and
    the kernel times at the new shapes."""
    import contextlib
    import copy
    from unittest import mock

    import bark_tpu_torch.models.leafgp as leafgp
    import bark_tpu_torch.optimizer.search as search
    import bark_tpu_torch.strategies.multi_fidelity as tmf
    from bark_tpu_torch import native
    from bark_tpu_torch.benchmarks import map_benchmark
    from bark_tpu_torch.benchmarks.kernel_timing import time_k1, time_k2
    from bark_tpu_torch.benchmarks.mf_bo import run_study
    from bark_tpu_torch.forest import Forest, num_null_trees, route_forest
    from bark_tpu_torch.models.gp import forest_predict
    from bark_tpu_torch.models.mogp import (
        LeafMOGPSurrogate, MOGPParams, mogp_kernel, task_covariance,
    )
    from bark_tpu_torch.ops import gram as gram_module
    from bark_tpu_torch.ops.chol import MAX_BLOCK, chol_inv_cuda, chol_inv_plain
    from bark_tpu_torch.ops.gram import gram_cuda, gram_from_leaves, gram_plain
    from bark_tpu_torch.ops.linalg import (
        JITTER, blocked_cholesky, kernel_matrix, robust_cholesky,
    )
    from bark_tpu_torch.optimizer.acquisition import (
        DEFAULT_KAPPA, build_acquisition, build_acquisition_mogp, evaluate_acquisition,
    )
    from bark_tpu_torch.strategies.tree_kernel import make_strategy

    t_phase = time.perf_counter()
    launches, times = {}, {}

    def zero():
        gram_cuda.launches = chol_inv_cuda.launches = robust_cholesky.escalations = 0

    def counts():
        return {"gram": gram_cuda.launches, "chol_inv": chol_inv_cuda.launches}

    def timed(fn):
        """(result, seconds, launches, jitter escalations) of one call."""
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, counts(), robust_cholesky.escalations

    def clocked(spent, part, fn, keep=None):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[part] = spent.get(part, 0.0) + time.perf_counter() - t0
            if keep is not None:
                keep[part] = (a, out)
            return out
        return run

    def patched(pairs):
        """Set (module, name, fn) for the duration of a ``with`` block."""
        stack = contextlib.ExitStack()
        for mod, name, fn in pairs:
            stack.enter_context(mock.patch.object(mod, name, fn))
        return stack

    def time_gram(name, l1, l2, reps):
        """K1 at a single-forest shape (G = 1): exact against its plain
        version, then timed; the same tensor twice is the symmetric path."""
        a = l1[None].contiguous()
        b = a if l2 is l1 else l2[None].contiguous()
        require(torch.equal(gram_cuda(a, b), gram_plain(a, b)),
                f"K1 {name} equals its plain version")
        t = time_k1(torch, gram_module, a, b, None, None, 64, *reps)
        require(t["device_ms"] > 0, f"K1 {name}: a device time")
        times[("gram", name)] = t
        log(f"[K1] {name}{' symmetric' if t['symmetric'] else ''}: exact; device "
            f"{t['device_ms']} ms ({t['kernels_per_call']} kernels a call, {t['device_source']}), "
            f"call {t['call_ms']:.5f}, plain {t['plain_ms']:.5f}; bf16 one-hot bmm "
            f"{t['library_ms']} ms device; bound {t['bound_ms']:.5f} ms ({t['bound_by']}), "
            f"{100 * t['share_of_bound']:.1f}% of it, on {smi}")

    def time_chol(name, K, reps):
        """K2 (``blocked_cholesky`` above 256) on one (N, N) matrix, G = 1,
        against its plain version: |L - L_plain| <= 1e-4 (2e-4 above 200, the
        reference's bound for its blocked path) and |E L - I| <= 5e-3 (the
        kernel matrices of fitted hyperparameters are ill-conditioned), then
        timed."""
        K = K[None].contiguous()
        n = K.shape[-1]
        factor = (lambda: chol_inv_cuda(K)) if n <= MAX_BLOCK else (lambda: blocked_cholesky(K))
        L, E = factor()
        Lp, _ = chol_inv_plain(K)
        err = (L - Lp).abs().max().item()
        resid = (E @ L - torch.eye(n, device=dev)).abs().max().item()
        bound = 1e-4 if n <= 200 else 2e-4
        require(err <= bound and resid <= 5e-3,
                f"K2 {name}: |L - L_plain| {err} <= {bound}, |E L - I| {resid} <= 5e-3")
        t = time_k2(torch, factor, lambda: chol_inv_plain(K), 1, n,
                    "chol_inv_kernel" if n <= MAX_BLOCK else None, *reps)
        require(t["device_ms"] > 0, f"K2 {name}: a device time")
        times[("chol_inv", name)] = t
        log(f"[K2] {name}: |L-L_plain| {err:.3e}, |EL-I| {resid:.3e}; device "
            f"{t['device_ms']:.5f} ms ({t['kernels_per_call']} kernels a call, "
            f"{t['device_source']}), call {t['call_ms']:.5f}, plain {t['plain_ms']:.5f} call / "
            f"{t['library_ms']} device (cuSOLVER); bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}), {100 * t['share_of_bound']:.1f}% of it, on {smi}")

    # ---- (a) LeafGP at full width: fit, predict, acquisition, five iterations
    t0 = time.perf_counter()
    native.build()
    build_s = time.perf_counter() - t0
    tf5 = map_benchmark("TreeFunction", dim=5, m=50, function_seed=1)
    dom = tf5.domain
    rng = np.random.default_rng(11)
    X, C = dom.sample(LEAFGP_N, rng), dom.sample(LEAFGP_POINTS, rng)
    y, fC = tf5.f(X), tf5.f(C)
    t0 = time.perf_counter()
    # the first Adam step of a process sets up the optimizer on the host once
    leafgp._fit_hypers(torch.eye(8, device=dev), torch.zeros(8, device=dev), steps=2)
    warm_s = time.perf_counter() - t0
    sur = leafgp.LeafGPSurrogate(dom)
    require(sur.device.type == "cuda", "LeafGPSurrogate's default device is the card")
    spent = {}
    with patched([(leafgp, "fit_booster_forest",
                   clocked(spent, "booster", leafgp.fit_booster_forest)),
                  (leafgp, "_fit_hypers", clocked(spent, "hypers", leafgp._fit_hypers))]):
        _, fit_s, c, _ = timed(lambda: sur.fit(X, y))
    launches[f"leafgp fit N={LEAFGP_N}"] = c
    require(c == {"gram": 1, "chol_inv": 0},
            f"LeafGP fit: one K1 launch (the Gram) and no K2 (Adam factors through the "
            f"library), got {c}")
    model = sur.model
    require(model.forest.is_leaf.shape == (1, 50, 64) and model.forest.is_leaf.is_cuda
            and model.noise.is_cuda, "LeafGP: a (1, 50, 64) forest on the card")
    train_x, train_y = sur.train_data
    ft = sur._feat_types
    forest1 = Forest(*(t[0] for t in model.forest))
    tl = route_forest(forest1, train_x, ft)
    gram = gram_from_leaves(tl, tl)
    require(torch.equal(gram, gram_plain(tl, tl)),
            "LeafGP Gram (1,200,200) equals its plain version")
    noise, scale = float(model.noise[0]), float(model.scale[0])
    mll_fit = mll64(torch, gram, train_y, noise, scale)
    mll_start = mll64(torch, gram, train_y, 0.1, 1.0)
    require(mll_fit >= mll_start,
            f"LeafGP: the fitted MLL {mll_fit} is not below Adam's start {mll_start}")
    log(f"[LeafGP] dim 5, m 50, N={LEAFGP_N} on {smi}: g++ build {build_s:.2f} s, Adam set-up "
        f"{warm_s:.2f} s; fit {fit_s:.3f} s = booster {spent['booster']:.3f} + hyperparameters "
        f"{spent['hypers']:.3f} (200 Adam steps) + the rest; launches {c}; noise {noise:.5f}, "
        f"scale {scale:.5f}; MLL {mll_start:.3f} at Adam's start -> {mll_fit:.3f}")
    K = kernel_matrix(gram, model.noise[0], model.scale[0])
    time_chol(f"(1,{LEAFGP_N},{LEAFGP_N}) LeafGP predict and build", K, (25, 10))

    (mu_s, sd_s), pred_s, c, esc = timed(lambda: sur.predict(C))
    launches["leafgp predict"] = c
    require(c == {"gram": 2, "chol_inv": 1 + esc},
            f"LeafGP predict: 2 K1 calls and 1 K2 call (+{esc} escalations), got {c}")
    Ct = torch.as_tensor(C, device=dev)
    mu, var = forest_predict(model.forest, model.noise, model.scale, train_x, train_y, Ct, ft)
    cl = route_forest(forest1, Ct, ft)
    ones = torch.ones(LEAFGP_N)
    mu64, var64 = oracle_posterior(torch, tl[None].cpu(), cl[None].cpu(), ones, train_y.cpu(),
                                   model.noise.cpu(), model.scale.cpu())
    ok_mu, err_mu = within(torch, mu, mu64, ORACLE_ATOL, ORACLE_RTOL)
    ok_var, err_var = within(torch, var, var64, ORACLE_ATOL, ORACLE_RTOL)
    require(ok_mu and ok_var, f"LeafGP predict against the float64 oracle: |mu diff| {err_mu}, "
                              f"|var diff| {err_var}")
    mse = float(np.mean((mu_s[:, 0] - fC) ** 2))
    require(mse < float(np.var(fC)), f"LeafGP held-out MSE {mse} under the mean predictor's "
                                     f"{np.var(fC)}")
    acq, acq_build_s, c_b, esc = timed(lambda: build_acquisition(model, train_x, train_y, ft))
    require(c_b == {"gram": 1, "chol_inv": 1 + esc},
            f"LeafGP build_acquisition: 1 K1 and 1 K2 call (+{esc}), got {c_b}")
    batch = torch.as_tensor(dom.sample(ACQ_BATCH, rng), device=dev)
    lcb, score_s, c_s, _ = timed(lambda: evaluate_acquisition(acq, batch, ft))
    require(c_s == {"gram": 1, "chol_inv": 0}, f"LeafGP scoring: 1 K1 call, got {c_s}")
    launches["leafgp acquisition"] = {k: c_b[k] + c_s[k] for k in c_s}
    cb = route_forest(forest1, batch, ft)
    mu64b, var64b = oracle_posterior(torch, tl[None].cpu(), cb[None].cpu(), ones, train_y.cpu(),
                                     model.noise.cpu(), model.scale.cpu(),
                                     num_null_trees(acq.forest).cpu())
    lcb64 = (mu64b - DEFAULT_KAPPA * var64b.clamp_min(1e-12).sqrt()).mean(0)
    ok_lcb, err_lcb = within(torch, lcb, lcb64, ORACLE_ATOL, ORACLE_RTOL)
    require(ok_lcb, f"LeafGP LCB at B={ACQ_BATCH} against the float64 oracle: {err_lcb}")
    log(f"[LeafGP] predict at {LEAFGP_POINTS} points {pred_s * 1e3:.1f} ms, launches "
        f"{launches['leafgp predict']}; against the float64 oracle |mu| {err_mu:.3e}, |var| "
        f"{err_var:.3e}; held-out MSE {mse:.4f} (mean predictor {np.var(fC):.4f}); "
        f"build_acquisition {acq_build_s * 1e3:.1f} ms, scoring B={ACQ_BATCH} "
        f"{score_s * 1e3:.1f} ms, launches {launches['leafgp acquisition']}; LCB against the "
        f"float64 oracle {err_lcb:.3e}; on {smi}")
    time_gram(f"(1,{LEAFGP_N},{LEAFGP_N}) LeafGP fit", tl, tl, (25, 10))
    time_gram(f"(1,{LEAFGP_POINTS},{LEAFGP_N}) LeafGP predict K_xX", cl, tl, (25, 10))
    time_gram(f"(1,{ACQ_BATCH},{LEAFGP_N}) LeafGP scoring", cb, tl, (10, 3))
    del acq, batch, cb, cl, mu, var

    s = make_strategy("LeafGP", dom, seed=0, num_candidates=ACQ_BATCH, num_rounds=LEAFGP_ROUNDS)
    require(s.device.type == "cuda", "make_strategy('LeafGP')'s default device is the card")
    s.tell(X, y)
    per_iter, med = full_width_iterations(
        torch, s, tf5, LEAFGP_ITERATIONS, LEAFGP_ROUNDS, {"gram": 1, "chol_inv": 0},
        "LeafGP full width", fit_parts=((leafgp, "fit_booster_forest", "booster"),
                                        (leafgp, "_fit_hypers", "hypers")))
    launches["leafgp_bo_iteration"] = per_iter
    log(f"[LeafGP full width] dim 5, m 50, N={LEAFGP_N}-{LEAFGP_N + LEAFGP_ITERATIONS - 1}, "
        f"{ACQ_BATCH} candidates x {LEAFGP_ROUNDS + 1} batches, medians of "
        f"{LEAFGP_ITERATIONS} on {smi}: {med['ask_s'] + med['fit_s']:.3f} s per iteration = fit "
        f"{med['fit_s']:.3f} (booster {med['booster']:.3f}, hyperparameters "
        f"{med['hypers']:.3f}) + build {med['build']:.4f} + score {med['score']:.4f} + "
        f"centring {med['centre']:.4f} + other "
        f"{med['ask_s'] - med['build'] - med['score'] - med['centre']:.4f}")

    # ---- (b) LeafGP in the documented flow
    bench = map_benchmark("TreeFunction", dim=2, m=10, function_seed=1)
    lo, hi = bench.domain.bounds("ordinal").T
    axis = (np.arange(400) + 0.5) / 400
    grid = np.stack(np.meshgrid(axis, axis), -1).reshape(-1, 2).astype(np.float32)
    grid_min = float(bench.f(grid).min())
    for seed in LEAFGP_LOOP_SEEDS:
        X2 = bench.domain.sample(8, np.random.default_rng(seed))
        y2 = bench.f(X2)
        s = make_strategy("LeafGP", bench.domain, seed=seed, num_candidates=1024, num_rounds=3)
        zero()
        t0 = time.perf_counter()
        s.tell(X2, y2)
        for i in range(LEAFGP_LOOP_ITERATIONS):
            c2 = s.ask()
            require(c2.shape == (1, 2) and bool((lo <= c2[0]).all() and (c2[0] <= hi).all()),
                    f"LeafGP loop seed {seed} iteration {i}: the ask {c2} lies in the domain")
            s.add(c2, bench.f(c2))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c = counts()
        launches[f"leafgp loop seed {seed}"] = c
        require(s.fallbacks == 0, f"LeafGP loop seed {seed}: no random fallback ({s.fallbacks})")
        require(c["gram"] > 0 and c["chol_inv"] > 0, f"LeafGP loop seed {seed}: both kernels")
        held = y2.min() <= grid_min + 1e-6
        if not held:
            require(s.y.min() < y2.min(),
                    f"LeafGP loop seed {seed}: best y {s.y.min()} below the initial {y2.min()}")
        log(f"[LeafGP loop seed {seed}] {LEAFGP_LOOP_ITERATIONS} iterations in {dt:.2f} s on "
            f"{smi}: best y {s.y.min():.6f} (initial {y2.min():.6f}, grid minimum "
            f"{grid_min:.6f}{', held by the initial points' if held else ''}); launches {c}")

    # ---- (c) the multi-fidelity study at the example's defaults
    records, study_s, c, _ = timed(lambda: run_study(0, MF_ITERATIONS))
    launches["mf_study"] = c
    fids = [r["fidelity"] for r in records]
    costs = [r["cum_cost"] for r in records]
    bests = [r["best_target"] for r in records]
    require(len(records) == MF_ITERATIONS and set(fids) <= {0, 1}, f"MF study fidelities {fids}")
    require(all(b > a for a, b in zip(costs, costs[1:])), f"MF study: the cost grows {costs}")
    require(all(np.isfinite(bests)) and all(b2 <= b1 for b1, b2 in zip(bests, bests[1:])),
            f"MF study: the target incumbent never worsens {bests}")
    # a fit (1), predict at the candidates (2), f* (2), the choice of fidelity
    # (a predict per fidelity, 2 each, and one joint posterior, 2)
    require(c == {"gram": 11 * MF_ITERATIONS, "chol_inv": 0},
            f"MF study: 11 K1 launches an iteration and no K2, got {c}")
    log(f"[MF study] CurrinExp2D, seed 0, 6 initial points, {MF_ITERATIONS} iterations, 256 "
        f"candidates, 16 f* in {study_s:.2f} s ({study_s / MF_ITERATIONS:.3f} s each) on {smi}: "
        f"fidelities {fids}, low-fidelity share {np.mean(np.asarray(fids) != 0):.2f}, total cost "
        f"{costs[-1]:.2f}, best target {bests[-1]:.6f}; launches {c}")

    # ---- (d) one MultiFidelityStrategy ask at N = 300
    mf = map_benchmark("CurrinExp2D")
    mdom = mf.domain
    Xm = mdom.sample(2 * MF_PER_FIDELITY, np.random.default_rng(5))
    fidm = np.repeat([0, 1], MF_PER_FIDELITY)
    ym = mf.f_fidelity(Xm, fidm)
    s = make_strategy("LeafMOGP", mdom, seed=0, fidelity_costs=list(mf.fidelity_costs))
    defaults = (s.num_candidates, s.num_rounds, s.num_fstar)
    require(s.device.type == "cuda" and defaults == (2048, 3, 16),
            "the multi-fidelity strategy runs on the card at its defaults")
    _, tell_s, c_fit, _ = timed(lambda: s.tell(Xm, fidm, ym))
    launches[f"mf fit N={2 * MF_PER_FIDELITY}"] = c_fit
    require(c_fit == {"gram": 1, "chol_inv": 0}, f"MOGP fit: one K1 launch, got {c_fit}")
    spent, kept = {}, {}
    rng_before = copy.deepcopy(s._rng)
    with patched([
        (tmf, "build_acquisition_mogp", clocked(spent, "build", tmf.build_acquisition_mogp, kept)),
        (search, "evaluate_acquisition", clocked(spent, "score", search.evaluate_acquisition)),
        (tmf, "fstar_samples_mogp", clocked(spent, "fstar", tmf.fstar_samples_mogp, kept)),
        (tmf, "propose_fidelity_information_based",
         clocked(spent, "fidelity", tmf.propose_fidelity_information_based)),
    ]):
        (x, fid), ask_s, c, esc = timed(lambda: s.ask())
    launches[f"mf ask N={2 * MF_PER_FIDELITY}"] = c
    want = {"gram": 1 + s.num_rounds + 2 + 6, "chol_inv": 2 * (1 + esc)}
    require(c == want, f"MF ask at N={2 * MF_PER_FIDELITY}: launches {c}, the code predicts "
                       f"{want} (K2 through blocked_cholesky: 2 a factorization)")
    sur_m = s.surrogate
    Xt_m, tasks_m, y_m, leaves_m, gram_m = sur_m.train
    params = sur_m.params
    B = task_covariance(params)
    noise_t = leafgp._softplus(params.raw_noise)
    acq = kept["build"][1]
    cands = torch.as_tensor(mdom.sample(256, np.random.default_rng(6)), device=dev)
    lcb = evaluate_acquisition(acq, cands, s._feat_types)
    cand_leaves = route_forest(sur_m.forest, cands, s._feat_types)
    mu64, cov64 = mogp_oracle(torch, leaves_m, tasks_m, y_m, B, noise_t, cand_leaves,
                              torch.zeros(256, dtype=torch.int64))
    lcb64 = mu64 - DEFAULT_KAPPA * torch.diagonal(cov64).clamp_min(1e-12).sqrt()
    # the state holds K^-1 = E^T E, as the reference's does; with the fitted
    # noise near 1e-3 K's condition number is near 1e5 and that formula
    # loses up to ~1e-2 on the LCB in float32 wherever it runs, so the card
    # is held to the plain versions' own error on the CPU from the same
    # state (the reference's formula in float32): at most twice it + 1e-3
    host = LeafMOGPSurrogate(mdom, num_tasks=2, device="cpu")
    host.forest = sur_m.forest.to("cpu")
    host.params = MOGPParams(*(p.cpu() for p in params))
    host.train = tuple(t.cpu() for t in sur_m.train)
    host.scaler = copy.deepcopy(sur_m.scaler)
    lcb_host = evaluate_acquisition(build_acquisition_mogp(host), cands.cpu(),
                                    s._feat_types.cpu())
    _, err_lcb = within(torch, lcb, lcb64, ORACLE_ATOL, ORACLE_RTOL)
    _, err_lcb_host = within(torch, lcb_host, lcb64, ORACLE_ATOL, ORACLE_RTOL)
    require(err_lcb <= 1e-3 + 2.0 * err_lcb_host,
            f"MOGP target-fidelity LCB against the float64 oracle: {err_lcb} on the card, "
            f"{err_lcb_host} for the plain versions on the CPU")
    Xj = mdom.sample(64, np.random.default_rng(7))
    tj = np.arange(64) % 2
    mu_j, cov_j = sur_m._posterior_joint(Xj, tj)
    mu64j, cov64j = mogp_oracle(
        torch, leaves_m, tasks_m, y_m, B, noise_t,
        route_forest(sur_m.forest, torch.as_tensor(Xj, device=dev), s._feat_types),
        torch.as_tensor(tj))
    ok_mu, err_mu = within(torch, mu_j, mu64j, ORACLE_ATOL, ORACLE_RTOL)
    ok_cov, err_cov = within(torch, cov_j, cov64j, ORACLE_ATOL, ORACLE_RTOL)
    require(ok_mu and ok_cov, f"MOGP _posterior_joint against the float64 oracle: |mu| "
                              f"{err_mu}, |cov| {err_cov}")
    # the choice of fidelity replayed on the CPU from the same state and numpy seed
    f_star_card = kept["fstar"][1]
    f_star_host = tmf.fstar_samples_mogp(host, s.X, s.num_fstar, rng_before)
    fid_host = tmf.propose_fidelity_information_based(host, x[0], s.fidelity_costs, f_star_host)
    fid_card_fstar = tmf.propose_fidelity_information_based(host, x[0], s.fidelity_costs,
                                                            f_star_card)
    require(fid == fid_host == fid_card_fstar,
            f"MF ask: fidelity {fid} on the card, {fid_host} in the CPU replay, "
            f"{fid_card_fstar} on the CPU from the card's f*")
    lo_m, hi_m = mdom.bounds("ordinal").T
    require(bool(((lo_m <= x[0]) & (x[0] <= hi_m)).all()), f"MF ask: x {x} in the domain")
    log(f"[MF ask N={2 * MF_PER_FIDELITY}] CurrinExp2D, 150 points at each fidelity, 2048 "
        f"candidates x 3 rounds, 16 f* on {smi}: fit {tell_s:.3f} s; ask {ask_s:.3f} s = build "
        f"{spent['build']:.4f} + score {spent['score']:.4f} + f* {spent['fstar']:.4f} + "
        f"fidelity choice {spent['fidelity']:.4f} + centring and the rest "
        f"{ask_s - sum(spent.values()):.4f}; launches {c}; x {x[0]}, fidelity {fid} (CPU replay "
        f"{fid_host}, |f* card - f* CPU| {np.abs(f_star_card - f_star_host).max():.3e}); LCB "
        f"against the float64 oracle {err_lcb:.3e} (plain versions on the CPU "
        f"{err_lcb_host:.3e}), _posterior_joint |mu| {err_mu:.3e}, "
        f"|cov| {err_cov:.3e}")
    n_m = 2 * MF_PER_FIDELITY
    time_gram(f"(1,{n_m},{n_m}) MOGP fit", leaves_m, leaves_m, (25, 10))
    time_gram(f"(1,{s.num_candidates},{n_m}) MOGP scoring",
              route_forest(sur_m.forest, torch.as_tensor(mdom.sample(s.num_candidates, rng),
                                                          device=dev), s._feat_types),
              leaves_m, (10, 3))
    K_m = mogp_kernel(gram_m, tasks_m, tasks_m, params) + torch.diag(JITTER + noise_t[tasks_m])
    time_chol(f"(1,{n_m},{n_m}) MOGP build, blocked_cholesky", K_m, (10, 3))
    log(f"[phase 11] {time.perf_counter() - t_phase:.1f} s")
    return launches, times


BART_N, BART_BIG_N, BART_BIG_CHAINS, BART_POINTS, BART_REPLAY = 200, 4096, 4, 1024, 5
GRID_N, GRID_CHAINS, GRID_SAMPLES, GRID_MAX = 50, 4, 8, 2**14
REGRESSION_RUNS = 2  # of the configuration's 5
STUDIES = (  # (benchmark config, model config, iterations)
    ("benchmark_treefunction", "model_bart", 5),
    ("benchmark_styblinskitang", {"model": "RelaxedGP"}, 10),
    ("benchmark_pestcontrol", {"model": "BARTGrid", "model_params": "model_bart"}, 5),
    ("benchmark_g6", "model_bark", 3),
    ("benchmark_pressurevessel", "model_bark", 3),
    ("benchmark_styblinskitang", {"model": "GridUCB", "model_params": "model_bark"}, 3),
)


def phase_baselines_study(torch, dev, smi):
    """Phase 12 (see the module docstring). Returns the launches by path and
    the kernel times at the grid-UCB shapes."""
    import csv
    import tempfile

    from bark_tpu_torch.benchmarks import map_benchmark
    from bark_tpu_torch.benchmarks.kernel_timing import time_k1, time_k2
    from bark_tpu_torch.benchmarks.regression import run_regression
    from bark_tpu_torch.benchmarks.study import EXAMPLE_CONFIGS, build_strategy, run_study
    from bark_tpu_torch.fitting.bart import (
        BARTParams, _moved_leaves, _one_hot, bart_step, bart_step_with_info, draw_bart,
        posterior_gamma_shape, run_bart_sampler,
    )
    from bark_tpu_torch.fitting.proposals import ProposalNoise, propose_tree_packed
    from bark_tpu_torch.fitting.params import SamplerParams
    from bark_tpu_torch.forest import flatten_batch, route_forest, route_tree, unpack_forest
    from bark_tpu_torch.models.bart import (
        BARTSurrogate, _invgamma_rate_for_quantile, _MinMaxHalf,
    )
    from bark_tpu_torch.models.surrogate import BARKSurrogate
    from bark_tpu_torch.ops import gram as gram_module
    from bark_tpu_torch.ops.chol import chol_inv_cuda, chol_inv_plain
    from bark_tpu_torch.ops.gram import gram_cuda, gram_from_leaves, gram_plain
    from bark_tpu_torch.ops.linalg import kernel_matrix, robust_cholesky
    from bark_tpu_torch.strategies.baselines import GridUCBStrategy, reparam_lcb

    t_phase = time.perf_counter()
    launches, times = {}, {}
    cpu = torch.device("cpu")
    none = {"gram": 0, "chol_inv": 0}

    def zero():
        gram_cuda.launches = chol_inv_cuda.launches = robust_cholesky.escalations = 0

    def counts():
        return {"gram": gram_cuda.launches, "chol_inv": chol_inv_cuda.launches}

    def timed(fn):
        """(result, seconds, launches) of one call."""
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, counts()

    def check_state(tag, state, X, ft, depth):
        """Cached leaves equal a fresh routing; f_total the sum of the leaf
        values over trees (1e-5 relative); sigma2 finite."""
        fresh = route_tree(unpack_forest(state.packed), X, ft, depth)
        require(torch.equal(fresh, state.leaves), f"{tag}: cached leaves equal a fresh routing")
        f_sum = torch.gather(state.leaf_values, -1, fresh.long()).sum(-2)
        err = ((f_sum - state.f_total).abs().max() / f_sum.abs().max()).item()
        require(err <= 1e-5, f"{tag}: f_total equals the sum of leaf values ({err} relative)")
        require(bool(torch.isfinite(state.sigma2).all()), f"{tag}: finite sigma2")
        return err

    # ---- (a) BART at the published defaults ---------------------------------
    tf = map_benchmark("TreeFunction", dim=5, m=50, function_seed=1)
    dom = tf.domain
    rng = np.random.default_rng(12)
    X, Xt = dom.sample(BART_N + 1, rng), dom.sample(BART_POINTS, rng)
    y, yt = tf.f(X), tf.f(Xt)
    params = BARTParams()
    fits = []
    for _ in range(2):
        sur, cold_s, c = timed(lambda: BARTSurrogate(dom, params, seed=1).fit(X[:BART_N],
                                                                              y[:BART_N]))
        require(sur.device.type == "cuda", "BARTSurrogate's default device is the card")
        require(c == none, f"BART fit: no K1 or K2 launch, got {c}")
        fits.append((sur, cold_s))
    launches[f"bart fit N={BART_N}"] = c
    (a, cold_s), (b, cold2_s) = fits
    require(all(torch.equal(u, v) for u, v in zip(a.samples, b.samples))
            and all(torch.equal(u, v) for u, v in zip(a._state, b._state)),
            "BART: two cold fits from one seed are equal (trees, leaf values, sigma2, state)")
    _, warm_s, c = timed(lambda: a.fit(X, y))
    require(c == none, f"BART warm refit: no K1 or K2 launch, got {c}")
    err_a = check_state(f"BART fit N={BART_N + 1}", a._state, a.train_data[0], a._feat_types,
                        params.max_depth)
    (mu, std), predict_s, c = timed(lambda: a.predict(Xt))
    mse, base = float(np.mean((mu[:, 0] - yt) ** 2)), float(np.mean((yt - y.mean()) ** 2))
    require(np.isfinite(mu).all() and np.isfinite(std).all() and mse < base,
            f"BART predict: finite, held-out MSE {mse} under the mean predictor's {base}")
    log(f"[BART] TreeFunction(dim=5, m=50, seed=1), {params.num_trees} trees, "
        f"{params.warmup_steps} warmup + {params.num_samples} sample sweeps, 1 chain, on {smi}: "
        f"cold fit at N={BART_N} {cold_s:.2f} s and {cold2_s:.2f} s (equal samples), "
        f"{cold_s / params.num_steps * 1e3:.1f} ms a sweep; warm refit at N={BART_N + 1} "
        f"({params.num_samples} sweeps) {warm_s:.2f} s; predict at {BART_POINTS} points "
        f"{predict_s * 1e3:.1f} ms, MSE {mse:.4f} vs mean predictor {base:.4f}; f_total "
        f"{err_a:.2e}; sigma2 {a.samples.sigma2[0, -1].item():.5f}")

    X4 = dom.sample(BART_BIG_N, rng)
    y4 = _MinMaxHalf()(tf.f(X4), train=True)
    rate = float(np.float32(_invgamma_rate_for_quantile(params.noise_prior_shape,
                                                        float(np.var(y4)))))
    params4 = params.with_(num_chains=BART_BIG_CHAINS)
    X4t = torch.as_tensor(X4, device=dev)
    y4t = torch.as_tensor(y4, dtype=torch.float32, device=dev)
    bounds = torch.as_tensor(dom.bounds("bitmask"), device=dev)
    ft = torch.as_tensor(dom.feature_types(), device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    (samples4, state4), big_s, c = timed(
        lambda: run_bart_sampler(gen, X4t, y4t, bounds, ft, params4, rate))
    launches[f"bart N={BART_BIG_N}"] = c
    require(c == none, f"BART at N={BART_BIG_N}: no K1 or K2 launch, got {c}")
    err_b = check_state(f"BART N={BART_BIG_N}", state4, X4t, ft, params.max_depth)
    # five more sweeps from one set of draws, on the card and replayed on the CPU
    draws = draw_bart(gen, BART_REPLAY, BART_BIG_CHAINS, params.num_trees, params.node_limit,
                      posterior_gamma_shape(params4, BART_BIG_N))
    card, host = state4, state4.to(cpu)
    infos, infos_c = [], []
    draws_c = draws.to(cpu)
    for t in range(BART_REPLAY):
        card, info = bart_step_with_info(draws.step(t), card, X4t, y4t, bounds, ft, params4,
                                         rate)
        host, info_c = bart_step_with_info(draws_c.step(t), host, X4t.cpu(), y4t.cpu(),
                                           bounds.cpu(), ft.cpu(), params4, rate)
        infos.append(info)
        infos_c.append(info_c)
    parted = {}
    for t, (i_d, i_c) in enumerate(zip(infos, infos_c)):
        acc_d, acc_c = i_d.accept.cpu(), i_c.accept
        for ch in range(BART_BIG_CHAINS):
            if ch in parted:
                continue
            for j in range(params.num_trees):
                if bool(acc_d[ch, j]) != bool(acc_c[ch, j]):
                    gap = min(abs(i_d.margin[ch, j].item()), abs(i_c.margin[ch, j].item()))
                    require(gap < NEAR_TIE, f"BART replay: chain {ch} sweep {t} tree {j} "
                            f"decides apart away from a tie (|log u - min(log a, 0)| {gap})")
                    parted[ch] = (t, j, gap)
                    break
    for ch in range(BART_BIG_CHAINS):
        if ch not in parted:
            require(torch.equal(card.packed[ch].cpu(), host.packed[ch]),
                    f"BART replay: chain {ch} ends with the CPU's trees")
    accept = torch.stack([i.accept for i in infos]).float().mean().item()
    require(0.0 < accept < 1.0, f"BART: tree accept rate {accept} in (0, 1)")
    log(f"[BART N={BART_BIG_N}] {BART_BIG_CHAINS} chains, {params4.num_steps} sweeps in "
        f"{big_s:.2f} s ({big_s / params4.num_steps * 1e3:.1f} ms a sweep of {params.num_trees} "
        f"trees) on {smi}; f_total {err_b:.2e}; tree accept rate {accept:.4f} over "
        f"{BART_REPLAY} sweeps; replayed on the CPU: {BART_BIG_CHAINS - len(parted)} of "
        f"{BART_BIG_CHAINS} chains decided every move alike, parted at near-ties {parted}")

    # the split of a sweep: the batched proposals (with the proposed leaves),
    # the one-hot columns of both branches, and the rest (the 50 visits and
    # sigma2), medians of 5 synchronised repetitions from one state
    def clock(fn, reps=5):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return statistics.median(out) * 1e3

    def sweep_split(state, X, y, mask):
        c, m, node_limit = state.leaf_values.shape
        d = draws.step(0) if c == BART_BIG_CHAINS else draw_bart(
            gen, 1, c, m, node_limit, 1.5 + 0.5 * float(mask.sum())).step(0)
        flat = ProposalNoise(*(t.reshape(c * m, *t.shape[2:]) for t in d.noise))

        def proposals():
            new, log_q, move, node = propose_tree_packed(
                state.packed.reshape(c * m, node_limit, 8), bounds, ft,
                params.proposal_params(), flat)
            return _moved_leaves(state.leaves, new.reshape(c, m, node_limit, 8),
                                 node.reshape(c, m), move.reshape(c, m),
                                 torch.isneginf(log_q.reshape(c, m)), X.t().contiguous(), ft)

        moved = proposals()
        whole = clock(lambda: bart_step(d, state, X, y, bounds, ft, params, rate, mask))
        prop = clock(proposals)
        onehot = clock(lambda: _one_hot(torch.stack([state.leaves, moved], 2), node_limit,
                                        mask).permute(0, 1, 3, 2, 4).reshape(c, m, -1, 2 * node_limit))
        return {"sweep": whole, "proposals": prop, "one_hot": onehot,
                "visits_and_sigma2": whole - prop - onehot}

    split_big = sweep_split(state4, X4t, y4t, None)
    split_200 = sweep_split(a._state, a.train_data[0], a.train_data[1], a.train_mask)
    log(f"[BART split] ms a sweep (median of 5) on {smi}: N={BART_BIG_N} x "
        f"{BART_BIG_CHAINS} chains {json.dumps({k: round(v, 3) for k, v in split_big.items()})}; "
        f"N={BART_N + 1} (bucket {a.train_data[0].shape[0]}) x 1 chain "
        f"{json.dumps({k: round(v, 3) for k, v in split_200.items()})}")

    # ---- (b) the regression runner ----------------------------------------
    out = tempfile.TemporaryDirectory()
    reg = {**EXAMPLE_CONFIGS["regression_treefunction"], "num_runs": REGRESSION_RUNS}
    for name in ("model_bart", "model_bark"):
        summary, reg_s, c = timed(lambda: run_regression(0, reg, EXAMPLE_CONFIGS[name],
                                                         out.name))
        launches[f"regression {EXAMPLE_CONFIGS[name]['model']}"] = c
        require(summary["mse"] < summary["mse_mean"] and np.isfinite(summary["nlpd"]),
                f"regression {name}: MSE {summary['mse']} under the mean predictor's "
                f"{summary['mse_mean']}")
        if name == "model_bart":
            require(c == none, f"regression BART: no K1 or K2 launch, got {c}")
        log(f"[regression] {EXAMPLE_CONFIGS[name]['model']} on TreeFunction(dim=5, m=50), "
            f"{reg['num_train']} train / {reg['num_test']} test, {reg['num_runs']} runs in "
            f"{reg_s:.1f} s on {smi}: MSE {summary['mse']:.4f} (mean predictor "
            f"{summary['mse_mean']:.4f}), NLPD {summary['nlpd']:.4f}, fit "
            f"{summary['fit_s']:.2f} s; launches {c}")

    # ---- (c) the BO studies of the example configurations ---------------------
    try:
        build_strategy({"model": "GridUCB"}, map_benchmark("PressureVessel").domain, 0)
    except ValueError as e:
        log(f"[study] GridUCB on PressureVessel refused, as the reference's: {e}")
    else:
        raise RuntimeError("check failed: GridUCB accepted the constrained PressureVessel")
    for bench_name, model, iterations in STUDIES:
        bench_cfg = {**EXAMPLE_CONFIGS[bench_name], "num_iter": iterations}
        if isinstance(model, str):
            model = EXAMPLE_CONFIGS[model]
        elif isinstance(model.get("model_params"), str):
            model = {**model, "model_params": EXAMPLE_CONFIGS[model["model_params"]]["model_params"]}
        merged, study_s, c = timed(lambda: run_study(0, bench_cfg, model, out.name))
        tag = f"{bench_cfg['benchmark']}_{model['model']}_seed=0"
        launches[f"study {bench_cfg['benchmark']} {model['model']}"] = c
        bdom = map_benchmark(bench_cfg["benchmark"], **bench_cfg.get("benchmark_params", {})).domain
        with open(f"{out.name}/experiments_{tag}.csv") as f:
            rows = list(csv.reader(f))
        require(rows[0] == [*bdom.input_keys, "y", "best", "viol", "fit_s", "optimize_s"]
                and len(rows) == iterations + 1, f"study {tag}: the reference's CSV columns")
        asks = np.array([[float(v) for v in r[:bdom.dim]] for r in rows[1:]], np.float32)
        lo, hi = bdom.bounds("ordinal").T
        require(bool(((lo <= asks) & (asks <= hi)).all()) and np.array_equal(bdom.round(asks), asks),
                f"study {tag}: every ask in the domain")
        best = np.array([float(r[bdom.dim + 1]) for r in rows[1:]])
        require(bool((np.diff(best) <= 0).all()) and merged["fallbacks"] == 0,
                f"study {tag}: the best y never rises; no fallback ({merged['fallbacks']})")
        if model["model"] in ("BART", "BARTGrid", "RelaxedGP"):
            require(c == none, f"study {tag}: no K1 or K2 launch, got {c}")
        else:
            require(c["gram"] > 0 and c["chol_inv"] > 0, f"study {tag}: both kernels ran, {c}")
        log(f"[study] {tag}: {iterations} iterations from {bench_cfg['num_init']} points in "
            f"{study_s:.1f} s ({study_s / iterations:.2f} s each) on {smi}: best y "
            f"{min(merged['best'], merged['initial_best']):.6g} (initial "
            f"{merged['initial_best']:.6g}), feasible proposals "
            f"{merged['feasible_proposal_rate']:.2f}; launches {c}")
    out.cleanup()

    # ---- (d) one grid-UCB ask over BARK at full width ---------------------------
    sp = SamplerParams(num_chains=GRID_CHAINS, num_samples=GRID_SAMPLES, steps_per_sample=5,
                       warmup_steps=50)
    s = GridUCBStrategy(dom, seed=0, params=sp, max_grid=GRID_MAX)
    require(s.device.type == "cuda", "GridUCBStrategy's default device is the card")
    Xg = dom.sample(GRID_N, np.random.default_rng(3))
    _, tell_s, _ = timed(lambda: s.tell(Xg, tf.f(Xg)))
    sur = s.surrogate
    S = GRID_CHAINS * GRID_SAMPLES
    n_grid = min(2 ** (5 * dom.dim), s.max_grid)
    eps = np.random.default_rng(4).standard_normal((1, S, n_grid))
    x, ask_s, c = timed(lambda: s.ask(1, eps=eps))
    launches["griducb ask"] = c
    esc = robust_cholesky.escalations
    require(c == {"gram": 2, "chol_inv": 1 + esc},
            f"grid-UCB ask: the predict's 2 K1 calls and 1 K2 call (+{esc} escalations), got {c}")
    grid = dom.sample_sobol(n_grid, seed=s.seed + s._ask_count - 1)
    lcb = reparam_lcb(sur.function_samples(grid, eps=eps), s.kappa)
    require(np.array_equal(x[0], grid[int(np.argmax(lcb))]), "grid-UCB ask: the LCB's argmax")
    host_sur = BARKSurrogate(dom, sp, device="cpu")
    host_sur.model = type(sur.model)(sur.model.forest.to(cpu), sur.model.noise.cpu(),
                                     sur.model.scale.cpu())
    host_sur.train_data = tuple(t.cpu() for t in sur.train_data)
    host_sur.train_mask = sur.train_mask.cpu()
    host_sur.scaler = sur.scaler
    lcb_c = reparam_lcb(host_sur.function_samples(grid, eps=eps), s.kappa)
    i_d, i_c = int(np.argmax(lcb)), int(np.argmax(lcb_c))
    gap = abs(lcb[i_d] - lcb[i_c]) / max(abs(lcb[i_d]), 1e-12)
    require(i_d == i_c or gap < 1e-5, f"grid-UCB ask: argmax {i_d} on the card, {i_c} in the "
            f"CPU replay, {gap} apart (relative) in the card's LCB")
    err_lcb = float(np.abs(lcb - lcb_c).max() / np.abs(lcb_c).max())
    # the split of an ask: the grid (host), predict (the card), the normals
    # and the LCB (host), medians of 5
    part = {
        "grid": clock(lambda: dom.sample_sobol(n_grid, seed=0)),
        "predict": clock(lambda: sur.predict(grid, batched=True)),
        "normals": clock(lambda: np.random.default_rng(5).standard_normal((1, S, n_grid))),
    }
    mu_g, sd_g = sur.predict(grid, batched=True)
    part["draws_and_lcb"] = clock(lambda: reparam_lcb(
        (mu_g[None, ..., 0] + sd_g[None, ..., 0] * eps).reshape(-1, n_grid), s.kappa))
    log(f"[griducb split] ms of an ask's parts (median of 5) on {smi}: "
        f"{json.dumps({k: round(v, 3) for k, v in part.items()})}")
    log(f"[griducb] GridUCB over BARK, dim 5, {GRID_CHAINS} chains x {GRID_SAMPLES} samples, "
        f"{GRID_N} observations, {n_grid}-point Sobol grid on {smi}: tell (fit) {tell_s:.2f} s; "
        f"ask {ask_s * 1e3:.1f} ms, launches {c}; argmax {i_d} (CPU replay {i_c}), LCB against "
        f"the CPU's {err_lcb:.2e} relative")
    # the kernels at the ask's shapes, each against its plain version
    train_x, mask = sur.train_data[0], sur.train_mask
    flat = flatten_batch(sur.model.forest)
    depth, node_limit = sp.max_depth, sp.node_limit
    tl = route_forest(flat, train_x, ft, depth).contiguous()
    gl = route_forest(flat, torch.as_tensor(grid, device=dev), ft, depth).contiguous()
    K_XX = gram_from_leaves(tl, tl, mask, mask, node_limit)
    K_xX = gram_from_leaves(gl, tl, None, mask, node_limit)
    require(torch.equal(K_XX, gram_plain(tl, tl, mask, mask))
            and torch.equal(K_xX, gram_plain(gl, tl, None, mask)),
            f"grid-UCB K1 {tuple(K_XX.shape)} and {tuple(K_xX.shape)} equal their plain versions")
    K = kernel_matrix(K_XX, sur.model.noise.reshape(-1), sur.model.scale.reshape(-1))
    L, E = chol_inv_cuda(K)
    Lp, _ = chol_inv_plain(K)
    n_pad = K.shape[-1]
    err_l = (L - Lp).abs().max().item()
    resid = (E @ L - torch.eye(n_pad, device=dev)).abs().max().item()
    require(err_l <= 1e-4 and resid <= 5e-4,
            f"grid-UCB K2 ({S},{n_pad},{n_pad}): |L - L_plain| {err_l} <= 1e-4, |E L - I| "
            f"{resid} <= 5e-4")
    for name, args, reps in (
        (f"({S},{n_pad},{n_pad}) griducb K_XX", (tl, tl, mask, mask), (25, 10)),
        (f"({S},{n_grid},{n_pad}) griducb K_xX", (gl, tl, None, mask), (5, 2)),
    ):
        t = time_k1(torch, gram_module, *args, node_limit, *reps)
        require(t["device_ms"] > 0, f"K1 {name}: a device time")
        times[("gram", name)] = t
        log(f"[K1] {name}{' symmetric' if t['symmetric'] else ''}: exact; device "
            f"{t['device_ms']} ms ({t['kernels_per_call']} kernels a call, {t['device_source']}), "
            f"call {t['call_ms']:.5f}, plain {t['plain_ms']:.5f}; bf16 one-hot bmm "
            f"{t['library_ms']} ms device; bound {t['bound_ms']:.5f} ms ({t['bound_by']}), "
            f"{100 * t['share_of_bound']:.1f}% of it, on {smi}")
    t = time_k2(torch, lambda: chol_inv_cuda(K), lambda: chol_inv_plain(K), S, n_pad,
                "chol_inv_kernel")
    require(t["device_ms"] > 0, "K2 at the grid-UCB shape: a device time")
    times[("chol_inv", f"({S},{n_pad},{n_pad}) griducb")] = t
    log(f"[K2] ({S},{n_pad},{n_pad}) griducb: |L-L_plain| {err_l:.3e}, |EL-I| {resid:.3e}; "
        f"device {t['device_ms']:.5f} ms ({t['device_source']}), call {t['call_ms']:.5f}, plain "
        f"{t['plain_ms']:.5f} call / {t['library_ms']} device (cuSOLVER); bound "
        f"{t['bound_ms']:.5f} ms ({t['bound_by']}), {100 * t['share_of_bound']:.1f}% of it, "
        f"on {smi}")
    log(f"[phase 12] {time.perf_counter() - t_phase:.1f} s")
    return launches, times


def phase_distributed(torch, dev, smi, tf):
    """Phase 13: the sharded paths, checkpoints, profiling, the last
    benchmarks. Returns the launches of each path and the kernels' times at
    the per-rank shapes."""
    import importlib.util
    import tempfile

    import torch.distributed as dist

    from bark_tpu_torch import graft_entry
    from bark_tpu_torch.benchmarks import map_benchmark
    from bark_tpu_torch.benchmarks.kernel_timing import time_k1, time_k2
    from bark_tpu_torch.fitting.params import SamplerParams
    from bark_tpu_torch.fitting.sampler import BARKModel, draw_step, init_chain_state, run_chain
    from bark_tpu_torch.fitting.sampler import step as sampler_step
    from bark_tpu_torch.forest import create_empty_forest, route_forest
    from bark_tpu_torch.models.gp import forest_predict_cg
    from bark_tpu_torch.models.surrogate import BARKSurrogate
    from bark_tpu_torch.ops import gram as gram_module
    from bark_tpu_torch.ops.chol import chol_inv_cuda, chol_inv_plain
    from bark_tpu_torch.ops.gram import gram_cuda, gram_plain
    from bark_tpu_torch.ops.linalg import kernel_matrix
    from bark_tpu_torch.optimizer.acquisition import (
        build_acquisition,
        evaluate_acquisition,
        evaluate_acquisition_sharded,
    )
    from bark_tpu_torch.parallel.distributed import global_chain_mesh, initialize_distributed
    from bark_tpu_torch.parallel.sharding import rank_generator, shard_model, sharded_run_sampler
    from bark_tpu_torch.parallel.smc import run_smc
    from bark_tpu_torch.utils import checkpoint, profiling

    t_phase = time.perf_counter()
    launches, times = {}, {}
    ft = torch.as_tensor(tf.domain.feature_types(), device=dev)
    bounds = torch.as_tensor(tf.domain.bounds("bitmask"), device=dev)

    def reset():
        gram_cuda.launches = chol_inv_cuda.launches = 0

    def counts():
        return {"gram": gram_cuda.launches, "chol_inv": chol_inv_cuda.launches}

    def data(n, seed=0):
        X_np = tf.domain.sample(n, np.random.default_rng(seed))
        y_np = tf.f(X_np)
        y_np = (y_np - y_np.mean()) / y_np.std()
        return (torch.as_tensor(X_np, device=dev),
                torch.as_tensor(y_np, dtype=torch.float32, device=dev), X_np, tf.f(X_np))

    def same_run(a, b):
        return (all(torch.equal(x, z) for x, z in zip(a.samples.forest, b.samples.forest))
                and torch.equal(a.samples.noise, b.samples.noise) and torch.equal(a.mll, b.mll))

    # a posterior at full width for scoring, CG and the checkpoint: S = 128
    X200, y200, X200_np, f200 = data(DIST_FIT_N, 1)
    fit_params = SamplerParams(warmup_steps=10, num_samples=8, steps_per_sample=2,
                               num_chains=DIST_FIT_CHAINS, num_trees=SLICE_TREES)
    sur = BARKSurrogate(tf.domain, fit_params, seed=DIST_SEED, device=dev).fit(X200_np, f200)
    tx, ty = sur.train_data
    depth = fit_params.max_depth
    acq = build_acquisition(sur.model, tx, ty, ft, depth, sur.train_mask)
    rng = np.random.default_rng(DIST_SEED)
    batches = [torch.as_tensor(tf.domain.sample(DIST_BATCH, rng), device=dev)
               for _ in range(DIST_BATCHES)]

    # --- (a) a one-rank NCCL group in this process ----------------------------
    X50, y50, _, _ = data(50)
    params = SamplerParams(num_chains=SLICE_CHAINS, num_trees=SLICE_TREES, **DIST_STEPS)
    steps = params.num_samples * params.steps_per_sample
    model = BARKModel(
        create_empty_forest(SLICE_TREES, params.node_limit, (SLICE_CHAINS,), dev),
        torch.full((SLICE_CHAINS,), 0.1, device=dev), torch.ones(SLICE_CHAINS, device=dev),
    )
    with tempfile.TemporaryDirectory() as tmp:
        rank_dev = initialize_distributed(f"file://{tmp}/pg", 1, 0)
        try:
            mesh = global_chain_mesh("chains")
            require(dist.get_backend() == "nccl" and rank_dev == dev,
                    f"one rank on {rank_dev} over {dist.get_backend()}")
            reset()
            t0 = time.perf_counter()
            run, diag = sharded_run_sampler(DIST_SEED, shard_model(model, mesh), X50, y50,
                                            bounds, ft, params, mesh)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            c = counts()
            launches["sharded sampler N=50, 1 NCCL rank"] = c
            require(c["gram"] == steps + 1 and c["chol_inv"] == steps + 1,
                    f"sharded sampler: K1 and K2 once per init and refresh ({steps + 1}), got {c}")
            want = run_chain(rank_generator(DIST_SEED, 0, dev), model, X50, y50, bounds, ft,
                             params)
            require(same_run(run, want), "sharded sampler (1 rank) equals run_chain")
            err = abs(float(diag.mean_mll) - float(want.state.mll.mean()))
            require(err <= 1e-6 * abs(float(want.state.mll.mean())),
                    f"mean MLL {float(diag.mean_mll)} is the chains' mean")
            log(f"[phase 13 a] sharded sampler, 1 NCCL rank, {SLICE_CHAINS} chains, m="
                f"{SLICE_TREES}, N=50, {steps} steps: equal to run_chain; {dt:.3f} s "
                f"({SLICE_CHAINS * steps / dt:.1f} chain-steps/s) on {smi}; launches {c}; "
                f"diagnostics {[round(float(v), 5) for v in diag]}")
            reset()
            sharded = [evaluate_acquisition_sharded(acq, b, ft, mesh, depth) for b in batches]
            torch.cuda.synchronize()
            c = counts()
            launches[f"sharded scoring {DIST_BATCHES} x {DIST_BATCH}, 1 NCCL rank"] = c
            require(c == {"gram": DIST_BATCHES, "chol_inv": 0},
                    f"sharded scoring: one K1 launch a batch, got {c}")
            plain = [evaluate_acquisition(acq, b, ft, depth) for b in batches]
            require(all(torch.equal(a, b) for a, b in zip(sharded, plain)),
                    "sharded scoring (1 rank) is bit-equal to evaluate_acquisition")
            log(f"[phase 13 a] sharded scoring, S={acq.K_inv.shape[0]}, N="
                f"{acq.K_inv.shape[-1]}: {DIST_BATCHES} x {DIST_BATCH} bit-equal; launches {c}")
        finally:
            dist.destroy_process_group()

    # --- (b) two Gloo ranks on this card ---------------------------------------
    X512 = graft_entry._problem(DIST_PT_N, 2, SLICE_TREES)[3]
    cands = batches[1][:DIST_CG_CANDIDATES]
    chains_per_rank = SLICE_CHAINS // 2
    parts = {
        "sampler": dict(seed=DIST_SEED, n_points=50, chains_per_rank=chains_per_rank,
                        num_trees=SLICE_TREES, params_kw=DIST_STEPS),
        "leaf": dict(seed=DIST_SEED, n_points=DIST_PT_N, chains_per_rank=1,
                     num_trees=SLICE_TREES,
                     params_kw=dict(warmup_steps=0, num_samples=1, steps_per_sample=2)),
        "pt": dict(seed=DIST_SEED, n_points=DIST_PT_N, num_trees=SLICE_TREES,
                   num_steps=DIST_PT_ROUNDS),
        "smc": dict(seed=DIST_SEED, num_trees=SLICE_TREES, **DIST_SMC),
        "scoring": dict(acq=acq, candidates=batches[0], feat_types=ft, max_depth=depth),
        "cg": dict(model=sur.model, train_x=tx, train_y=ty, candidates=cands, feat_types=ft,
                   max_depth=depth, train_mask=sur.train_mask),
    }
    t0 = time.perf_counter()
    out = graft_entry.dryrun_multichip(2, device=dev, backend="gloo", timeout=600, **parts)
    spawn_s = time.perf_counter() - t0
    for rank, r in enumerate(out):
        for part in ("sampler", "leaf", "pt", "smc", "scoring", "cg"):
            launches[f"sharded {part}, Gloo rank {rank} of 2"] = r[part]["launches"]
    # the sampler: diagnostics alike (dryrun_multichip checks it), each block
    # equal to run_chain over it from the rank's generator
    _, sp, smodel, sX, sy, sb, sft = graft_entry._problem(50, SLICE_CHAINS, SLICE_TREES,
                                                          DIST_STEPS, dev)
    for rank, r in enumerate(out):
        rows = slice(rank * chains_per_rank, (rank + 1) * chains_per_rank)
        block = BARKModel(type(smodel.forest)(*(t[rows] for t in smodel.forest)),
                          smodel.noise[rows], smodel.scale[rows])
        want = run_chain(rank_generator(DIST_SEED, rank, dev), block, sX, sy, sb, sft, sp)
        require(same_run(graft_entry._to_device(r["sampler"]["run"], dev), want),
                f"sharded sampler rank {rank} of 2 equals run_chain over its block")
        c = r["sampler"]["launches"]
        require(c["gram"] == steps + 1 and c["chol_inv"] == steps + 1,
                f"sharded sampler rank {rank}: K1 and K2 {steps + 1} times, got {c}")
    # PT at N=512: both ranks follow pt_swap_states driving the same replicas
    _, pp, pmodel, pX, py, pb, pft = graft_entry._problem(DIST_PT_N, 2, SLICE_TREES, None, dev)
    mlls, rates, states, _ = graft_entry.single_process_pt(
        DIST_SEED, 2, pmodel.forest, pmodel.noise, pmodel.scale, pX, py, pb, pft, pp,
        DIST_PT_ROUNDS)
    for rank, r in enumerate(out):
        pt_run = r["pt"]["run"]
        require(torch.equal(pt_run.mll, mlls[:, rank].cpu())
                and torch.equal(pt_run.swap_rate, rates.cpu()),
                f"sharded PT rank {rank}: MLL trace and swap rate equal pt_swap_states'")
        c = r["pt"]["launches"]
        require(c["gram"] == 0 and c["chol_inv"] == DIST_PT_ROUNDS + 1,
                f"sharded PT rank {rank}: K2 once per init and round, K1 never, got {c}")
    # SMC: run_smc from the same generator
    _, mp_, _, mX, my, mb, mft = graft_entry._problem(DIST_SMC["n_points"], 1, SLICE_TREES,
                                                      None, dev)
    kw = {k: v for k, v in DIST_SMC.items() if k != "n_points"}
    ref = run_smc(torch.Generator(device=dev).manual_seed(DIST_SEED), mX, my, mb, mft, mp_, **kw)
    for rank, r in enumerate(out):
        res = r["smc"]["result"]
        b_err = (res.betas - ref.betas.cpu()).abs().max().item()
        z_err = abs(float(res.log_evidence) - float(ref.log_evidence))
        require(b_err <= 1e-5 and z_err <= 1e-5 * abs(float(ref.log_evidence)),
                f"sharded SMC rank {rank}: betas within 1e-5 ({b_err}), log-evidence within "
                f"1e-5 relative ({z_err})")
        c = r["smc"]["launches"]
        n_smc = 1 + DIST_SMC["num_rounds"] * DIST_SMC["mutation_steps"]
        require(c == {"gram": n_smc, "chol_inv": n_smc},
                f"sharded SMC rank {rank}: K1 and K2 {n_smc} times, got {c}")
    # CG and scoring against the single-process calls
    mu, var = forest_predict_cg(sur.model.forest, sur.model.noise, sur.model.scale, tx, ty,
                                cands, ft, depth, train_mask=sur.train_mask)
    scores = evaluate_acquisition(acq, batches[0], ft, depth)
    cg_err = score_err = 0.0
    for rank, r in enumerate(out):
        for got, want in ((r["cg"]["mu"], mu), (r["cg"]["var"], var)):
            cg_err = max(cg_err, rel_err(torch, got[None], want.cpu()[None]))
        score_err = max(score_err, rel_err(torch, r["scoring"]["scores"][None, None],
                                           scores.cpu()[None, None]))
    require(cg_err <= 1e-5, f"sharded CG within 1e-5 of forest_predict_cg ({cg_err})")
    require(score_err <= 1e-6, f"sharded scoring over 2 ranks within 1e-6 ({score_err})")
    bit_equal = all(torch.equal(r["scoring"]["scores"], scores.cpu()) for r in out)
    log(f"[phase 13 b] 2 Gloo ranks on {torch.cuda.get_device_name(0)} through dryrun_multichip in "
        f"{spawn_s:.1f} s: sampler blocks equal run_chain, diagnostics alike "
        f"({float(out[0]['sampler']['diag'].mean_mll):.4f}); PT at N={DIST_PT_N} ({DIST_PT_ROUNDS} "
        f"rounds, swap rate {float(rates.mean()):.3f}) equal to pt_swap_states; SMC 2 x "
        f"{DIST_SMC['num_particles'] // 2} particles: log-evidence {float(ref.log_evidence):.4f}; "
        f"CG within {cg_err:.2e}; scoring within {score_err:.2e} "
        f"({'bit-equal' if bit_equal else 'not bit-equal'}); launches "
        f"{ {k: v for k, v in launches.items() if 'Gloo rank 0' in k} }")

    # --- (c) a checkpoint round trip ----------------------------------------------
    held_out = tf.domain.sample(256, np.random.default_rng(7))
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.save_surrogate(f"{tmp}/bark.npz", sur)
        fresh = checkpoint.load_surrogate(f"{tmp}/bark.npz", BARKSurrogate(
            tf.domain, fit_params, device=dev))
    before, after = sur.predict(held_out), fresh.predict(held_out)
    require(all(np.array_equal(a, b) for a, b in zip(before, after)),
            "a restored surrogate predicts as the saved one")
    log(f"[phase 13 c] checkpoint round trip of the S=128 surrogate: predictions equal")

    # --- (d) a trace of 3 steps names K1 and K2 -------------------------------------
    sp3 = SamplerParams(num_chains=SLICE_CHAINS, num_trees=SLICE_TREES)
    gen = torch.Generator(device=dev).manual_seed(DIST_SEED)
    state = init_chain_state(model.forest, model.noise, model.scale, X50, y50, ft, sp3,
                             bounds=bounds)
    with tempfile.TemporaryDirectory() as tmp:
        for attempt in range(1, 4):  # the profiler at times captures no kernel
            with profiling.trace(tmp) as prof:
                with profiling.annotate("three steps"):
                    for _ in range(TRACE_STEPS):
                        state = sampler_step(state, X50, y50, bounds, ft, sp3,
                                             draw_step(gen, SLICE_CHAINS, sp3, dev))
            names = [e.key for e in prof.key_averages()]
            k1 = [n for n in names if "gram" in n and "kernel" in n]
            k2 = [n for n in names if "chol_inv_kernel" in n]
            if k1 and k2:
                break
        text = open(f"{tmp}/{profiling.TRACE_FILE}").read()
    require(k1 and k2 and "chol_inv_kernel" in text and "three steps" in names,
            f"a trace of {TRACE_STEPS} steps names K1 and K2 ({k1}, {k2})")
    log(f"[phase 13 d] trace of {TRACE_STEPS} steps (attempt {attempt}): {k1 + k2}")

    # --- (e) the last six benchmarks -------------------------------------------------
    for name in ("CCOBench", "MAXBandit", "ToyReaction"):
        b = map_benchmark(name)
        y = b.f(b.domain.sample(64, np.random.default_rng(0)))
        require(y.shape == (64,) and bool(np.isfinite(y).all()), f"{name} evaluates")
    refused = []
    # each names the first package it needs that is missing (DatasetBenchmark
    # without data: pandas, then the UCI fetcher)
    for name, kw, pkgs in (("SVRBench", {"num_samples": 400}, ("xgboost", "sklearn")),
                           ("XGBoostMNIST", {}, ("xgboost", "sklearn")),
                           ("DatasetBenchmark", {"dataset_name": "Abalone"},
                            ("pandas", "ucimlrepo"))):
        missing = [p for p in pkgs if importlib.util.find_spec(p) is None]
        if not missing:
            log(f"[phase 13 e] {pkgs} are installed: {name} not checked")
            continue
        pkg = missing[0]
        try:
            map_benchmark(name, **kw)
        except RuntimeError as e:
            require(pkg in str(e), f"{name} names {pkg}: {e}")
            refused.append(name)
        else:
            raise RuntimeError(f"check failed: {name} built without {pkg}")
    log(f"[phase 13 e] CCOBench, MAXBandit, ToyReaction evaluate; {refused} raise naming "
        f"their package")

    # --- the kernels at the per-rank shapes of the sharded paths ----------------------
    cl = route_forest(acq.forest, batches[0][:DIST_BATCH // 2], ft, depth).contiguous()
    name = f"({cl.shape[0]},{cl.shape[1]},{acq.train_leaves.shape[1]}) sharded scoring, per rank"
    t = time_k1(torch, gram_module, cl, acq.train_leaves, None, acq.train_mask,
                acq.forest.node_limit)
    require(torch.equal(gram_cuda(cl, acq.train_leaves, None, acq.train_mask,
                                  acq.forest.node_limit),
                        gram_plain(cl, acq.train_leaves, None, acq.train_mask)),
            f"K1 {name} equals its plain version")
    times[("gram", name)] = t
    log(f"[K1] {name}: exact; device {t['device_ms']} ms ({t['device_source']}), call "
        f"{t['call_ms']:.5f}, plain {t['plain_ms']:.5f}; bf16 one-hot bmm {t['library_ms']} ms "
        f"device; bound {t['bound_ms']:.5f} ms ({t['bound_by']}), "
        f"{100 * t['share_of_bound']:.1f}% of it, on {smi}")
    leaves = run.state.leaves[:chains_per_rank].contiguous()
    gram = gram_plain(leaves, leaves)
    K = torch.cat([kernel_matrix(gram, torch.full((chains_per_rank,), nz, device=dev),
                                 torch.ones(chains_per_rank, device=dev))
                   for nz in (0.1, 0.01)]).contiguous()
    name = f"({K.shape[0]},50,50) sharded sampler refresh, per rank"
    L, E = chol_inv_cuda(K)
    Lp, _ = chol_inv_plain(K)
    err_l = (L - Lp).abs().max().item()
    require(err_l <= 1e-4, f"K2 {name}: |L - L_plain| {err_l} <= 1e-4")
    t = time_k2(torch, lambda: chol_inv_cuda(K), lambda: chol_inv_plain(K), K.shape[0], 50,
                "chol_inv_kernel")
    times[("chol_inv", name)] = t
    log(f"[K2] {name}: |L-L_plain| {err_l:.3e}; device {t['device_ms']:.5f} ms "
        f"({t['device_source']}), call {t['call_ms']:.5f}, plain {t['plain_ms']:.5f} call / "
        f"{t['library_ms']} device (cuSOLVER); bound {t['bound_ms']:.5f} ms ({t['bound_by']}), "
        f"{100 * t['share_of_bound']:.1f}% of it, on {smi}")
    log(f"[phase 13] {time.perf_counter() - t_phase:.1f} s")
    return launches, times


# --- phase 14: the last entry points ------------------------------------------------
GRAM_API_FORESTS, GRAM_API_ROWS = 16, (4096, 224)
LARGEN = dict(seed=0, n_init=4080, num_iter=2, num_candidates=4096, num_chains=4,
              num_samples=4)  # the reference's configuration; 2 of its 6 iterations
LARGEN_TIMING_N = 8192
BANDIT_ITERATIONS = 3
HPO_GRID = ((0.5, 0.95), (1.0, 2.0))  # alphas, betas
ABLATION_GRID = ((1, 2), (2, 5))  # chains, samples; one run
PRIOR_STEPS, PRIOR_CHAINS = 1000, 64
SCALING_RANKS, SCALING_STEPS = (1, 2), 10


class _Recorded:
    """A kernel wrapper that reports each call first; its ``launches`` is the
    wrapped function's, which the wrapper's module increments by name."""

    def __init__(self, fn, keep):
        self.fn, self.keep = fn, keep

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value

    def __call__(self, *args, **kwargs):
        self.keep(*args, **kwargs)
        return self.fn(*args, **kwargs)


class KernelRecorder:
    """While active, counts each kernel's launches by shape and keeps the
    arguments of the first launch at each shape (``gram_cuda`` and
    ``chol_inv_cuda`` wrapped in their modules, where every caller looks
    them up). The launch counts go on as without it."""

    def __init__(self):
        from bark_tpu_torch.ops import chol as chol_module
        from bark_tpu_torch.ops import gram as gram_module

        self.modules = (gram_module, chol_module)
        self.shapes = {"gram": {}, "chol_inv": {}}  # shape -> launches
        self.args = {"gram": {}, "chol_inv": {}}  # shape -> first arguments

    def __enter__(self):
        gram_module, chol_module = self.modules
        self.originals = gram_module.gram_cuda, chol_module.chol_inv_cuda

        def gram(l1, l2, mask1=None, mask2=None, node_limit=64):
            sym = gram_module.is_symmetric_call(l1, l2, mask1, mask2)
            key = (*l1.shape[:2], l2.shape[1], "sym" if sym else "")
            self._keep("gram", key, lambda: (l1.clone(), None if sym else l2.clone(),
                                             mask1, mask2, node_limit))

        def chol(a):
            self._keep("chol_inv", tuple(a.shape), a.clone)

        gram_module.gram_cuda = _Recorded(self.originals[0], gram)
        chol_module.chol_inv_cuda = _Recorded(self.originals[1], chol)
        return self

    def _keep(self, kernel, key, args):
        self.shapes[kernel][key] = self.shapes[kernel].get(key, 0) + 1
        if key not in self.args[kernel]:
            self.args[kernel][key] = args()

    def __exit__(self, *exc):
        gram_module, chol_module = self.modules
        gram_module.gram_cuda, chol_module.chol_inv_cuda = self.originals

    def counts(self) -> dict:
        return {k: sum(v.values()) for k, v in self.shapes.items()}


def hold_recorded(torch, dev, smi, path, rec, times, held):
    """Each shape a :class:`KernelRecorder` kept, its first launch against the
    plain version on the same input (K1 exact; K2 |L - L_plain| / max
    |L_plain| <= 5e-4 and |E L - I| <= 5e-4); each kernel's most launched
    shape on the path timed into ``times`` unless ``held`` has it. These
    launches come after the path's counts were read."""
    from bark_tpu_torch.benchmarks.kernel_timing import time_k1, time_k2
    from bark_tpu_torch.ops import gram as gram_module
    from bark_tpu_torch.ops.chol import chol_inv_cuda, chol_inv_plain
    from bark_tpu_torch.ops.gram import gram_plain

    top = {k: max(v, key=v.get) for k, v in rec.shapes.items() if v}
    for key, (l1, l2, m1, m2, nl) in rec.args["gram"].items():
        l2 = l1 if l2 is None else l2
        m2 = m1 if key[-1] == "sym" else m2
        got = gram_module.gram_cuda(l1, l2, m1, m2, nl)
        require(torch.equal(got, gram_plain(l1, l2, m1, m2)),
                f"K1 {key} of {path} equals its plain version")
        name = f"({key[0]},{key[1]},{key[2]}){' sym' if key[-1] else ''} {path}"
        if key == top.get("gram") and ("gram", key) not in held:
            held.add(("gram", key))
            t = time_k1(torch, gram_module, l1, l2, m1, m2, nl)
            times[("gram", name)] = t
            log(f"[K1] {name}: exact; device {t['device_ms']} ms ({t['device_source']}), "
                f"call {t['call_ms']:.5f}, plain {t['plain_ms']:.5f}; bf16 one-hot bmm "
                f"{t['library_ms']} ms device; bound {t['bound_ms']:.5f} ms "
                f"({t['bound_by']}), {100 * t['share_of_bound']:.1f}% of it, on {smi}")
        else:
            log(f"[K1] {name}: exact")
    for key, a in rec.args["chol_inv"].items():
        L, E = chol_inv_cuda(a)
        Lp, _ = chol_inv_plain(a)
        err = rel_err(torch, L, Lp)
        resid = (E @ L - torch.eye(key[-1], device=dev)).abs().max().item()
        name = f"({key[0]},{key[1]},{key[2]}) {path}"
        require(err <= REL_BOUND and resid <= 5e-4,
                f"K2 {name}: |L - L_plain| / max |L_plain| = {err}, |E L - I| = {resid}")
        if key == top.get("chol_inv") and ("chol_inv", key) not in held:
            held.add(("chol_inv", key))
            t = time_k2(torch, lambda: chol_inv_cuda(a), lambda: chol_inv_plain(a), key[0],
                        key[1], "chol_inv_kernel")
            times[("chol_inv", name)] = t
            log(f"[K2] {name}: |L-L_plain|/max|L| {err:.3e}, |EL-I| {resid:.3e}; device "
                f"{t['device_ms']:.5f} ms ({t['device_source']}), call "
                f"{t['call_ms']:.5f}, plain {t['plain_ms']:.5f} call / {t['library_ms']} "
                f"device (cuSOLVER); bound {t['bound_ms']:.5f} ms ({t['bound_by']}), "
                f"{100 * t['share_of_bound']:.1f}% of it, on {smi}")
        else:
            log(f"[K2] {name}: |L-L_plain|/max|L| {err:.3e}, |EL-I| {resid:.3e}")


def phase_entry_points(torch, dev, smi, tf):
    """Phase 14: the forest Gram API and the drivers of ``benchmarks/`` that
    twin the reference's last scripts, on the card. Returns the launches of
    each path and the kernels' times at the paths' new shapes."""
    import importlib.util
    import tempfile
    from pathlib import Path

    from bark_tpu_torch.benchmarks import (
        bandit_bo, bo_largen, largen_timing, mcmc_record, plot_bo_runs, priors_and_proposals,
        regression_hpo, samples_ablation, scaling, tempered_smc,
    )
    from bark_tpu_torch.benchmarks.study import EXAMPLE_CONFIGS
    from bark_tpu_torch.fitting.prior import draw_prior, sample_forest_prior
    from bark_tpu_torch.forest import (
        Forest, batched_forest_gram_matrix, batched_forest_gram_matrix_no_null,
        forest_gram_matrix, num_null_trees, route_forest,
    )
    from bark_tpu_torch.models import surrogate as surrogate_module
    from bark_tpu_torch.ops.chol import chol_inv_cuda
    from bark_tpu_torch.ops.gram import gram_cuda, gram_plain
    from bark_tpu_torch.optimizer import search
    from bark_tpu_torch.optimizer.acquisition import LR_THRESHOLD
    from bark_tpu_torch.strategies import tree_kernel

    t_phase = time.perf_counter()
    launches, times, held = {}, {}, set()
    tmp = tempfile.TemporaryDirectory()
    out_dir = Path(tmp.name)

    def drive(path, fn, *args, **kwargs):
        """Run one path with the counts set to 0 just before and read just
        after; returns its result and its recorder."""
        gram_cuda.launches = chol_inv_cuda.launches = 0
        t0 = time.perf_counter()
        with KernelRecorder() as rec:
            result = fn(*args, **kwargs)
        torch.cuda.synchronize()
        counts = {"gram": gram_cuda.launches, "chol_inv": chol_inv_cuda.launches}
        require(counts == rec.counts(), f"{path}: recorded launches {rec.counts()} == {counts}")
        launches[path] = counts
        log(f"[phase 14] {path}: {time.perf_counter() - t0:.2f} s; launches {counts}; "
            f"shapes K1 {rec.shapes['gram']} K2 {rec.shapes['chol_inv']}")
        return result, rec

    def hold(path, rec):
        hold_recorded(torch, dev, smi, path, rec, times, held)

    # --- (a) the forest Gram API ------------------------------------------------------
    ft = torch.as_tensor(tf.domain.feature_types(), device=dev)
    bounds = torch.as_tensor(tf.domain.bounds("bitmask"), device=dev)
    gen = torch.Generator(device=dev).manual_seed(14)
    forests = sample_forest_prior(draw_prior(gen, GRAM_API_FORESTS, SLICE_TREES, device=dev),
                                  SLICE_TREES, bounds, ft)
    rng = np.random.default_rng(14)
    x1, x2 = (torch.as_tensor(tf.domain.sample(n, rng), device=dev) for n in GRAM_API_ROWS)
    one = Forest(*(t[0] for t in forests))

    def gram_api():
        return (forest_gram_matrix(one, x1, x2, ft),
                batched_forest_gram_matrix(forests, x1, x2, ft),
                batched_forest_gram_matrix_no_null(forests, x1, x2, ft))

    (g_one, batched, no_null), rec = drive("forest gram api", gram_api)
    require(launches["forest gram api"] == {"gram": 3, "chol_inv": 0},
            f"the Gram API launches K1 once a call: {launches['forest gram api']}")
    l1, l2 = route_forest(forests, x1, ft), route_forest(forests, x2, ft)
    plain = gram_plain(l1, l2)
    m = SLICE_TREES
    n_null = num_null_trees(forests).to(plain.dtype)[..., None, None]
    require(torch.equal(batched, plain) and torch.equal(g_one, plain[0]),
            "forest_gram_matrix and the batched form equal the plain Gram")
    require(torch.equal(no_null, (plain - n_null / m) * (m / torch.clamp_min(m - n_null, 1.0))),
            "the no-null form equals the plain Gram rescaled")
    hold("forest gram api", rec)

    # --- (b) bo_largen at full width ----------------------------------------------------
    built = []
    build, lr_builds = bo_largen.build, []
    predict_leaf = surrogate_module.forest_predict_leaf
    build_lr = tree_kernel.build_acquisition_lr

    # the ask split into the factored build, the scored batches and the
    # centring, each clocked between device synchronisations (as phase 8 b)
    parts, asks = {}, []

    def clocked(part, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            parts[part] = parts.get(part, 0.0) + time.perf_counter() - t0
            return out
        return run

    def counting_build(*args, **kwargs):
        built.append(build(*args, **kwargs))
        strat = built[-1][1]
        ask = strat.ask

        def split_ask(*a, **k):
            parts.clear()
            out = ask(*a, **k)
            asks.append(dict(parts))
            return out

        strat.ask = split_ask
        return built[-1]

    def counting_lr(*args, **kwargs):
        lr_builds.append(args[1].shape[0])
        return build_lr(*args, **kwargs)

    bo_path = f"bo_largen N={LARGEN['n_init']}"
    patched = [(bo_largen, "build", counting_build),
               (tree_kernel, "build_acquisition_lr", clocked("build", counting_lr)),
               (search, "evaluate_acquisition", clocked("score", search.evaluate_acquisition)),
               (search, "_leaf_box", clocked("centre", search._leaf_box)),
               (search, "_box_center", clocked("centre", search._box_center))]
    originals = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
    try:
        for mod, name, fn in patched:
            setattr(mod, name, fn)
        res, rec = drive(bo_path, bo_largen.run_study, device=dev, **LARGEN)
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    bench, strat = built[0]
    its = res["iterations"]
    bests = [r["best_y"] for r in its]
    require(len(its) == LARGEN["num_iter"] and all(np.isfinite(bests))
            and all(b1 <= b0 for b0, b1 in zip(bests, bests[1:])),
            f"bo_largen: a finite, non-increasing incumbent {bests}")
    require(all(np.isfinite(v) for r in its for v in r["fit_diagnostics"].values()),
            f"bo_largen: finite fit_diagnostics {[r['fit_diagnostics'] for r in its]}")
    require(strat.fallbacks == 0, "bo_largen: no ask fell back to a random candidate")
    n_pad = strat.surrogate.train_data[0].shape[0]
    require(len(lr_builds) >= LARGEN["num_iter"] and min(lr_builds) > LR_THRESHOLD,
            f"bo_largen: every ask took the factored acquisition at padded N={lr_builds}")
    counts = launches[bo_path]
    require(counts["gram"] == 0 and counts["chol_inv"] > 0,
            f"bo_largen: the leaf tier and the factored build launch K2, never K1 {counts}")
    calls = []

    def counting_predict_leaf(*args, **kwargs):
        calls.append(args[3].shape[0])
        return predict_leaf(*args, **kwargs)

    surrogate_module.forest_predict_leaf = counting_predict_leaf
    try:
        probe = bench.domain.sample(256, np.random.default_rng(1))
        mu, sd = strat.surrogate.predict(probe)
    finally:
        surrogate_module.forest_predict_leaf = predict_leaf
    require(calls == [n_pad] and n_pad > strat.surrogate.cg_threshold
            and bool(np.isfinite(mu).all() and np.isfinite(sd).all() and (sd > 0).all()),
            f"bo_largen: predict at padded N={n_pad} took the leaf-space posterior {calls}")
    log(f"[phase 14 b] bo_largen N={LARGEN['n_init']}, {LARGEN['num_candidates']} candidates, "
        f"{LARGEN['num_chains']} x {LARGEN['num_samples']}, m=50, seed {LARGEN['seed']}: "
        f"initial fit {res['initial_fit_s']} s; ask/fit s "
        f"{[(r['ask_s'], r['fit_s']) for r in its]}; best {bests} (probe min "
        f"{res['f_star_probe_200k']:.4f}); fit_diagnostics {its[-1]['fit_diagnostics']}; "
        f"backends: acquisition factored (build_acquisition_lr x {len(lr_builds)}, padded N "
        f"{lr_builds} > {LR_THRESHOLD}), predict leaf at padded N={n_pad} > "
        f"{strat.surrogate.cg_threshold}; K2 launches by shape {rec.shapes['chol_inv']} on {smi}")
    for i, (r, split) in enumerate(zip(its, asks)):
        log(f"[phase 14 b] iteration {i}: fit {r['fit_s']} s + ask {r['ask_s']} s (build "
            f"{split.get('build', 0.0):.4f}, score {split.get('score', 0.0):.4f}, centring "
            f"{split.get('centre', 0.0):.4f}; between synchronisations)")
    hold(bo_path, rec)

    # --- (c) largen_timing at N=8192 --------------------------------------------------
    ask, rec = drive(f"largen ask lowrank N={LARGEN_TIMING_N}", largen_timing.time_ask,
                     LARGEN_TIMING_N, "lowrank", device=dev)
    require(ask["in_domain"] and np.isfinite(ask["acq_value"]) and rec.counts()["chol_inv"] > 0,
            f"largen ask: in the domain, a finite value, K2 launched {ask}")
    hold(f"largen ask lowrank N={LARGEN_TIMING_N}", rec)
    rows, rec = drive(f"largen predict N={LARGEN_TIMING_N}", largen_timing.time_predict,
                      [LARGEN_TIMING_N], dev)
    require([r["backend"] for r in rows] == ["cg", "leaf"] and rec.counts()["chol_inv"] > 0,
            f"largen predict at N={LARGEN_TIMING_N}: cg and leaf (dense skipped) {rows}")
    log(f"[phase 14 c] ask at N={LARGEN_TIMING_N} (lowrank, S=16): {ask}; predict {rows} "
        f"on {smi}")
    hold(f"largen predict N={LARGEN_TIMING_N}", rec)

    # --- (d) mcmc_record at its configuration ---------------------------------------------
    summary, rec = drive("mcmc_record N=50", mcmc_record.run_record, 0,
                         EXAMPLE_CONFIGS["mcmc_benchmark"], EXAMPLE_CONFIGS["mcmc_model"],
                         out_dir / "mcmc", dev)
    mlls = np.load(out_dir / "mcmc" / "mlls.npy")
    p = EXAMPLE_CONFIGS["mcmc_model"]["model_params"]
    require(mlls.shape == (p["num_chains"], p["num_samples"]) and np.isfinite(mlls).all()
            and np.isfinite(summary["r_hat"]),
            f"mcmc_record: finite mlls of shape (4, 500) and an R-hat {mlls.shape} {summary}")
    require((4, 50, 50, "sym") in rec.shapes["gram"] and (8, 50, 50) in rec.shapes["chol_inv"],
            f"mcmc_record: K1 at (4,50,50) and K2 at (8,50,50) {rec.shapes}")
    log(f"[phase 14 d] mcmc_record 4 chains x 500 steps, N=50: summary {summary}")
    hold("mcmc_record N=50", rec)

    # --- (e) tempered_smc, single-process and sharded on one NCCL rank ----------------------
    single, rec = drive("tempered_smc single", tempered_smc.run_single, 0, device=dev)
    require(0.0 < single["pt"]["swap_rate"] < 1.0 and single["smc"]["final_beta"] == 1.0
            and np.isfinite(single["smc"]["log_evidence"]),
            f"tempered_smc: a swap rate in (0, 1), SMC reaching beta 1 {single}")
    hold("tempered_smc single", rec)
    t0 = time.perf_counter()
    sharded = tempered_smc.run_sharded(0, 1, device=dev)
    rank0 = sharded.pop("ranks")[0]
    rank_launches = rank0.pop("launches")
    launches["tempered_smc sharded, 1 NCCL rank"] = rank_launches
    twin = tempered_smc.sharded_twin(0, 1, device=dev)
    traces = twin.pop("traces")
    for k, v in traces.items():
        require(torch.equal(rank0[k], v.cpu()), f"sharded PT: rank 0's {k} trace equals "
                f"single_process_pt's")
    for part, rtol, atol in (("pt", 1e-12, 0.0), ("smc", 1e-5, 1e-6)):
        for k, v in twin[part].items():
            require(abs(sharded[part][k] - v) <= rtol * abs(v) + atol,
                    f"sharded {part} {k} {sharded[part][k]} equals the single process's {v}")
    require(rank_launches["gram"] > 0 and rank_launches["chol_inv"] > 0,
            f"the NCCL rank launched both kernels {rank_launches}")
    log(f"[phase 14 e] tempered_smc single {single}; sharded on one NCCL rank {sharded} "
        f"({time.perf_counter() - t0:.1f} s with its twin; rank launches {rank_launches})")

    # --- (f) the small drivers --------------------------------------------------------------
    rows, rec = drive("bandit_bo", bandit_bo.run_bandit, 0, BANDIT_ITERATIONS,
                      out_dir / "bandit", device=dev)
    require(len(rows) == BANDIT_ITERATIONS
            and (out_dir / "bandit" / "bandit_seed=0.csv").exists()
            and all(b1["best"] <= b0["best"] for b0, b1 in zip(rows, rows[1:])),
            f"bandit: {BANDIT_ITERATIONS} rows, the best never rising {rows}")
    hold("bandit_bo", rec)
    bench_cfg = EXAMPLE_CONFIGS["regression_treefunction"]
    grid, rec = drive("regression_hpo", regression_hpo.run_hpo, 0, bench_cfg, *HPO_GRID,
                      out_dir / "hpo", device=dev)
    require(grid.shape == (2, 2) and np.isfinite(grid).all(), f"hpo grid {grid}")
    hold("regression_hpo", rec)
    grid_ab, rec = drive("samples_ablation", samples_ablation.run_ablation, 0, bench_cfg,
                         out_dir / "ablation", *ABLATION_GRID, 1, device=dev)
    require(grid_ab.shape == (2, 2) and np.isfinite(grid_ab).all(), f"ablation grid {grid_ab}")
    hold("samples_ablation", rec)
    log(f"[phase 14 f] bandit {rows}; hpo NLPD {grid.tolist()}; ablation NLPD "
        f"{grid_ab.tolist()}")
    (prior, _), rec = drive("priors_and_proposals", priors_and_proposals.run_study,
                            PRIOR_STEPS, PRIOR_CHAINS, device=dev)
    require(abs(prior["proposal_lognormal"]["proposal_log_std"] - 1.0) < 0.1
            and prior["reference_ratio_for_contrast"]["noise_prior_quantiles_empirical"][2]
            < 0.7 * prior["noise_prior_quantiles_analytic"][2],
            f"priors: a lognormal walk, the reference ratio's halved tail {prior}")
    log(f"[phase 14 f] priors and proposals, {PRIOR_STEPS} steps x {PRIOR_CHAINS} chains: "
        f"{prior}")
    payload = scaling.run_scaling(SCALING_RANKS, num_steps=SCALING_STEPS, device=dev)
    require(payload["dry_run"] and all(r["steps_per_s"] > 0
                                       for r in payload["weak_scaling"]["results"]),
            f"scaling: a dry run with positive rates {payload}")
    for n, c in payload["launches_per_rank"].items():
        launches[f"scaling, {n} rank(s), rank 0"] = c
        require(c["gram"] > 0 and c["chol_inv"] > 0, f"scaling rank 0 of {n}: both kernels {c}")
    log(f"[phase 14 f] scaling (dry run: the ranks share this card) {payload}")
    runs = plot_bo_runs.load_runs(Path(__file__).resolve().parent / "results" / "regret_r2")
    summary_runs = plot_bo_runs.summarize(runs)
    require(summary_runs["PestControl/BARK"]["seeds"] == 5
            and summary_runs["TreeFunction/BARK"]["final_best_mean"]
            < summary_runs["TreeFunction/Random"]["final_best_mean"],
            f"plot_bo_runs summary over results/regret_r2 {summary_runs}")
    if importlib.util.find_spec("matplotlib") is None:
        try:
            plot_bo_runs.plot(runs, out_dir / "bo_runs.png")
        except RuntimeError as e:
            require("matplotlib" in str(e), f"the figure's error names matplotlib: {e}")
            log(f"[phase 14 f] plot_bo_runs: no matplotlib here; the figure raises: {e}")
        else:
            raise RuntimeError("check failed: a figure was drawn without matplotlib")
    else:
        plot_bo_runs.plot(runs, out_dir / "bo_runs.png")
        require((out_dir / "bo_runs.png").exists(), "plot_bo_runs drew its figure")
    log(f"[phase 14 f] plot_bo_runs summary {summary_runs}")
    tmp.cleanup()
    log(f"[phase 14] {time.perf_counter() - t_phase:.1f} s")
    return launches, times


# --- phase 15: the headline benchmark's twin -------------------------------------
BENCH_DEFAULT_RUNS = 1  # the default mode (N=50); three in a row before the cut in CUTS
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline")  # root bench.py's line


class _TimedWindow:
    """Wraps the twin's ``run_bark_sampler`` for one ``measure``: sets the
    kernels' counts to 0 just before the third call, the first timed one,
    so that after ``measure`` they hold the timed window's launches; keeps
    the arguments of the last call."""

    def __init__(self, fn, kernels):
        self.fn, self.kernels, self.calls, self.last = fn, kernels, 0, None

    def __call__(self, *args):
        if self.calls == 2:
            for k in self.kernels:
                k.launches = 0
        self.calls += 1
        self.last = args
        return self.fn(*args)


def phase_bench(torch, dev, smi):
    """Phase 15: ``bark_tpu_torch/benchmarks/bench.py``, the twin of the root
    ``bench.py``, at the reference's protocol on the points the slices of
    phases 5-6 leave out. Returns the launches of each timed window and the
    kernels' times at its shapes."""
    import collections
    import contextlib
    import io
    import math
    import warnings
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    from bark_tpu_torch.benchmarks import bench
    from bark_tpu_torch.ops.chol import chol_inv_cuda
    from bark_tpu_torch.ops.gram import gram_cuda

    t_phase = time.perf_counter()
    launches, times, held, shapes = {}, {}, set(), {}
    tpu = {(r["n_train"], r["cat_dim"]): r["value"] for r in json.loads(
        (Path(__file__).resolve().parent / "BENCH_CURVE_r05.json").read_text())}

    def drive(path, fn):
        """One ``measure`` through ``fn``; the launches of its timed window,
        the first input of each kernel shape held against the plain version."""
        window = _TimedWindow(bench.run_bark_sampler, (gram_cuda, chol_inv_cuda))
        gram_cuda.launches = chol_inv_cuda.launches = 0
        bench.run_bark_sampler = window
        try:
            with KernelRecorder() as rec:
                res = fn()
        finally:
            bench.run_bark_sampler = window.fn
        counts = {"gram": gram_cuda.launches, "chol_inv": chol_inv_cuda.launches}
        require(window.calls == 7, f"{path}: 2 untimed and 5 timed sampler calls ({window.calls})")
        value = res["value"]
        require(all(isinstance(res[k], (int, float)) and math.isfinite(res[k]) and res[k] > 0
                    for k in ("value", "vs_baseline")), f"{path}: finite positive values {res}")
        require(res["metric"] == "forest_mcmc_steps_per_s_per_chip"
                and res["unit"] == "steps/s/chip", f"{path}: the reference's names {res}")
        n, cat = (int(path.split("N=")[1].split()[0]), 2 if path.endswith("cat") else 0)
        log(f"[phase 15] {path}: {json.dumps(res)} | launches in the timed window {counts} | "
            f"the TPU's value (BENCH_CURVE_r05.json, not this card's) "
            f"{tpu[(n, cat)]} steps/s/chip | {value} steps/s/chip on {smi}")
        if path in launches:
            require(counts == launches[path], f"{path}: the same launches each run "
                                              f"({counts} vs {launches[path]})")
        launches[path] = counts
        shapes[path] = {k: set(v) for k, v in rec.shapes.items()}
        hold_recorded(torch, dev, smi, path, rec, times, held)
        return res, window

    def busy(path, window, res):
        """The card's busy share at ``path``: the device kernels' summed
        duration in one more call on the warm model under torch.profiler,
        over the timed window's mean call (uninstrumented); then, in another
        call under CUDA's sync debug mode, the host's synchronisations."""
        _, model, *rest = window.last

        def call(seed):
            window.fn(torch.Generator(device=dev).manual_seed(seed), model, *rest)
            torch.cuda.synchronize()

        for attempt in range(1, 4):  # the profiler at times captures no kernel
            torch.cuda.synchronize()
            # the device's activity only: a call is ~3,300 kernels a step, and
            # the host's op events would cost minutes to summarise
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                call(15)
                wall_ms = 1e3 * (time.perf_counter() - t0)
            # the raw events: key_averages() over ~170,000 kernels takes a
            # minute; kernels only, not the copies and fills
            durations = [e.duration_ns() for e in prof.profiler.kineto_results.events()
                         if "CUDA" in str(e.device_type())
                         and not e.name().startswith(("Memcpy", "Memset"))]
            if durations:
                break
        require(bool(durations), f"{path}: the profiler captured the call's kernels")
        kernel_ms = sum(durations) / 1e6
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                call(16)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = collections.Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                                    if "called a synchronizing" in str(w.message))
        params, chains = rest[-1], model.noise.shape[0]
        timed_ms = 1e3 * chains * params.num_samples * params.steps_per_sample / res["value"]
        log(f"[phase 15] {path}: {len(durations)} device kernels, {kernel_ms:.1f} ms, in one "
            f"call under torch.profiler (attempt {attempt}, {wall_ms:.1f} ms of wall time); "
            f"over the timed window's mean call, {timed_ms:.1f} ms: busy "
            f"{100 * kernel_ms / timed_ms:.1f}% on {smi}; host synchronisations inside "
            f"another call (sync debug mode): {sum(syncs.values())} at {dict(syncs)}")

    # the default mode: one line with exactly the reference's four keys
    def default_mode():
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            bench.main([])
        lines = out.getvalue().splitlines()
        require(len(lines) == 1 and tuple(json.loads(lines[0])) == BENCH_KEYS,
                f"the default mode prints one line with exactly {BENCH_KEYS}: {lines}")
        return json.loads(lines[0])

    rates = []
    for _ in range(BENCH_DEFAULT_RUNS):
        res, window = drive("bench N=50", default_mode)
        rates.append(res["value"])
    log(f"[phase 15] default mode (N=50) x {BENCH_DEFAULT_RUNS} in a row: {rates}; median "
        f"{statistics.median(rates)}, spread {min(rates)}-{max(rates)} steps/s/chip on {smi}")
    busy("bench N=50", window, res)

    drive("bench N=50 cat", lambda: bench.measure(n_train=50, cat_dim=2))
    require(launches["bench N=50 cat"] == launches["bench N=50"]
            and shapes["bench N=50 cat"] == shapes["bench N=50"],
            f"the categorical run launches K1 and K2 as the continuous one: "
            f"{launches['bench N=50 cat']} {shapes['bench N=50 cat']} vs "
            f"{launches['bench N=50']} {shapes['bench N=50']}")
    require(launches["bench N=50"]["gram"] == launches["bench N=50"]["chol_inv"] == 5 * 51,
            f"N=50: one K1 and one K2 launch per init and step in the timed window "
            f"{launches['bench N=50']}")

    res, window = drive("bench N=512", lambda: bench.measure(n_train=512))
    require(launches["bench N=512"] == {"gram": 0, "chol_inv": 5 * 51},
            f"N=512, leaf tier at R=256: K2 once per init and step, K1 never "
            f"{launches['bench N=512']}")
    busy("bench N=512", window, res)
    log(f"[phase 15] {time.perf_counter() - t_phase:.1f} s")
    return launches, times


# --- phase 16: the sampler's lowerings ---------------------------------------------
LOWERING_STEPS, LOWERING_FREE_STEPS, LOWERING_WARM = 5, 50, 20
# name -> SamplerParams overrides. At N=50 every configuration of the
# reference's test_hot_styles_agree_on_trajectory and
# test_backends_agree_on_trajectory (the default, auto/rank1, is the base)
# whose port lowering differs (doubling_fused resolves to doubling; the port
# does not read gram_dtype, so coeff_factor_bf16 is coeff_factor), with the
# carry and the explicit pair refresh; at N=512 the dense-carry lowerings a
# user pins there (scan auto is lowrank at 256-1023 under a dense refresh).
PROPOSAL_SIDE = {"scatter": dict(hot_style="scatter"), "select": dict(hot_style="select"),
                 "doubling": dict(hot_style="doubling"), "carry": dict(subspace_mode="carry")}
KERNEL_SIDE_50 = {
    "select_fused": dict(hot_style="select", refresh_style="batched"),
    "aug": dict(scan_style="aug"), "lowrank": dict(scan_style="lowrank"),
    "coeff": dict(scan_style="coeff"), "factor": dict(scan_style="coeff", refresh_style="factor"),
    "leaf": dict(scan_style="coeff", refresh_style="leaf"), "pair": dict(refresh_style="pair"),
    "chol": dict(kernel_backend="chol"), "woodbury": dict(kernel_backend="woodbury"),
}
KERNEL_SIDE_512 = {
    "lowrank": dict(scan_style="lowrank"),
    "coeff": dict(scan_style="coeff", refresh_style="onesolve"),
    "factor": dict(refresh_style="factor"), "pair": dict(refresh_style="pair"),
    "batched": dict(refresh_style="batched"),
}
MLL_RTOL, MLL_ATOL = 1e-4, 1e-3  # the repo's maintained-vs-rebuilt MLL tolerance
RATE_DEADLINE_S = 1080  # phase 16's rates end before this second of the script
DECISION_SHARE = 0.99


def _expected_launches(params, n, steps):
    """K1 and K2 launches of an init and ``steps`` steps of a lowering at
    padded N=n (K2 in 256-blocks above 256; m + 1 factorizations a chol
    step; 2m capacitance factorizations and a rebuild a woodbury step)."""
    blocks = -(-n // 256)
    m = params.num_trees
    if params.kernel_backend == "chol":
        return {"gram": 1, "chol_inv": blocks * (1 + steps * (m + 1))}
    if params.kernel_backend == "woodbury":
        return {"gram": 1 + steps, "chol_inv": blocks * (1 + steps) + steps * 2 * m}
    if params.refresh_style == "leaf":
        return {"gram": 0, "chol_inv": 1 + steps}  # R <= 256 here
    per_step = 2 if params.refresh_style == "pair" else 1
    return {"gram": 1 + steps, "chol_inv": blocks * (1 + per_step * steps)}


def phase_lowerings(torch, dev, smi, tf):
    """Phase 16: every lowering of the sampler on the card, at the width of
    ``bench.py``'s twin (dim 5, m=50, 64 chains, node_limit 64), at N=50 and
    at 512. Returns the launches of each path and the kernels' times at the
    paths' new shapes."""
    import collections
    import warnings
    from pathlib import Path

    from bark_tpu_torch.benchmarks import bench
    from bark_tpu_torch.fitting.params import SamplerParams
    from bark_tpu_torch.fitting.sampler import (
        BARKModel, _leaf_budget, _leaf_Z, _resolve_styles, draw_step, init_chain_state,
        run_chain, step_with_info,
    )
    from bark_tpu_torch.fitting.traversal import all_node_subspaces
    from bark_tpu_torch.forest import create_empty_forest, route_forest
    from bark_tpu_torch.ops.chol import chol_inv_cuda
    from bark_tpu_torch.ops.gram import gram_cuda, gram_plain
    from bark_tpu_torch.ops.linalg import JITTER

    t_phase = time.perf_counter()
    launches, times, held, table = {}, {}, set(), []
    rows, defaults = {}, {}
    ft = torch.as_tensor(tf.domain.feature_types(), device=dev)
    bounds = torch.as_tensor(tf.domain.bounds("bitmask"), device=dev)

    def rebuild_check(tag, st, params, X, y):
        """(b): the carry after the free run against a float64 rebuild from
        a fresh routing, as phases 5-6 and 10 check theirs."""
        n = X.shape[0]
        fresh = route_forest(st.forest, X, ft)
        require(torch.equal(fresh, st.leaves), f"{tag}: leaves equal a fresh routing")
        nu, scale = (JITTER + st.noise).double(), st.scale.double()
        gram = gram_plain(fresh, fresh).double()
        K = scale[:, None, None] * gram + torch.diag_embed(nu[:, None].expand(-1, n))
        L64 = torch.linalg.cholesky(K)
        logdet = 2.0 * torch.log(torch.diagonal(L64, dim1=-2, dim2=-1)).sum(-1)
        kern, what = st.kern, {}
        if kern.K is not None:
            err = (kern.K.double() - K).abs()
            require(bool((err <= 1e-5 + 1e-5 * K.abs()).all()),
                    f"{tag}: K within 1e-5 (abs and rel) of the rebuild ({err.max().item()})")
            what["K"] = err.max().item()
        elif kern.K_inv is not None:
            K_inv = torch.cholesky_inverse(L64)
            err = (kern.K_inv.double() - K_inv).abs()
            ok = bool((err <= 2e-3 + 1e-3 * K_inv.abs()).all())
            require(ok, f"{tag}: K^-1 within rtol 1e-3 / atol 2e-3 of the rebuild "
                        f"(max |diff| {err.max().item()})")
            what["K_inv"] = err.max().item()
        elif params.refresh_style == "leaf":
            budget = _leaf_budget(params, n)
            Z, _ = _leaf_Z(st.forest, fresh, budget, torch.ones(n, device=dev))
            gamma = scale / params.num_trees
            A = (Z.transpose(1, 2) @ Z).double() + (nu / gamma)[:, None, None] * torch.eye(
                budget, dtype=torch.float64, device=dev)
            La = torch.linalg.cholesky(A)
            what["L"] = rel_err(torch, kern.L.double(), La)
            require(what["L"] <= REL_BOUND, f"{tag}: |L - rebuild|/max|L| = {what['L']}")
        else:  # the factor refresh: L of K
            what["L"] = rel_err(torch, kern.L.double(), L64)
            require(what["L"] <= REL_BOUND, f"{tag}: |L - rebuild|/max|L| = {what['L']}")
        if kern.K_logdet is not None:
            d = (kern.K_logdet.double() - logdet).abs()
            require(bool((d <= 1e-3 + 1e-4 * logdet.abs()).all()),
                    f"{tag}: logdet within rtol 1e-4 / atol 1e-3 ({d.max().item()})")
            what["logdet"] = d.max().item()
        if st.subspaces is not None:
            want = all_node_subspaces(st.forest, bounds, ft, params.max_depth)
            act = st.forest.active
            require(torch.equal(st.subspaces[act], want[act]),
                    f"{tag}: carried subspaces equal a fresh walk on every active node")
            what["subspaces"] = "exact"
        return what

    def syncs_per_step(st, params, X, y):
        """Host synchronisations of one step (CUDA's sync debug mode)."""
        draws = draw_step(torch.Generator(device=dev).manual_seed(99), st.noise.shape[0],
                          params, dev)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                step_with_info(st, X, y, bounds, ft, params, draws)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return collections.Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                                   if "called a synchronizing" in str(w.message))

    for n in (50, 512):
        X_np = tf.domain.sample(n, np.random.default_rng(0))
        y_np = tf.f(X_np)
        X = torch.as_tensor(X_np, device=dev)
        y = torch.as_tensor((y_np - y_np.mean()) / y_np.std(), dtype=torch.float32, device=dev)
        base = SamplerParams(num_chains=SLICE_CHAINS, num_trees=SLICE_TREES)
        # the shared state: the default lowering, LOWERING_WARM steps from empty forests
        empty = BARKModel(
            create_empty_forest(SLICE_TREES, base.node_limit, (SLICE_CHAINS,), dev),
            torch.full((SLICE_CHAINS,), 0.1, device=dev), torch.ones(SLICE_CHAINS, device=dev))
        warm = run_chain(torch.Generator(device=dev).manual_seed(n), empty, X, y, bounds, ft,
                         base.with_(warmup_steps=LOWERING_WARM - 1, num_samples=1,
                                    steps_per_sample=1)).state
        shared = (warm.forest, warm.noise, warm.scale)
        gen = torch.Generator(device=dev).manual_seed(1000 + n)
        draws = [draw_step(gen, SLICE_CHAINS, base, dev) for _ in range(LOWERING_FREE_STEPS)]
        # the default's own trajectory over the compared steps
        default = [init_chain_state(*shared, X, y, ft, base, bounds=bounds)]
        infos = []
        for t in range(LOWERING_STEPS):
            st, info = step_with_info(default[-1], X, y, bounds, ft, base, draws[t])
            default.append(st)
            infos.append(info)
        resolved = _resolve_styles(base, n)
        defaults[n] = f"default ({resolved.scan_style}, {resolved.refresh_style})"

        configs = ({**PROPOSAL_SIDE, **KERNEL_SIDE_50} if n == 50 else KERNEL_SIDE_512)
        for name, overrides in configs.items():
            t0 = time.perf_counter()
            params = base.with_(**overrides)
            r = _resolve_styles(params, n)
            path = f"lowering {name} N={n}"
            # (a) the first LOWERING_STEPS steps against the default
            if name in PROPOSAL_SIDE:
                st = init_chain_state(*shared, X, y, ft, params, bounds=bounds)
                for t in range(LOWERING_STEPS):
                    st, info = step_with_info(st, X, y, bounds, ft, params, draws[t])
                    want = default[t + 1]
                    same = (all(torch.equal(a, b) for a, b in zip(st.forest, want.forest))
                            and torch.equal(st.leaves, want.leaves)
                            and torch.equal(info.tree_accepts, infos[t].tree_accepts)
                            and torch.equal(info.hyper_accept, infos[t].hyper_accept))
                    require(same, f"{path} step {t}: forests, leaves and accepts bit-identical "
                                  f"to the default")
                agree = f"bit-identical over {LOWERING_STEPS} steps, |mll - default| " \
                        f"{(st.mll - want.mll).abs().max().item():.3e}"
            else:
                # every step from the default's state (this lowering's carry
                # built from it), so each decision is compared from one state
                same_dec = total = 0
                worst = 0.0
                for t in range(LOWERING_STEPS):
                    st0 = init_chain_state(default[t].forest, default[t].noise,
                                           default[t].scale, X, y, ft, params, bounds=bounds)
                    st, info = step_with_info(st0, X, y, bounds, ft, params, draws[t])
                    dec = info.tree_accepts == infos[t].tree_accepts
                    same_dec += int(dec.sum())
                    total += dec.numel()
                    alike = dec.all(1) & (info.hyper_accept == infos[t].hyper_accept)
                    want = default[t + 1].mll[alike]
                    diff = (st.mll[alike] - want).abs()
                    rel = (diff / want.abs()).max().item() if diff.numel() else 0.0
                    require(bool((diff <= MLL_ATOL + MLL_RTOL * want.abs()).all()),
                            f"{path} step {t}: MLL within rtol {MLL_RTOL} / atol {MLL_ATOL} of "
                            f"the default where the decisions agree (relative {rel})")
                    worst = max(worst, rel)
                share = same_dec / total
                require(share >= DECISION_SHARE, f"{path}: {share:.4f} of the tree decisions "
                                                 f"agree with the default")
                agree = (f"{same_dec}/{total} tree decisions as the default ({share:.4%}), MLL "
                         f"max relative diff {worst:.3e}")
            # (b) and (c): LOWERING_FREE_STEPS free steps from the shared state
            gram_cuda.launches = chol_inv_cuda.launches = 0
            with KernelRecorder() as rec:
                st = init_chain_state(*shared, X, y, ft, params, bounds=bounds)
                for t in range(LOWERING_FREE_STEPS):
                    st, _ = step_with_info(st, X, y, bounds, ft, params, draws[t])
                torch.cuda.synchronize()
            counts = {"gram": gram_cuda.launches, "chol_inv": chol_inv_cuda.launches}
            launches[path] = counts
            want_counts = _expected_launches(r, n, LOWERING_FREE_STEPS)
            require(counts == want_counts, f"{path}: launches {counts}, expected {want_counts}")
            require(bool(torch.isfinite(st.mll).all()), f"{path}: finite MLL")
            checked = rebuild_check(path, st, r, X, y)
            syncs = syncs_per_step(st, params, X, y)
            hold_recorded(torch, dev, smi, path, rec, times, held)
            rows[(n, name)] = {"N": n, "lowering": name, "scan": r.scan_style,
                               "refresh": r.refresh_style, "backend": r.kernel_backend,
                               "syncs_per_step": sum(syncs.values()), "launches": counts}
            log(f"[phase 16] {path} ({r.kernel_backend}, {r.scan_style}, {r.refresh_style}, "
                f"{r.hot_style}, {r.subspace_mode}): (a) {agree}; (b) after "
                f"{LOWERING_FREE_STEPS} steps vs a float64 rebuild {checked}; (c) launches "
                f"{counts} by shape {rec.shapes}; {sum(syncs.values())} host syncs a step "
                f"{dict(syncs)}; on {smi}; {time.perf_counter() - t0:.1f} s")

    # (d) the rates through the benchmark's twin, after every check: each
    # reading starts only if it ends before RATE_DEADLINE_S of the script (a
    # slow host loses readings, logged as cut, never the checks); the default
    # is read before and after the lowerings of its N (the host drifts within
    # a call) and each lowering is reported against the mean
    cut, cost = [], 0.0
    for n in (50, 512):
        def rate_of(what, **overrides):
            nonlocal cost
            if time.perf_counter() - SCRIPT_T0 + 1.5 * cost > RATE_DEADLINE_S:
                cut.append(what)
                return None
            t0 = time.perf_counter()
            rate = bench.measure(n_train=n, steps_per_call=20, n_calls=1, untimed_calls=1,
                                 **overrides)["value"]
            cost = max(cost, time.perf_counter() - t0)
            log(f"[phase 16] (d) {what}: {rate} steps/s/chip (bench.measure, one untimed and "
                f"one timed call of 20 steps) on {smi}")
            return rate

        default_rates = [rate_of(f"{defaults[n]} N={n}, before")]
        configs = {**PROPOSAL_SIDE, **KERNEL_SIDE_50} if n == 50 else KERNEL_SIDE_512
        for name, overrides in configs.items():
            rows[(n, name)]["steps_per_s"] = rate_of(f"{name} N={n}", **overrides)
        default_rates.append(rate_of(f"{defaults[n]} N={n}, after"))
        read = [r for r in default_rates if r is not None]
        mean0 = sum(read) / len(read) if read else None
        table.append({"N": n, "lowering": defaults[n], "steps_per_s": default_rates})
        for name in configs:
            row = rows[(n, name)]
            rate = row["steps_per_s"]
            row["vs_default"] = None if rate is None or mean0 is None else round(rate / mean0, 4)
            table.append(row)
        log(f"[phase 16] N={n} default before and after the lowerings {default_rates} "
            f"steps/s/chip; each lowering over their mean: "
            f"{ {name: rows[(n, name)]['vs_default'] for name in configs} } on {smi}")
    if cut:
        log(f"[phase 16] cut: no rate for {cut} (the script's clock passed "
            f"{RATE_DEADLINE_S} s)")
    log(f"[phase 16] table {json.dumps(table)}")
    log(f"[phase 16] {time.perf_counter() - t_phase:.1f} s")
    return launches, times


SCAN_CASES = ((SLICE_CHAINS, 50, 0), (4, 64, 10), (8, 255, 0))  # (chains, N, pad rows)
SCAN_TIE = 1e-5  # |u - p| (twin or float64 loop) below which a chain is no longer compared
SCAN_LA_ATOL = 1e-4
STATIONARY_WARMUP, STATIONARY_STEPS, STATIONARY_THIN = 100, 500, 10
STATIONARY_Z = 4.0


def scan_case(torch, dev, tf, chains, n, pads, seed=0, steps=20):
    """The move scan's inputs: a state ``steps`` steps from empty forests on
    TreeFunction(dim=5, m=50) data (the last ``pads`` rows masked), then one
    step's proposal batch and update patterns. Returns (state, batch,
    W_pat, y, mask, pad_count, params)."""
    from bark_tpu_torch.fitting import sampler
    from bark_tpu_torch.fitting.params import SamplerParams
    from bark_tpu_torch.forest import create_empty_forest

    rng = np.random.default_rng(seed)
    X_np = tf.domain.sample(n, rng)
    y_np = tf.f(X_np)
    y_np = (y_np - y_np.mean()) / y_np.std()
    y_np[n - pads:] = 0.0
    X = torch.as_tensor(X_np, device=dev)
    y = torch.as_tensor(y_np, dtype=torch.float32, device=dev)
    mask = torch.ones(n, device=dev)
    mask[n - pads:] = 0.0
    ft = torch.as_tensor(tf.domain.feature_types(), device=dev)
    bounds = torch.as_tensor(tf.domain.bounds("bitmask"), device=dev)
    params = SamplerParams(warmup_steps=steps, num_samples=1, steps_per_sample=1,
                           num_chains=chains, num_trees=SLICE_TREES)
    model = sampler.BARKModel(
        create_empty_forest(SLICE_TREES, params.node_limit, (chains,), dev),
        torch.full((chains,), 0.1, device=dev), torch.ones(chains, device=dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = sampler.run_chain(gen, model, X, y, bounds, ft, params, mask=mask).state
    params = sampler._resolve_styles(params, n)
    draws = sampler.draw_step(gen, chains, params, dev)
    packed0, batch = sampler._propose_all_trees(state, X, ft, bounds, params, draws.proposal)
    W_pat = sampler._update_patterns(packed0, batch, mask)
    return state, batch, W_pat, y, mask, n - mask.sum(), params


def phase_move_scan(torch, dev, smi, tf):
    """Phase 17: K3, the dense move scan as one kernel. Returns its launches
    on the main path, the largest log-alpha gap, and its times."""
    from bark_tpu_torch.benchmarks.kernel_timing import call_ms, k3_bound, kernel_time
    from bark_tpu_torch.fitting import sampler
    from bark_tpu_torch.fitting.params import SamplerParams
    from bark_tpu_torch.fitting.traversal import terminal_mask
    from bark_tpu_torch.forest import Forest, create_empty_forest
    from bark_tpu_torch.ops.chol import chol_inv_cuda
    from bark_tpu_torch.ops.gram import gram_cuda
    from bark_tpu_torch.ops.scan import move_scan_cuda

    t_phase = time.perf_counter()
    m = SLICE_TREES
    # (a) the kernel against its twin, move by move, and both against the
    # twin run in float64 from the same inputs
    def f64(x):
        if torch.is_tensor(x):
            return x.double() if x.is_floating_point() else x
        if isinstance(x, tuple):
            items = [f64(t) for t in x]
            return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
        return x

    worst = {"kernel": 0.0, "twin": 0.0, "kernel vs twin": 0.0}
    cases = {}
    for chains, n, pads in SCAN_CASES:
        args = scan_case(torch, dev, tf, chains, n, pads)
        cases[(chains, n)] = args
        for beta in (1.0, torch.linspace(0.2, 1.0, chains, device=dev)):
            tag = (f"K3 ({chains},{n}) pads {pads} beta "
                   f"{beta if isinstance(beta, float) else 'per chain'}")
            before = move_scan_cuda.launches
            acc, la = sampler._scan_plain(*args, beta)
            torch.cuda.synchronize()
            require(move_scan_cuda.launches == before + 1, f"{tag}: one launch")
            want_acc, want_la = (torch.stack(t, 1) for t in sampler._scan_plain_loop(*args, beta))
            acc64, la64 = (torch.stack(t, 1)
                           for t in sampler._scan_plain_loop(*f64(args), f64(beta)))
            u = args[1].u_accept.double()
            tie = ((u - torch.exp(torch.clamp_max(want_la.double(), 0.0))).abs() <= SCAN_TIE) | (
                (u - torch.exp(torch.clamp_max(la64, 0.0))).abs() <= SCAN_TIE) | (acc64 != want_acc)
            stop = torch.where(tie.any(1), tie.int().argmax(1), m)
            compared = torch.arange(m, device=dev) < stop[:, None]
            require(torch.equal(acc[compared], want_acc[compared]),
                    f"{tag}: every chain decides like the twin before a near-tie")
            require(torch.equal(torch.isinf(la[compared]), torch.isinf(want_la[compared])),
                    f"{tag}: the kernel vetoes the moves the twin vetoes")
            fin = compared & torch.isfinite(la64)
            gaps = {"kernel": (la[fin].double() - la64[fin]).abs().max().item(),
                    "twin": (want_la[fin].double() - la64[fin]).abs().max().item(),
                    "kernel vs twin": (la[fin] - want_la[fin]).abs().max().item()}
            worst = {k: max(v, gaps[k]) for k, v in worst.items()}
            require(gaps["kernel"] <= gaps["twin"] + SCAN_LA_ATOL,
                    f"{tag}: log alpha no farther from the float64 loop's than "
                    f"{SCAN_LA_ATOL} beyond the twin's ({gaps})")
            if n <= 64:
                require(gaps["kernel vs twin"] <= SCAN_LA_ATOL,
                        f"{tag}: log alpha within {SCAN_LA_ATOL} of the twin's ({gaps})")
            log(f"[K3] {tag}: {int(compared.sum())} of {chains * m} moves compared "
                f"({int((stop < m).sum())} chains stopped at a near-tie), decisions alike; "
                f"|log alpha - float64 loop's| kernel {gaps['kernel']:.3e}, twin "
                f"{gaps['twin']:.3e}; kernel vs twin {gaps['kernel vs twin']:.3e}; accept "
                f"rate {want_acc.float().mean().item():.3f}")
    log(f"[K3] largest log alpha gaps: {json.dumps(worst)}")

    # (b) the main path: one launch a step, K1 and K2 as before
    X_np = tf.domain.sample(50, np.random.default_rng(0))
    y_np = tf.f(X_np)
    X = torch.as_tensor(X_np, device=dev)
    y = torch.as_tensor((y_np - y_np.mean()) / y_np.std(), dtype=torch.float32, device=dev)
    ft = torch.as_tensor(tf.domain.feature_types(), device=dev)
    bounds = torch.as_tensor(tf.domain.bounds("bitmask"), device=dev)

    def model(chains):
        return sampler.BARKModel(
            create_empty_forest(m, 64, (chains,), dev), torch.full((chains,), 0.1, device=dev),
            torch.ones(chains, device=dev))

    params = SamplerParams(warmup_steps=0, num_samples=10, steps_per_sample=5,
                           num_chains=SLICE_CHAINS, num_trees=m)
    before = (move_scan_cuda.launches, gram_cuda.launches, chol_inv_cuda.launches)
    sampler.run_chain(torch.Generator(device=dev).manual_seed(3), model(SLICE_CHAINS), X, y,
                      bounds, ft, params)
    torch.cuda.synchronize()
    counts = {k: a - b for k, a, b in zip(
        ("move_scan", "gram", "chol_inv"),
        (move_scan_cuda.launches, gram_cuda.launches, chol_inv_cuda.launches), before)}
    require(counts == {"move_scan": 50, "gram": 51, "chol_inv": 51},
            f"K3 once a step, K1 and K2 once per init and step on run_chain: {counts}")
    log(f"[K3] run_chain N=50, 64 chains, 50 steps: launches {counts}")

    # (c) times at the cells' shapes: the kernel's device and call time, the twin's call
    times = {}
    for chains, n in ((SLICE_CHAINS, 50), (4, 64)):
        st, batch, W_pat, yc, mask, pad_count, p = cases[(chains, n)]
        h, corr = sampler._scan_scales(st, pad_count, p)
        ones = torch.ones_like(h)

        def run():
            return move_scan_cuda(st.kern.K_inv, yc, W_pat, h, st.kern.K_logdet, corr,
                                  batch.log_q_prior, batch.u_accept, ones)

        dev_ms, _, _, source = kernel_time(torch, run, "move_scan_kernel", 1)
        call = call_ms(torch, run)
        plain = call_ms(torch, lambda: sampler._scan_plain_loop(st, batch, W_pat, yc, mask,
                                                                pad_count, p, 1.0),
                        reps=5, inner=2, warmup=1)
        bound_ms, bound_by = k3_bound(chains, n, m)
        name = f"({chains},{n})"
        times[name] = {"device_ms": dev_ms, "device_source": source, "call_ms": call,
                       "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by,
                       "share_of_bound": bound_ms / dev_ms}
        log(f"[K3] {name} x {m} moves: device {dev_ms:.5f} ms ({source}), call {call:.5f}, "
            f"plain (the twin's loop) {plain:.3f} ms; bound {bound_ms:.5f} ms ({bound_by}), "
            f"{100 * bound_ms / dev_ms:.2f}% of it, on {smi}")

    # (d) stationarity: from one warm state, 500 steps with the kernel and with
    # the twin (independent draws); the tree accept rate and the mean leaves a
    # tree agree within their Monte-Carlo error (each chain's two arms a pair)
    warm = sampler.run_chain(
        torch.Generator(device=dev).manual_seed(11), model(SLICE_CHAINS), X, y, bounds, ft,
        SamplerParams(warmup_steps=STATIONARY_WARMUP - 1, num_samples=1, steps_per_sample=1,
                      num_chains=SLICE_CHAINS, num_trees=m))
    start = sampler.BARKModel(Forest(*(f[:, -1] for f in warm.samples.forest)),
                              warm.samples.noise[:, -1], warm.samples.scale[:, -1])
    params = SamplerParams(warmup_steps=0, num_samples=STATIONARY_STEPS // STATIONARY_THIN,
                           steps_per_sample=STATIONARY_THIN, num_chains=SLICE_CHAINS,
                           num_trees=m)
    stats = {}
    for arm, seed in (("kernel", 21), ("twin", 22)):
        saved = sampler._SCANS["plain"]
        if arm == "twin":
            sampler._SCANS["plain"] = sampler._scan_plain_loop
        t0 = time.perf_counter()
        try:
            run = sampler.run_chain(torch.Generator(device=dev).manual_seed(seed), start, X, y,
                                    bounds, ft, params)
            torch.cuda.synchronize()
        finally:
            sampler._SCANS["plain"] = saved
        leaves = terminal_mask(run.samples.forest).sum(-1).float().mean((1, 2))  # (C,)
        stats[arm] = {"accept": run.tree_accept_rate.float(), "leaves": leaves,
                      "seconds": time.perf_counter() - t0}
    for what in ("accept", "leaves"):
        a, b = stats["kernel"][what], stats["twin"][what]
        d = a - b  # chain c of both arms starts from warm chain c: paired
        se = (d.std() / SLICE_CHAINS ** 0.5).item()
        z = d.mean().item() / se
        log(f"[K3 stationarity] {what}: kernel {a.mean().item():.5f}, twin "
            f"{b.mean().item():.5f} (se of the difference {se:.2e}, z {z:+.2f}) over "
            f"{STATIONARY_STEPS} steps x {SLICE_CHAINS} chains at N=50")
        require(abs(z) <= STATIONARY_Z, f"K3 stationarity: {what} within {STATIONARY_Z} "
                                        f"standard errors of the twin's (z {z:+.2f})")
    log(f"[K3 stationarity] {STATIONARY_STEPS} steps: kernel "
        f"{stats['kernel']['seconds']:.1f} s, twin {stats['twin']['seconds']:.1f} s on {smi}")
    log(f"[phase 17] {time.perf_counter() - t_phase:.1f} s")
    return {"run_chain N=50": counts["move_scan"]}, worst["kernel"], times


PROPOSE_CASES = (  # (name, chains, N, inputs): the four cells' shapes
    ("mcmc.treefn5.n50", SLICE_CHAINS, 50, "cont"),
    ("mcmc.treefn5.n50.cat2", SLICE_CHAINS, 50, "cat2"),
    ("bo.treefn5.n50", 4, 64, "cont"),
    ("bo.pest25.n120", 4, 128, "pest"),
)
PROPOSE_ULPS = 8  # log q: logf and powf against torch.log and torch.pow


def propose_case(torch, dev, chains, n, inputs, seed=0, steps=20):
    """A proposal batch's inputs on the card: a state ``steps`` sampler steps
    from empty forests on data of 5 continuous inputs, 3 and 2 categorical
    ones of 5 levels, or 25 categorical ones, and one step's draws. Returns
    (state, X, feat_types, bounds, params, noise)."""
    from bark_tpu_torch.fitting import sampler
    from bark_tpu_torch.fitting.params import SamplerParams
    from bark_tpu_torch.forest import FEAT_CAT, FEAT_CONT, create_empty_forest

    n_cat = {"cont": 0, "cat2": 2, "pest": 25}[inputs]
    n_cont = 0 if inputs == "pest" else 5 - n_cat
    rng = np.random.default_rng(seed)
    X_np = np.concatenate([rng.uniform(size=(n, n_cont)),
                           rng.integers(0, 5, (n, n_cat)).astype(np.float64)], 1)
    y_np = np.sin(6.0 * X_np[:, 0]) + (X_np[:, -1] >= 2)
    y_np = (y_np - y_np.mean()) / y_np.std()
    X = torch.as_tensor(X_np, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y_np, dtype=torch.float32, device=dev)
    ft = torch.tensor([FEAT_CONT] * n_cont + [FEAT_CAT] * n_cat, dtype=torch.int32, device=dev)
    bounds = torch.tensor([[0.0, 1.0]] * n_cont + [[0.0, 31.0]] * n_cat, device=dev)
    params = SamplerParams(warmup_steps=steps, num_samples=1, steps_per_sample=1,
                           num_chains=chains, num_trees=SLICE_TREES)
    model = sampler.BARKModel(
        create_empty_forest(SLICE_TREES, params.node_limit, (chains,), dev),
        torch.full((chains,), 0.1, device=dev), torch.ones(chains, device=dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = sampler.run_chain(gen, model, X, y, bounds, ft, params).state
    params = sampler._resolve_styles(params, n)
    return state, X, ft, bounds, params, sampler.draw_step(gen, chains, params, dev).proposal


def phase_propose(torch, dev, smi):
    """Phase 18: K4, the proposal batch as one kernel. Returns its launches
    on the main path, the largest log q gap in ulps, and its times."""
    from bark_tpu_torch.benchmarks.kernel_timing import call_ms, k4_bound, kernel_time
    from bark_tpu_torch.fitting import sampler
    from bark_tpu_torch.ops.propose import propose_batch_cuda

    t_phase = time.perf_counter()
    names = ("new_packed", "cur_leavesT", "new_leavesT", "log_q_prior", "move", "node")
    worst_ulps, times = 0.0, {}
    for name, chains, n, inputs in PROPOSE_CASES:
        state, X, ft, bounds, params, noise = propose_case(torch, dev, chains, n, inputs)
        # (a) the kernel against the twin
        before = propose_batch_cuda.launches
        _, batch = sampler._propose_all_trees(state, X, ft, bounds, params, noise)
        torch.cuda.synchronize()
        require(propose_batch_cuda.launches == before + 1, f"K4 {name}: one launch")
        want = sampler._propose_torch(sampler.pack_forest(state.forest), noise, state.leaves, X,
                                      ft, bounds, params)
        for field, got, exp in zip(names, batch, want):
            if field != "log_q_prior":
                require(torch.equal(got, exp), f"K4 {name}: {field} equal to the twin's")
        lq, lq_twin = batch.log_q_prior, want[3]
        require(torch.equal(torch.isinf(lq), torch.isinf(lq_twin)),
                f"K4 {name}: the twin's rejects")
        fin = torch.isfinite(lq_twin)
        ulps = ((lq[fin] - lq_twin[fin]).abs() / (torch.finfo(torch.float32).eps
                                                  * torch.clamp_min(lq_twin[fin].abs(), 1.0)))
        gap = ulps.max().item() if ulps.numel() else 0.0
        worst_ulps = max(worst_ulps, gap)
        require(gap <= PROPOSE_ULPS, f"K4 {name}: log q within {PROPOSE_ULPS} ulps ({gap})")
        moves = torch.bincount(batch.move.flatten(), minlength=3).tolist()
        log(f"[K4] {name} ({chains} x {SLICE_TREES} trees, N={n}): every field the twin's, "
            f"log q within {gap:.1f} ulps; moves grow/prune/change {moves}, rejects "
            f"{torch.isinf(lq).float().mean().item():.3f}")

        # (c) times: the kernel's device and call time, the twin's call
        packed0 = sampler.pack_forest(state.forest)
        args = (packed0, *noise[:6], bounds, ft, X, state.leaves, params.proposal_weights,
                params.alpha, params.beta, params.max_depth)
        dev_ms, _, _, source = kernel_time(torch, lambda: propose_batch_cuda(*args),
                                           "propose_kernel", 1)
        call = call_ms(torch, lambda: propose_batch_cuda(*args))
        plain = call_ms(torch, lambda: sampler._propose_torch(packed0, noise, state.leaves, X, ft,
                                                              bounds, params),
                        reps=5, inner=2, warmup=1)
        bound_ms, bound_by = k4_bound(chains, SLICE_TREES, params.node_limit, n, X.shape[1])
        times[name] = {"device_ms": dev_ms, "device_source": source, "call_ms": call,
                       "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by,
                       "share_of_bound": bound_ms / dev_ms}
        log(f"[K4] {name}: device {dev_ms:.5f} ms ({source}), call {call:.5f}, plain (the "
            f"twin) {plain:.3f} ms; bound {bound_ms:.5f} ms ({bound_by}), "
            f"{100 * bound_ms / dev_ms:.2f}% of it, on {smi}")

    # (b) the main path: one launch a step, none in the init
    state, X, ft, bounds, params, _ = propose_case(torch, dev, SLICE_CHAINS, 50, "cont", steps=0)
    y = torch.sin(6.0 * X[:, 0])
    y = (y - y.mean()) / y.std()
    before = propose_batch_cuda.launches
    run = sampler.run_chain(torch.Generator(device=dev).manual_seed(3), sampler.BARKModel(
        state.forest, state.noise, state.scale), X, y, bounds, ft,
        params.with_(warmup_steps=0, num_samples=10, steps_per_sample=5))
    torch.cuda.synchronize()
    launches = propose_batch_cuda.launches - before
    require(launches == 50, f"K4 once a step on run_chain: {launches} in 50 steps")
    log(f"[K4] run_chain N=50, 64 chains, 50 steps: {launches} launches, tree accept rate "
        f"{run.tree_accept_rate.mean().item():.3f}")
    log(f"[phase 18] {time.perf_counter() - t_phase:.1f} s")
    return {"run_chain N=50": launches}, worst_ulps, times


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
    log(f"[cuts] {CUTS}")

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
        require(t["device_ms"] > 0, f"K1 {name}: a device time")
        k1_times[name] = t
        log(f"[K1] {name}{' symmetric' if t['symmetric'] else ''}: device "
            f"{t['device_ms']} ms ({t['kernels_per_call']} kernels a call: {t['kernel_ms']}), "
            f"call {t['call_ms']:.5f}, plain {t['plain_ms']:.5f}; bf16 one-hot bmm "
            f"{t['library_ms']} ms device; bound {t['bound_ms']:.5f} ms ({t['bound_by']}), "
            f"{100 * t['share_of_bound']:.1f}% of it, on {smi}")

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
        require(t["device_ms"] > 0, f"K2 {name}: a device time")
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
    # --- 9. tempered fitting ---------------------------------------------------
    path_launches, path_times = phase_tempered(torch, dev, smi)
    launches.update(path_launches)
    for (kernel, name), t in path_times.items():
        (k1_times if kernel == "gram" else k2_times)[name] = t
    # --- 10. the chol oracle, posterior function sampling, the CG predict ----
    path_launches, path_times = phase_oracle_sampling_cg(torch, dev, smi, tf)
    launches.update(path_launches)
    for (kernel, name), t in path_times.items():
        (k1_times if kernel == "gram" else k2_times)[name] = t
    # --- 11. the booster forests: LeafGP, LeafMOGP, the multi-fidelity loop ---
    path_launches, path_times = phase_booster_forests(torch, dev, smi)
    launches.update(path_launches)
    for (kernel, name), t in path_times.items():
        (k1_times if kernel == "gram" else k2_times)[name] = t
    # --- 12. BART, the baselines, the study and regression runners ------------
    path_launches, path_times = phase_baselines_study(torch, dev, smi)
    launches.update(path_launches)
    for (kernel, name), t in path_times.items():
        (k1_times if kernel == "gram" else k2_times)[name] = t
    # --- 13. the sharded paths, checkpoints, profiling, the last benchmarks ----
    path_launches, path_times = phase_distributed(torch, dev, smi, tf)
    launches.update(path_launches)
    for (kernel, name), t in path_times.items():
        (k1_times if kernel == "gram" else k2_times)[name] = t
    # --- 14. the forest Gram API and the last entry points ----------------------
    path_launches, path_times = phase_entry_points(torch, dev, smi, tf)
    launches.update(path_launches)
    for (kernel, name), t in path_times.items():
        (k1_times if kernel == "gram" else k2_times)[name] = t
    # --- 15. the headline benchmark's twin ----------------------------------------
    path_launches, path_times = phase_bench(torch, dev, smi)
    launches.update(path_launches)
    for (kernel, name), t in path_times.items():
        (k1_times if kernel == "gram" else k2_times)[name] = t
    # --- 16. the sampler's lowerings --------------------------------------------------
    path_launches, path_times = phase_lowerings(torch, dev, smi, tf)
    launches.update(path_launches)
    for (kernel, name), t in path_times.items():
        (k1_times if kernel == "gram" else k2_times)[name] = t
    # --- 17. the dense move scan as one kernel ------------------------------------
    k3_launches, k3_err, k3_times = phase_move_scan(torch, dev, smi, tf)
    # --- 18. the proposal batch as one kernel -------------------------------------
    k4_launches, k4_ulps, k4_times = phase_propose(torch, dev, smi)

    k1 = k1_times[f"({SLICE_CHAINS},50,50)"]
    k2 = k2_times["(128,50,50)"]
    k1_keys = ("device_ms", "kernel_ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
               "bound_by", "share_of_bound", "symmetric", "device_source", "library_source")
    kernels = [
        {"name": "gram", "route": "cuda", "source": "bark_tpu_torch/csrc/gram.cu",
         "replaces": "bark_tpu/ops/pallas_gram.py:40",
         "launches": launches[f"dense N={DENSE_NS[0]}"]["gram"],
         "launches_by_path": {p: c["gram"] for p, c in launches.items()},
         "max_abs_err": k1_err, "ms": k1["device_ms"], "device_ms": k1["device_ms"],
         "device_source": k1["device_source"],
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
         "device_source": k2["device_source"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": k2["library_ms"], "times": k2_times},
        {"name": "move_scan", "route": "cuda", "source": "bark_tpu_torch/csrc/move_scan.cu",
         "replaces": None, "launches": k3_launches["run_chain N=50"],
         "launches_by_path": k3_launches, "max_abs_err": k3_err,
         "ms": k3_times[f"({SLICE_CHAINS},50)"]["device_ms"], "times": k3_times},
        {"name": "propose", "route": "cuda", "source": "bark_tpu_torch/csrc/propose.cu",
         "replaces": None, "launches": k4_launches["run_chain N=50"],
         "launches_by_path": k4_launches, "max_log_q_ulps": k4_ulps,
         "ms": k4_times["mcmc.treefn5.n50"]["device_ms"], "times": k4_times},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
