"""The drift-free ``chol`` backend of the port's sampler against the JAX
reference, the rest of ``ops/linalg`` and the stationarity script, on the CPU.

The reference runs in a subprocess with JAX's x64 mode off, as in
tests/test_torch_sampler.py; this file is that subprocess's script too
(``python tests/test_torch_chol_backend.py OUT.npz``). On the mixed domain
of tests/fitting/test_sampler.py (m = 8, 2 chains, prior forests) it saves
``kernel_backend="chol"`` runs: unpadded N=20; N=24 padded to 32; N=20 at
beta 0.5; and N=270 padded to 288, where ``blocked_cholesky`` blocks on the
host at 256. Every step's draws are rebuilt from its keys, and the port
replays them from the converted initial state. One jitted step per shape
takes X, y, the mask and beta as arguments, so it compiles once per shape.

Tolerances: accepts, forests and leaves exact (up to a reported near-tie
|log u - min(log a, 0)| < 1e-3, after which a chain is not compared); noise
and scale rtol 1e-6; MLL rtol 1e-4 / atol 1e-3; the carried K rtol 1e-5 /
atol 1e-5, against the reference's and against a fresh rebuild from the
leaves. The four ``ops/linalg`` functions run on float32 inputs in both
packages at rtol 1e-5.
"""

import dataclasses
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_sampler import NOISE_FIELDS, make_problem
from test_torch_sampler import _inputs as unpadded_inputs
from torch_support import REPO, run_reference

from bark_tpu_torch import convert
from bark_tpu_torch.convert import chain_state_from_reference, to_numpy
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.fitting.proposals import ProposalNoise
from bark_tpu_torch.fitting.sampler import (
    BARKModel,
    StepDraws,
    _resolve_styles,
    draw_step,
    init_chain_state,
    run_bark_sampler_with_trace,
    run_chain,
    step_with_info,
)
from bark_tpu_torch.forest import FOREST_FIELDS, create_empty_forest, route_forest
from bark_tpu_torch.ops import linalg
from bark_tpu_torch.ops.gram import gram_plain
from bark_tpu_torch.parallel.smc import run_smc
from bark_tpu_torch.parallel.tempering import run_parallel_tempering

M = 8
CHAINS = 2
NEAR_TIE = 1e-3
CHOL = {"kernel_backend": "chol"}
# case -> (real N, padded N, steps, beta)
CASES = {
    "n20": (20, 20, 3, 1.0),
    "pad24": (24, 32, 2, 1.0),
    "beta": (20, 20, 2, 0.5),
    "n270": (270, 288, 1, 1.0),
}
K_TOL = dict(rtol=1e-5, atol=1e-5)


def padded_problem(n, npad):
    """make_problem(n) with npad - n zero rows (y 0) and the row mask."""
    bounds, ft, X, y = make_problem(n)
    pad = npad - n
    Xp = np.concatenate([X, np.zeros((pad, X.shape[1]), X.dtype)])
    yp = np.concatenate([y, np.zeros(pad, y.dtype)])
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    return bounds, ft, Xp, yp, mask


def reference_run(out_path: str) -> None:
    """The JAX side (run as a script, x64 off)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from bark_tpu.fitting.params import SamplerParams as JaxParams
    from bark_tpu.fitting.prior import sample_forest_prior
    from bark_tpu.fitting.proposals import make_proposal_noise
    from bark_tpu.fitting.sampler import _propose_all_trees, init_chain_state as jax_init
    from bark_tpu.fitting.sampler import step as jax_step
    from bark_tpu.forest import pack_forest

    params = JaxParams(num_trees=M, **CHOL)
    out = {}

    def draws(k):
        k_trees, k_hyper, k_hyper_accept = jax.random.split(k, 3)
        k_noise, k_scale = jax.random.split(k_hyper)
        return (
            make_proposal_noise(k_trees, M, params.node_limit),
            jax.random.normal(k_noise, dtype=jnp.float32),
            jax.random.normal(k_scale, dtype=jnp.float32),
            jax.random.uniform(k_hyper_accept, dtype=jnp.float32),
        )

    draws_of = jax.jit(jax.vmap(draws))
    split = jax.jit(jax.vmap(jax.random.split))

    @jax.jit
    def init(forests, noise, scale, X, y, ft, bounds, mask):
        return jax.vmap(
            lambda f, nz, sc: jax_init(f, nz, sc, X, y, ft, params, mask, bounds=bounds)
        )(forests, noise, scale)

    @jax.jit
    def step_and_proposal(keys, states, X, y, ft, bounds, mask, beta):
        def one(k, s):
            proposal = _propose_all_trees(jax.random.split(k, 3)[0], s, X, ft, bounds, params)
            return jax_step(k, s, X, y, bounds, ft, params, mask, beta), proposal
        return jax.vmap(one)(keys, states)

    for case, (n, npad, steps, beta) in CASES.items():
        bounds, ft, X, y, mask = (jnp.asarray(a) for a in padded_problem(n, npad))
        forests = sample_forest_prior(jax.random.key(1), M, bounds, ft, num_samples=CHAINS)
        noise0 = jnp.asarray([0.1, 0.3], jnp.float32)
        scale0 = jnp.asarray([1.0, 0.7], jnp.float32)
        state = init(forests, noise0, scale0, X, y, ft, bounds, mask)

        def save_state(tag, st):
            for k in FOREST_FIELDS:
                out[f"{case}/{tag}/forest.{k}"] = np.asarray(getattr(st.forest, k))
            for k in ("leaves", "noise", "scale", "mll"):
                out[f"{case}/{tag}/{k}"] = np.asarray(getattr(st, k))
            for k in ("K", "K_inv", "K_logdet"):
                out[f"{case}/{tag}/{k}"] = np.asarray(getattr(st.kern, k))

        save_state("s0", state)
        keys = jax.random.split(jax.random.key(2), CHAINS)
        for s in range(steps):
            pair = split(keys)
            keys, k = pair[:, 0], pair[:, 1]
            pn, z_noise, z_scale, u_hyper = draws_of(k)
            for f in NOISE_FIELDS:
                out[f"{case}/d{s}/{f}"] = np.asarray(getattr(pn, f))
            out[f"{case}/d{s}/z_noise"] = np.asarray(z_noise)
            out[f"{case}/d{s}/z_scale"] = np.asarray(z_scale)
            out[f"{case}/d{s}/u_hyper"] = np.asarray(u_hyper)
            state, (packed0, batch) = step_and_proposal(
                k, state, X, y, ft, bounds, mask, jnp.float32(beta))
            # accept code per move: 1 accepted, 0 rejected, -1 undecidable
            # (the proposal left the tree as it was)
            new, old = np.asarray(batch.new_packed), np.asarray(packed0)
            final = np.asarray(pack_forest(state.forest))
            same = (new == old).all(axis=(-2, -1))
            took = (final == new).all(axis=(-2, -1))
            out[f"{case}/d{s}/accept"] = np.where(same, -1, took.astype(np.int64))
            save_state(f"s{s + 1}", state)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(__file__, tmp_path_factory.mktemp("reference"), "reference.npz")


def _state(ref, case, tag):
    return {
        "forest": {k: ref[f"{case}/{tag}/forest.{k}"] for k in FOREST_FIELDS},
        "kern": {k: ref[f"{case}/{tag}/{k}"] for k in ("K", "K_inv", "K_logdet")},
        **{k: ref[f"{case}/{tag}/{k}"] for k in ("leaves", "noise", "scale", "mll")},
    }


def _draws(ref, case, s) -> StepDraws:
    get = lambda f: torch.as_tensor(ref[f"{case}/d{s}/{f}"])  # noqa: E731
    return StepDraws(ProposalNoise(*(get(f) for f in NOISE_FIELDS)),
                     get("z_noise"), get("z_scale"), get("u_hyper"))


def _inputs(case):
    n, npad = CASES[case][:2]
    bounds, ft, X, y, mask = padded_problem(n, npad)
    return tuple(torch.as_tensor(a) for a in (X, y, bounds, ft, mask))


def _rebuilt_K(state, X, ft, mask):
    """K from a fresh routing of the state's forests (the plain Gram)."""
    leaves = route_forest(state.forest, X, ft)
    return linalg.kernel_matrix(gram_plain(leaves, leaves, mask, mask), state.noise,
                                state.scale)


@pytest.mark.parametrize("case", list(CASES))
def test_init_chain_state_matches_reference(reference, case):
    X, y, bounds, ft, mask = _inputs(case)
    params = SamplerParams(num_trees=M, **CHOL)
    want = _state(reference, case, "s0")
    start = chain_state_from_reference(want, device="cpu")
    state = init_chain_state(start.forest, start.noise, start.scale, X, y, ft, params, mask,
                             bounds)
    assert state.kern.K_inv is None and state.kern.L is None and state.kern.K_logdet is None
    np.testing.assert_array_equal(state.leaves.numpy(), want["leaves"])
    np.testing.assert_allclose(state.mll.numpy(), want["mll"], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(state.kern.K.numpy(), want["kern"]["K"], **K_TOL)
    torch.testing.assert_close(start.kern.K, state.kern.K, **K_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_chol_steps_replay_reference(reference, case):
    """Replay the reference's draws: the same accepts, forests and leaves,
    noise and scale, the MLL, and the carried K, which also equals a fresh
    rebuild from the leaves; padded rows of K keep (jitter + noise) on the
    diagonal and nothing else."""
    n, npad, steps, beta = CASES[case]
    X, y, bounds, ft, mask = _inputs(case)
    params = SamplerParams(num_trees=M, **CHOL)
    state = chain_state_from_reference(_state(reference, case, "s0"), device="cpu")
    parted = [False] * CHAINS
    decided = {0: 0, 1: 0}
    for s in range(steps):
        draws = _draws(reference, case, s)
        prev_noise = reference[f"{case}/s{s}/noise"]
        state, info = step_with_info(state, X, y, bounds, ft, params, draws, mask, beta)
        want = _state(reference, case, f"s{s + 1}")
        codes = reference[f"{case}/d{s}/accept"]
        gap = (torch.log(draws.proposal.u_accept)
               - torch.clamp_max(info.tree_log_alpha, 0.0)).abs()
        torch.testing.assert_close(state.kern.K, _rebuilt_K(state, X, ft, mask), **K_TOL)
        pads = state.kern.K[:, n:, n:]
        torch.testing.assert_close(
            pads, torch.eye(npad - n) * (linalg.JITTER + state.noise)[:, None, None])
        assert not state.kern.K[:, :n, n:].any()
        for c in range(CHAINS):
            if parted[c]:
                continue
            acc = info.tree_accepts[c].numpy()
            for v in (0, 1):
                decided[v] += int((codes[c] == v).sum())
            wrong = np.nonzero((codes[c] >= 0) & (acc != (codes[c] == 1)))[0]
            hyper_wrong = bool(info.hyper_accept[c]) != (want["noise"][c] != prev_noise[c])
            if wrong.size or hyper_wrong:
                g = (gap[c, wrong[0]] if wrong.size else (
                    torch.log(draws.u_hyper[c])
                    - torch.clamp_max(info.hyper_log_alpha[c], 0.0)).abs()).item()
                assert g < NEAR_TIE, f"{case} step {s} chain {c}: decision differs, gap {g}"
                print(f"{case} step {s} chain {c}: near-tie (gap {g:.2e}); chain parted")
                parted[c] = True
                continue
            for k in FOREST_FIELDS:
                np.testing.assert_array_equal(getattr(state.forest, k)[c].numpy(),
                                              want["forest"][k][c], err_msg=f"{case} {s} {k}")
            np.testing.assert_array_equal(state.leaves[c].numpy(), want["leaves"][c])
            np.testing.assert_allclose(state.noise[c].item(), want["noise"][c], rtol=1e-6)
            np.testing.assert_allclose(state.scale[c].item(), want["scale"][c], rtol=1e-6)
            np.testing.assert_allclose(state.mll[c].item(), want["mll"][c], rtol=1e-4,
                                       atol=1e-3)
            np.testing.assert_allclose(state.kern.K[c].numpy(), want["kern"]["K"][c], **K_TOL)
    assert not all(parted)
    assert decided[0] > 0 and decided[1] > 0, decided


def test_chol_and_rank1_decide_alike():
    """The oracle and the shipped dense tier from the same state and the same
    draws, three steps: identical forests and decisions (as
    tests/fitting/test_sampler.py holds the reference's two backends)."""
    X, y, bounds, ft = unpadded_inputs(30)
    rank1 = SamplerParams(num_trees=M)
    chol = rank1.with_(**CHOL)
    forest = create_empty_forest(M, rank1.node_limit, (4,))
    noise, scale = torch.tensor([0.1, 0.3, 0.05, 1.0]), torch.ones(4)
    a = init_chain_state(forest, noise, scale, X, y, ft, rank1, bounds=bounds)
    b = init_chain_state(forest, noise, scale, X, y, ft, chol, bounds=bounds)
    torch.testing.assert_close(a.mll, b.mll, rtol=1e-5, atol=1e-4)
    gen = torch.Generator().manual_seed(5)
    accepted = 0
    for s in range(3):
        draws = draw_step(gen, 4, rank1)
        a, ia = step_with_info(a, X, y, bounds, ft, rank1, draws)
        b, ib = step_with_info(b, X, y, bounds, ft, chol, draws)
        assert torch.equal(ia.tree_accepts, ib.tree_accepts), s
        assert torch.equal(ia.hyper_accept, ib.hyper_accept), s
        for k in FOREST_FIELDS:
            assert torch.equal(getattr(a.forest, k), getattr(b.forest, k)), (s, k)
        torch.testing.assert_close(a.mll, b.mll, rtol=1e-4, atol=1e-3)
        accepted += int(ia.tree_accepts.sum())
    assert accepted > 0


def test_chol_runs_through_run_chain_pt_and_smc():
    """run_chain, run_bark_sampler_with_trace, parallel tempering and SMC take
    chol params unchanged; the carried K equals a fresh rebuild."""
    X, y, bounds, ft = unpadded_inputs(24)
    params = SamplerParams(num_trees=M, warmup_steps=2, num_samples=2, steps_per_sample=1,
                           **CHOL)
    model = BARKModel(create_empty_forest(M, params.node_limit, (2,)), torch.full((2,), 0.1),
                      torch.ones(2))
    run = run_chain(torch.Generator().manual_seed(0), model, X, y, bounds, ft, params)
    ones = torch.ones(24)
    torch.testing.assert_close(run.state.kern.K, _rebuilt_K(run.state, X, ft, ones), **K_TOL)
    samples, mll = run_bark_sampler_with_trace(torch.Generator().manual_seed(1), model, X, y,
                                               bounds, ft, params)
    assert mll.shape == (2, 2) and bool(torch.isfinite(mll).all())
    shape = (1, 3)
    pt = run_parallel_tempering(
        torch.Generator().manual_seed(2), create_empty_forest(M, params.node_limit, shape),
        torch.full(shape, 0.1), torch.ones(shape), X, y, bounds, ft, params, num_replicas=3,
        num_steps=2, beta_min=0.2)
    chains = pt.state.chains
    assert chains.kern.K.shape == (3, 24, 24)
    torch.testing.assert_close(chains.kern.K, _rebuilt_K(chains, X, ft, ones), **K_TOL)
    res = run_smc(torch.Generator().manual_seed(3), X, y, bounds, ft, params, num_particles=4,
                  num_rounds=2, mutation_steps=1)
    assert bool(torch.isfinite(res.log_evidence))


def test_resolve_styles_takes_chol_as_the_reference_does():
    from bark_tpu.fitting.params import SamplerParams as JaxParams
    from bark_tpu.fitting.sampler import _resolve_styles as jax_resolve

    for n in (20, 300):
        port = _resolve_styles(SamplerParams(**CHOL), n)
        ref = jax_resolve(JaxParams(**CHOL), n)
        assert (port.scan_style, port.refresh_style) == (ref.scan_style, ref.refresh_style)
    # the other backend and the proposal lowerings resolve as the
    # reference does too: only rank1 has scan and refresh styles
    for kw in (dict(kernel_backend="woodbury"), dict(hot_style="select", **CHOL)):
        port = _resolve_styles(SamplerParams(**kw), 20)
        ref = jax_resolve(JaxParams(**kw), 20)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), kw


def test_chol_state_round_trips_through_numpy():
    X, y, bounds, ft = unpadded_inputs(20)
    params = SamplerParams(num_trees=M, **CHOL)
    st = init_chain_state(create_empty_forest(M, 64, (2,)), torch.tensor([0.1, 0.2]),
                          torch.ones(2), X, y, ft, params, bounds=bounds)
    back = chain_state_from_reference(
        {**to_numpy(st), "kern": {"K": st.kern.K.numpy(), "K_inv": np.empty((2, 0)),
                                  "K_logdet": np.empty((2, 0))}}, device="cpu")
    assert torch.equal(back.kern.K, st.kern.K) and back.kern.K_logdet is None


def test_conversions_default_to_the_cuda_device(reference):
    """``device=None`` in every ``*_from_reference`` means the CUDA device:
    without one it raises, as ``models.surrogate.resolve_device`` does."""
    st = _state(reference, "n20", "s0")
    model = {"forest": st["forest"], "noise": st["noise"], "scale": st["scale"]}
    calls = (
        lambda: convert.forest_from_reference(st["forest"]),
        lambda: convert.model_from_reference(model),
        lambda: convert.chain_state_from_reference(st),
        lambda: convert.pt_state_from_reference({"chains": st, "betas": np.ones(2, np.float32)}),
        lambda: convert.acquisition_state_from_reference({**model, "K_inv": np.eye(2)}),
    )
    for call in calls:
        if torch.cuda.is_available():
            assert call()[0] is not None
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                call()
    assert convert.chain_state_from_reference(st, device="cpu").noise.device.type == "cpu"


# ---- the rest of ops/linalg -------------------------------------------------


def _spd(rng, n=12, rank=3):
    A = rng.standard_normal((n, n)).astype(np.float32)
    K = (A @ A.T / n + np.eye(n, dtype=np.float32)).astype(np.float32)
    U = (0.3 * rng.standard_normal((n, rank))).astype(np.float32)
    return K, np.linalg.inv(K.astype(np.float64)).astype(np.float32), U


@pytest.mark.parametrize("subtract", [False, True])
def test_linalg_updates_match_reference(subtract):
    import jax.numpy as jnp

    from bark_tpu.ops import linalg as jlin

    rng = np.random.default_rng(7 + subtract)
    K, K_inv, U = _spd(rng)
    y = rng.standard_normal(12).astype(np.float32)
    logdet = np.float32(np.linalg.slogdet(K.astype(np.float64))[1])
    t = torch.as_tensor

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)

    close(linalg.mll(t(K_inv), t(logdet), t(y)), jlin.mll(jnp.asarray(K_inv), logdet, y))
    close(linalg.low_rank_inv_update(t(K_inv), t(U), subtract),
          jlin.low_rank_inv_update(jnp.asarray(K_inv), jnp.asarray(U), subtract))
    close(linalg.low_rank_det_update(t(K_inv), t(U), t(logdet), subtract),
          jlin.low_rank_det_update(jnp.asarray(K_inv), jnp.asarray(U), logdet, subtract))
    got = linalg.rank1_inv_logdet_update(t(K_inv), t(logdet), t(U[:, 0]), subtract)
    want = jlin.rank1_inv_logdet_update(jnp.asarray(K_inv), logdet, jnp.asarray(U[:, 0]),
                                        subtract)
    for g, w in zip(got, want):
        close(g, w)
    # and against a dense recomputation in float64
    sign = -1.0 if subtract else 1.0
    K2 = K.astype(np.float64) + sign * (U @ U.T)
    np.testing.assert_allclose(linalg.low_rank_inv_update(t(K_inv), t(U), subtract).numpy(),
                               np.linalg.inv(K2), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        linalg.low_rank_det_update(t(K_inv), t(U), t(logdet), subtract).item(),
        np.linalg.slogdet(K2)[1], rtol=1e-5)


def test_rank1_update_reports_a_failed_subtraction():
    """denom = 1 - w^T K^-1 w <= 0 when the subtraction leaves K indefinite:
    the caller rejects."""
    K_inv = torch.eye(3)
    w = torch.tensor([1.0, 1.0, 0.0])
    _, _, denom = linalg.rank1_inv_logdet_update(K_inv, torch.tensor(0.0), w, subtract=True)
    assert denom.item() <= 0.0


# ---- the stationarity script --------------------------------------------------


def test_stationary_data_equals_the_reference_tools():
    from bark_tpu_torch.benchmarks import stationary

    spec = importlib.util.spec_from_file_location(
        "selfparity_stationary", REPO / "tools" / "selfparity_stationary.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for got, want in zip(stationary.make_data(), tool.make_data()):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_stationary_script_runs_end_to_end(tmp_path):
    """A toy size on the CPU: 4 chains, N=64, 24 steps an arm, the leaf tier
    against the chol oracle. It writes each arm's file and the comparison."""
    import json

    proc = subprocess.run(
        [sys.executable, "-m", "bark_tpu_torch.benchmarks.stationary", "--arms",
         "leaf@64,chol@64", "--chains", "4", "--warmup", "16", "--samples", "4", "--thin", "2",
         "--chunk", "8", "--device", "cpu", "--out-dir", str(tmp_path)],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads((tmp_path / "stationary.json").read_text())
    assert set(summary["convergence"]) == {"leaf@64", "chol@64"}
    rows = summary["rows"]
    assert {(r["a"], r["b"], r["metric"]) for r in rows} == {
        ("leaf@64", "chol@64", m) for m in ("noise_mean", "leaves_per_tree", "leaf_depth_mean")}
    assert all(np.isfinite(r["z"]) for r in rows)
    for arm in ("leaf_n64", "chol_n64"):
        res = json.loads((tmp_path / f"stationary_{arm}.json").read_text())
        assert len(res["per_chain"]["noise_mean"]) == 4


def test_stationary_compares_n512_against_the_recorded_reference():
    from bark_tpu_torch.benchmarks import stationary

    chains = {"noise_mean": [0.1] * 8 + [0.102] * 8, "leaves_per_tree": [2.56] * 16,
              "leaf_depth_mean": [1.49, 1.5] * 8}
    rows = stationary.compare({"leaf@512": {"per_chain": chains}})
    oracle = [r for r in rows if r["b"] == "reference chol (TPU)"]
    assert len(oracle) == 1 and oracle[0]["pass"] is not None
    assert oracle[0]["b_mean"] == pytest.approx(0.100014, abs=1e-6)
    assert {r["b"] for r in rows} == {"reference chol (TPU)", "reference leaf (TPU)",
                                      "reference dense (TPU)"}


if __name__ == "__main__":
    reference_run(sys.argv[1])
