"""Tempered sampling on the port against the JAX reference, on the CPU.

The reference runs in a subprocess with JAX's x64 mode off, as in
tests/test_torch_sampler.py; this file is that subprocess's script too
(``python tests/test_torch_tempering.py OUT.npz``). It saves, on the mixed
domain of tests/fitting/test_sampler.py (m = 8, N = 20):

  - three tempered steps of 8 chains at beta 1, 0.3, 0.05, 1, ..., in the
    dense tier and in the pinned leaf tier;
  - four rounds of ``run_parallel_tempering`` (one ladder of R = 4);
  - ``swap_move`` at fixed MLLs for both parities on two ladders, and
    ``pt_swap_states`` on a fixed state;
  - three rounds of ``run_smc`` (P = 8, one mutation step) and the same
    rounds replayed with the reference's own functions, to expose each
    round's ancestors and accepts;

each with the draws rebuilt from its keys. The port replays those draws.
Every batched reference function runs at the one batch of 8 rows (the
draws and prior forests of a smaller batch are the first rows of 8), so
that each compiles once.
Tolerances are those of tests/test_torch_sampler.py (accepts, forests and
leaves exact up to a reported near-tie |log u - min(log a, 0)| < 1e-3;
MLL rtol 1e-4 / atol 1e-3), and for SMC: beta within 1e-6, ESS and
log-evidence rtol 1e-5, ancestors exact unless a cumulative weight lies
within 1e-6 of a resample position (reported).
"""

import sys

import numpy as np
import pytest
import torch

from test_torch_sampler import NOISE_FIELDS, _assert_close_state, _inputs, make_problem
from torch_support import run_reference

from bark_tpu_torch.convert import chain_state_from_reference, to_numpy
from bark_tpu_torch.domain import CategoricalInput, ContinuousInput, Domain, IntegerInput
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.fitting.proposals import ProposalNoise
from bark_tpu_torch.fitting.sampler import (
    BARKModel,
    KernState,
    StepDraws,
    draw_step,
    init_chain_state,
    step,
    step_with_info,
)
from bark_tpu_torch.forest import FOREST_FIELDS, Forest, create_empty_forest
from bark_tpu_torch.models.surrogate import BARKPriorSurrogate, BARKSurrogate
from bark_tpu_torch.parallel.smc import (
    SMCDraws,
    run_smc,
    smc_round,
    systematic_resample,
)
from bark_tpu_torch.parallel.tempering import (
    PTDraws,
    geometric_ladder,
    pt_swap_states,
    run_parallel_tempering,
    swap_move,
)

M = 8
N = 20
NEAR_TIE = 1e-3
LEAF_PINS = {"scan_style": "coeff", "refresh_style": "leaf"}
STEP_CASES = {"dense": {}, "leaf": LEAF_PINS}
P, SMC_ROUNDS = 8, 3
BETAS = (1.0, 0.3, 0.05) * 2 + (1.0, 0.3)  # one per row of P
STEPS = 3
R, PT_ROUNDS = 4, 4
SWAP_R = 6


def reference_run(out_path: str) -> None:
    """The JAX side (run as a script, x64 off)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from bark_tpu.fitting.params import SamplerParams as JaxParams
    from bark_tpu.fitting.prior import sample_forest_prior, sample_noise_prior
    from bark_tpu.fitting.proposals import make_proposal_noise
    from bark_tpu.fitting.sampler import _propose_all_trees, _resolve_styles, init_chain_state
    from bark_tpu.fitting.sampler import step as jax_step
    from bark_tpu.forest import pack_forest
    from bark_tpu.parallel import smc as jsmc
    from bark_tpu.parallel import tempering as jpt

    out = {}
    bounds, ft, X, y = (jnp.asarray(a) for a in make_problem(N))

    def step_draws(k):
        k_trees, k_hyper, k_hyper_accept = jax.random.split(k, 3)
        k_noise, k_scale = jax.random.split(k_hyper)
        return (
            make_proposal_noise(k_trees, M, 64),
            jax.random.normal(k_noise, dtype=jnp.float32),
            jax.random.normal(k_scale, dtype=jnp.float32),
            jax.random.uniform(k_hyper_accept, dtype=jnp.float32),
        )

    draws_of = jax.jit(jax.vmap(step_draws))

    def save_draws(tag, keys):
        n = keys.shape[0]
        pn, z_noise, z_scale, u_hyper = draws_of(jnp.concatenate([keys, keys[: P - n]]))
        for f in NOISE_FIELDS:
            out[f"{tag}/{f}"] = np.asarray(getattr(pn, f))[:n]
        out[f"{tag}/z_noise"] = np.asarray(z_noise)[:n]
        out[f"{tag}/z_scale"] = np.asarray(z_scale)[:n]
        out[f"{tag}/u_hyper"] = np.asarray(u_hyper)[:n]

    def prior(key, n):
        forests = sample_forest_prior(key, M, bounds, ft, num_samples=P)
        return jax.tree.map(lambda a: a[:n], forests)

    def save_state(tag, st):
        for k in FOREST_FIELDS:
            out[f"{tag}/forest.{k}"] = np.asarray(getattr(st.forest, k))
        for k in ("leaves", "noise", "scale", "mll"):
            out[f"{tag}/{k}"] = np.asarray(getattr(st, k))
        for k in ("K", "K_inv", "K_logdet"):
            out[f"{tag}/{k}"] = np.asarray(getattr(st.kern, k))

    def tools(params):
        """(init, step) jitted over the rows; the step also returns each
        move's proposal, which XLA shares with the step's own."""
        resolved = _resolve_styles(params, N)
        init = jax.jit(jax.vmap(
            lambda f, nz, sc: init_chain_state(f, nz, sc, X, y, ft, params, bounds=bounds)))

        def step_and_proposal(k, s, b):
            proposal = _propose_all_trees(jax.random.split(k, 3)[0], s, X, ft, bounds, resolved)
            return jax_step(k, s, X, y, bounds, ft, params, beta=b), proposal

        return init, jax.jit(jax.vmap(step_and_proposal))

    def stepped(stepj, tag, keys, before, betas):
        """The step's new state; its accept code per move under ``tag``: 1
        accepted, 0 rejected, -1 undecidable from the states (the proposal
        left the tree as it was)."""
        after, (packed0, batch) = stepj(keys, before, betas)
        new, old = np.asarray(batch.new_packed), np.asarray(packed0)
        final = np.asarray(pack_forest(after.forest))
        same = (new == old).all(axis=(-2, -1))
        took = (final == new).all(axis=(-2, -1))
        out[f"{tag}/accept"] = np.where(same, -1, took.astype(np.int64))
        return after

    # --- tempered steps in both tiers
    tools_of = {case: tools(JaxParams(num_trees=M, **pins)) for case, pins in STEP_CASES.items()}
    for case, (init, stepj) in tools_of.items():
        state = init(prior(jax.random.key(1), P),
                     jnp.resize(jnp.asarray([0.1, 0.3, 0.2], jnp.float32), P),
                     jnp.resize(jnp.asarray([1.0, 0.7, 1.2], jnp.float32), P))
        save_state(f"{case}/s0", state)
        betas = jnp.asarray(BETAS, jnp.float32)
        keys = jax.random.split(jax.random.key(2), P)
        for s in range(STEPS):
            pair = jax.vmap(jax.random.split)(keys)
            keys, k = pair[:, 0], pair[:, 1]
            save_draws(f"{case}/d{s}", k)
            state = stepped(stepj, f"{case}/d{s}", k, state, betas)
            save_state(f"{case}/s{s + 1}", state)

    # --- parallel tempering, one ladder of R (the dense case's parameters)
    params = JaxParams(num_trees=M)
    init, stepj = tools_of["dense"]
    forests = prior(jax.random.key(3), R)
    noise0, scale0 = jnp.full((R,), 0.3, jnp.float32), jnp.ones((R,), jnp.float32)
    for k in FOREST_FIELDS:
        out[f"pt/forest0.{k}"] = np.asarray(getattr(forests, k))
    samples, beta_trace, swap_rate, cold_mll = jpt.run_parallel_tempering(
        jax.random.key(4), forests, noise0, scale0, X, y, bounds, ft, params,
        num_replicas=R, num_steps=PT_ROUNDS,
    )
    for k in FOREST_FIELDS:
        out[f"pt/cold.{k}"] = np.asarray(getattr(samples.forest, k))
    out["pt/cold_noise"], out["pt/cold_scale"] = np.asarray(samples.noise), np.asarray(samples.scale)
    out["pt/beta_trace"], out["pt/cold_mll"] = np.asarray(beta_trace), np.asarray(cold_mll)
    out["pt/swap_rate"] = np.asarray(swap_rate)
    out["pt/ladder"] = np.asarray(jpt.geometric_ladder(R))
    for t, k in enumerate(jax.random.split(jax.random.key(4), PT_ROUNDS)):
        k_steps, k_swap = jax.random.split(k)
        save_draws(f"pt/d{t}", jax.random.split(k_steps, R))
        out[f"pt/d{t}/u_swap"] = np.asarray(jax.random.uniform(k_swap, (R,)))

    # --- swap_move at fixed MLLs, two ladders, both parities
    rng = np.random.default_rng(5)
    ladder = np.asarray(jpt.geometric_ladder(SWAP_R))
    for lad in range(2):
        betas = ladder[rng.permutation(SWAP_R)]
        mlls = (rng.normal(size=SWAP_R) * 2.0).astype(np.float32)
        mlls[lad + 2] = np.nan if lad == 1 else mlls[lad + 2]
        out[f"swap{lad}/betas"], out[f"swap{lad}/mlls"] = betas, mlls
        for parity in (0, 1):
            key = jax.random.key(20 + 10 * lad + parity)
            out[f"swap{lad}/p{parity}/u"] = np.asarray(jax.random.uniform(key, (SWAP_R,)))
            out[f"swap{lad}/p{parity}/out"] = np.asarray(
                jpt.swap_move(key, jnp.asarray(betas), jnp.asarray(mlls), jnp.int32(parity)))

    # --- pt_swap_states on a fixed state
    chains = init(forests, noise0, scale0)
    save_state("pss/s0", chains)
    mlls = jnp.asarray([0.0, 0.4, -3.0, 0.1], jnp.float32)
    for parity in (0, 1):
        key = jax.random.key(40 + parity)
        out[f"pss/p{parity}/u"] = np.asarray(
            [jax.random.uniform(jax.random.fold_in(key, i)) for i in range(R)])
        new, acc = jpt.pt_swap_states(key, chains, jpt.geometric_ladder(R), mlls, parity)
        out[f"pss/p{parity}/accept"] = np.asarray(acc)
        save_state(f"pss/p{parity}", new)

    # --- SMC: run_smc, and its rounds replayed with the reference's functions
    k_forest, k_noise, k_rounds = jax.random.split(jax.random.key(7), 3)
    forests = sample_forest_prior(
        k_forest, M, bounds, ft, alpha=params.alpha, beta=params.beta, num_samples=P,
        node_limit=params.node_limit, max_depth=params.max_depth,
    )
    noises = sample_noise_prior(
        k_noise, params.gamma_prior_shape, params.gamma_prior_rate, P).astype(jnp.float32)
    for k in FOREST_FIELDS:
        out[f"smc/forest0.{k}"] = np.asarray(getattr(forests, k))
    out["smc/noise0"] = np.asarray(noises)
    res = jsmc.run_smc(jax.random.key(7), X, y, bounds, ft, params, num_particles=P,
                       num_rounds=SMC_ROUNDS, mutation_steps=1)
    for k in ("betas", "ess_trace", "log_evidence", "log_weights"):
        out[f"smc/run/{k}"] = np.asarray(getattr(res, k))
    out["smc/run/noise"] = np.asarray(res.model.noise)
    chains = init(forests, noises, jnp.ones((P,), jnp.float32))
    beta, log_w, log_z = jnp.float32(0.0), jnp.zeros((P,), jnp.float32), jnp.float32(0.0)
    for t, k in enumerate(jax.random.split(k_rounds, SMC_ROUNDS)):
        k_res, k_mut = jax.random.split(k)
        new_beta = jsmc._next_beta(beta, chains.mll, 0.6)
        inc = (new_beta - beta) * chains.mll
        log_z = log_z + jax.scipy.special.logsumexp(inc, b=jax.nn.softmax(log_w))
        log_w = log_w + inc
        do_resample = jsmc._ess(log_w) < 0.5 * P
        out[f"smc/r{t}/u_res"] = np.asarray(jax.random.uniform(k_res))
        out[f"smc/r{t}/cum"] = np.asarray(jnp.cumsum(jax.nn.softmax(log_w)))
        ancestors = jsmc.systematic_resample(k_res, log_w)
        idx = jnp.where(do_resample, ancestors, jnp.arange(P, dtype=jnp.int32))
        chains = jax.tree.map(lambda a: a[idx], chains)
        log_w = jnp.where(do_resample, jnp.zeros_like(log_w), log_w)
        step_keys = jax.vmap(lambda kk: jax.random.split(kk, 1)[0])(jax.random.split(k_mut, P))
        save_draws(f"smc/r{t}/d0", step_keys)
        chains = stepped(stepj, f"smc/r{t}", step_keys, chains, jnp.full((P,), new_beta))
        out[f"smc/r{t}/beta"], out[f"smc/r{t}/ancestors"] = np.asarray(new_beta), np.asarray(idx)
        out[f"smc/r{t}/log_z"], out[f"smc/r{t}/ess"] = np.asarray(log_z), np.asarray(jsmc._ess(log_w))
        save_state(f"smc/r{t}", chains)
        beta = new_beta
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(__file__, tmp_path_factory.mktemp("reference"), "reference.npz")


def _state(ref, tag):
    return {
        "forest": {k: ref[f"{tag}/forest.{k}"] for k in FOREST_FIELDS},
        "kern": {k: ref[f"{tag}/{k}"] for k in ("K", "K_inv", "K_logdet")},
        **{k: ref[f"{tag}/{k}"] for k in ("leaves", "noise", "scale", "mll")},
    }


def _draws(ref, tag) -> StepDraws:
    get = lambda f: torch.as_tensor(ref[f"{tag}/{f}"])  # noqa: E731
    return StepDraws(ProposalNoise(*(get(f) for f in NOISE_FIELDS)),
                     get("z_noise"), get("z_scale"), get("u_hyper"))


def _forest(ref, tag) -> Forest:
    return Forest(*(torch.as_tensor(ref[f"{tag}.{k}"]) for k in FOREST_FIELDS))


def _row(state, c):
    one = lambda t: t[c : c + 1]  # noqa: E731
    return type(state)(state.forest, state.leaves, one(state.noise), one(state.scale),
                       KernState(*(None if t is None else one(t) for t in state.kern)),
                       one(state.mll))


def _check_step(tag, state, info, draws, want, codes, prev_noise, parted, decided):
    """Every row that has not parted decides each move as the reference did
    (or parts at a reported near-tie), and then holds the reference's state."""
    log_u = torch.log(draws.proposal.u_accept)
    gap = (log_u - torch.clamp_max(info.tree_log_alpha, 0.0)).abs()
    for c in range(state.noise.shape[0]):
        if parted[c]:
            continue
        acc = info.tree_accepts[c].numpy()
        for v in (0, 1):
            decided[v] += int((codes[c] == v).sum())
        wrong = np.nonzero((codes[c] >= 0) & (acc != (codes[c] == 1)))[0]
        hyper_wrong = bool(info.hyper_accept[c]) != (want["noise"][c] != prev_noise[c])
        if wrong.size or hyper_wrong:
            g = (gap[c, wrong[0]] if wrong.size else (
                torch.log(draws.u_hyper[c]) - torch.clamp_max(info.hyper_log_alpha[c], 0.0)).abs()).item()
            assert g < NEAR_TIE, f"{tag} row {c}: decision differs, gap {g}"
            print(f"{tag} row {c}: near-tie (gap {g:.2e}); row parted")
            parted[c] = True
            continue
        for k in FOREST_FIELDS:
            np.testing.assert_array_equal(getattr(state.forest, k)[c].numpy(), want["forest"][k][c],
                                          err_msg=f"{tag} row {c} forest.{k}")
        np.testing.assert_array_equal(state.leaves[c].numpy(), want["leaves"][c])
        _assert_close_state(
            _row(state, c),
            {"noise": want["noise"][c : c + 1], "scale": want["scale"][c : c + 1],
             "mll": want["mll"][c : c + 1],
             "kern": {k: v[c : c + 1] for k, v in want["kern"].items()}},
            f"{tag} row {c}",
        )


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_beta_one_is_the_plain_step_bit_for_bit(reference, case):
    """beta = 1.0 and beta = ones(C) give the plain step's state and
    decisions exactly, in both tiers (the port's twin of the reference's
    test_beta_one_matches_plain_step)."""
    X, y, bounds, ft = _inputs(N)
    params = SamplerParams(num_trees=M, **STEP_CASES[case])
    state = chain_state_from_reference(_state(reference, f"{case}/s0"), device="cpu")
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        draws = draw_step(gen, len(BETAS), params)
        plain, info = step_with_info(state, X, y, bounds, ft, params, draws)
        for beta in (1.0, torch.ones(len(BETAS))):
            got, ginfo = step_with_info(state, X, y, bounds, ft, params, draws, beta=beta)
            for a, b in zip(to_numpy(got).values(), to_numpy(plain).values()):
                if isinstance(a, dict):
                    assert all(np.array_equal(a[k], b[k], equal_nan=True) for k in a)
                else:
                    assert np.array_equal(a, b, equal_nan=True)
            for a, b in zip(ginfo, info):
                assert torch.equal(a, b)
        assert torch.equal(step(state, X, y, bounds, ft, params, draws, beta=1.0).forest.threshold,
                           plain.forest.threshold)
        state = plain


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_tempered_steps_replay_reference(reference, case):
    """Three steps at per-row beta (1, 0.3, 0.05) replay the reference's."""
    X, y, bounds, ft = _inputs(N)
    params = SamplerParams(num_trees=M, **STEP_CASES[case])
    state = chain_state_from_reference(_state(reference, f"{case}/s0"), device="cpu")
    assert (state.kern.L is not None) == (case == "leaf")
    betas = torch.tensor(BETAS)
    parted, decided = [False] * len(BETAS), {0: 0, 1: 0}
    for s in range(STEPS):
        draws = _draws(reference, f"{case}/d{s}")
        prev = reference[f"{case}/s{s}/noise"]
        state, info = step_with_info(state, X, y, bounds, ft, params, draws, beta=betas)
        _check_step(f"{case} step {s}", state, info, draws, _state(reference, f"{case}/s{s + 1}"),
                    reference[f"{case}/d{s}/accept"], prev, parted, decided)
    assert not all(parted) and decided[0] > 0 and decided[1] > 0, decided


def test_tempering_effect_hot_grows_more():
    """At beta = 0.02 the likelihood barely gates the moves: hot chains grow
    more nodes than cold ones over the same 30 steps and sit at a lower MLL
    (the reference's test_tempering_effect_hot_grows_more, 6 chains each)."""
    bounds, ft, X, y = (torch.as_tensor(a) for a in make_problem(25))
    params = SamplerParams(num_trees=8)
    c = 6
    state0 = init_chain_state(create_empty_forest(8, 64, (2 * c,)), 0.1, 1.0, X, y, ft, params,
                              bounds=bounds)
    beta = torch.cat([torch.full((c,), 0.02), torch.ones(c)])
    gen = torch.Generator().manual_seed(0)
    state = state0
    for _ in range(30):
        state = step(state, X, y, bounds, ft, params, draw_step(gen, 2 * c, params), beta=beta)
    nodes = state.forest.active.sum((1, 2)).float()
    assert nodes[:c].mean() > nodes[c:].mean(), nodes
    assert state.mll[:c].mean() <= state.mll[c:].mean(), state.mll


def test_geometric_ladder_matches_reference(reference):
    ladder = geometric_ladder(R)
    assert ladder.dtype == torch.float32 and ladder[0] == 1.0
    np.testing.assert_array_equal(ladder.numpy(), reference["pt/ladder"])
    assert torch.equal(geometric_ladder(1), torch.ones(1))


def test_swap_move_matches_reference(reference):
    """Both parities on two ladders (one with a NaN MLL, which never swaps),
    each alone and batched as a (2, R) ladder axis."""
    for parity in (0, 1):
        us, bs, ms, wants = [], [], [], []
        for lad in range(2):
            u = torch.as_tensor(reference[f"swap{lad}/p{parity}/u"])
            b = torch.as_tensor(reference[f"swap{lad}/betas"])
            m = torch.as_tensor(reference[f"swap{lad}/mlls"])
            want = reference[f"swap{lad}/p{parity}/out"]
            got = swap_move(u, b, m, parity)
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(np.sort(got.numpy()), np.sort(b.numpy()))
            us.append(u), bs.append(b), ms.append(m), wants.append(want)
        batched = swap_move(torch.stack(us), torch.stack(bs), torch.stack(ms), parity)
        np.testing.assert_array_equal(batched.numpy(), np.stack(wants))
    nan_at = np.isnan(reference["swap1/mlls"])
    for parity in (0, 1):
        out = reference[f"swap1/p{parity}/out"]
        np.testing.assert_array_equal(out[nan_at], reference["swap1/betas"][nan_at])
    # some pair swapped and some did not
    moved = [(reference[f"swap{lad}/p{p}/out"] != reference[f"swap{lad}/betas"]).any()
             for lad in range(2) for p in (0, 1)]
    assert any(moved)


def test_pt_swap_states_matches_reference(reference):
    chains = chain_state_from_reference(_state(reference, "pss/s0"), device="cpu")
    mlls = torch.tensor([0.0, 0.4, -3.0, 0.1])
    for parity in (0, 1):
        u = torch.as_tensor(reference[f"pss/p{parity}/u"])
        new, acc = pt_swap_states(u, chains, geometric_ladder(R), mlls, parity)
        np.testing.assert_array_equal(acc.numpy(), reference[f"pss/p{parity}/accept"])
        want = _state(reference, f"pss/p{parity}")
        for k in FOREST_FIELDS:
            np.testing.assert_array_equal(getattr(new.forest, k).numpy(), want["forest"][k])
        for k in ("leaves", "noise", "scale", "mll"):
            np.testing.assert_array_equal(getattr(new, k).numpy(), want[k])
        np.testing.assert_array_equal(new.kern.K_inv.numpy(), want["kern"]["K_inv"])
    assert reference["pss/p0/accept"].any() or reference["pss/p1/accept"].any()


def test_parallel_tempering_replays_reference(reference):
    """Four rounds of run_parallel_tempering from the reference's draws: the
    beta trace exactly, the cold samples and cold MLL trace within the
    sampler's tolerances, the ladder multiset every round."""
    X, y, bounds, ft = _inputs(N)
    params = SamplerParams(num_trees=M)
    draws = [PTDraws(_draws(reference, f"pt/d{t}"),
                     torch.as_tensor(reference[f"pt/d{t}/u_swap"])[None])
             for t in range(PT_ROUNDS)]
    samples, beta_trace, swap_rate, cold_mll, _ = run_parallel_tempering(
        None, _forest(reference, "pt/forest0"), torch.full((R,), 0.3), torch.ones(R), X, y,
        bounds, ft, params, num_replicas=R, num_steps=PT_ROUNDS, draws=draws,
    )
    assert beta_trace.shape == (PT_ROUNDS, R) and cold_mll.shape == (PT_ROUNDS,)
    assert samples.noise.shape == (PT_ROUNDS,) and samples.forest.is_leaf.shape == (PT_ROUNDS, M, 64)
    np.testing.assert_array_equal(beta_trace.numpy(), reference["pt/beta_trace"])
    ladder = np.sort(geometric_ladder(R).numpy())
    for row in beta_trace.numpy():
        np.testing.assert_array_equal(np.sort(row), ladder)
    for k in FOREST_FIELDS:
        np.testing.assert_array_equal(getattr(samples.forest, k).numpy(), reference[f"pt/cold.{k}"])
    np.testing.assert_allclose(samples.noise.numpy(), reference["pt/cold_noise"], rtol=1e-6)
    np.testing.assert_allclose(samples.scale.numpy(), reference["pt/cold_scale"], rtol=1e-6)
    np.testing.assert_allclose(cold_mll.numpy(), reference["pt/cold_mll"], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(float(swap_rate), float(reference["pt/swap_rate"]), rtol=1e-6)


def test_smc_rounds_replay_reference(reference):
    """Three SMC rounds from the reference's initial particles and draws:
    beta within 1e-6, ESS and log-evidence rtol 1e-5, ancestors exact (or a
    reported near-tie of a cumulative weight and a resample position),
    accepts and states as in the sampler's replay. Then run_smc itself
    against the reference's run_smc."""
    X, y, bounds, ft = _inputs(N)
    params = SamplerParams(num_trees=M)
    particles = BARKModel(_forest(reference, "smc/forest0"),
                          torch.as_tensor(reference["smc/noise0"]), torch.ones(P))
    chains = init_chain_state(particles.forest, particles.noise, particles.scale, X, y, ft,
                              params, bounds=bounds)
    beta, log_w, log_z = torch.zeros(()), torch.zeros(P), torch.zeros(())
    parted, decided = [False] * P, {0: 0, 1: 0}
    prev_noise = chains.noise.numpy()
    rounds = []
    for t in range(SMC_ROUNDS):
        draws = SMCDraws(torch.as_tensor(reference[f"smc/r{t}/u_res"]),
                         (_draws(reference, f"smc/r{t}/d0"),))
        rounds.append(draws)
        out = smc_round(chains, beta, log_w, log_z, draws, X, y, bounds, ft, params)
        np.testing.assert_allclose(out.beta.item(), reference[f"smc/r{t}/beta"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(out.log_evidence.item(), reference[f"smc/r{t}/log_z"], rtol=1e-5)
        np.testing.assert_allclose(out.ess.item(), reference[f"smc/r{t}/ess"], rtol=1e-5)
        want_idx = reference[f"smc/r{t}/ancestors"]
        if not np.array_equal(out.ancestors.numpy(), want_idx):
            cum = reference[f"smc/r{t}/cum"]
            pos = (np.arange(P) + reference[f"smc/r{t}/u_res"]) / P
            tie = np.abs(cum[:, None] - pos[None, :]).min()
            assert tie < 1e-6, f"round {t}: ancestors differ away from a tie ({tie})"
            print(f"round {t}: ancestors part at a near-tie ({tie:.2e}); stop")
            break
        # the mutation started from the resampled particles
        prev = prev_noise[want_idx]
        _check_step(f"smc round {t}", out.chains, out.infos[0], draws.steps[0],
                    _state(reference, f"smc/r{t}"), reference[f"smc/r{t}/accept"], prev,
                    parted, decided)
        chains, beta, log_w, log_z = out.chains, out.beta, out.log_w, out.log_evidence
        prev_noise = reference[f"smc/r{t}/noise"]
    assert decided[0] > 0 and decided[1] > 0, decided
    res = run_smc(None, X, y, bounds, ft, params, num_particles=P, num_rounds=SMC_ROUNDS,
                  mutation_steps=1, particles=particles, draws=rounds)
    np.testing.assert_allclose(res.betas.numpy(), reference["smc/run/betas"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(res.ess_trace.numpy(), reference["smc/run/ess_trace"], rtol=1e-5)
    np.testing.assert_allclose(res.log_evidence.item(), reference["smc/run/log_evidence"], rtol=1e-5)
    np.testing.assert_allclose(torch.exp(res.log_weights).sum().item(), 1.0, rtol=1e-5)


def test_systematic_resample_unbiased():
    log_w = torch.log(torch.tensor([0.1, 0.2, 0.3, 0.4]))
    gen = torch.Generator().manual_seed(0)
    idx = torch.stack([systematic_resample(torch.rand((), generator=gen), log_w)
                       for _ in range(400)])
    counts = [(idx == i).float().mean().item() for i in range(4)]
    np.testing.assert_allclose(counts, [0.1, 0.2, 0.3, 0.4], atol=0.02)


def _tree_problem(n=20, seed=0, dim=2, m=6):
    from bark_tpu_torch.benchmarks.tree_function import TreeFunction

    bench = TreeFunction(dim=dim, m=m, function_seed=1)
    X = bench.domain.sample(n, np.random.default_rng(seed))
    y = bench.f(X)
    y = (y - y.mean()) / max(y.std(), 1e-6)
    return (bench, torch.as_tensor(X), torch.as_tensor(y, dtype=torch.float32),
            torch.as_tensor(bench.domain.bounds("bitmask")),
            torch.as_tensor(bench.domain.feature_types()))


def test_smc_reaches_the_posterior():
    """From the port's own prior: a non-decreasing schedule that reaches 1,
    a finite log-evidence and weights summing to 1 (the reference's
    test_smc_reaches_posterior)."""
    _, X, y, bounds, ft = _tree_problem()
    res = run_smc(torch.Generator().manual_seed(0), X, y, bounds, ft,
                  SamplerParams(num_trees=5), num_particles=16, num_rounds=12, mutation_steps=1)
    betas = res.betas.numpy()
    assert (np.diff(betas) >= -1e-6).all() and betas[-1] == 1.0, betas
    assert np.isfinite(res.log_evidence.item()) and res.model.noise.shape == (16,)
    np.testing.assert_allclose(torch.exp(res.log_weights).sum().item(), 1.0, rtol=1e-4)


def test_parallel_tempering_batched_ladders_and_padding():
    """Two ladders run as one (C, R) batch; the same run on padded data (a
    row mask) takes the same decisions and the same MLLs; each ladder's
    betas stay a permutation of the ladder; ``keep`` keeps only the asked
    rounds."""
    _, X, y, bounds, ft = _tree_problem()
    params = SamplerParams(num_trees=5)
    c, r, t = 2, 4, 6
    forest = create_empty_forest(5, params.node_limit, (c, r))
    noise, scale = torch.full((c, r), 0.1), torch.ones(c, r)
    pad = 12
    Xp = torch.cat([X, X[:1].expand(pad, -1)])
    yp = torch.cat([y, torch.zeros(pad)])
    mask = torch.cat([torch.ones(N), torch.zeros(pad)])
    runs = [
        run_parallel_tempering(torch.Generator().manual_seed(3), forest, noise, scale, X_, y_,
                               bounds, ft, params, num_replicas=r, num_steps=t, mask=mask_,
                               keep=slice(1, None, 2))
        for X_, y_, mask_ in ((X, y, None), (Xp, yp, mask))
    ]
    (samples, betas, swap, cold, _), (psamples, pbetas, pswap, pcold, _) = runs
    assert samples.noise.shape == (c, 3) and samples.forest.is_leaf.shape == (c, 3, 5, 64)
    assert betas.shape == (t, c, r) and swap.shape == (c,) and cold.shape == (c, t)
    ladder = np.sort(geometric_ladder(r).numpy())
    for row in betas.reshape(-1, r).numpy():
        np.testing.assert_array_equal(np.sort(row), ladder)
    assert bool(((swap >= 0) & (swap <= 1)).all())
    assert torch.equal(betas, pbetas) and torch.equal(swap, pswap)
    for a, b in zip(samples.forest, psamples.forest):
        assert torch.equal(a, b)
    assert torch.equal(samples.noise, psamples.noise)
    torch.testing.assert_close(pcold, cold, rtol=1e-4, atol=1e-3)


def test_tempered_entry_points_refuse_reduced_matmul_precision():
    _, X, y, bounds, ft = _tree_problem()
    params = SamplerParams(num_trees=5)
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="highest|allow_tf32"):
            run_parallel_tempering(torch.Generator(), create_empty_forest(5, 64, (2,)),
                                   torch.full((2,), 0.1), torch.ones(2), X, y, bounds, ft,
                                   params, num_replicas=2, num_steps=1)
        with pytest.raises(RuntimeError, match="highest|allow_tf32"):
            run_smc(torch.Generator(), X, y, bounds, ft, params, num_particles=4, num_rounds=1)
        sur = BARKPriorSurrogate(_tree_problem()[0].domain, device="cpu")
        with pytest.raises(RuntimeError, match="highest|allow_tf32"):
            sur.fit(X.numpy(), y.numpy())
    finally:
        torch.set_float32_matmul_precision(before)


# --- surrogates (tests/models/test_tempered_fit.py on the port) ------------

FAST = SamplerParams(warmup_steps=6, num_samples=3, steps_per_sample=2, num_chains=2,
                     num_trees=8)


def _surrogate_problem(n=24, seed=0):
    from bark_tpu_torch.benchmarks.tree_function import TreeFunction

    bench = TreeFunction(dim=3, m=10, function_seed=1)
    X = bench.domain.sample(n, np.random.default_rng(seed))
    return bench, X, bench.f(X)


def test_tempered_fit_shapes_diagnostics_and_warm_start(monkeypatch):
    """The reference's shapes ((C, num_samples) noise), a swap rate in
    [0, 1], predict; the warm start tiles each chain's last sample over its
    ladder, skips warmup, and keeps only the thinned rounds."""
    import bark_tpu_torch.models.surrogate as mod

    bench, X, y = _surrogate_problem()
    sur = BARKSurrogate(bench.domain, FAST, seed=0, fit_style="tempered", num_replicas=4,
                        device="cpu")
    calls = []
    real = mod.run_parallel_tempering

    def spy(gen, forest, noise, scale, *a, **k):
        calls.append((forest, noise, k["num_steps"], k["keep"]))
        return real(gen, forest, noise, scale, *a, **k)

    monkeypatch.setattr(mod, "run_parallel_tempering", spy)
    sur.fit(X, y)
    assert sur.model.noise.shape == (FAST.num_chains, FAST.num_samples)
    assert sur.model.forest.is_leaf.shape == (FAST.num_chains, FAST.num_samples, 8, 64)
    assert np.isfinite(sur.model.noise.numpy()).all()
    d = sur.fit_diagnostics
    assert set(d) >= {"r_hat_noise", "ess_noise", "swap_rate"} and 0.0 <= d["swap_rate"] <= 1.0
    mu, std = sur.predict(X[:5])
    assert mu.shape == (5, 1) and np.isfinite(mu).all() and (std > 0).all()
    first = sur.model
    X2 = np.vstack([X, bench.domain.sample(8, np.random.default_rng(9))])
    sur.fit(X2, bench.f(X2))
    assert sur.model.noise.shape == (FAST.num_chains, FAST.num_samples)
    (_, _, steps0, keep0), (forest1, noise1, steps1, keep1) = calls
    assert (steps0, keep0) == (12, slice(7, None, 2)) and (steps1, keep1) == (6, slice(1, None, 2))
    assert noise1.shape == (FAST.num_chains, 4)
    assert torch.equal(noise1, first.noise[:, -1:].expand(-1, 4))
    assert torch.equal(forest1.threshold, first.forest.threshold[:, -1:].expand(-1, 4, -1, -1))


def test_chains_fit_records_no_swap_rate():
    bench, X, y = _surrogate_problem()
    sur = BARKSurrogate(bench.domain, FAST, seed=0, device="cpu").fit(X, y)
    assert "r_hat_noise" in sur.fit_diagnostics and "swap_rate" not in sur.fit_diagnostics
    assert sur.model_as_tuple() is sur.model


def test_tempered_strategy_end_to_end():
    from bark_tpu_torch.strategies.tree_kernel import TreeKernelStrategy

    bench, X, y = _surrogate_problem(n=12)
    sur = BARKSurrogate(bench.domain, FAST, seed=0, fit_style="tempered", num_replicas=4,
                        device="cpu")
    strat = TreeKernelStrategy(bench.domain, surrogate=sur, seed=0, num_candidates=128,
                               num_rounds=2)
    strat.tell(X, y)
    lo, hi = bench.domain.bounds("ordinal").T
    for _ in range(2):
        c = strat.ask(1)
        assert c.shape == (1, 3) and ((lo <= c[0]) & (c[0] <= hi)).all()
        strat.add(c, bench.f(c))
    assert strat.fallbacks == 0


def _reference_prior_surrogate():
    import jax

    from bark_tpu.domain import Domain as JaxDomain
    from bark_tpu.domain import CategoricalInput as JCat, ContinuousInput as JCont
    from bark_tpu.domain import IntegerInput as JInt
    from bark_tpu.models.surrogate import BARKPriorSurrogate as JaxPrior

    dom = JaxDomain([JCont("x_0", (0.0, 1.0)), JCont("x_1", (-2.0, 3.0)),
                     JInt("i_0", (0, 5)), JCat("c_0", ("a", "b", "c", "d"))])
    rng = np.random.default_rng(4)
    X = dom.sample(N, rng)
    y = np.sin(3 * X[:, 0]) + 0.1 * rng.standard_normal(N)
    with jax.enable_x64(False):
        ref = JaxPrior(dom, num_samples=6, seed=3).fit(X, y)
    return ref, dom, X


def test_prior_surrogate_from_reference_predicts_as_the_reference():
    """A fitted reference BARKPriorSurrogate, converted: mu and std within
    1e-4 of the reference's, batched and mixed."""
    import jax

    from bark_tpu_torch.convert import surrogate_from_reference

    ref, dom, _ = _reference_prior_surrogate()
    port = surrogate_from_reference(ref, device="cpu")
    assert isinstance(port, BARKPriorSurrogate) and port.num_samples == 6
    Xq = dom.sample(32, np.random.default_rng(5))
    for batched in (False, True):
        with jax.enable_x64(False):
            mu_ref, std_ref = ref.predict(Xq, batched=batched)
        mu, std = port.predict(Xq, batched=batched)
        assert mu.shape == mu_ref.shape
        np.testing.assert_allclose(mu, mu_ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(std, std_ref, rtol=1e-4, atol=1e-4)


def test_prior_surrogate_fits_draws_and_padding_is_inert():
    """The fit draws (S,) prior samples with the Gamma(2.5, 9) noise prior
    and scale 1; the same draws predict the same from the bucket-padded
    training set as from the unpadded one."""
    dom = Domain([ContinuousInput("x_0", (0.0, 1.0)), IntegerInput("i_0", (0, 5)),
                  CategoricalInput("c_0", ("a", "b", "c"))])
    rng = np.random.default_rng(1)
    X = dom.sample(N, rng)
    y = np.cos(4 * X[:, 0]) + X[:, 1] * 0.1
    sur = BARKPriorSurrogate(dom, num_samples=7, seed=2, device="cpu").fit(X, y)
    assert sur.params.gamma_prior_shape == 2.5 and sur.params.gamma_prior_rate == 9.0
    assert sur.model.noise.shape == (7,) and torch.equal(sur.model.scale, torch.ones(7))
    assert sur.model.forest.is_leaf.shape == (7, 50, 64) and bool((sur.model.noise > 0).all())
    assert sur.train_data[0].shape[0] == 32 and sur.model_as_tuple() is sur.model
    Xq = dom.sample(16, rng)
    mu, std = sur.predict(Xq, batched=True)
    x_pad, y_pad = sur.train_data
    sur.train_data, sur.train_mask = (x_pad[:N], y_pad[:N]), None
    mu0, std0 = sur.predict(Xq, batched=True)
    np.testing.assert_allclose(mu, mu0, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(std, std0, rtol=1e-5, atol=1e-5)
    again = BARKPriorSurrogate(dom, num_samples=7, seed=2, device="cpu").fit(X, y)
    assert torch.equal(again.model.noise, sur.model.noise)


def test_make_strategy_bark_prior_tells_and_asks():
    from bark_tpu_torch.strategies.tree_kernel import make_strategy

    bench, X, y = _surrogate_problem(n=10)
    s = make_strategy("BARKPrior", bench.domain, seed=0, device="cpu", num_candidates=128,
                      num_rounds=2)
    s.tell(X, y)
    lo, hi = bench.domain.bounds("ordinal").T
    for _ in range(2):
        c = s.ask(1)
        assert c.shape == (1, 3) and ((lo <= c[0]) & (c[0] <= hi)).all()
        s.add(c, bench.f(c))
    assert s.fallbacks == 0 and s.surrogate.model.noise.shape == (5,)


def test_convert_pt_state(reference):
    from bark_tpu_torch.convert import pt_state_from_reference

    st = pt_state_from_reference({"chains": _state(reference, "pss/s0"),
                                  "betas": reference["pt/ladder"]}, device="cpu")
    assert st.betas.shape == (1, R) and st.chains.noise.shape == (R,)
    np.testing.assert_array_equal(st.betas[0].numpy(), reference["pt/ladder"])


if __name__ == "__main__":
    reference_run(sys.argv[1])
