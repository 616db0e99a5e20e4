"""Trajectory parity of the port's sampler with the JAX reference.

The reference run happens in a subprocess with JAX's x64 mode off: the
suite turns x64 on (tests/conftest.py), and under x64 the reference draws
its proposal noise in float64 and follows another float32 trajectory than
the command-line one. This file is that subprocess's script too
(``python tests/test_torch_sampler.py OUT.npz``): it runs ``init_chain_state``
and ``step`` of ``bark_tpu`` on the mixed domain of
tests/fitting/test_sampler.py (2 chains, m=8 trees, prior forests) and
saves the states, the accept decisions and every step's draws rebuilt from
the step keys. The port then replays the same draws from the converted
initial state.

Tolerances (float32 on both sides, different LAPACK/XLA and PyTorch
kernels, and transcendentals that round differently in the last ulp):

  - forest, leaves and per-move accept decisions: exact, except at a
    reported near-tie |log u - min(log a, 0)| < 1e-3, after which that
    chain's two trajectories part and are not compared further;
  - noise and scale: rtol 1e-6 (a proposed noise goes through log, expm1,
    exp and log1p, one ulp apart between the two packages);
  - MLL and logdet: rtol 1e-4 / atol 1e-3, and K^-1: rtol 1e-3 /
    atol 2e-3, the reference's own maintained-vs-rebuilt tolerances
    (tests/fitting/test_sampler.py);
  - the leaf tier's carried factor L of A = (nu/gamma) I + Z^T Z: within
    1e-5 of max |L| (entries up to sqrt(N); two float32 Cholesky orderings
    of the same integer-plus-ridge matrix).

The cases cover both tiers: the dense tier at N=20 and at a ragged N=150;
the leaf tier pinned (``coeff``/``leaf``) at N=20, resolved from ``auto``
at N=256 (budget R=128 at m=8), and pinned with ``leaf_budget = m + 2``
from stumps, where the capacity guard rejects grows at every step.
"""

import sys

import numpy as np
import pytest
import torch

from torch_support import run_reference

from bark_tpu_torch.convert import chain_state_from_reference, forest_from_reference
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.fitting.proposals import ProposalNoise
from bark_tpu_torch.fitting.traversal import terminal_mask
from bark_tpu_torch.fitting.sampler import (
    BARKModel,
    KernState,
    StepDraws,
    _leaf_budget,
    _resolve_styles,
    draw_step,
    init_chain_state,
    run_chain,
    step_with_info,
)
from bark_tpu_torch.forest import FOREST_FIELDS, gram_from_leaves, route_forest
from bark_tpu_torch.ops.linalg import JITTER, chol_inv_logdet, kernel_matrix

NUM_TREES = 8
NUM_CHAINS = 2
NEAR_TIE = 1e-3
LEAF_PINS = {"scan_style": "coeff", "refresh_style": "leaf"}
# case -> (N, steps, SamplerParams overrides, initial forests); N=150 is a
# ragged dense-tier N above 128 (one K2 call)
CASES = {
    "n20": (20, 3, {}, "prior"),
    "n150": (150, 1, {}, "prior"),
    "leaf20": (20, 3, LEAF_PINS, "prior"),
    "leaf256": (256, 1, {}, "prior"),
    "cap20": (20, 6, {**LEAF_PINS, "leaf_budget": NUM_TREES + 2}, "stumps"),
}
L_BOUND = 1e-5  # |L - L_ref| / max |L_ref| of the leaf tier's factor
NOISE_FIELDS = ("u_move", "g_node", "u_feat", "u_cat", "u_int", "u_cont", "u_accept")


def make_problem(n, seed=0):
    """Data of tests/fitting/test_sampler.py:make_problem (numpy float32)."""
    from bark_tpu_torch.domain import CategoricalInput, ContinuousInput, Domain, IntegerInput

    dom = Domain(
        [
            ContinuousInput("x_0", (0.0, 1.0)),
            ContinuousInput("x_1", (0.0, 1.0)),
            IntegerInput("i_0", (0, 5)),
            CategoricalInput("c_0", ("a", "b", "c", "d")),
        ]
    )
    rng = np.random.default_rng(seed)
    X = dom.sample(n, rng)
    y = rng.standard_normal((n,)).astype(np.float32)
    return dom.bounds("bitmask"), dom.feature_types(), X, y


def reference_run(out_path: str) -> None:
    """The JAX side (run as a script, x64 off): states, accepts and draws."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from bark_tpu.fitting.params import SamplerParams as JaxParams
    from bark_tpu.fitting.prior import sample_forest_prior
    from bark_tpu.fitting.proposals import make_proposal_noise
    from bark_tpu.fitting.sampler import (
        _propose_all_trees,
        _resolve_styles as jax_resolve,
        init_chain_state as jax_init,
        step as jax_step,
    )
    from bark_tpu.forest import create_empty_forest, pack_forest

    out = {}
    for case, (n, steps, overrides, start) in CASES.items():
        params = JaxParams(num_trees=NUM_TREES, **overrides)
        bounds, ft, X, y = (jnp.asarray(a) for a in make_problem(n))
        if start == "prior":
            forests = sample_forest_prior(
                jax.random.key(1), NUM_TREES, bounds, ft, num_samples=NUM_CHAINS
            )
        else:
            forests = create_empty_forest(NUM_TREES, params.node_limit, (NUM_CHAINS,))
        noise0 = jnp.asarray([0.1, 0.3], jnp.float32)
        scale0 = jnp.asarray([1.0, 0.7], jnp.float32)
        init = jax.jit(jax.vmap(
            lambda f, nz, sc: jax_init(f, nz, sc, X, y, ft, params, bounds=bounds)
        ))
        stepj = jax.jit(jax.vmap(lambda k, s: jax_step(k, s, X, y, bounds, ft, params)))
        resolved = jax_resolve(params, n)
        propose = jax.jit(jax.vmap(
            lambda k, s: _propose_all_trees(k, s, X, ft, bounds, resolved)
        ))

        def draws(k):
            k_trees, k_hyper, k_hyper_accept = jax.random.split(k, 3)
            k_noise, k_scale = jax.random.split(k_hyper)
            return (
                k_trees,
                make_proposal_noise(k_trees, NUM_TREES, params.node_limit),
                jax.random.normal(k_noise, dtype=jnp.float32),
                jax.random.normal(k_scale, dtype=jnp.float32),
                jax.random.uniform(k_hyper_accept, dtype=jnp.float32),
            )

        draws = jax.jit(jax.vmap(draws))
        split = jax.jit(jax.vmap(jax.random.split))

        def save_state(tag, st):
            for k in FOREST_FIELDS:
                out[f"{case}/{tag}/forest.{k}"] = np.asarray(getattr(st.forest, k))
            for k in ("leaves", "noise", "scale", "mll"):
                out[f"{case}/{tag}/{k}"] = np.asarray(getattr(st, k))
            for k in ("K", "K_inv", "K_logdet"):
                out[f"{case}/{tag}/{k}"] = np.asarray(getattr(st.kern, k))

        for k in FOREST_FIELDS:
            out[f"{case}/forest0.{k}"] = np.asarray(getattr(forests, k))
        out[f"{case}/noise0"], out[f"{case}/scale0"] = np.asarray(noise0), np.asarray(scale0)
        state = init(forests, noise0, scale0)
        save_state("s0", state)
        keys = jax.random.split(jax.random.key(2), NUM_CHAINS)
        for s in range(steps):
            pair = split(keys)
            keys, k = pair[:, 0], pair[:, 1]
            k_trees, pn, z_noise, z_scale, u_hyper = draws(k)
            for f in NOISE_FIELDS:
                out[f"{case}/d{s}/{f}"] = np.asarray(getattr(pn, f))
            out[f"{case}/d{s}/z_noise"] = np.asarray(z_noise)
            out[f"{case}/d{s}/z_scale"] = np.asarray(z_scale)
            out[f"{case}/d{s}/u_hyper"] = np.asarray(u_hyper)
            packed0, batch = propose(k_trees, state)
            state = stepj(k, state)
            # accept code per move: 1 accepted, 0 rejected, -1 undecidable
            # from the states (the proposal left the tree as it was)
            new = np.asarray(batch.new_packed)
            old = np.asarray(packed0)
            final = np.asarray(pack_forest(state.forest))
            same = (new == old).all(axis=(-2, -1))
            took = (final == new).all(axis=(-2, -1))
            out[f"{case}/d{s}/accept"] = np.where(same, -1, took.astype(np.int64))
            save_state(f"s{s + 1}", state)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(__file__, tmp_path_factory.mktemp("reference"), "reference.npz")


def _state_dict(ref, case, tag):
    return {
        "forest": {k: ref[f"{case}/{tag}/forest.{k}"] for k in FOREST_FIELDS},
        "kern": {k: ref[f"{case}/{tag}/{k}"] for k in ("K", "K_inv", "K_logdet")},
        **{k: ref[f"{case}/{tag}/{k}"] for k in ("leaves", "noise", "scale", "mll")},
    }


def _params(case):
    return SamplerParams(num_trees=NUM_TREES, **CASES[case][2])


def _inputs(n):
    bounds, ft, X, y = make_problem(n)
    return tuple(torch.as_tensor(a) for a in (X, y, bounds, ft))


def _assert_close_state(got, want, what):
    np.testing.assert_allclose(got.noise.numpy(), want["noise"], rtol=1e-6, err_msg=what)
    np.testing.assert_allclose(got.scale.numpy(), want["scale"], rtol=1e-6, err_msg=what)
    np.testing.assert_allclose(got.mll.numpy(), want["mll"], rtol=1e-4, atol=1e-3, err_msg=what)
    np.testing.assert_allclose(
        got.kern.K_logdet.numpy(), want["kern"]["K_logdet"], rtol=1e-4, atol=1e-3, err_msg=what
    )
    if got.kern.L is None:
        np.testing.assert_allclose(
            got.kern.K_inv.numpy(), want["kern"]["K_inv"], rtol=1e-3, atol=2e-3, err_msg=what
        )
    else:
        L_ref = want["kern"]["K"]
        err = np.abs(got.kern.L.numpy() - L_ref).max() / np.abs(L_ref).max()
        assert err <= L_BOUND, f"{what}: |L - L_ref| / max |L_ref| = {err}"


@pytest.mark.parametrize("case", list(CASES))
def test_init_chain_state_matches_reference(reference, case):
    n = CASES[case][0]
    X, y, bounds, ft = _inputs(n)
    forest = forest_from_reference(
        {k: reference[f"{case}/forest0.{k}"] for k in FOREST_FIELDS}, device="cpu"
    )
    state = init_chain_state(
        forest, torch.as_tensor(reference[f"{case}/noise0"]),
        torch.as_tensor(reference[f"{case}/scale0"]), X, y, ft,
        _params(case), bounds=bounds,
    )
    assert (state.kern.L is not None) == ("refresh_style" in CASES[case][2] or n >= 256)
    want = _state_dict(reference, case, "s0")
    np.testing.assert_array_equal(state.leaves.numpy(), want["leaves"])
    _assert_close_state(state, want, f"{case} init")


@pytest.mark.parametrize("case", list(CASES))
def test_steps_replay_reference(reference, case):
    """Replay the reference's draws from its converted initial state. In
    the leaf tier every chain also stays within its leaf budget with a
    finite MLL at every step (the capacity guard)."""
    n, steps = CASES[case][:2]
    X, y, bounds, ft = _inputs(n)
    params = _params(case)
    budget = _leaf_budget(params, n)
    state = chain_state_from_reference(_state_dict(reference, case, "s0"), device="cpu")
    leaf_tier = state.kern.L is not None
    parted = [False] * NUM_CHAINS
    decided = {0: 0, 1: 0}
    for s in range(steps):
        d = {k: torch.as_tensor(v) for k, v in reference.items() if k.startswith(f"{case}/d{s}/")}
        get = lambda f: d[f"{case}/d{s}/{f}"]  # noqa: E731
        draws = StepDraws(
            ProposalNoise(*(get(f) for f in NOISE_FIELDS)),
            get("z_noise"), get("z_scale"), get("u_hyper"),
        )
        prev_noise = reference[f"{case}/s{s}/noise"]
        state, info = step_with_info(state, X, y, bounds, ft, params, draws)
        if leaf_tier:
            assert state.kern.L.shape == (NUM_CHAINS, budget, budget)
            assert bool((terminal_mask(state.forest).sum((1, 2)) <= budget).all()), s
            assert bool(torch.isfinite(state.mll).all()), s
        want = _state_dict(reference, case, f"s{s + 1}")
        codes = get("accept").numpy()
        log_u = torch.log(draws.proposal.u_accept)
        gap = (log_u - torch.clamp_max(info.tree_log_alpha, 0.0)).abs()
        for c in range(NUM_CHAINS):
            if parted[c]:
                continue
            acc = info.tree_accepts[c].numpy()
            decidable = codes[c] >= 0
            for v in (0, 1):
                decided[v] += int((codes[c] == v).sum())
            wrong = np.nonzero(decidable & (acc != (codes[c] == 1)))[0]
            ref_hyper = want["noise"][c] != prev_noise[c]
            hyper_wrong = bool(info.hyper_accept[c]) != ref_hyper
            if wrong.size or hyper_wrong:
                g = (gap[c, wrong[0]] if wrong.size else (
                    torch.log(draws.u_hyper[c])
                    - torch.clamp_max(info.hyper_log_alpha[c], 0.0)).abs()).item()
                assert g < NEAR_TIE, f"{case} step {s} chain {c}: decision differs, gap {g}"
                print(f"{case} step {s} chain {c}: near-tie (gap {g:.2e}); chain parted")
                parted[c] = True
                continue
            for k in FOREST_FIELDS:
                np.testing.assert_array_equal(
                    getattr(state.forest, k)[c].numpy(), want["forest"][k][c],
                    err_msg=f"{case} step {s} chain {c} forest.{k}",
                )
            np.testing.assert_array_equal(state.leaves[c].numpy(), want["leaves"][c])
            one = lambda t: t[c : c + 1]  # noqa: E731
            _assert_close_state(
                type(state)(state.forest, state.leaves, one(state.noise), one(state.scale),
                            KernState(*(None if t is None else one(t) for t in state.kern)),
                            one(state.mll)),
                {
                    "noise": want["noise"][c : c + 1], "scale": want["scale"][c : c + 1],
                    "mll": want["mll"][c : c + 1],
                    "kern": {k: v[c : c + 1] for k, v in want["kern"].items()},
                },
                f"{case} step {s} chain {c}",
            )
    assert not all(parted)
    # the replay covered accepted and rejected tree moves
    assert decided[0] > 0 and decided[1] > 0, decided


def test_padded_run_equals_unpadded(reference):
    """Padding rows (masked out, y = 0) leaves the trajectory unchanged:
    same accept decisions and forests, the same MLL (its logdet correction
    removes the pads' (jitter + noise) factors) and the same K^-1 on the
    real rows, with pad rows of K^-1 = I / (jitter + noise)."""
    n, pad = 20, 12
    X, y, bounds, ft = _inputs(n)
    Xp = torch.cat([X, torch.zeros(pad, X.shape[1])])
    yp = torch.cat([y, torch.zeros(pad)])
    mask = torch.cat([torch.ones(n), torch.zeros(pad)])
    params = SamplerParams(num_trees=NUM_TREES)
    forest = forest_from_reference(
        {k: reference[f"n20/forest0.{k}"] for k in FOREST_FIELDS}, device="cpu"
    )
    noise0 = torch.as_tensor(reference["n20/noise0"])
    scale0 = torch.as_tensor(reference["n20/scale0"])
    plain = init_chain_state(forest, noise0, scale0, X, y, ft, params, bounds=bounds)
    padded = init_chain_state(forest, noise0, scale0, Xp, yp, ft, params, mask, bounds)
    gen = torch.Generator().manual_seed(3)
    for s in range(4):
        draws = draw_step(gen, NUM_CHAINS, params)
        plain, info = step_with_info(plain, X, y, bounds, ft, params, draws)
        padded, pinfo = step_with_info(padded, Xp, yp, bounds, ft, params, draws, mask)
        assert torch.equal(info.tree_accepts, pinfo.tree_accepts), s
        assert torch.equal(info.hyper_accept, pinfo.hyper_accept), s
        for k in FOREST_FIELDS:
            assert torch.equal(getattr(plain.forest, k), getattr(padded.forest, k)), (s, k)
        assert torch.equal(plain.leaves, padded.leaves[:, :n])
        assert torch.equal(plain.noise, padded.noise)
        torch.testing.assert_close(padded.mll, plain.mll, rtol=1e-4, atol=1e-3)
        corr = pad * torch.log(JITTER + padded.noise)
        torch.testing.assert_close(padded.kern.K_logdet - corr, plain.kern.K_logdet,
                                   rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(padded.kern.K_inv[:, :n, :n], plain.kern.K_inv,
                                   rtol=1e-3, atol=2e-3)
        pad_block = padded.kern.K_inv[:, n:, n:]
        eye = torch.eye(pad).expand_as(pad_block) / (JITTER + padded.noise)[:, None, None]
        torch.testing.assert_close(pad_block, eye, rtol=1e-5, atol=1e-5)
        assert padded.kern.K_inv[:, :n, n:].abs().max() < 1e-6


def test_run_chain_state_consistent_with_rebuild():
    """The maintained state after a run equals a fresh routing and rebuild
    (the reference's own oracle, tests/fitting/test_sampler.py)."""
    X, y, bounds, ft = _inputs(25)
    params = SamplerParams(num_trees=8, warmup_steps=4, num_samples=3, steps_per_sample=2)
    from bark_tpu_torch.forest import create_empty_forest

    model = BARKModel(create_empty_forest(8, 64, (3,)), torch.full((3,), 0.1), torch.ones(3))
    run = run_chain(torch.Generator().manual_seed(0), model, X, y, bounds, ft, params)
    assert run.samples.forest.is_leaf.shape == (3, 3, 8, 64)
    assert run.samples.noise.shape == run.mll.shape == (3, 3)
    assert bool(((run.tree_accept_rate > 0) & (run.tree_accept_rate < 1)).all())
    leaves = route_forest(run.state.forest, X, ft)
    assert torch.equal(leaves, run.state.leaves)
    K_inv, logdet = chol_inv_logdet(
        kernel_matrix(gram_from_leaves(leaves, leaves), run.state.noise, run.state.scale)
    )
    torch.testing.assert_close(run.state.kern.K_inv, K_inv, rtol=1e-3, atol=2e-3)
    torch.testing.assert_close(run.state.kern.K_logdet, logdet, rtol=1e-4, atol=1e-3)


def test_resolve_styles_resolves_auto():
    p = _resolve_styles(SamplerParams(), 255)
    assert (p.scan_style, p.refresh_style) == ("plain", "onesolve")
    assert _resolve_styles(p, 50) is p


if __name__ == "__main__":
    reference_run(sys.argv[1])
