"""Every sampler lowering of the port against the JAX reference, on the CPU.

The JAX package's own tests hold its lowerings to each other
(tests/fitting/test_sampler.py: ``test_backends_agree_on_trajectory``,
``test_hot_styles_agree_on_trajectory``); here each configuration of both,
and ``subspace_mode="carry"``, is replayed on the port against the same
configuration of the reference. The reference runs in ONE subprocess with
JAX's x64 mode off (as in tests/test_torch_sampler.py); this file is its
script too (``python tests/test_torch_lowerings.py OUT.npz``). It spawns
workers that jit-compile, once per distinct lowering, the initial state and
a scan of three steps from prior forests (m = 6 trees, 2 chains, the mixed
domain at N = 20; the woodbury backend padded, 16 real rows and 8 pads) and
save the states and every step's draws rebuilt from the step keys;
configurations the reference itself holds bit-identical share one
trajectory (``SAME_AS``). It also saves each proposal lowering's
``propose_tree_packed``, the reference's ``_resolve_styles`` for each case
of ``RESOLVE_CASES`` and its routing by ``route_forest_select`` and
``route_forest_auto``.

Tolerances of the replay (float32 on both sides):

  - forest, leaves, per-move accept decisions and the carried subspaces:
    exact, except at a reported near-tie |log u - min(log a, 0)| < 1e-3,
    after which that chain is not compared further;
  - noise and scale: rtol 1e-6;
  - MLL and logdet: rtol 1e-4 / atol 1e-3, and K^-1: rtol 1e-3 / atol
    2e-3 (the reference's own maintained-vs-rebuilt tolerances);
  - a carried Cholesky factor (the leaf tier's of A, the ``factor``
    refresh's of K): within 1e-5 of its largest entry; the chol backend's
    K: atol 1e-5.

The port's lowerings are also held to each other in float64, where the
reference claims exact agreement (the cross-lowering trajectories then
differ only by float association), to a rebuild from the leaves after ten
steps, padded against unpadded, tempered (beta = 0.5) dense pair against
coeff + leaf, and through a PT round, an SMC round and a checkpoint round
trip under ``subspace_mode="carry"``.
"""

import sys

import numpy as np
import pytest
import torch

from test_torch_sampler import NOISE_FIELDS, make_problem
from torch_support import run_reference

from bark_tpu_torch.convert import chain_state_from_reference, forest_from_reference
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.fitting.proposals import ProposalNoise
from bark_tpu_torch.fitting.sampler import (
    BARKModel,
    StepDraws,
    _resolve_styles,
    draw_step,
    init_chain_state,
    run_bark_sampler,
    run_chain,
    step,
    step_with_info,
)
from bark_tpu_torch.fitting.traversal import all_node_subspaces
from bark_tpu_torch.forest import (
    FOREST_FIELDS,
    Forest,
    create_empty_forest,
    gram_from_leaves,
    route_forest,
    route_forest_auto,
    route_forest_select,
)
from bark_tpu_torch.ops.linalg import JITTER, chol_inv_logdet, kernel_matrix

M, C, N, STEPS = 6, 2, 20, 3
N_REAL, N_PAD = 16, 8
NEAR_TIE = 1e-3
FACTOR_BOUND = 1e-5  # |L - L_ref| / max |L_ref|
# name -> SamplerParams overrides: the configurations of the reference's
# test_hot_styles_agree_on_trajectory and test_backends_agree_on_trajectory,
# the explicit pair refresh and the subspace carry; the woodbury backend
# runs padded (N_REAL real rows and N_PAD pads)
CONFIGS = {
    "scatter": dict(hot_style="scatter"),
    "walk_select": dict(hot_style="walk_select"),
    "select": dict(hot_style="select"),
    "select_fused": dict(hot_style="select", refresh_style="batched"),
    "doubling": dict(hot_style="doubling"),
    "doubling_fused": dict(hot_style="doubling", refresh_style="onesolve"),
    "aug_scan": dict(scan_style="aug"),
    "lowrank_scan": dict(scan_style="lowrank"),
    "coeff_scan": dict(scan_style="coeff"),
    "coeff_factor": dict(scan_style="coeff", refresh_style="factor"),
    "coeff_factor_bf16": dict(scan_style="coeff", refresh_style="factor", gram_dtype="bf16"),
    "coeff_leaf": dict(scan_style="coeff", refresh_style="leaf"),
    "auto_scan": dict(scan_style="auto"),
    "rank1": dict(kernel_backend="rank1"),
    "chol": dict(kernel_backend="chol"),
    "woodbury": dict(kernel_backend="woodbury"),
    "pair": dict(refresh_style="pair"),
    "carry": dict(subspace_mode="carry"),
}
PADDED = {"woodbury"}
# Configurations whose reference trajectory is another's bit for bit (the
# reference's own tests hold them so: the proposal lowerings change no
# proposal, the default is auto/rank1 itself, the bf16 one-hot Gram counts
# exactly): replayed against that trajectory, so the reference compiles
# each distinct lowering once (a compile costs ~11 s of one CPU core). Each
# proposal lowering is also held to the reference's own function of the
# same style (test_proposal_lowering_matches_reference).
SAME_AS = {
    "scatter": "walk_select", "select": "walk_select", "doubling": "walk_select",
    "doubling_fused": "walk_select", "auto_scan": "walk_select", "rank1": "walk_select",
    "coeff_factor_bf16": "coeff_factor",
}
REPLAYED = [n for n in CONFIGS if n not in SAME_AS]
PROPOSAL_STYLES = ("walk_select", "scatter", "select", "doubling", "carry")
PROPOSAL_REPS = 8  # noise draws per prior tree
# (SamplerParams overrides, padded N) -> the reference's resolved (scan,
# refresh): tests/fitting/test_sampler.py:288, :386-402, :465-489 and more
RESOLVE_CASES = [
    ({}, 50), ({}, 224), ({}, 255), ({}, 256), ({}, 512), ({}, 1024),
    ({"refresh_style": "onesolve"}, 256), ({"refresh_style": "onesolve"}, 1024),
    ({"scan_style": "lowrank"}, 512), ({"scan_style": "plain"}, 1024),
    ({"scan_style": "aug"}, 1024), ({"scan_style": "coeff"}, 1024),
    ({"scan_style": "coeff"}, 50), ({"refresh_style": "pair"}, 2048),
    ({"refresh_style": "pair"}, 50), ({"refresh_style": "batched"}, 300),
    ({"refresh_style": "leaf"}, 64), ({"refresh_style": "factor"}, 50),
    ({"kernel_backend": "woodbury"}, 512), ({"kernel_backend": "chol"}, 50),
    ({"hot_style": "doubling", "subspace_mode": "carry"}, 50),
]
ROUTE_N = 2100  # past 2048: the select router walks rows in blocks


def _params(name, **extra):
    return SamplerParams(num_trees=M, **CONFIGS[name], **extra)


def _problem(name):
    """(X, y, bounds, ft, mask) of a configuration, numpy; a padded one
    appends N_PAD rows (copies of row 0, y = 0, mask 0) to N_REAL."""
    if name not in PADDED:
        bounds, ft, X, y = make_problem(N)
        return X, y, bounds, ft, np.ones(N, np.float32)
    bounds, ft, X, y = make_problem(N_REAL)
    X = np.concatenate([X, np.repeat(X[:1], N_PAD, 0)])
    y = np.concatenate([y, np.zeros(N_PAD, np.float32)])
    mask = np.concatenate([np.ones(N_REAL), np.zeros(N_PAD)]).astype(np.float32)
    return X, y, bounds, ft, mask


def _prior_forests() -> dict:
    """C forests of M trees from the port's prior (numpy fields): the
    start of every configuration in both packages."""
    from bark_tpu_torch.fitting.prior import draw_prior, sample_forest_prior

    bounds, ft, _, _ = make_problem(N)
    forests = sample_forest_prior(draw_prior(torch.Generator().manual_seed(1), C, M), M,
                                  torch.as_tensor(bounds), torch.as_tensor(ft))
    return {k: getattr(forests, k).numpy() for k in FOREST_FIELDS}


def _jax_setup():
    """Import JAX for the CPU (x64 off, as the command line runs it)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def _reference_configs(names, forest0) -> dict:
    """The reference's initial states, draws and three steps for ``names``
    (configurations that resolve to one lowering share one compile): one
    jit of the init and a scan of the steps each. Runs in a worker."""
    import dataclasses

    jax = _jax_setup()
    import jax.numpy as jnp

    from bark_tpu.fitting.params import SamplerParams as JaxParams
    from bark_tpu.fitting.proposals import make_proposal_noise
    from bark_tpu.fitting.sampler import (
        _resolve_styles as jax_resolve,
        init_chain_state as jax_init,
        step as jax_step,
    )
    from bark_tpu.forest import Forest

    # the sampler runs op by op, so that the ops the configurations share
    # compile once; the proposal batch is one jit per proposal lowering, as
    # inside the reference's jitted step (its threshold draw contracts to a
    # fused multiply-add there, which the port reproduces)
    import bark_tpu.fitting.sampler as jax_sampler

    jax_sampler._propose_all_trees = jax.jit(jax_sampler._propose_all_trees,
                                             static_argnums=(5,))
    forests = Forest(**{k: jnp.asarray(v) for k, v in forest0.items()})
    noise0 = jnp.asarray([0.1, 0.3], jnp.float32)
    scale0 = jnp.asarray([1.0, 0.7], jnp.float32)
    keys = jax.random.split(jax.random.key(2), C)
    step_keys = []
    for _ in range(STEPS):
        pair = jax.vmap(jax.random.split)(keys)
        keys = pair[:, 0]
        step_keys.append(pair[:, 1])
    step_keys = jnp.stack(step_keys)  # (STEPS, C)

    def run(name):
        params = JaxParams(num_trees=M, **CONFIGS[name])
        X, y, bounds, ft, mask = (jnp.asarray(a) for a in _problem(name))

        def draws(k):
            k_trees, k_hyper, k_hyper_accept = jax.random.split(k, 3)
            k_noise, k_scale = jax.random.split(k_hyper)
            return (
                make_proposal_noise(k_trees, M, params.node_limit),
                jax.random.normal(k_noise, dtype=jnp.float32),
                jax.random.normal(k_scale, dtype=jnp.float32),
                jax.random.uniform(k_hyper_accept, dtype=jnp.float32),
            )

        init = jax.vmap(lambda f, nz, sc: jax_init(
            f, nz, sc, X, y, ft, params, mask, bounds=bounds))
        state = state0 = init(forests, noise0, scale0)
        steps, drawn = [], []
        for ks in step_keys:
            state = jax.vmap(lambda k, s: jax_step(
                k, s, X, y, bounds, ft, params, mask))(ks, state)
            steps.append(state)
            drawn.append(jax.vmap(draws)(ks))
        stack = lambda *a: jnp.stack(a)  # noqa: E731
        return state0, (jax.tree.map(stack, *drawn), jax.tree.map(stack, *steps))

    out, done = {}, {}
    for name in names:
        sig = (dataclasses.astuple(jax_resolve(JaxParams(num_trees=M, **CONFIGS[name]), N)),
               name in PADDED)
        if sig not in done:
            done[sig] = run(name)
        state0, (dr, states) = done[sig]

        def save_state(tag, st, s=None):
            pick = (lambda a: np.asarray(a)) if s is None else (lambda a: np.asarray(a)[s])
            for k in FOREST_FIELDS:
                out[f"{name}/{tag}/forest.{k}"] = pick(getattr(st.forest, k))
            for k in ("leaves", "noise", "scale", "mll", "subspaces"):
                out[f"{name}/{tag}/{k}"] = pick(getattr(st, k))
            for k in ("K", "K_inv", "K_logdet"):
                out[f"{name}/{tag}/{k}"] = pick(getattr(st.kern, k))

        save_state("s0", state0)
        pn, z_noise, z_scale, u_hyper = dr
        for s in range(STEPS):
            for f in NOISE_FIELDS:
                out[f"{name}/d{s}/{f}"] = np.asarray(getattr(pn, f))[s]
            out[f"{name}/d{s}/z_noise"] = np.asarray(z_noise)[s]
            out[f"{name}/d{s}/z_scale"] = np.asarray(z_scale)[s]
            out[f"{name}/d{s}/u_hyper"] = np.asarray(u_hyper)[s]
            save_state(f"s{s + 1}", states, s)
    return out


def _reference_proposals(forest0) -> dict:
    """Each proposal lowering of the reference (``propose_tree_packed`` of
    every hot style, and with a subspace tree) on the C * M prior trees,
    from one noise draw."""
    jax = _jax_setup()
    import jax.numpy as jnp

    from bark_tpu.fitting.params import SamplerParams as JaxParams
    from bark_tpu.fitting.proposals import make_proposal_noise, propose_tree_packed
    from bark_tpu.fitting.traversal import all_node_subspaces as jax_subspaces
    from bark_tpu.forest import Forest, pack_forest

    bounds, ft, _, _ = (jnp.asarray(a) for a in make_problem(N))
    trees = Forest(**{k: jnp.asarray(np.tile(v.reshape(C * M, -1), (PROPOSAL_REPS, 1)))
                      for k, v in forest0.items()})
    packed = pack_forest(trees)
    noise = make_proposal_noise(jax.random.key(5), packed.shape[0], packed.shape[1])
    out = {f"propose/noise/{f}": np.asarray(getattr(noise, f)) for f in NOISE_FIELDS}
    for style in PROPOSAL_STYLES:
        params = JaxParams(num_trees=M, **({"subspace_mode": "carry"} if style == "carry"
                                           else {"hot_style": style}))

        @jax.jit
        def propose(packed, noise, trees=trees, params=params, carry=style == "carry"):
            def one(p, nz, t):
                if not carry:
                    return propose_tree_packed(None, p, bounds, ft, params, noise=nz)
                sub = jax_subspaces(t, bounds, ft, params.max_depth)
                return propose_tree_packed(None, p, bounds, ft, params, subspace_tree=sub,
                                           noise=nz)
            return jax.vmap(one)(packed, noise, trees)

        for i, a in enumerate(propose(packed, noise)):
            out[f"propose/{style}/{i}"] = np.asarray(a)
    return out


def reference_run(out_path: str, workers: int = 6) -> None:
    """The JAX side (run as a script, x64 off): the configurations split
    over ``workers`` spawned processes (tracing holds the interpreter, so
    threads would not overlap it), the rest here."""
    import multiprocessing

    jax = _jax_setup()
    import jax.numpy as jnp

    from bark_tpu.fitting.params import SamplerParams as JaxParams
    from bark_tpu.fitting.sampler import _resolve_styles as jax_resolve
    from bark_tpu.forest import Forest
    from bark_tpu.forest import route_forest as jax_route
    from bark_tpu.forest import route_forest_auto as jax_route_auto
    from bark_tpu.forest import route_forest_select as jax_route_select

    forest0 = _prior_forests()
    # configurations resolving to one lowering stay together; the groups
    # are dealt round-robin
    groups = {}
    for name in REPLAYED:
        sig = (jax_resolve(JaxParams(num_trees=M, **CONFIGS[name]), N), name in PADDED)
        groups.setdefault(sig, []).append(name)
    chunks = [sum(list(groups.values())[i::workers], []) for i in range(workers)]
    chunks = [c for c in chunks if c]
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        pending = pool.starmap_async(_reference_configs, [(c, forest0) for c in chunks])
        out = {f"forest0.{k}": v for k, v in forest0.items()}
        for i, (overrides, n) in enumerate(RESOLVE_CASES):
            r = jax_resolve(JaxParams(**overrides), n)
            out[f"resolve/{i}"] = np.array([r.scan_style, r.refresh_style, r.kernel_backend])
        ft = jnp.asarray(make_problem(N)[1])
        Xr = jnp.asarray(make_problem(ROUTE_N, seed=7)[2])
        one = Forest(**{k: jnp.asarray(v[0]) for k, v in forest0.items()})
        out["route/select"] = np.asarray(jax_route_select(one, Xr, ft))
        out["route/auto"] = np.asarray(jax_route_auto(one, Xr, ft))
        out["route/walk"] = np.asarray(jax_route(one, Xr, ft))
        out.update(_reference_proposals(forest0))
        for part in pending.get():
            out.update(part)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(__file__, tmp_path_factory.mktemp("reference"), "lowerings.npz")


def _inputs(name, dtype=torch.float32):
    X, y, bounds, ft, mask = _problem(name)
    return (torch.as_tensor(X, dtype=dtype), torch.as_tensor(y, dtype=dtype),
            torch.as_tensor(bounds), torch.as_tensor(ft), torch.as_tensor(mask, dtype=dtype))


def _ref_state(ref, name, tag):
    get = lambda k: ref[f"{name}/{tag}/{k}"]  # noqa: E731
    return {
        "forest": {k: get(f"forest.{k}") for k in FOREST_FIELDS},
        "kern": {k: get(k) for k in ("K", "K_inv", "K_logdet")},
        **{k: get(k) for k in ("leaves", "noise", "scale", "mll", "subspaces")},
    }


def _ref_draws(ref, name, s) -> StepDraws:
    get = lambda f: torch.as_tensor(ref[f"{name}/d{s}/{f}"])  # noqa: E731
    return StepDraws(ProposalNoise(*(get(f) for f in NOISE_FIELDS)),
                     get("z_noise"), get("z_scale"), get("u_hyper"))


def _assert_close(got, want, c, what):
    """Chain ``c`` of a port state against the reference's (see the module
    docstring for the tolerances)."""
    np.testing.assert_allclose(got.noise[c].numpy(), want["noise"][c], rtol=1e-6, err_msg=what)
    np.testing.assert_allclose(got.scale[c].numpy(), want["scale"][c], rtol=1e-6, err_msg=what)
    np.testing.assert_allclose(got.mll[c].numpy(), want["mll"][c], rtol=1e-4, atol=1e-3,
                               err_msg=what)
    kern, ref_kern = got.kern, want["kern"]
    if kern.K is not None:
        np.testing.assert_allclose(kern.K[c].numpy(), ref_kern["K"][c], atol=1e-5, err_msg=what)
        return
    np.testing.assert_allclose(kern.K_logdet[c].numpy(), ref_kern["K_logdet"][c], rtol=1e-4,
                               atol=1e-3, err_msg=what)
    if kern.K_inv is not None:
        np.testing.assert_allclose(kern.K_inv[c].numpy(), ref_kern["K_inv"][c], rtol=1e-3,
                                   atol=2e-3, err_msg=what)
    else:
        L_ref = ref_kern["K"][c]
        err = np.abs(kern.L[c].numpy() - L_ref).max() / np.abs(L_ref).max()
        assert err <= FACTOR_BOUND, f"{what}: |L - L_ref| / max |L_ref| = {err}"


@pytest.mark.parametrize("name", list(CONFIGS))
def test_lowering_replays_reference(reference, name):
    """Each configuration from the reference's converted initial state,
    three steps on its draws: the same trajectory (see the tolerances)."""
    X, y, bounds, ft, mask = _inputs(name)
    params = _params(name)
    forest = forest_from_reference(
        {k: reference[f"forest0.{k}"] for k in FOREST_FIELDS}, device="cpu")
    init = init_chain_state(forest, torch.tensor([0.1, 0.3]), torch.tensor([1.0, 0.7]), X, y,
                            ft, params, mask, bounds)
    key = SAME_AS.get(name, name)
    want0 = _ref_state(reference, key, "s0")
    np.testing.assert_array_equal(init.leaves.numpy(), want0["leaves"])
    for c in range(C):
        _assert_close(init, want0, c, f"{name} init")
    if params.subspace_mode == "carry":
        np.testing.assert_array_equal(init.subspaces.numpy(), want0["subspaces"])
    else:
        assert init.subspaces is None and want0["subspaces"].size == 0

    state = chain_state_from_reference(want0, device="cpu")
    parted = [False] * C
    decided = {0: 0, 1: 0}
    for s in range(STEPS):
        draws = _ref_draws(reference, key, s)
        state, info = step_with_info(state, X, y, bounds, ft, params, draws, mask)
        want = _ref_state(reference, key, f"s{s + 1}")
        gap = (torch.log(draws.proposal.u_accept)
               - torch.clamp_max(info.tree_log_alpha, 0.0)).abs()
        hyper_gap = (torch.log(draws.u_hyper)
                     - torch.clamp_max(info.hyper_log_alpha, 0.0)).abs()
        for c in range(C):
            if parted[c]:
                continue
            live = torch.isfinite(info.tree_log_alpha[c])
            decided[1] += int((info.tree_accepts[c] & live).sum())
            decided[0] += int((~info.tree_accepts[c] & live).sum())
            # a tree or the noise move that came out otherwise than in the
            # reference must be a near-tie of the MH decision
            trees = np.nonzero(np.any(
                [getattr(state.forest, k)[c].numpy() != want["forest"][k][c]
                 for k in FOREST_FIELDS], axis=(0, 2)))[0]
            hyper = not np.isclose(state.noise[c].item(), want["noise"][c], rtol=1e-6, atol=0)
            if trees.size or hyper:
                g = (gap[c, trees[0]] if trees.size else hyper_gap[c]).item()
                assert g < NEAR_TIE, f"{name} step {s} chain {c}: decision differs, gap {g}"
                print(f"{name} step {s} chain {c}: near-tie (gap {g:.2e}); chain parted")
                parted[c] = True
                continue
            np.testing.assert_array_equal(state.leaves[c].numpy(), want["leaves"][c])
            if state.subspaces is not None:
                np.testing.assert_array_equal(state.subspaces[c].numpy(), want["subspaces"][c])
            _assert_close(state, want, c, f"{name} step {s} chain {c}")
    assert not all(parted)
    # the replay covered accepted and rejected tree moves
    assert decided[0] > 0 and decided[1] > 0, decided


@pytest.mark.parametrize("style", PROPOSAL_STYLES)
def test_proposal_lowering_matches_reference(reference, style):
    """``propose_tree_packed`` of each hot style (and from a subspace tree,
    returning the updated tree) equals the reference's function of the same
    style on the prior trees under one noise draw."""
    from bark_tpu_torch.fitting.proposals import propose_tree_packed
    from bark_tpu_torch.forest import pack_forest

    _, _, bounds, ft, _ = _inputs("walk_select")
    trees = Forest(*(torch.as_tensor(reference[f"forest0.{k}"]).reshape(C * M, -1)
                     .repeat(PROPOSAL_REPS, 1) for k in FOREST_FIELDS))
    noise = ProposalNoise(*(torch.as_tensor(reference[f"propose/noise/{f}"])
                            for f in NOISE_FIELDS))
    carry = style == "carry"
    params = SamplerParams(num_trees=M, **({"subspace_mode": "carry"} if carry
                                           else {"hot_style": style}))
    sub = all_node_subspaces(trees, bounds, ft, params.max_depth) if carry else None
    got = propose_tree_packed(pack_forest(trees), bounds, ft, params, noise, subspace_tree=sub)
    want = [reference[f"propose/{style}/{i}"] for i in range(len(got))]
    lq = 2 if carry else 1
    for i, (a, b) in enumerate(zip(got, want)):
        if i != lq:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f"{style} output {i}")
    fin = np.isfinite(want[lq])
    np.testing.assert_array_equal(np.isfinite(got[lq].numpy()), fin)
    np.testing.assert_allclose(got[lq].numpy()[fin], want[lq][fin], rtol=1e-6, atol=1e-6)
    assert set(np.unique(want[lq + 1])) == {0, 1, 2} and 0 < fin.sum() < fin.size


@pytest.mark.parametrize("i", range(len(RESOLVE_CASES)))
def test_resolve_styles_matches_reference(reference, i):
    """The port resolves every case as the reference does (auto by padded N,
    explicit pins kept, only rank1 has styles)."""
    overrides, n = RESOLVE_CASES[i]
    r = _resolve_styles(SamplerParams(**overrides), n)
    assert [r.scan_style, r.refresh_style, r.kernel_backend] == \
        reference[f"resolve/{i}"].tolist(), (overrides, n)
    assert _resolve_styles(r, n) is r


@pytest.mark.parametrize("router", ["select", "auto"])
def test_routing_matches_reference(reference, router):
    """``route_forest_select`` (rows in blocks past 2048) and
    ``route_forest_auto`` equal the reference's and the gather walk, for
    one forest and for a batch of forests."""
    fn = {"select": route_forest_select, "auto": route_forest_auto}[router]
    bounds, ft, X, _ = make_problem(ROUTE_N, seed=7)
    X, ft = torch.as_tensor(X), torch.as_tensor(ft)
    forests = forest_from_reference(
        {k: reference[f"forest0.{k}"] for k in FOREST_FIELDS}, device="cpu")
    got = fn(Forest(*(t[0] for t in forests)), X, ft)
    np.testing.assert_array_equal(got.numpy(), reference[f"route/{router}"])
    np.testing.assert_array_equal(got.numpy(), reference["route/walk"])
    assert torch.equal(fn(forests, X[:300], ft), route_forest(forests, X[:300], ft))


def _empty_model(dtype=torch.float32):
    return BARKModel(create_empty_forest(M, 64, (C,)), torch.full((C,), 0.1, dtype=dtype),
                     torch.ones(C, dtype=dtype))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_lowering_state_consistent_with_rebuild(name):
    """After ten steps from stumps the maintained state equals a fresh
    routing and rebuild (the reference's oracle, tests/fitting/
    test_sampler.py:46): K^-1 and logdet K, the factor of K or of A, K
    itself, and the carried subspaces on every active node."""
    X, y, bounds, ft, _ = _inputs("walk_select")
    params = _params(name, warmup_steps=9, num_samples=1, steps_per_sample=1)
    st = run_chain(torch.Generator().manual_seed(5), _empty_model(), X, y, bounds, ft,
                   params).state
    leaves = route_forest(st.forest, X, ft)
    assert torch.equal(leaves, st.leaves)
    K = kernel_matrix(gram_from_leaves(leaves, leaves), st.noise, st.scale)
    K_inv, logdet = chol_inv_logdet(K)
    kern = st.kern
    if kern.K is not None:
        torch.testing.assert_close(kern.K, K, rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(kern.K_logdet, logdet, rtol=1e-4, atol=1e-3)
    if kern.K_inv is not None:
        torch.testing.assert_close(kern.K_inv, K_inv, rtol=1e-3, atol=2e-3)
    elif kern.L is not None and kern.L.shape[-1] == N:  # the factor refresh: L of K
        torch.testing.assert_close(kern.L @ kern.L.transpose(1, 2), K, rtol=1e-4, atol=1e-4)
    elif kern.L is not None:  # the leaf tier: L of A, checked through K's logdet above
        assert bool(torch.isfinite(kern.L).all())
    if st.subspaces is not None:
        active = st.forest.active
        want = all_node_subspaces(st.forest, bounds, ft, params.max_depth)
        assert torch.equal(st.subspaces[active], want[active])


@pytest.mark.parametrize("name", ["carry", "coeff_factor", "pair", "woodbury"])
def test_padded_run_equals_unpadded(name):
    """Pad rows (masked out, y = 0) are inert in every carry: the same
    decisions and forests, the same MLL, logdet less the pads' own
    log(jitter + noise)."""
    X, y, bounds, ft, _ = _inputs("walk_select")
    pad = 12
    Xp = torch.cat([X, X[:1].expand(pad, -1)])
    yp = torch.cat([y, torch.zeros(pad)])
    mask = torch.cat([torch.ones(N), torch.zeros(pad)])
    params = _params(name)
    model = _empty_model()
    plain = init_chain_state(*model, X, y, ft, params, bounds=bounds)
    padded = init_chain_state(*model, Xp, yp, ft, params, mask, bounds)
    gen = torch.Generator().manual_seed(3)
    for s in range(6):
        draws = draw_step(gen, C, params)
        plain, info = step_with_info(plain, X, y, bounds, ft, params, draws)
        padded, pinfo = step_with_info(padded, Xp, yp, bounds, ft, params, draws, mask)
        assert torch.equal(info.tree_accepts, pinfo.tree_accepts), s
        assert torch.equal(info.hyper_accept, pinfo.hyper_accept), s
        for k in FOREST_FIELDS:
            assert torch.equal(getattr(plain.forest, k), getattr(padded.forest, k)), (s, k)
        assert torch.equal(plain.noise, padded.noise)
        torch.testing.assert_close(padded.mll, plain.mll, rtol=1e-4, atol=1e-3)
        corr = pad * torch.log(JITTER + padded.noise)
        torch.testing.assert_close(padded.kern.K_logdet - corr, plain.kern.K_logdet,
                                   rtol=1e-4, atol=1e-3)
        if plain.subspaces is not None:
            assert torch.equal(plain.subspaces, padded.subspaces)
    assert bool(info.tree_accepts.any())


def test_tempered_pair_matches_coeff_leaf():
    """beta = 0.5 (PT, SMC): the dense pair refresh and the coeff scan with
    the leaf refresh temper alike (tests/fitting/test_sampler.py:427)."""
    X, y, bounds, ft, _ = _inputs("pair")
    out = {}
    for kw in (dict(scan_style="plain", refresh_style="pair"),
               dict(scan_style="coeff", refresh_style="leaf")):
        params = SamplerParams(num_trees=M, **kw)
        st = init_chain_state(*_empty_model(), X, y, ft, params, bounds=bounds)
        gen = torch.Generator().manual_seed(40)
        for _ in range(8):
            st = step(st, X, y, bounds, ft, params, draw_step(gen, C, params), beta=0.5)
        out[kw["refresh_style"]] = st
    a, b = out["pair"], out["leaf"]
    assert torch.equal(a.forest.threshold, b.forest.threshold)
    torch.testing.assert_close(a.noise, b.noise, rtol=1e-6, atol=0)
    torch.testing.assert_close(a.mll, b.mll, rtol=1e-4, atol=0)


def test_lowerings_agree_in_float64():
    """Every configuration gives the default's trajectory in float64 (the
    reference's claim: only float association differs): the same forests,
    noise and accept rates from the same generator."""
    X, y, bounds, ft, _ = _inputs("walk_select", torch.float64)
    out = {}
    for name in CONFIGS:
        params = _params(name, warmup_steps=3, num_samples=3, steps_per_sample=2)
        out[name] = run_chain(torch.Generator().manual_seed(11), _empty_model(torch.float64),
                              X, y, bounds, ft, params)
        assert out[name].samples.noise.dtype == torch.float64, name
    ref = out["walk_select"]
    for name, run in out.items():
        for k in FOREST_FIELDS:
            assert torch.equal(getattr(ref.samples.forest, k),
                               getattr(run.samples.forest, k)), (name, k)
        torch.testing.assert_close(run.samples.noise, ref.samples.noise, rtol=1e-12, atol=0)
        assert torch.equal(run.tree_accept_rate, ref.tree_accept_rate), name


@pytest.mark.parametrize("backend", ["rank1", "chol", "woodbury"])
def test_every_accepted_combination_runs(backend):
    """Every (scan, refresh, hot_style, subspace_mode) that SamplerParams
    accepts with this backend runs ``run_bark_sampler`` (init and a step,
    at a tiny size); each distinct resolved lowering also runs a PT round
    and an SMC round."""
    import itertools

    from bark_tpu_torch.parallel.smc import run_smc
    from bark_tpu_torch.parallel.tempering import run_parallel_tempering

    X, y, bounds, ft, _ = (t[:8] if t.dim() and t.shape[0] == N else t
                           for t in _inputs("walk_select"))
    small = dict(num_trees=2, node_limit=8, max_depth=3, warmup_steps=0, num_samples=1,
                 steps_per_sample=1)
    model = BARKModel(create_empty_forest(2, 8, (1,)), torch.full((1,), 0.1), torch.ones(1))
    styles = itertools.product(
        SamplerParams._ALLOWED_MODES["scan_style"], SamplerParams._ALLOWED_MODES["refresh_style"],
        SamplerParams._ALLOWED_MODES["hot_style"], SamplerParams._ALLOWED_MODES["subspace_mode"])
    ran, lowerings = 0, {}
    for scan, refresh, hot, subs in styles:
        try:
            params = SamplerParams(kernel_backend=backend, scan_style=scan, refresh_style=refresh,
                                   hot_style=hot, subspace_mode=subs, **small)
        except ValueError:  # factor/leaf with a non-coeff scan, as the reference
            continue
        out = run_bark_sampler(torch.Generator().manual_seed(ran), model, X, y, bounds, ft, params)
        assert bool(torch.isfinite(out.noise).all()), params
        ran += 1
        r = _resolve_styles(params, X.shape[0])
        lowerings.setdefault((r.scan_style, r.refresh_style), params)
    assert ran == 24 * 8  # 5 scans x 6 refreshes less 6 invalid pairs, x 4 x 2
    for params in lowerings.values():
        pt = run_parallel_tempering(torch.Generator().manual_seed(1),
                                    create_empty_forest(2, 8, (2,)), torch.full((2,), 0.1),
                                    torch.ones(2), X, y, bounds, ft, params, num_replicas=2,
                                    num_steps=1)
        assert bool(torch.isfinite(pt.cold_mll).all()), params
        smc = run_smc(torch.Generator().manual_seed(2), X, y, bounds, ft, params,
                      num_particles=2, num_rounds=1, mutation_steps=1)
        assert bool(torch.isfinite(smc.log_evidence)), params


def _carry_and_walk(fn):
    """``fn(params)`` under carry and under walk; the two must agree."""
    return {mode: fn(SamplerParams(num_trees=M, subspace_mode=mode))
            for mode in ("carry", "walk")}


def test_parallel_tempering_round_under_carry():
    """Two PT rounds (one ladder of 4 replicas, swaps between them): the
    carried subspaces follow their chains through the swaps, so the rounds
    equal the walk's and the subspaces a fresh computation."""
    from bark_tpu_torch.parallel.tempering import run_parallel_tempering

    X, y, bounds, ft, _ = _inputs("carry")
    forest = create_empty_forest(M, 64, (4,))

    def run(params):
        return run_parallel_tempering(torch.Generator().manual_seed(8), forest,
                                      torch.full((4,), 0.1), torch.ones(4), X, y, bounds, ft,
                                      params, num_replicas=4, num_steps=3)

    out = _carry_and_walk(run)
    a, b = out["carry"], out["walk"]
    assert torch.equal(a.betas, b.betas) and bool((a.swap_rate > 0).all())
    assert torch.equal(a.state.chains.forest.threshold, b.state.chains.forest.threshold)
    torch.testing.assert_close(a.cold_mll, b.cold_mll, rtol=0, atol=0)
    ch = a.state.chains
    assert ch.subspaces is not None and b.state.chains.subspaces is None
    want = all_node_subspaces(ch.forest, bounds, ft, 16)
    assert torch.equal(ch.subspaces[ch.forest.active], want[ch.forest.active])


def test_smc_round_under_carry():
    """Two SMC rounds (a resample takes whole states, the subspaces
    included, and the mutation steps propose from them): the same particles
    and evidence as under the walk."""
    from bark_tpu_torch.parallel.smc import run_smc

    X, y, bounds, ft, _ = _inputs("carry")

    def run(params):
        return run_smc(torch.Generator().manual_seed(9), X, y, bounds, ft, params,
                       num_particles=8, num_rounds=2, mutation_steps=1)

    out = _carry_and_walk(run)
    a, b = out["carry"], out["walk"]
    for k in FOREST_FIELDS:
        assert torch.equal(getattr(a.model.forest, k), getattr(b.model.forest, k)), k
    assert torch.equal(a.betas, b.betas)
    torch.testing.assert_close(a.log_evidence, b.log_evidence, rtol=0, atol=0)


def test_checkpoint_round_trip_under_carry(tmp_path):
    """A model saved after a carry run loads back, and the state rebuilt
    from it (``init_chain_state``) carries the run's subspaces on every
    active node and continues as the run's own state does."""
    from bark_tpu_torch.utils.checkpoint import load_model, save_model

    X, y, bounds, ft, _ = _inputs("carry")
    params = _params("carry", warmup_steps=5, num_samples=1, steps_per_sample=1)
    st = run_chain(torch.Generator().manual_seed(2), _empty_model(), X, y, bounds, ft,
                   params).state
    save_model(tmp_path / "carry.npz", BARKModel(st.forest, st.noise, st.scale))
    model, _, _ = load_model(tmp_path / "carry.npz", device="cpu")
    back = init_chain_state(*model, X, y, ft, params, bounds=bounds)
    active = st.forest.active
    assert torch.equal(back.subspaces[active], st.subspaces[active])
    draws = draw_step(torch.Generator().manual_seed(4), C, params)
    a = step(st, X, y, bounds, ft, params, draws)
    b = step(back, X, y, bounds, ft, params, draws)
    assert torch.equal(a.forest.threshold, b.forest.threshold)
    assert torch.equal(a.subspaces[a.forest.active], b.subspaces[a.forest.active])


@pytest.mark.parametrize("built, stepped", [("walk", "carry"), ("carry", "walk")])
def test_step_refuses_a_state_of_the_other_subspace_mode(built, stepped):
    """The step picks the walk or the carry from ``params.subspace_mode``,
    as the reference does: a state built under the other mode raises
    instead of running the lowering it happens to hold."""
    X, y, bounds, ft, _ = _inputs("carry")
    st = init_chain_state(*_empty_model(), X, y, ft,
                          SamplerParams(num_trees=M, subspace_mode=built), bounds=bounds)
    params = SamplerParams(num_trees=M, subspace_mode=stepped)
    draws = draw_step(torch.Generator().manual_seed(4), C, params)
    with pytest.raises(ValueError, match="subspace_mode"):
        step(st, X, y, bounds, ft, params, draws)


if __name__ == "__main__":
    reference_run(sys.argv[1])
