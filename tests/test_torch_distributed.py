"""The port's multi-process paths against their single-process counterparts
and the JAX reference, on the CPU.

Ranks are real processes joined into a Gloo group by
``bark_tpu_torch.graft_entry.launch`` (spawned; the group meets through a
file in a temporary directory, so parallel test workers cannot collide on a
port). Each rank runs a function of ``graft_entry`` and returns its result
to the test, which holds it to:

  - the sharded sampler: each rank's block bit-equal to ``run_chain`` over
    the same chains from the rank's generator; the all-reduced diagnostics
    equal on every rank and to the reference's formula over the
    concatenated samples (float32 sums in another order: rtol 1e-6);
  - ``sharded_pt_swap`` over 4 ranks: bit-equal to the reference's
    ``sharded_pt_swap`` on 4 devices of the virtual mesh, given the
    reference's ``fold_in`` uniforms, both parities;
  - sharded PT: bit-equal to ``pt_swap_states`` driving the same replicas
    in one process (``graft_entry.single_process_pt``);
  - sharded SMC: ``run_smc`` from the same generator: the same beta
    schedule (rtol 1e-6) and log-evidence within 1e-5 relative;
  - sharded scoring and ``propose(mesh=...)``: bit-equal;
  - the row-sharded CG predict: within 1e-5 relative of
    ``forest_predict_cg``;
  - ``entry()``'s initial MLL: the reference's at rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bark_tpu_torch import graft_entry
from bark_tpu_torch.benchmarks import map_benchmark
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.fitting.sampler import init_chain_state, run_chain
from bark_tpu_torch.forest import Forest
from bark_tpu_torch.models.gp import forest_predict_cg
from bark_tpu_torch.models.surrogate import BARKSurrogate
from bark_tpu_torch.optimizer.acquisition import build_acquisition, evaluate_acquisition
from bark_tpu_torch.optimizer.search import draw_search, propose
from bark_tpu_torch.parallel.distributed import initialize_distributed
from bark_tpu_torch.parallel.sharding import rank_generator
from bark_tpu_torch.parallel.smc import run_smc

CPU = torch.device("cpu")


def launch(fn, n, **payload):
    return graft_entry.launch(fn, n, device="cpu", timeout=120, **payload)


def test_initialize_distributed_names_what_is_missing(monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="num_processes.*process_id"):
        initialize_distributed(device="cpu")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    with pytest.raises(RuntimeError, match="MASTER_PORT"):
        initialize_distributed(num_processes=2, process_id=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            initialize_distributed("localhost:1", 1, 0)


def test_chain_mesh_on_one_rank(tmp_path):
    """A one-rank Gloo group in this process: the chain mesh spans it, a
    mesh of another size is refused, and a second call of
    ``initialize_distributed`` keeps the group."""
    import torch.distributed as dist

    from bark_tpu_torch.parallel.sharding import chain_mesh

    assert initialize_distributed(f"file://{tmp_path}/pg", 1, 0, device="cpu") == CPU
    try:
        assert initialize_distributed(device="cpu") == CPU
        mesh = chain_mesh()
        assert mesh.size() == 1 and mesh.mesh_dim_names == ("chains",)
        assert dist.get_backend() == "gloo"
        with pytest.raises(ValueError, match="2 devices"):
            chain_mesh(2)
    finally:
        dist.destroy_process_group()


def test_sharded_sampler_blocks_equal_run_chain():
    seed, chains, n_ranks = 3, 4, 2
    kw = dict(warmup_steps=2, num_samples=3, steps_per_sample=2)
    out = launch(graft_entry.rank_sampler, n_ranks, seed=seed, n_points=16,
                 num_chains=chains, num_trees=8, params_kw=kw)
    _, params, model, X, y, bounds, ft = graft_entry._problem(16, chains, 8, kw)
    local = chains // n_ranks
    noises, mlls, depth, active = [], [], 0.0, 0.0
    for r, got in enumerate(out):
        block = Forest(*(t[r * local:(r + 1) * local] for t in model.forest))
        want = run_chain(rank_generator(seed, r, CPU), type(model)(block, model.noise[:local],
                         model.scale[:local]), X, y, bounds, ft, params)
        run = got["run"]
        for a, b in zip(run.samples.forest, want.samples.forest):
            assert torch.equal(a, b)
        assert torch.equal(run.samples.noise, want.samples.noise)
        assert torch.equal(run.mll, want.mll)
        assert torch.equal(run.tree_accept_rate, want.tree_accept_rate)
        noises.append(want.samples.noise)
        mlls.append(want.state.mll)
        f = want.samples.forest
        depth += float((f.depth * f.active).sum())
        active += float(f.active.sum())
    d0, d1 = out[0]["diag"], out[1]["diag"]
    assert all(torch.equal(a, b) for a, b in zip(d0, d1))
    np.testing.assert_allclose(float(d0.mean_mll), float(torch.cat(mlls).mean()), rtol=1e-6)
    np.testing.assert_allclose(float(d0.mean_noise), float(torch.cat(noises).mean()), rtol=1e-6)
    assert float(d0.mean_depth) == np.float32(depth) / np.float32(active)


def test_a_failing_rank_fails_the_launch():
    """Three chains do not divide over two ranks: the ranks raise, and the
    launcher raises with the rank's traceback and leaves no process."""
    with pytest.raises(RuntimeError, match="do not divide"):
        launch(graft_entry.rank_sampler, 2, seed=0, n_points=8, num_chains=3, num_trees=4)


def _reference_pt_swap(betas, mlls, chains, key, parity, r):
    """The reference's ``sharded_pt_swap`` on r devices of the virtual mesh,
    with x64 off (as it runs), and its ``fold_in`` uniforms by position."""
    import functools

    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from bark_tpu.parallel.tempering import sharded_pt_swap

    mesh = Mesh(np.array(jax.devices()[:r]), ("replicas",))

    @functools.partial(shard_map, mesh=mesh, in_specs=(P("replicas"),) * 3,
                       out_specs=(P("replicas"), P("replicas")), check_vma=False)
    def go(c, b, m):
        c_local = jax.tree.map(lambda a: a[0], c)
        nc, acc = sharded_pt_swap(key, c_local, b[0], m[0], parity, "replicas", r)
        return jax.tree.map(lambda a: a[None], nc), acc[None]

    out_chains, out_acc = go(chains, betas, mlls)
    u = jnp.stack([jax.random.uniform(jax.random.fold_in(key, i)) for i in range(r)])
    return jax.tree.map(np.asarray, out_chains), np.asarray(out_acc), np.asarray(u)


@pytest.mark.parametrize("parity", [0, 1])
def test_sharded_pt_swap_bit_equal_to_reference(parity):
    from bark_tpu.parallel.tempering import geometric_ladder

    r = 4
    with jax.enable_x64(False):
        betas = geometric_ladder(r)
        # a spread that gives accepts and rejects in both phases
        mlls = jnp.asarray(np.random.default_rng(1).normal(size=r) * 3.0, jnp.float32)
        chains = {"a": jnp.asarray(np.random.default_rng(2).normal(size=(r, 4)), jnp.float32),
                  "b": jnp.arange(r, dtype=jnp.int32) * 7}
        ref_chains, ref_acc, u = _reference_pt_swap(betas, mlls, chains, jax.random.key(42),
                                                    parity, r)
    assert u.dtype == np.float32
    out = launch(graft_entry.rank_pt_swap, r, u=torch.tensor(u),
                 chains={k: torch.tensor(np.asarray(v)) for k, v in chains.items()},
                 betas=torch.tensor(np.asarray(betas)), mlls=torch.tensor(np.asarray(mlls)),
                 parity=parity)
    acc = np.array([bool(a) for _, a in out])
    np.testing.assert_array_equal(acc, ref_acc)
    for k in chains:
        got = np.stack([c[k].numpy() for c, _ in out])
        np.testing.assert_array_equal(got, ref_chains[k])


def test_sharded_pt_follows_pt_swap_states():
    seed, r, steps = 5, 3, 6
    kw = dict(warmup_steps=0, num_samples=1, steps_per_sample=1)
    out = launch(graft_entry.rank_pt, r, seed=seed, n_points=16, num_trees=6,
                 num_steps=steps, params_kw=kw)
    _, params, model, X, y, bounds, ft = graft_entry._problem(16, r, 6, kw)
    mlls, rates, states, _ = graft_entry.single_process_pt(
        seed, r, model.forest, model.noise, model.scale, X, y, bounds, ft, params, steps)
    for i, got in enumerate(out):
        run = got["run"]
        assert torch.equal(run.mll, mlls[:, i])
        assert torch.equal(run.swap_rate, rates)
        assert torch.equal(run.state.mll, states[i].mll)
        for a, b in zip(run.state.forest, states[i].forest):
            assert torch.equal(a, b)
    assert float(out[0]["run"].beta) == 1.0
    assert 0.0 < float(rates.mean()) < 1.0, rates


def test_sharded_smc_matches_run_smc():
    seed, n_ranks = 11, 2
    kw = dict(num_particles=8, num_rounds=5, mutation_steps=1)
    out = launch(graft_entry.rank_smc, n_ranks, seed=seed, n_points=12, num_trees=4, **kw)
    _, params, _, X, y, bounds, ft = graft_entry._problem(12, 1, 4)
    ref = run_smc(torch.Generator().manual_seed(seed), X, y, bounds, ft, params, **kw)
    assert (ref.ess_trace == 8.0).any()  # a round resampled: the state gather ran
    for got in out:
        res = got["result"]
        np.testing.assert_allclose(res.betas.numpy(), ref.betas.numpy(), rtol=1e-6)
        np.testing.assert_allclose(float(res.log_evidence), float(ref.log_evidence), rtol=1e-5)
        np.testing.assert_allclose(res.ess_trace.numpy(), ref.ess_trace.numpy(), rtol=1e-5)
    log_w = torch.cat([got["result"].log_weights for got in out])
    np.testing.assert_allclose(log_w.numpy(), ref.log_weights.numpy(), rtol=1e-5, atol=1e-6)
    assert torch.cat([got["result"].model.noise for got in out]).shape == (8,)


@pytest.fixture(scope="module")
def fitted():
    bench = map_benchmark("TreeFunction", dim=3, m=5, function_seed=1)
    rng = np.random.default_rng(0)
    X = bench.domain.sample(16, rng)
    params = SamplerParams(warmup_steps=10, num_samples=4, steps_per_sample=2,
                           num_chains=2, num_trees=5)
    sur = BARKSurrogate(bench.domain, params, seed=0, device="cpu").fit(X, bench.f(X))
    cands = torch.as_tensor(bench.domain.sample(64, rng))
    return bench, sur, cands


def test_sharded_scoring_and_propose_are_bit_equal(fitted):
    bench, sur, cands = fitted
    tx, ty = sur.train_data
    ft = sur._feat_types
    acq = build_acquisition(sur.model, tx, ty, ft, sur.params.max_depth, sur.train_mask)
    draws = draw_search(torch.Generator().manual_seed(0), 64, bench.domain.dim, 2)
    out = launch(graft_entry.rank_scoring, 2, acq=acq, candidates=cands, feat_types=ft,
                 max_depth=sur.params.max_depth, search_draws=draws, domain=bench.domain)
    want = evaluate_acquisition(acq, cands, ft, sur.params.max_depth)
    x_want, v_want = propose(draws, acq, bench.domain, ft, max_depth=sur.params.max_depth,
                             return_center=False)
    for got in out:
        assert torch.equal(got["scores"], want)
        np.testing.assert_array_equal(got["proposal"][0], x_want)
        assert got["proposal"][1] == v_want


def test_sharded_cg_predict_matches_forest_predict_cg(fitted):
    _, sur, cands = fitted
    tx, ty = sur.train_data
    ft = sur._feat_types
    out = launch(graft_entry.rank_cg, 2, model=sur.model, train_x=tx, train_y=ty,
                 candidates=cands, feat_types=ft, max_depth=sur.params.max_depth,
                 train_mask=sur.train_mask)
    mu, var = forest_predict_cg(sur.model.forest, sur.model.noise, sur.model.scale, tx, ty,
                                cands, ft, sur.params.max_depth, train_mask=sur.train_mask)
    for got in out:
        np.testing.assert_allclose(got["mu"].numpy(), mu.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(mu.abs().max()))
        np.testing.assert_allclose(got["var"].numpy(), var.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(var.abs().max()))


def test_entry_initial_mll_equals_the_reference():
    import __graft_entry__ as ref_entry
    from bark_tpu.fitting.sampler import init_chain_state as jinit

    fn, (draws, forest, noise, scale, X, y, bounds, ft) = graft_entry.entry("cpu")
    _, params, *_ = graft_entry._problem(16, 4, 8)
    state = init_chain_state(forest, noise, scale, X, y, ft, params, bounds=bounds)
    with jax.enable_x64(False):
        _, jparams, jmodel, jX, jy, jbounds, jft = ref_entry._problem(16, 4, 8)
        np.testing.assert_array_equal(np.asarray(jX), X.numpy())
        jmll = jax.vmap(lambda f, n, s: jinit(f, n, s, jX, jy, jft, jparams,
                                              bounds=jbounds).mll)(
            jmodel.forest, jmodel.noise, jmodel.scale)
    np.testing.assert_allclose(state.mll.numpy(), np.asarray(jmll), rtol=1e-6)
    mll, new_noise, new_scale = fn(draws, forest, noise, scale, X, y, bounds, ft)
    assert mll.shape == (4,) and bool(torch.isfinite(mll).all())


def test_dryrun_multichip_on_two_cpu_ranks():
    out = graft_entry.dryrun_multichip(2, device="cpu")
    assert len(out) == 2
    assert torch.equal(out[0]["sampler"]["diag"].mean_mll, out[1]["sampler"]["diag"].mean_mll)
    assert torch.equal(out[0]["leaf"]["diag"].mean_noise, out[1]["leaf"]["diag"].mean_noise)
    assert out[0]["leaf"]["run"].state.kern.L is not None  # N=512 ran the leaf tier
    assert out[0]["pt"]["run"].samples.noise.shape == (2,)
