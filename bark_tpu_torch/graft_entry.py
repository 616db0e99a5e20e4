"""Entry points of the port: one sampler step, and multi-process dry runs.

Counterpart of the repository's ``__graft_entry__.py``. :func:`entry`
returns one full forest-MCMC step (init + m tree moves + the noise move) of
4 chains at N=16, m=8, on the reference's problem, with its example
arguments. :func:`dryrun_multichip` starts ``n_ranks`` processes, joins
them into one process group and runs the sharded sampler (dense and leaf
tier) and sharded parallel tempering in them.

:func:`launch` is the launcher under both: it spawns the ranks, runs a
function of this module in each with the rank's mesh and device, and
returns each rank's result with its tensors on the host. The rank functions
(``rank_*``) live here, so a spawned rank imports nothing but the port.
The ``single_process_*`` functions are the single-process counterparts the
sharded runs are held to.

    python -m bark_tpu_torch.graft_entry            # on the GPU
    python -m bark_tpu_torch.graft_entry --cpu 2    # two Gloo ranks on the CPU
"""

from __future__ import annotations

import multiprocessing as mp
import pickle
import queue as queue_module
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
from torch.utils import _pytree as pytree

from bark_tpu_torch.domain import CategoricalInput, ContinuousInput, Domain
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.fitting.sampler import (
    BARKModel,
    draw_step,
    init_chain_state,
    step,
    step_with_info,
)
from bark_tpu_torch.forest import Forest, create_empty_forest
from bark_tpu_torch.models.surrogate import resolve_device


def _problem(n_points: int, num_chains: int, num_trees: int, params_kw=None, device=None):
    """The reference's ``__graft_entry__._problem``: two continuous inputs
    and a categorical one, y standard normal, empty forests, noise 0.1."""
    domain = Domain([
        ContinuousInput("x_0", (0.0, 1.0)),
        ContinuousInput("x_1", (0.0, 1.0)),
        CategoricalInput("c_0", ("a", "b", "c")),
    ])
    params = SamplerParams(num_chains=num_chains, num_trees=num_trees, **(params_kw or {}))
    rng = np.random.default_rng(0)
    X = torch.as_tensor(domain.sample(n_points, rng), device=device)
    y = torch.as_tensor(rng.standard_normal(n_points).astype(np.float32), device=device)
    bounds = torch.as_tensor(domain.bounds("bitmask"), device=device)
    feat_types = torch.as_tensor(domain.feature_types(), device=device)
    forest = create_empty_forest(num_trees, params.node_limit, (num_chains,), device)
    model = BARKModel(
        forest,
        torch.full((num_chains,), 0.1, dtype=torch.float32, device=device),
        torch.ones(num_chains, dtype=torch.float32, device=device),
    )
    return domain, params, model, X, y, bounds, feat_types


def entry(device=None):
    """(fn, example_args): one forest-MCMC step of 4 chains at N=16, m=8.

    ``fn(draws, forest, noise, scale, X, y, bounds, feat_types)`` builds the
    chain state and takes one step with ``draws`` (a :class:`StepDraws` of
    4 rows); it returns the chains' (mll, noise, scale).
    """
    device = resolve_device(device)
    _, params, model, X, y, bounds, feat_types = _problem(16, 4, 8, device=device)

    def forward_step(draws, forest, noise, scale, X, y, bounds, feat_types):
        state = init_chain_state(forest, noise, scale, X, y, feat_types, params, bounds=bounds)
        state = step(state, X, y, bounds, feat_types, params, draws)
        return state.mll, state.noise, state.scale

    draws = draw_step(torch.Generator(device=device).manual_seed(0), 4, params)
    return forward_step, (draws, model.forest, model.noise, model.scale, X, y, bounds, feat_types)


# --- the launcher -------------------------------------------------------------


def _to_host(tree):
    return pytree.tree_map(
        lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t, tree
    )


def _to_device(tree, device):
    return pytree.tree_map(
        lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, tree
    )


def _rank_main(fn, rank, n_ranks, init_method, device, backend, payload, results):
    import torch.distributed as dist

    from bark_tpu_torch.parallel.distributed import global_chain_mesh, initialize_distributed

    try:
        dev = initialize_distributed(init_method, n_ranks, rank, backend, device)
        mesh = global_chain_mesh()
        with open(payload, "rb") as f:
            kwargs = pickle.load(f)
        out = fn(mesh, dev, **_to_device(kwargs, dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        # plain pickle: the queue's own would share tensors through file
        # descriptors that die with this process
        results.put((rank, True, pickle.dumps(_to_host(out))))
        dist.destroy_process_group()
    except Exception:  # reported to the parent, which stops every rank
        results.put((rank, False, traceback.format_exc()))


def launch(fn, n_ranks: int, device=None, backend: str | None = None,
           timeout: float = 600.0, **payload) -> list:
    """Run ``fn(mesh, device, **payload)`` in ``n_ranks`` spawned processes
    joined into one process group (Gloo on the CPU, NCCL on CUDA unless
    ``backend`` says otherwise; ranks that share one GPU need
    ``backend="gloo"``). Tensors of ``payload`` go to each rank's device.
    Returns each rank's result, in rank order, with its tensors on the host.
    A rank that raises, dies or outlives ``timeout`` seconds stops every
    rank, and the error is raised here."""
    device = resolve_device(device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        # the payload goes through a file: written to a spawned process's
        # pipe, a large one would block the start of every rank after one
        # that dies before reading it
        with open(f"{tmp}/payload.pkl", "wb") as f:
            pickle.dump(_to_host(payload), f)
        procs = [
            ctx.Process(
                target=_rank_main,
                args=(fn, rank, n_ranks, f"file://{tmp}/pg", device, backend,
                      f"{tmp}/payload.pkl", results),
                daemon=True,
            )
            for rank in range(n_ranks)
        ]
        for p in procs:
            p.start()
        out = [None] * n_ranks
        deadline = time.monotonic() + timeout
        try:
            for _ in range(n_ranks):
                while True:
                    try:
                        rank, ok, value = results.get(timeout=1.0)
                        break
                    except queue_module.Empty:
                        dead = [(i, p.exitcode) for i, p in enumerate(procs)
                                if p.exitcode not in (None, 0)]
                        if dead:
                            raise RuntimeError(f"rank(s) died without a result: {dead}")
                        if time.monotonic() > deadline:
                            raise TimeoutError(f"{fn.__name__}: ranks ran past {timeout} s")
                if not ok:
                    raise RuntimeError(f"rank {rank} of {fn.__name__} failed:\n{value}")
                out[rank] = pickle.loads(value)
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    return out


# --- rank functions -------------------------------------------------------------
#
# Each takes the rank's mesh and device first, sets the kernels' launch
# counts to 0, and returns what the rank computed with the launches it made.


def reset_launches() -> None:
    """Set both kernels' launch counts of this process to 0."""
    from bark_tpu_torch.ops.chol import chol_inv_cuda
    from bark_tpu_torch.ops.gram import gram_cuda

    gram_cuda.launches = chol_inv_cuda.launches = 0


def launch_counts() -> dict:
    """Both kernels' launch counts of this process."""
    from bark_tpu_torch.ops.chol import chol_inv_cuda
    from bark_tpu_torch.ops.gram import gram_cuda

    return {"gram": gram_cuda.launches, "chol_inv": chol_inv_cuda.launches}


def rank_sampler(mesh, device, seed, n_points, num_chains, num_trees, params_kw=None):
    """The sharded sampler over :func:`_problem`'s chains; returns this
    rank's run and the diagnostics."""
    from bark_tpu_torch.parallel.sharding import shard_model, sharded_run_sampler

    reset_launches()
    _, params, model, X, y, bounds, ft = _problem(
        n_points, num_chains, num_trees, params_kw, device
    )
    run, diag = sharded_run_sampler(seed, shard_model(model, mesh), X, y, bounds, ft, params, mesh)
    return {"run": run, "diag": diag, "launches": launch_counts()}


def rank_pt_swap(mesh, device, u, chains, betas, mlls, parity):
    """One :func:`sharded_pt_swap` phase; rank i takes row i of ``chains``
    (a pytree with a leading replica dim), ``betas`` and ``mlls``."""
    from bark_tpu_torch.parallel.tempering import sharded_pt_swap

    i = mesh.get_local_rank()
    mine = pytree.tree_map(lambda t: t[i], chains)
    return sharded_pt_swap(u, mine, betas[i], mlls[i], parity, mesh)


def rank_pt(mesh, device, seed, n_points, num_trees, num_steps, beta_min=0.05, params_kw=None):
    """Sharded PT on :func:`_problem`'s data, one replica per rank from
    empty forests."""
    from bark_tpu_torch.parallel.sharding import shard_model
    from bark_tpu_torch.parallel.tempering import run_parallel_tempering_sharded

    reset_launches()
    _, params, model, X, y, bounds, ft = _problem(
        n_points, mesh.size(), num_trees, params_kw, device
    )
    local = shard_model(model, mesh)
    run = run_parallel_tempering_sharded(
        seed, local.forest, local.noise, local.scale, X, y, bounds, ft, params, mesh,
        num_steps=num_steps, beta_min=beta_min,
    )
    return {"run": run, "launches": launch_counts()}


def rank_smc(mesh, device, seed, n_points, num_trees, num_particles, num_rounds,
             mutation_steps, params_kw=None):
    """Sharded SMC on :func:`_problem`'s data, every rank's generator seeded
    by ``seed``."""
    from bark_tpu_torch.parallel.smc import run_smc_sharded

    reset_launches()
    _, params, _, X, y, bounds, ft = _problem(n_points, 1, num_trees, params_kw, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    result = run_smc_sharded(
        gen, X, y, bounds, ft, params, mesh, num_particles=num_particles,
        num_rounds=num_rounds, mutation_steps=mutation_steps,
    )
    return {"result": result, "launches": launch_counts()}


def rank_scoring(mesh, device, acq, candidates, feat_types, max_depth=16,
                 search_draws=None, domain=None):
    """Sharded scoring of ``candidates``; with ``search_draws``, also one
    ``propose(mesh=...)`` over ``domain`` (no centring)."""
    from bark_tpu_torch.optimizer.acquisition import evaluate_acquisition_sharded
    from bark_tpu_torch.optimizer.search import propose

    reset_launches()
    out = {"scores": evaluate_acquisition_sharded(acq, candidates, feat_types, mesh, max_depth)}
    out["launches"] = launch_counts()
    if search_draws is not None:
        out["proposal"] = propose(search_draws, acq, domain, feat_types, max_depth=max_depth,
                                  return_center=False, mesh=mesh)
    return out


def rank_cg(mesh, device, model, train_x, train_y, candidates, feat_types, max_depth=16,
            train_mask=None):
    """``forest_predict_cg`` with the training rows split over the ranks."""
    from bark_tpu_torch.models.gp import forest_predict_cg

    reset_launches()
    mu, var = forest_predict_cg(
        model.forest, model.noise, model.scale, train_x, train_y, candidates, feat_types,
        max_depth, train_mask=train_mask, mesh=mesh,
    )
    return {"mu": mu, "var": var, "launches": launch_counts()}


# --- single-process counterparts ------------------------------------------------


def single_process_pt(seed, num_replicas, forest, noise, scale, X, y, bounds, feat_types,
                      params, num_steps, beta_min=0.05, mask=None):
    """What :func:`run_parallel_tempering_sharded` computes over R ranks, in
    one process: each replica's step on its own (one row, as on its rank),
    from the draws its rank makes, then :func:`pt_swap_states` on the R rows
    for each phase. Returns the (T, R) MLL trace, the (T,) swap rate, the
    final states and the (T, R) noise trace."""
    from bark_tpu_torch.parallel.sharding import rank_generator
    from bark_tpu_torch.parallel.tempering import geometric_ladder, pt_swap_states

    dev = X.device
    r = num_replicas
    betas = geometric_ladder(r, beta_min, dev)
    states = [
        init_chain_state(Forest(*(t[i:i + 1] for t in forest)), noise[i:i + 1],
                         scale[i:i + 1], X, y, feat_types, params, mask, bounds)
        for i in range(r)
    ]
    step_gens = [rank_generator(seed, i, dev) for i in range(r)]
    swap_gen = torch.Generator(device=dev).manual_seed(seed)
    cat = lambda rows: pytree.tree_map(lambda *t: None if t[0] is None else torch.cat(t), *rows)  # noqa: E731
    mlls, rates = [], []
    noises = []
    for _ in range(num_steps):
        # the draws of draw_sharded_pt_round: each rank's step from its own
        # generator, the uniforms (alike on every rank) from the shared one
        states = [
            step_with_info(states[i], X, y, bounds, feat_types, params,
                           draw_step(step_gens[i], 1, params, dev), mask, beta=betas[i])[0]
            for i in range(r)
        ]
        u_even, u_odd = torch.rand((2, r), generator=swap_gen, device=dev)
        chains = cat(states)
        chains, acc_e = pt_swap_states(u_even, chains, betas, chains.mll, 0)
        chains, acc_o = pt_swap_states(u_odd, chains, betas, chains.mll, 1)
        states = [chains.take(torch.tensor([i], device=dev)) for i in range(r)]
        mlls.append(chains.mll)
        noises.append(chains.noise)
        rates.append((acc_e.sum() + acc_o.sum()).to(torch.float32) / (2.0 * max(r - 1, 1)))
    return torch.stack(mlls), torch.stack(rates), states, torch.stack(noises)


# --- the dry run ------------------------------------------------------------------

#: what the dry run drives on each rank, at the reference's sizes: the sharded
#: sampler in the dense tier (2 chains a rank, N=8) and in the leaf tier (one
#: chain a rank at N=512, which resolves to it), and sharded PT (2 rounds)
DRYRUN = {
    "sampler": dict(seed=0, n_points=8, chains_per_rank=2, num_trees=4,
                    params_kw=dict(warmup_steps=1, num_samples=1, steps_per_sample=1)),
    "leaf": dict(seed=2, n_points=512, chains_per_rank=1, num_trees=4,
                 params_kw=dict(warmup_steps=0, num_samples=1, steps_per_sample=1)),
    "pt": dict(seed=1, n_points=8, num_trees=4, num_steps=2),
}


def _dryrun_rank(mesh, device, sampler, leaf, pt, smc=None, scoring=None, cg=None):
    n = mesh.size()
    out = {}
    for name, kw in (("sampler", sampler), ("leaf", leaf)):
        kw = dict(kw)
        out[name] = rank_sampler(mesh, device, num_chains=n * kw.pop("chains_per_rank"), **kw)
    out["pt"] = rank_pt(mesh, device, **pt)
    for name, fn, kw in (("smc", rank_smc, smc), ("scoring", rank_scoring, scoring),
                         ("cg", rank_cg, cg)):
        if kw is not None:
            out[name] = fn(mesh, device, **kw)
    return out


def dryrun_multichip(n_ranks: int, device=None, backend: str | None = None,
                     timeout: float = 600.0, **parts) -> list:
    """Run every sharded path in ``n_ranks`` spawned ranks: the sharded
    sampler (dense and leaf tier) and sharded PT at :data:`DRYRUN`'s sizes
    or those given in ``parts`` (``sampler``, ``leaf``, ``pt``: keyword
    dicts of the rank functions), and, when given, ``smc``, ``scoring`` and
    ``cg`` (keyword dicts of :func:`rank_smc`, :func:`rank_scoring`,
    :func:`rank_cg`). Checks that every rank's diagnostics agree and the
    samples are finite; returns each rank's results by part. Ranks sharing
    one GPU need ``backend="gloo"``."""
    kw = {**DRYRUN, **parts}
    out = launch(_dryrun_rank, n_ranks, device=device, backend=backend, timeout=timeout, **kw)
    for part in ("sampler", "leaf"):
        diags = [r[part]["diag"] for r in out]
        if not all(torch.equal(torch.stack(d), torch.stack(diags[0])) for d in diags):
            raise AssertionError(f"{part}: the ranks' diagnostics differ: {diags}")
        if not all(bool(torch.isfinite(r[part]["run"].samples.noise).all()) for r in out):
            raise AssertionError(f"{part}: non-finite samples")
    if not all(bool(torch.isfinite(r["pt"]["run"].samples.noise).all()) for r in out):
        raise AssertionError("pt: non-finite samples")
    return out


if __name__ == "__main__":
    cpu = "--cpu" in sys.argv
    n = int(sys.argv[-1]) if cpu else max(torch.cuda.device_count(), 1)
    fn, args = entry("cpu" if cpu else None)
    print("entry ok:", [tuple(t.shape) for t in fn(*args)])
    for rank, parts in enumerate(dryrun_multichip(n, "cpu" if cpu else None)):
        print(f"dryrun_multichip rank {rank}: mean MLL "
              f"{float(parts['sampler']['diag'].mean_mll):.4f}")
