"""Chain parallelism over ranks: the chain mesh and the sharded sampler.

Counterpart of ``bark_tpu/parallel/sharding.py``. Chains are independent
between the points where the reference reduced them, so each rank runs
:func:`run_chain` on its own block of chains and the only collective is one
``all_reduce`` of four scalars for the cross-chain diagnostics (the
reference's ``psum``). Every rank launches K1 and K2 on its block exactly as
a single process would on the same chains: the Gram and the factorizations
of a rank are those of its chains alone.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.fitting.sampler import BARKModel, ChainRun, StepDraws, run_chain
from bark_tpu_torch.forest import Forest
from bark_tpu_torch.parallel.distributed import all_reduce, global_chain_mesh, mesh_rank


def chain_mesh(n_devices: int | None = None):
    """1-D mesh with a single ``chains`` dimension over every rank of the
    process group (``n_devices``, when given, must be the number of ranks)."""
    mesh = global_chain_mesh("chains")
    if n_devices is not None and n_devices != mesh.size():
        raise ValueError(f"chain_mesh: {n_devices} devices asked for, {mesh.size()} ranks")
    return mesh


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """A generator on ``device`` seeded by (seed, rank): the pair is mixed by
    numpy's ``SeedSequence``, so the ranks' streams do not overlap."""
    mixed = np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed >> 1))


class ChainDiagnostics(NamedTuple):
    """Cross-chain summaries, reduced over every rank."""

    mean_mll: torch.Tensor  # () final MLL, mean over chains
    mean_noise: torch.Tensor  # () sampled noise, mean over chains and samples
    mean_depth: torch.Tensor  # () depth of the active nodes of every sample


def _block(t: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    if t.shape[0] % size:
        raise ValueError(f"{t.shape[0]} rows do not divide over {size} ranks")
    local = t.shape[0] // size
    return t[rank * local:(rank + 1) * local]


def shard_model(model: BARKModel, mesh) -> BARKModel:
    """This rank's block of a chain-batched model (leading chain dim, which
    must divide by the number of ranks)."""
    rank, size = mesh_rank(mesh)
    return BARKModel(
        Forest(*(_block(t, rank, size) for t in model.forest)),
        _block(model.noise, rank, size), _block(model.scale, rank, size),
    )


def sharded_run_sampler(
    seed: int,
    model: BARKModel,
    X: torch.Tensor,
    y: torch.Tensor,
    bounds: torch.Tensor,
    feat_types: torch.Tensor,
    params: SamplerParams,
    mesh,
    mask: torch.Tensor | None = None,
    draws: Sequence[StepDraws] | None = None,
) -> tuple[ChainRun, ChainDiagnostics]:
    """Run this rank's chains (``model``, from :func:`shard_model`) and
    reduce the diagnostics over every rank.

    Data, bounds and mask are replicated. Draws come from
    :func:`rank_generator` (seed, rank), or step t takes ``draws[t]`` (this
    rank's rows). Returns this rank's :class:`ChainRun` and the diagnostics,
    equal on every rank: ``mean_mll`` over the final MLL of every chain,
    ``mean_noise`` over every sample's noise, ``mean_depth`` the depth
    summed over the active nodes of every sample over their count.
    """
    rank, size = mesh_rank(mesh)
    generator = rank_generator(seed, rank, X.device)
    run = run_chain(generator, model, X, y, bounds, feat_types, params, mask, draws)
    forest = run.samples.forest
    sums = torch.stack([
        run.state.mll.sum(),
        run.samples.noise.sum(),
        (forest.depth * forest.active).sum(dtype=torch.float32),
        forest.active.sum(dtype=torch.float32),
    ])
    sums = all_reduce(sums, mesh)
    chains = size * run.state.mll.shape[0]
    diag = ChainDiagnostics(
        mean_mll=sums[0] / chains,
        mean_noise=sums[1] / (chains * params.num_samples),
        mean_depth=sums[2] / sums[3],
    )
    return run, diag
