"""Multi-process start-up and the collectives of the sharded paths.

Counterpart of ``bark_tpu/parallel/distributed.py``. Each process (a
"rank") calls :func:`initialize_distributed` once, after which
:func:`global_chain_mesh` is a 1-D ``DeviceMesh`` over every rank and the
sharded functions (``parallel.sharding``, ``parallel.tempering``,
``parallel.smc``, ``optimizer.acquisition``, ``ops.iterative``) take it as
their ``mesh``. Where the reference let XLA insert collectives into a
``shard_map``, the port calls them explicitly through the helpers below.

The settings come from the arguments, else from torch's own environment
(``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
as ``torchrun`` sets them). There is no quiet single-process mode: without
settings :func:`initialize_distributed` raises and names what is missing.

The backend is NCCL for a CUDA device and Gloo for the CPU. NCCL refuses
two ranks on one GPU, so ranks that share a card pass ``backend="gloo"``.
Gloo has no point-to-point or gather on CUDA tensors: the helpers here copy
the few tensors they exchange to the host and back for a Gloo group, and
the compute stays on the card. They choose by the group's backend, never by
catching an error.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

#: how long a rank waits for the others at start-up and in a collective
TIMEOUT = datetime.timedelta(seconds=300)


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return int(value) if value else None


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device=None,
) -> torch.device:
    """Join the process group of ``num_processes`` ranks as ``process_id``.

    ``coordinator_address`` is an init-method URL (``tcp://host:port``,
    ``file:///path``) or ``host:port``; without it, ``MASTER_ADDR`` and
    ``MASTER_PORT`` from the environment (``env://``). ``num_processes`` and
    ``process_id`` default to ``WORLD_SIZE`` and ``RANK``. ``device=None``
    means CUDA: the rank takes ``cuda:(LOCAL_RANK % device_count)``
    (LOCAL_RANK defaults to the rank) and the backend defaults to NCCL;
    ``device="cpu"`` defaults to Gloo. Returns this rank's device. A second
    call in a process that has joined returns the device again.
    """
    device = torch.device(device) if device is not None else torch.device("cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless the caller "
                'asks for the CPU (device="cpu")'
            )
        if device.index is None:
            local = _env_int("LOCAL_RANK")
            rank = process_id if process_id is not None else _env_int("RANK")
            local = local if local is not None else (rank or 0)
            device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device

    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if coordinator_address is None:
        have = [k for k in ("MASTER_ADDR", "MASTER_PORT") if os.environ.get(k)]
        init_method = "env://" if len(have) == 2 else None
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    missing = [
        what for what, value in (
            ("coordinator_address (or MASTER_ADDR and MASTER_PORT)", init_method),
            ("num_processes (or WORLD_SIZE)", world),
            ("process_id (or RANK)", rank),
        ) if value is None
    ]
    if missing:
        raise RuntimeError(
            "initialize_distributed: no process group settings: " + ", ".join(missing)
        )
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank, timeout=TIMEOUT
    )
    return device


def global_chain_mesh(axis_name: str = "chains"):
    """1-D ``DeviceMesh`` over every rank, its one dimension named
    ``axis_name``: of CUDA devices for an NCCL group, of the CPU for a Gloo
    one (whose collectives go through the host, wherever the tensors are)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("global_chain_mesh: call initialize_distributed first")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=(axis_name,))


def mesh_rank(mesh) -> tuple[int, int]:
    """(this rank's coordinate, number of ranks) on a 1-D mesh."""
    return mesh.get_local_rank(), mesh.size()


# --- collectives -------------------------------------------------------------


def _via_host(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _wire(t: torch.Tensor, host: bool) -> torch.Tensor:
    """The tensor a collective sends: contiguous, bool as uint8, on the
    host for a Gloo group."""
    t = t.contiguous()
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return t.cpu() if host else t


def all_reduce(t: torch.Tensor, mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of ``t`` over the mesh's ranks, on ``t``'s device."""
    group = mesh.get_group()
    buf = _wire(t, _via_host(group)).clone()
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(device=t.device, dtype=t.dtype)


def all_gather(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0, in rank order (each rank
    gives the same shape)."""
    group = mesh.get_group()
    buf = _wire(t, _via_host(group))
    parts = [torch.empty_like(buf) for _ in range(mesh.size())]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts).to(device=t.device, dtype=t.dtype)


def all_gather_tree(tree, mesh):
    """:func:`all_gather` of every tensor of a pytree (None fields stay)."""
    leaves, spec = pytree.tree_flatten(tree)
    return pytree.tree_unflatten(
        [None if t is None else all_gather(t, mesh) for t in leaves], spec
    )


def exchange_tree(tree, peer: int, mesh):
    """Send every tensor of ``tree`` (None fields stay) to mesh coordinate
    ``peer`` and receive the peer's (same structure and shapes) in one
    ``batch_isend_irecv``."""
    group = mesh.get_group()
    host = _via_host(group)
    peer = dist.get_global_rank(group, peer)
    leaves, spec = pytree.tree_flatten(tree)
    tensors = [t for t in leaves if t is not None]
    sends = [_wire(t, host) for t in tensors]
    recvs = [torch.empty_like(s) for s in sends]
    ops = []
    for s, r in zip(sends, recvs):
        ops.append(dist.P2POp(dist.isend, s, peer, group))
        ops.append(dist.P2POp(dist.irecv, r, peer, group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    got = iter(r.to(device=t.device, dtype=t.dtype) for r, t in zip(recvs, tensors))
    return pytree.tree_unflatten([None if t is None else next(got) for t in leaves], spec)
