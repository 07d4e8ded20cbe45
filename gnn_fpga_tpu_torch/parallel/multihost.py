"""Multi-process initialisation and per-process data sharding.

The counterpart of ``gnn_fpga_tpu/parallel/multihost.py`` on
``torch.distributed``:

- :func:`initialize`: ``torch.distributed.init_process_group``, a no-op
  when there is neither an argument nor a launcher's environment, and
  idempotent;
- :func:`process_info`, :func:`local_shard`, :func:`host_slice`: this
  process's place in the world and its share of a global work list or
  batch, with the JAX functions' arithmetic;
- :func:`global_batch_to_device`: this process's local slice of a batch on
  its device.

Deliberate differences: each process drives one device (the card of its
``LOCAL_RANK`` under NCCL), so ``process_info()["local_devices"]`` is 1;
and torch has no global array, so :func:`global_batch_to_device` returns
the local slice it is given, on this process's device.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def default_backend(device=None) -> str:
    """``"nccl"`` for ranks on a card, ``"gloo"`` on the CPU; with no
    device given, by whether a card is present."""
    if device is None:
        return "nccl" if torch.cuda.is_available() else "gloo"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join the process group (idempotent; a no-op for a single process).

    ``coordinator_address``: ``host:port`` (TCP) or an init URL such as
    ``tcp://host:port`` or ``file:///path``, with ``num_processes`` and
    ``process_id``.  With no arguments the launcher's environment is read
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` as
    ``torchrun`` sets them); with neither this does nothing.

    ``backend`` defaults to ``"nccl"`` when a card is present and
    ``"gloo"`` otherwise.  Under NCCL each process takes the card of its
    local rank (``LOCAL_RANK``, else ``process_id`` modulo the cards); NCCL
    refuses two ranks on one card, so a launcher's local world larger than
    the cards (``LOCAL_WORLD_SIZE``) raises here: several ranks on one
    card must ask for ``backend="gloo"``.  Nothing picks another backend
    quietly.
    """
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and num_processes is None:
        if not all(k in env for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE")):
            return
        init_method, world, rank = ("env://", int(env["WORLD_SIZE"]),
                                    int(env["RANK"]))
    else:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("initialize needs coordinator_address, "
                             "num_processes and process_id together")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world, rank = int(num_processes), int(process_id)
    backend = backend or default_backend()
    if backend == "nccl":
        n_cards = torch.cuda.device_count()
        local = int(env.get("LOCAL_RANK", rank % max(n_cards, 1)))
        local_world = int(env.get("LOCAL_WORLD_SIZE", 1))
        if local >= n_cards or local_world > n_cards:
            raise RuntimeError(
                f"NCCL takes one card a rank: {local_world} ranks on this "
                f"host, {n_cards} cards; several ranks on one card need "
                "backend='gloo'")
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)


def initialize_single(backend: Optional[str] = None) -> None:
    """A world of this one process (an in-memory store, no network), unless
    a process group exists already; the single-process runs of the
    parallel paths use it."""
    if dist.is_initialized():
        return
    dist.init_process_group(backend or default_backend(),
                            store=dist.HashStore(), world_size=1, rank=0)


def _rank_and_world():
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_info() -> dict:
    """{'process_id', 'process_count', 'local_devices', 'global_devices'}:
    one device a process."""
    rank, world = _rank_and_world()
    return {"process_id": rank, "process_count": world, "local_devices": 1,
            "global_devices": world}


def local_shard(items: Sequence, process_id: Optional[int] = None,
                process_count: Optional[int] = None) -> list:
    """This process's strided shard of a global work list: every process
    gets ``len(items) // n`` items (the trailing ``len(items) % n`` are
    dropped everywhere, since unequal per-process batch counts deadlock
    collectives)."""
    rank, world = _rank_and_world()
    pid = rank if process_id is None else process_id
    n = world if process_count is None else process_count
    per = len(items) // n
    return list(items[pid::n][:per])


def host_slice(n_global: int, process_id: Optional[int] = None,
               process_count: Optional[int] = None) -> slice:
    """Contiguous ``[start, stop)`` range of a global batch owned by this
    process (the batch split evenly across processes)."""
    rank, world = _rank_and_world()
    pid = rank if process_id is None else process_id
    n = world if process_count is None else process_count
    if n_global % n:
        raise ValueError(f"global batch {n_global} not divisible by {n} hosts")
    per = n_global // n
    return slice(pid * per, (pid + 1) * per)


def global_batch_to_device(local_tree, mesh, axis: str = "data"):
    """This process's local slice of a globally sharded batch, on its
    device (torch has no global array: the local slice is what a rank
    computes on).  ``local_tree`` is a tensor, a numpy array or a
    :class:`~gnn_fpga_tpu_torch.core.graph.TensorFields` tree; ``axis``
    names the mesh dimension the batch is sharded over, kept for the JAX
    function's signature."""
    from gnn_fpga_tpu_torch.parallel.mesh import mesh_device

    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no dimension {axis!r}")
    if isinstance(local_tree, np.ndarray):
        local_tree = torch.from_numpy(local_tree)
    return local_tree.to(mesh_device(mesh))
