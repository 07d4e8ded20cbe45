"""Device meshes: a ``data`` dimension for data parallelism over graphs in a
step, a ``graph`` dimension for one large graph partitioned across ranks
(``parallel/partition.py``).

The counterpart of ``gnn_fpga_tpu/parallel/mesh.py`` on
``torch.distributed.device_mesh.DeviceMesh``: one rank a device, each
mesh dimension's process group from ``mesh.get_group(name)``.  The
sharding specs become the placements they stand for (``Replicate()``,
``Shard(0)``).

Deliberate difference: ``shard_map`` has no counterpart.  Each rank runs
the shard body on its own shard, as one process of the group, and the
collectives inside it name the mesh dimension's group; there is no global
program for a ``shard_map`` to split.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from gnn_fpga_tpu_torch.core.device import default_device
from gnn_fpga_tpu_torch.core.graph import index_fields

DATA_AXIS = "data"
GRAPH_AXIS = "graph"


def make_mesh(axis_sizes: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = (DATA_AXIS,),
              device=None) -> DeviceMesh:
    """A DeviceMesh over every rank of the (initialised) world.

    Default: all ranks on one ``data`` dimension.  Pass ``axis_sizes=(n_data,
    n_graph)`` with ``axis_names=("data", "graph")`` for hybrid data x graph
    parallelism.  ``device``: the ranks' device type, the card unless
    ``"cpu"`` is given.
    """
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call parallel.multihost."
            "initialize (or initialize_single for one process) first")
    n = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = (n,) if len(axis_names) == 1 else None
    if axis_sizes is None:
        raise ValueError("axis_sizes required for multi-axis meshes")
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(f"axis sizes {axis_sizes} don't cover {n} ranks")
    return DeviceMesh(default_device(device).type,
                      torch.arange(n).reshape(tuple(axis_sizes)),
                      mesh_dim_names=tuple(axis_names))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def replicated(mesh: DeviceMesh) -> tuple:
    """The placements of a tensor replicated on every rank."""
    return (Replicate(),) * mesh.ndim


def batch_sharded(mesh: DeviceMesh, axis: str = DATA_AXIS) -> tuple:
    """The placements of a tensor whose leading (batch) axis is split over
    mesh dimension ``axis`` and replicated over the others."""
    return tuple(Shard(0) if name == axis else Replicate()
                 for name in mesh.mesh_dim_names)


def shard_batch(tree, mesh: DeviceMesh, axis: str = DATA_AXIS,
                dim: int = 0):
    """This rank's slice of dimension ``dim`` of every tensor of ``tree``
    (a tensor or a :class:`~gnn_fpga_tpu_torch.core.graph.TensorFields`
    such as a batched Graph), on this rank's device: rank ``r`` of ``P``
    along mesh dimension ``axis`` takes rows ``[r * B / P, (r + 1) * B /
    P)``.  ``dim=1`` splits the batch axis of a stack of batches
    ``[K, B, ...]`` (:func:`~gnn_fpga_tpu_torch.train.trainer.
    stack_batches`), as the JAX package shards ``P(None, DATA)``."""
    r, p = mesh.get_local_rank(axis), mesh.size(mesh.mesh_dim_names.index(
        axis))
    n = (tree if isinstance(tree, torch.Tensor) else next(tree.tensors())
         ).shape[dim]
    if n % p:
        raise ValueError(f"batch {n} not divisible by {p} ranks on {axis!r}")
    per = n // p
    return index_fields(tree, slice(r * per, (r + 1) * per), dim).to(
        mesh_device(mesh))
