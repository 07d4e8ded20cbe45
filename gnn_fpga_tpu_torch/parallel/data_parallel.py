"""Data-parallel training over the mesh's ``data`` dimension.

The counterpart of ``gnn_fpga_tpu/parallel/data_parallel.py``.  Every rank
holds the whole model and takes its slice of the batch's leading axis
(``mesh.shard_batch``).  The loss is the masked mean over the **whole**
batch, as the JAX step computes it over its sharded batch: each rank's
masked sum over the count summed over all ranks (not a mean of per-rank
means).  Each rank backpropagates its own share, the parameter gradients
are **summed** over the ranks (so they equal the single-device gradient of
the whole batch, not ``P`` times it, and not the average DDP would take),
and the L1 term is added once, on rank 0's share.  The gradient sum is an
all_gather and a sum in rank order (``parallel/collectives.py``), so every
rank applies the same update and the replicas stay identical.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gnn_fpga_tpu_torch.compress.pruning import apply_masks_to_params
from gnn_fpga_tpu_torch.parallel.collectives import Comm


def bce_sums(logits, targets, mask=None, pos_weight: float = 1.0):
    """``(sum, count)`` of the sigmoid BCE over unmasked elements, positive
    targets weighted by ``pos_weight``; without a mask every element
    counts."""
    per = F.binary_cross_entropy_with_logits(logits, targets,
                                             reduction="none")
    if pos_weight != 1.0:
        per = per * torch.where(targets > 0.5, pos_weight, 1.0)
    if mask is None:
        return per.sum(), per.new_tensor(float(per.numel()))
    return (per * mask).sum(), mask.sum()


def global_mean(local_sum, local_count, comm: Comm):
    """``(objective, loss)`` of a mean over all ranks' elements:
    ``objective`` is this rank's sum over the total count (its gradient is
    this rank's share of the mean's), ``loss`` the mean itself, the same
    on every rank."""
    total = comm.all_sum(torch.stack([local_sum.detach().float(),
                                      local_count.detach().float()]))
    count = total[1].clamp_min(1.0)
    return local_sum / count, total[0] / count


def add_l1(objective, loss, model, l1: float, masks, comm: Comm):
    """The L1 term on the loss, and on rank 0's objective only, so that the
    summed gradients hold it once."""
    if not l1:
        return objective, loss
    from gnn_fpga_tpu_torch.train.trainer import l1_penalty

    penalty = l1 * l1_penalty(model, masks=masks)
    if comm.rank == 0:
        objective = objective + penalty
    return objective, loss + penalty.detach()


def sum_gradients(params, comm: Comm) -> None:
    """Replace each parameter's gradient by its sum over the ranks (a
    parameter without one counts as zero)."""
    params = list(params)
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1).float()
                      for p in params])
    total = comm.all_sum(flat)
    offset = 0
    for p in params:
        n = p.numel()
        p.grad = total[offset:offset + n].view_as(p).to(p.dtype)
        offset += n


def make_dp_loss_fn(model: nn.Module, cfg, comm: Comm, masks=None):
    """``loss_fn(local_batch) -> (objective, loss)``: the masked mean BCE
    over the whole batch (with ``cfg.l1``'s term), from this rank's slice
    of it."""

    def loss_fn(graph):
        logits = model(graph, masks)
        if cfg.target == "edge":
            targets, mask = graph.y, graph.edge_mask
        else:
            targets, mask = graph.node_y, graph.node_mask
        s, c = bce_sums(logits, targets, mask if cfg.loss_masking else None,
                        cfg.pos_weight)
        objective, loss = global_mean(s, c, comm)
        return add_l1(objective, loss, model, cfg.l1, masks, comm)

    return loss_fn


def train_step(optimizer, model: nn.Module, loss_fn, batch, comm: Comm,
               masks: Optional[dict] = None):
    """One optimizer step of a parallel path: this rank's objective
    backpropagated, the gradients summed over ``comm``, the update, and
    the masks re-applied.  Returns the loss (0-d, on the device)."""
    optimizer.zero_grad(set_to_none=True)
    objective, loss = loss_fn(batch)
    objective.backward()
    sum_gradients(model.parameters(), comm)
    optimizer.step()
    apply_masks_to_params(model, masks)
    return loss.detach()


def make_dp_train_step(model: nn.Module, optimizer, mesh, cfg, masks=None):
    """``step(batch) -> loss``: one data-parallel step on the global
    ``batch``, of which this rank takes its slice."""
    from gnn_fpga_tpu_torch.parallel import mesh as mesh_lib

    comm = Comm(mesh.get_group(mesh_lib.DATA_AXIS))
    loss_fn = make_dp_loss_fn(model, cfg, comm, masks)

    def step(batch):
        local = mesh_lib.shard_batch(batch, mesh, mesh_lib.DATA_AXIS)
        return train_step(optimizer, model, loss_fn, local, comm, masks)

    return step


def make_dp_eval_step(model: nn.Module, mesh, cfg, masks=None):
    """``eval(batch) -> loss``: the data-parallel loss, no update."""
    from gnn_fpga_tpu_torch.parallel import mesh as mesh_lib

    comm = Comm(mesh.get_group(mesh_lib.DATA_AXIS))
    loss_fn = make_dp_loss_fn(model, cfg, comm, masks)

    def evaluate(batch):
        with torch.no_grad():
            return loss_fn(mesh_lib.shard_batch(batch, mesh,
                                                mesh_lib.DATA_AXIS))[1]

    return evaluate
