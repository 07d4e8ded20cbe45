"""Training engine: optimizer step, loss, checkpoint/resume.

The counterpart of ``gnn_fpga_tpu/train/trainer.py`` on one device.  A
step runs the model forward, the masked BCE on logits (plus the L1 term
on the edge and node networks), ``loss.backward()`` (on the ``pallas``
route, through the backward kernels of ``ops/cuda/spmm.py``), the
optimizer, and the mask re-projection that keeps pruned weights at 0.

On a CUDA device the step, the eval loss and predict each run as one
captured CUDA graph for each static batch signature
(``core/capture.py``), the counterpart of the JAX package's ``jax.jit``:
the first batch of a signature runs eagerly and is captured, every later
one is copied into the capture's static buffers and replayed.
:meth:`Trainer.run_steps` takes a stack of batches (:func:`stack_batches`)
and runs one step a slice in one call, the JAX package's ``lax.scan``
inside ``jit``: on the card one replay of a graph that holds all ``K``
steps.  The cosine rate is a device tensor that each step's body computes
from a step count on the device, so one mechanism serves the one-step
and the K-step graphs, and Adam runs with ``capturable=True``.
``Trainer(capture=False)`` dispatches every op from Python instead; on the
CPU the static-buffer body runs eagerly.

``strategy="dp"`` and ``"partitioned"`` run the same engine on a device
mesh of one rank a device (``parallel/``): each rank takes its slice of
a batch (``dp``) or its shard of a
:class:`~gnn_fpga_tpu_torch.parallel.partition.PartitionedGraph`
(``partitioned``), backpropagates its share of the whole batch's loss and
sums the parameter gradients over the ranks, so every rank applies the
same update; losses, predictions and metrics are the whole batch's on
every rank.  Rank 0 writes the checkpoints and metrics, every rank reads
them.  Under NCCL the step, eval loss and predict are captured with their
collectives; gloo's collectives cannot be captured, so on a card under
gloo the steps run eagerly and ``capture=True`` raises.

Deliberate differences from the JAX package: the trainer takes the
``nn.Module`` (``model(graph, masks) -> logits``) instead of a
``logits_fn`` over a parameter pytree; :meth:`Trainer.run_steps` also
takes a sequence of batches, stacked first, one stack (and one call) a
run of one signature; :meth:`Trainer.fit` keeps an epoch's losses on the
device and reads them back once an epoch (unless ``verbose``);
checkpoints go through ``torch.save``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import time
from datetime import datetime
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from gnn_fpga_tpu_torch.compress.pruning import (apply_masks_to_params,
                                                 weight_matrices)
from gnn_fpga_tpu_torch.core.capture import CapturedCall, scan, signature
from gnn_fpga_tpu_torch.core.graph import Graph, TensorFields, stack_fields
from gnn_fpga_tpu_torch.train import metrics as metrics_lib
from gnn_fpga_tpu_torch.train.checkpoint import CheckpointManager
from gnn_fpga_tpu_torch.utils.profiling import span


def logger(s: str) -> None:
    """Datetime-stamped print."""
    print(datetime.now(), s, flush=True)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3
    optimizer: str = "adam"            # adam | sgd
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    l1: float = 0.0                    # L1 coeff on edge/node net weights
    target: str = "edge"               # edge -> graph.y ; node -> graph.node_y
    loss_masking: bool = True
    pos_weight: float = 1.0            # BCE weight on positive targets
    lr_schedule: str = "constant"      # constant | cosine
    decay_steps: int = 0               # cosine: steps to decay over
    lr_min_fraction: float = 0.01      # cosine: final lr / initial lr


def cosine_decay(step: int, decay_steps: int, alpha: float) -> float:
    """Learning-rate factor of ``optax.cosine_decay_schedule``: it falls
    from 1 to ``alpha`` over ``decay_steps`` and stays there."""
    t = min(step, decay_steps) / decay_steps
    return alpha + (1 - alpha) * 0.5 * (1 + math.cos(math.pi * t))


class CosineRate:
    """The cosine schedule: the rate of step ``t`` (the first update is
    ``t = 0``) is ``learning_rate * cosine_decay(t)``.

    ``count`` is the number of the next step.  When the groups' rate is a
    tensor (Adam, and any captured step), ``count`` is a 0-d f32 tensor on
    the same device and :meth:`advance`, which a step's body calls after
    its update, moves it on and writes the next step's rate in f32 tensor
    ops, in place: a captured step, or ``K`` steps captured in one graph,
    then computes each step's own rate on the device, as optax computes
    its schedule in f32 inside the JAX package's scan.  A float rate (SGD,
    never captured) is computed on the host and replaced.  ``last_epoch``
    counts the steps taken on the host; the caller adds a call's steps to
    it after the call (:meth:`step` does both, outside a step's body).
    ``last_epoch`` and the state dict keep the names of the ``LambdaLR``
    this replaces, so checkpoints resume either way."""

    def __init__(self, optimizer, cfg: TrainConfig):
        self.optimizer = optimizer
        self.cfg = cfg
        self.last_epoch = 0
        lr = optimizer.param_groups[0]["lr"]
        self.count = (torch.zeros((), dtype=torch.float32, device=lr.device)
                      if isinstance(lr, torch.Tensor) else 0)
        self.apply()

    def rate(self) -> float:
        """The rate of step ``last_epoch``, in float64 on the host."""
        return self.cfg.learning_rate * cosine_decay(
            self.last_epoch, self.cfg.decay_steps, self.cfg.lr_min_fraction)

    def _device_rate(self) -> torch.Tensor:
        """The rate of step ``count`` in f32 tensor ops, in optax's order."""
        cfg = self.cfg
        t = torch.clamp(self.count, max=float(cfg.decay_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * t / cfg.decay_steps))
        decayed = (1 - cfg.lr_min_fraction) * cosine + cfg.lr_min_fraction
        return cfg.learning_rate * decayed

    def apply(self) -> None:
        """Write the rate of step ``count`` into every group."""
        if isinstance(self.count, torch.Tensor):
            lr = self._device_rate()
            for group in self.optimizer.param_groups:
                group["lr"].copy_(lr)
            return
        lr = self.cfg.learning_rate * cosine_decay(
            self.count, self.cfg.decay_steps, self.cfg.lr_min_fraction)
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def advance(self) -> None:
        """After an optimizer step, inside its body: the next step's
        count and rate."""
        if isinstance(self.count, torch.Tensor):
            self.count.add_(1)
        else:
            self.count += 1
        self.apply()

    def step(self) -> None:
        self.advance()
        self.last_epoch += 1

    def state_dict(self) -> dict:
        return {"last_epoch": self.last_epoch}

    def load_state_dict(self, state: dict) -> None:
        self.last_epoch = int(state["last_epoch"])
        if isinstance(self.count, torch.Tensor):
            self.count.fill_(self.last_epoch)
        else:
            self.count = self.last_epoch
        self.apply()


def make_optimizer(cfg: TrainConfig, params, device_rate: bool = False):
    """``(optimizer, scheduler)``: Adam or plain SGD, and a
    :class:`CosineRate` for the cosine schedule (None for a constant
    rate).  Step the scheduler after the optimizer, so the first update
    uses step 0.

    ``device_rate``: the rate of the cosine schedule is a 0-d f32 tensor
    on the parameters' device, which the scheduler computes in place from
    its step count on the device, so that captured steps read each step's
    rate; Adam then runs with ``capturable=True`` on a CUDA device (its
    step count on the device).  SGD takes no tensor rate: sgd with the
    cosine schedule raises here.
    """
    params = list(params)
    device = params[0].device if params else torch.device("cpu")
    if cfg.lr_schedule not in ("constant", "cosine"):
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    if cfg.lr_schedule == "cosine" and cfg.decay_steps <= 0:
        raise ValueError("lr_schedule='cosine' needs decay_steps > 0")
    lr = cfg.learning_rate
    if device_rate and cfg.lr_schedule == "cosine":
        lr = torch.tensor(lr, dtype=torch.float32, device=device)
    if cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(cfg.b1, cfg.b2),
                               eps=cfg.eps,
                               capturable=device_rate
                               and device.type == "cuda")
    elif cfg.optimizer == "sgd":
        if isinstance(lr, torch.Tensor):
            # torch's SGD reads a tensor rate back to the host each step
            raise ValueError("sgd with a cosine rate cannot be captured: "
                             "use Trainer(capture=False)")
        opt = torch.optim.SGD(params, lr=lr)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    if cfg.lr_schedule == "constant":
        return opt, None
    return opt, CosineRate(opt, cfg)


def stack_batches(batches: Sequence, device=None):
    """Stack batches of one static signature along a new leading axis for
    :meth:`Trainer.run_steps` (the scan axis: one optimizer step a slice),
    on ``device`` (default: the first batch's), where the stack should
    live: on the card, where each call reads it.

    Takes Graphs (packed with plans, batched, with blocks) and
    :class:`~gnn_fpga_tpu_torch.parallel.partition.PartitionedGraph`s.
    Their tensors must agree in shape and dtype and their host fields must
    be equal (:func:`~gnn_fpga_tpu_torch.core.graph.stack_fields`), else
    ``ValueError``: batches with plans must be padded to one
    ``PlanCapacity`` first (``pad_plans``, ``batch_capacity``,
    ``PlanCapacity.covering``)."""
    batches = list(batches)
    if not batches:
        raise ValueError("stack_batches needs at least one batch")
    device = (next(batches[0].tensors()).device if device is None
              else torch.device(device))
    try:
        stacked = stack_fields(batches, type(batches[0]).__name__)
    except ValueError as err:
        if ".plans" in str(err):
            raise ValueError(
                f"{err}; batches with plans must be padded to one "
                "PlanCapacity first (pad_plans, batch_capacity, "
                "PlanCapacity.covering)") from None
        raise
    return stacked.to(device)


def l1_penalty(model: nn.Module, modules=("edge", "node"),
               masks=None) -> torch.Tensor:
    """Sum of |W| over the weight matrices of the given sub-networks
    (biases and the input layer excluded).  With ``masks``, pruned
    positions are excluded."""
    terms = []
    for mod, name, w in weight_matrices(model, modules):
        m = None if masks is None else masks.get(mod, {}).get(name)
        terms.append((w if m is None else w * m).abs().sum())
    return torch.stack(terms).sum() if terms else torch.zeros(())


def masked_bce_with_logits(logits, targets, mask=None,
                           pos_weight: float = 1.0) -> torch.Tensor:
    """Mean sigmoid BCE over unmasked elements; positive targets
    (``t > 0.5``) weighted by ``pos_weight``."""
    per = F.binary_cross_entropy_with_logits(logits, targets,
                                             reduction="none")
    if pos_weight != 1.0:
        per = per * torch.where(targets > 0.5, pos_weight, 1.0)
    if mask is None:
        return per.mean()
    return (per * mask).sum() / mask.sum().clamp_min(1.0)


def _masks_to(masks, device):
    if masks is None:
        return None
    return {mod: {k: None if m is None else m.to(device)
                  for k, m in layer.items()}
            for mod, layer in masks.items()}


class Trainer:
    """Training engine around a model ``model(graph, masks) -> logits``
    (edge logits ``[E]`` or node logits ``[N]`` per ``cfg.target``, with a
    leading batch axis for a batched graph).

    Args:
      model: the ``nn.Module``; it is trained in place.
      cfg: TrainConfig.
      masks: optional pruning masks (see ``compress/pruning.py``), moved
        to the model's device.
      checkpoint_dir: directory for latest/best checkpoints; None disables.
      metrics_path: optional jsonl file appended with per-epoch records.
      strategy: ``"single"`` (one device), ``"dp"`` (data parallel over
        ``mesh``'s ``data`` dimension: batched Graphs, each rank its slice
        of the leading axis) or ``"partitioned"`` (graph parallel over
        ``mesh``'s ``graph`` dimension: batches are stacked
        :class:`~gnn_fpga_tpu_torch.parallel.partition.PartitionedGraph`s,
        each rank runs the shard body on its shard with ``exchange``).
        The model's own config sets the route of the shard body (plans and
        ``fused_iteration``) and ``cfg.target`` its head.
      capture: on a CUDA device, run the step, the eval loss and predict
        as captured CUDA graphs, one for each static batch signature
        (:func:`~gnn_fpga_tpu_torch.core.capture.signature`); the first
        batch of a signature runs eagerly.  False dispatches every op from
        Python (the eager path the captured one is checked against).  On
        the CPU the captured path's static-buffer body runs eagerly.
      mesh: the ``DeviceMesh`` of ``"dp"`` and ``"partitioned"``
        (``parallel/mesh.py``).
      exchange: ``"halo"`` or ``"allgather"``, the partitioned halo
        exchange.
    """

    def __init__(self, model: nn.Module, cfg: TrainConfig = TrainConfig(),
                 masks=None, checkpoint_dir: Optional[str] = None,
                 metrics_path: Optional[str] = None,
                 strategy: str = "single", capture: bool = True,
                 mesh=None, exchange: str = "halo"):
        if strategy not in ("single", "dp", "partitioned"):
            raise ValueError(f"unknown strategy {strategy!r}")
        self.cfg = cfg
        self.model = model
        self.device = next(model.parameters()).device
        self.strategy = strategy
        self.mesh = mesh
        self.exchange = exchange
        self._comm = None
        if strategy != "single":
            self._comm = self._parallel_comm(capture)
        self.capture = capture
        self.masks = _masks_to(masks, self.device)
        self._captured: dict = {}    # (kind, signature) -> CapturedCall
        self._pool = None            # the captures' shared memory pool
        self.optimizer, self.scheduler = self._make_optimizer()
        self.train_losses: List[float] = []
        self.valid_losses: List[float] = []
        self.best_valid_loss = float("inf")
        self.ckpt = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
        self.metrics_path = metrics_path
        logger("Parameters: %i" % sum(p.numel() for p in model.parameters()))

    def _parallel_comm(self, capture: bool):
        """The collectives of the ``dp`` or ``partitioned`` strategy over
        the mesh dimension it runs on."""
        from gnn_fpga_tpu_torch.parallel import mesh as mesh_lib
        from gnn_fpga_tpu_torch.parallel.collectives import Comm

        if self.mesh is None:
            raise ValueError(f"strategy={self.strategy!r} needs a mesh")
        axis = (mesh_lib.DATA_AXIS if self.strategy == "dp"
                else mesh_lib.GRAPH_AXIS)
        comm = Comm(self.mesh.get_group(axis))
        if capture and self.device.type == "cuda" and comm.backend != "nccl":
            raise ValueError(
                f"capture=True needs NCCL: {comm.backend}'s collectives "
                "cannot be captured in a CUDA graph; pass capture=False")
        return comm

    @property
    def is_writer(self) -> bool:
        """Whether this process writes checkpoints and metrics (rank 0)."""
        return self._comm is None or dist.get_rank() == 0

    # -- steps -------------------------------------------------------------

    def _target_and_mask(self, graph: Graph):
        if self.cfg.target == "edge":
            return graph.y, (graph.edge_mask if self.cfg.loss_masking else None)
        if graph.node_y is None:
            raise ValueError("node target requested but graph.node_y is None")
        return graph.node_y, (graph.node_mask if self.cfg.loss_masking else None)

    def _logits(self, graph: Graph) -> torch.Tensor:
        """Logits of a single graph, or ``[B, ...]`` of a batched one
        (leading batch axis), which the model takes whole: the blocked and
        dense routes fold the batch into their matmuls.  Under
        ``"partitioned"``, this rank's shard's (the shard body)."""
        if self.strategy == "partitioned":
            from gnn_fpga_tpu_torch.parallel import partition as part

            return part.sharded_logits(self.model, graph, self._comm,
                                       self.masks, self.exchange,
                                       self.cfg.target)
        return self.model(graph, self.masks)

    def _loss(self, graph: Graph) -> torch.Tensor:
        targets, mask = self._target_and_mask(graph)
        loss = masked_bce_with_logits(self._logits(graph), targets, mask,
                                      self.cfg.pos_weight)
        if self.cfg.l1:
            loss = loss + self.cfg.l1 * l1_penalty(self.model,
                                                   masks=self.masks)
        return loss

    def _make_optimizer(self):
        # Adam takes its cosine rate from the device (on the CPU too)
        # whether or not the step is captured, so that captured and eager
        # steps update alike; SGD only when captured on a card (where its
        # cosine rate raises)
        return make_optimizer(
            self.cfg, self.model.parameters(),
            device_rate=self.cfg.optimizer == "adam"
            or (self.capture and self.device.type == "cuda"))

    def _parallel_loss(self, local, train: bool):
        """``(objective, loss)`` of the dp or partitioned strategy on this
        rank's part of a batch (``parallel/``): the whole batch's masked
        mean, this rank's share of it to backpropagate.  The partitioned
        step always masks and its eval loss adds no L1 term, as in the JAX
        package."""
        from gnn_fpga_tpu_torch.parallel import data_parallel as dp
        from gnn_fpga_tpu_torch.parallel import partition as part

        cfg = self.cfg
        if self.strategy == "dp":
            return dp.make_dp_loss_fn(self.model, cfg, self._comm,
                                      self.masks)(local)
        if train:
            return part.sharded_loss(self.model, local, self._comm,
                                     self.masks, self.exchange, cfg.target,
                                     cfg.pos_weight, cfg.l1)
        targets, mask = self._target_and_mask(local)
        s, c = dp.bce_sums(self._logits(local), targets, mask,
                           cfg.pos_weight)
        return dp.global_mean(s, c, self._comm)

    def _step_body(self, graph: Graph) -> torch.Tensor:
        """One optimizer step on ``graph``, then the next step's cosine
        rate from the step count on the device: what a capture records,
        once for the one-step call and ``K`` times for the K-step call
        (:func:`~gnn_fpga_tpu_torch.core.capture.scan`), so that the two
        agree bit for bit."""
        if self._comm is not None:
            from gnn_fpga_tpu_torch.parallel import data_parallel as dp

            loss = dp.train_step(
                self.optimizer, self.model,
                lambda g: self._parallel_loss(g, True), graph, self._comm,
                self.masks)
        else:
            self.optimizer.zero_grad(set_to_none=True)
            loss = self._loss(graph)
            loss.backward()
            self.optimizer.step()
            if self.masks is not None:
                # pruned weights stay exactly 0
                apply_masks_to_params(self.model, self.masks)
            loss = loss.detach()
        if self.scheduler is not None:
            self.scheduler.advance()
        return loss

    def _eval_body(self, graph: Graph) -> torch.Tensor:
        with torch.no_grad():
            if self._comm is not None:
                return self._parallel_loss(graph, False)[1]
            return self._loss(graph)

    def _predict_body(self, graph: Graph) -> torch.Tensor:
        with torch.no_grad():
            probs = torch.sigmoid(self._logits(graph))
            if self.strategy == "dp":
                return self._comm.all_gather(probs).flatten(0, 1)
            if self.strategy == "partitioned":
                return self._comm.all_gather(probs)
            return probs

    def _local(self, batch, stacked: bool = False):
        """This rank's part of a batch, on its device: its slice (dp), its
        shard (partitioned), or the batch as given (single).  A
        ``stacked`` batch (:func:`stack_batches`) is split along axis 1,
        each step's batch as the one-step call splits it."""
        axis = 1 if stacked else 0
        if self.strategy == "dp":
            from gnn_fpga_tpu_torch.parallel import mesh as mesh_lib

            return mesh_lib.shard_batch(batch, self.mesh, mesh_lib.DATA_AXIS,
                                        dim=axis)
        if self.strategy == "partitioned":
            from gnn_fpga_tpu_torch.parallel import partition as part

            return part.local_shard(batch, self._comm.rank, self.device,
                                    axis)
        return batch

    def _call(self, kind: str, body, graph: Graph, stacked: bool = False):
        """``(call, graph)``: ``graph`` as this rank takes it (its part
        under dp or partitioned) and what runs ``body`` on it: ``body``
        itself with ``capture=False``, else the captured call of ``kind``
        for the graph's signature (made at its first batch)."""
        graph = self._local(graph, stacked)
        if not self.capture:
            return body, graph
        key = (kind, signature(graph))
        call = self._captured.get(key)
        if call is None:
            if self._pool is None and self.device.type == "cuda":
                self._pool = torch.cuda.graph_pool_handle()
            call = self._captured[key] = CapturedCall(body, self.device,
                                                      self._pool)
        return call, graph

    @staticmethod
    def _replays(call) -> bool:
        """Whether ``call``'s next output is a capture's, which the
        capture's next replay overwrites (the caller copies it out)."""
        return isinstance(call, CapturedCall) and call.captured

    def _run(self, kind: str, body, graph: Graph) -> torch.Tensor:
        """``body(graph)`` through :meth:`_call`; the result is the
        caller's own."""
        call, graph = self._call(kind, body, graph)
        replay = self._replays(call)
        out = call(graph)
        return out.clone() if replay else out

    def _drop_captures(self) -> None:
        """Forget the captured graphs (they hold the addresses of the
        optimizer state and weights they were captured with); the next
        batch of each signature is captured anew."""
        if self._captured and self.device.type == "cuda":
            # replays still queued read memory that is about to be freed
            torch.cuda.synchronize(self.device)
        self._captured.clear()

    def _train_step(self, graph: Graph) -> torch.Tensor:
        loss = self._run("train", self._step_body, graph)
        if self.scheduler is not None:
            self.scheduler.last_epoch += 1
        return loss

    def _step_calls(self, stacks) -> list:
        """``(call, stack)`` of :meth:`_call` for each stack: one call
        runs one optimizer step a slice of its stack, on the card as one
        replay of the K-step graph."""
        for s in stacks:
            if s.x.dim() < 3:
                raise ValueError(
                    "run_steps takes a stack of batches (stack_batches) or "
                    "a sequence of batches, not one graph of x "
                    f"{tuple(s.x.shape)}")
        body = functools.partial(scan, self._step_body)
        return [self._call("train", body, s, stacked=True) for s in stacks]

    def _run_step_calls(self, calls) -> np.ndarray:
        """Runs :meth:`_step_calls`' calls in order; their ``[K]`` losses
        stay on the device until they are read back together, as float32,
        after the last."""
        losses = []
        for call, stack in calls:
            replay = self._replays(call)
            out = call(stack)
            with span("gnn.run_steps.readback"):
                losses.append(out.clone() if replay else out)
                if self.scheduler is not None:
                    self.scheduler.last_epoch += out.shape[0]
                if len(losses) == len(calls):
                    return torch.cat(losses).float().cpu().numpy()
        raise ValueError("run_steps got no batches")

    def _stacks(self, batches) -> list:
        """``batches`` as stacks for :meth:`_step_calls`: a stack as it
        is; a sequence through :func:`stack_batches`, one stack a run of
        consecutive batches of one signature."""
        if isinstance(batches, TensorFields):
            return [batches]
        runs = []
        for b in batches:
            if runs and signature(b) == signature(runs[-1][-1]):
                runs[-1].append(b)
            else:
                runs.append([b])
        return [stack_batches(run) for run in runs]

    def _eval_loss(self, graph: Graph) -> float:
        return float(self._run("eval", self._eval_body, graph))

    # -- public API --------------------------------------------------------

    @property
    def epoch(self) -> int:
        return len(self.train_losses)

    def fit(self, train_generator: Iterator[Graph], n_batches: int,
            n_epochs: int, valid_generator: Optional[Iterator[Graph]] = None,
            n_valid_batches: int = 0, verbose: int = 0) -> None:
        """Epoch loop, resumable: epochs are numbered from
        ``len(train_losses)``.  An epoch's losses stay on the device and
        are read back once at its end (after each step when ``verbose >
        0``), then summed in step order."""
        epoch_start = self.epoch
        for i in range(epoch_start, epoch_start + n_epochs):
            logger("Epoch %i" % i)
            t0 = time.perf_counter()
            losses = []
            for j in range(n_batches):
                losses.append(self._train_step(next(train_generator)))
                if verbose > 0:
                    logger("  Batch %i loss %f" % (j, float(losses[-1])))
            # one readback an epoch, summed in step order as before
            sum_loss = 0.0
            for loss in torch.stack(losses).cpu().tolist():
                sum_loss += loss
            dt = time.perf_counter() - t0
            avg_loss = sum_loss / n_batches
            logger("  training loss %.3g time %gs" % (avg_loss, dt))
            vloss = None
            if valid_generator is not None and n_valid_batches > 0:
                vloss = float(np.mean([self._eval_loss(next(valid_generator))
                                       for _ in range(n_valid_batches)]))
                logger("  validate loss %.3g" % vloss)
            self._end_epoch(i, avg_loss, dt, vloss)

    def run_steps(self, stacked) -> np.ndarray:
        """One optimizer step per leading-axis slice of ``stacked`` (a
        stack from :func:`stack_batches`) in one call: on the card, one
        replay of a graph that holds all ``K`` steps (captured at the
        first stack of a signature, which includes ``K``), each step's
        collectives under dp or partitioned included.  A sequence of
        batches is stacked first (:meth:`_stacks`).  The losses stay on
        the device and are read back once, as float32.

        Under a profiler a call is the spans ``gnn.run_steps.prepare``
        (the stacks and their captured calls looked up), then for each
        stack ``gnn.captured.load``, ``gnn.captured.replay`` and
        ``gnn.run_steps.readback`` (its output copied out; the losses to
        the host after the last), one after another."""
        with span("gnn.run_steps.prepare"):
            calls = self._step_calls(self._stacks(stacked))
        return self._run_step_calls(calls)

    def fit_stacked(self, train_epoch, n_epochs: int,
                    valid_batch: Optional[Graph] = None,
                    verbose: int = 0) -> None:
        """:meth:`fit` over a fixed stacked epoch of batches, one
        :meth:`run_steps` call an epoch, with the same checkpoint/metrics
        semantics; a sequence is stacked once, before the first epoch."""
        stacks = self._stacks(train_epoch)
        epoch_start = self.epoch
        for i in range(epoch_start, epoch_start + n_epochs):
            t0 = time.perf_counter()
            with span("gnn.run_steps.prepare"):
                calls = self._step_calls(stacks)
            losses = self._run_step_calls(calls)
            dt = time.perf_counter() - t0
            avg_loss = float(losses.mean())
            if verbose > 0:
                logger("Epoch %i training loss %.3g time %gs"
                       % (i, avg_loss, dt))
            self._end_epoch(i, avg_loss, dt, None if valid_batch is None
                            else self._eval_loss(valid_batch))

    def _end_epoch(self, epoch: int, avg_loss: float, dt: float,
                   vloss: Optional[float] = None) -> None:
        """The end of an epoch of :meth:`fit` or :meth:`fit_stacked`: the
        losses recorded, the checkpoint saved (best by the validation loss
        ``vloss``, where there is one) and the metrics line written."""
        self.train_losses.append(avg_loss)
        record = {"epoch": epoch, "train_loss": avg_loss, "time_s": dt}
        if vloss is not None:
            record["valid_loss"] = vloss
            self.valid_losses.append(vloss)
            is_best = vloss < self.best_valid_loss
            self.best_valid_loss = min(vloss, self.best_valid_loss)
            self.save_checkpoint(is_best)
        elif self.ckpt is not None:
            self.save_checkpoint(False)
        self._write_metrics(record)

    def predict(self, generator: Iterator[Graph], n_batches: int,
                concat: bool = True):
        """Sigmoid probabilities over ``n_batches``; returns
        ``(preds, targets, masks)`` as numpy, flattened when ``concat``."""
        preds, targets, masks = [], [], []
        for _ in range(n_batches):
            g = next(generator)
            p = self._run("predict", self._predict_body, g).cpu().numpy()
            t, m = self._target_and_mask(g)
            preds.append(p.ravel())
            targets.append(t.cpu().numpy().ravel())
            masks.append(np.ones_like(p).ravel() if m is None
                         else m.cpu().numpy().ravel())
        if concat:
            return (np.concatenate(preds), np.concatenate(targets),
                    np.concatenate(masks))
        return preds, targets, masks

    def evaluate(self, generator: Iterator[Graph], n_batches: int,
                 threshold: float = 0.5):
        """accuracy / precision / recall / f1 / AUC over ``n_batches``."""
        p, t, m = self.predict(generator, n_batches)
        return metrics_lib.binary_metrics(p, t, m, threshold)

    # -- checkpointing -----------------------------------------------------

    def _state(self):
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": ({} if self.scheduler is None
                              else self.scheduler.state_dict())}

    def _meta(self):
        return {
            "epoch": self.epoch,
            "best_valid_loss": self.best_valid_loss,
            "train_losses": [float(x) for x in self.train_losses],
            "valid_losses": [float(x) for x in self.valid_losses],
        }

    def save_checkpoint(self, is_best: bool) -> None:
        """Rank 0 writes; under dp or partitioned every rank then waits
        for it, so that any rank may read the checkpoint afterwards."""
        if self.ckpt is None:
            return
        if self.is_writer:
            self.ckpt.save(self._state(), self._meta(), is_best)
        if self._comm is not None:
            self._comm.barrier()

    def load_checkpoint(self, best: bool = False) -> bool:
        """Restore the weights, optimizer and schedule state and the loss
        histories; False when there is no checkpoint."""
        if self.ckpt is None or not self.ckpt.exists(best):
            return False
        state, meta = self.ckpt.restore(best)
        self._drop_captures()
        self.model.load_state_dict(state["model"])
        self._load_optimizer_state(state["optimizer"])
        if self.scheduler is not None:
            self.scheduler.load_state_dict(state["scheduler"])
        self.best_valid_loss = float(meta["best_valid_loss"])
        self.train_losses = list(meta["train_losses"])
        self.valid_losses = list(meta["valid_losses"])
        return True

    def load_weights(self, state_dict, apply_masks: bool = True) -> None:
        """Mask-aware weight transplant for pruning rounds: copy
        ``state_dict`` into the model, zero the masked-out weights, and
        start the optimizer and schedule afresh."""
        self._drop_captures()
        self.model.load_state_dict(state_dict)
        if apply_masks:
            apply_masks_to_params(self.model, self.masks)
        self.optimizer, self.scheduler = self._make_optimizer()

    def _load_optimizer_state(self, state) -> None:
        """``optimizer.load_state_dict``, keeping this trainer's own rate
        (a device tensor the captures read, or a float) and
        ``capturable`` flag, which the saved groups would replace."""
        keep = [(g["lr"], g.get("capturable"))
                for g in self.optimizer.param_groups]
        self.optimizer.load_state_dict(state)
        for group, (lr, capturable) in zip(self.optimizer.param_groups,
                                           keep):
            group["lr"] = lr
            if capturable is not None:
                group["capturable"] = capturable
            if capturable:
                for p in group["params"]:
                    st = self.optimizer.state.get(p, {})
                    if "step" in st:
                        st["step"] = torch.as_tensor(
                            st["step"], dtype=torch.float32).to(p.device)

    def _write_metrics(self, record) -> None:
        if not self.metrics_path or not self.is_writer:
            return
        os.makedirs(os.path.dirname(os.path.abspath(self.metrics_path)),
                    exist_ok=True)
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")
