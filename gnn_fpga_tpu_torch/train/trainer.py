"""Training engine: optimizer step, loss, checkpoint/resume.

The counterpart of ``gnn_fpga_tpu/train/trainer.py`` on one device.  A
step runs the model forward, the masked BCE on logits (plus the L1 term
on the edge and node networks), ``loss.backward()`` (on the ``pallas``
route, through the backward kernels of ``ops/cuda/spmm.py``), the
optimizer, and the mask re-projection that keeps pruned weights at 0.

Deliberate differences from the JAX package: the trainer takes the
``nn.Module`` (``model(graph, masks) -> logits``) instead of a
``logits_fn`` over a parameter pytree; :meth:`Trainer.run_steps` is a
Python loop over a sequence of graphs (the JAX package's ``lax.scan``
over stacked batches) that keeps the losses on the device and reads them
back once; checkpoints go through ``torch.save``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from datetime import datetime
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gnn_fpga_tpu_torch.compress.pruning import (apply_masks_to_params,
                                                 weight_matrices)
from gnn_fpga_tpu_torch.core.graph import Graph
from gnn_fpga_tpu_torch.train import metrics as metrics_lib
from gnn_fpga_tpu_torch.train.checkpoint import CheckpointManager


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


def make_optimizer(cfg: TrainConfig, params):
    """``(optimizer, scheduler)``: Adam or plain SGD, and a ``LambdaLR``
    for the cosine schedule (None for a constant rate).  Step the
    scheduler after the optimizer, so the first update uses step 0."""
    params = list(params)
    if cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=cfg.learning_rate,
                               betas=(cfg.b1, cfg.b2), eps=cfg.eps)
    elif cfg.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=cfg.learning_rate)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    if cfg.lr_schedule == "constant":
        return opt, None
    if cfg.lr_schedule != "cosine":
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    if cfg.decay_steps <= 0:
        raise ValueError("lr_schedule='cosine' needs decay_steps > 0")
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: cosine_decay(t, cfg.decay_steps, cfg.lr_min_fraction))
    return opt, sched


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
      strategy: ``"single"``; ``"dp"`` and ``"partitioned"`` are not
        ported yet.
    """

    def __init__(self, model: nn.Module, cfg: TrainConfig = TrainConfig(),
                 masks=None, checkpoint_dir: Optional[str] = None,
                 metrics_path: Optional[str] = None,
                 strategy: str = "single"):
        if strategy in ("dp", "partitioned"):
            raise NotImplementedError(
                f"strategy={strategy!r} is not ported yet (ROADMAP Queue 1 "
                "item 12, 'Parallelism')")
        if strategy != "single":
            raise ValueError(f"unknown strategy {strategy!r}")
        self.cfg = cfg
        self.model = model
        device = next(model.parameters()).device
        self.masks = _masks_to(masks, device)
        self.optimizer, self.scheduler = make_optimizer(cfg,
                                                        model.parameters())
        self.train_losses: List[float] = []
        self.valid_losses: List[float] = []
        self.best_valid_loss = float("inf")
        self.ckpt = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
        self.metrics_path = metrics_path
        logger("Parameters: %i" % sum(p.numel() for p in model.parameters()))

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
        dense routes fold the batch into their matmuls."""
        return self.model(graph, self.masks)

    def _loss(self, graph: Graph) -> torch.Tensor:
        targets, mask = self._target_and_mask(graph)
        loss = masked_bce_with_logits(self._logits(graph), targets, mask,
                                      self.cfg.pos_weight)
        if self.cfg.l1:
            loss = loss + self.cfg.l1 * l1_penalty(self.model,
                                                   masks=self.masks)
        return loss

    def _train_step(self, graph: Graph) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._loss(graph)
        loss.backward()
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        if self.masks is not None:
            # pruned weights stay exactly 0
            apply_masks_to_params(self.model, self.masks)
        return loss.detach()

    @torch.no_grad()
    def _eval_loss(self, graph: Graph) -> float:
        return float(self._loss(graph))

    # -- public API --------------------------------------------------------

    @property
    def epoch(self) -> int:
        return len(self.train_losses)

    def fit(self, train_generator: Iterator[Graph], n_batches: int,
            n_epochs: int, valid_generator: Optional[Iterator[Graph]] = None,
            n_valid_batches: int = 0, verbose: int = 0) -> None:
        """Epoch loop, resumable: epochs are numbered from
        ``len(train_losses)``."""
        epoch_start = self.epoch
        for i in range(epoch_start, epoch_start + n_epochs):
            logger("Epoch %i" % i)
            t0 = time.perf_counter()
            sum_loss = 0.0
            for j in range(n_batches):
                loss = float(self._train_step(next(train_generator)))
                sum_loss += loss
                if verbose > 0:
                    logger("  Batch %i loss %f" % (j, loss))
            dt = time.perf_counter() - t0
            avg_loss = sum_loss / n_batches
            self.train_losses.append(avg_loss)
            logger("  training loss %.3g time %gs" % (avg_loss, dt))
            record = {"epoch": i, "train_loss": avg_loss, "time_s": dt}
            if valid_generator is not None and n_valid_batches > 0:
                vloss = float(np.mean([self._eval_loss(next(valid_generator))
                                       for _ in range(n_valid_batches)]))
                logger("  validate loss %.3g" % vloss)
                record["valid_loss"] = vloss
                self._end_epoch_valid(vloss)
            elif self.ckpt is not None:
                self.save_checkpoint(False)
            self._write_metrics(record)

    def run_steps(self, batches: Sequence[Graph]) -> np.ndarray:
        """One optimizer step per graph of ``batches``; the losses stay on
        the device and are read back once.  Returns them as float32."""
        losses = [self._train_step(g) for g in batches]
        return torch.stack(losses).float().cpu().numpy()

    def fit_stacked(self, train_epoch: Sequence[Graph], n_epochs: int,
                    valid_batch: Optional[Graph] = None,
                    verbose: int = 0) -> None:
        """:meth:`fit` over a fixed epoch of batches through
        :meth:`run_steps`, with the same checkpoint/metrics semantics."""
        epoch_start = self.epoch
        for i in range(epoch_start, epoch_start + n_epochs):
            t0 = time.perf_counter()
            losses = self.run_steps(train_epoch)
            dt = time.perf_counter() - t0
            avg_loss = float(losses.mean())
            self.train_losses.append(avg_loss)
            if verbose > 0:
                logger("Epoch %i training loss %.3g time %gs"
                       % (i, avg_loss, dt))
            record = {"epoch": i, "train_loss": avg_loss, "time_s": dt}
            if valid_batch is not None:
                vloss = self._eval_loss(valid_batch)
                record["valid_loss"] = vloss
                self._end_epoch_valid(vloss)
            elif self.ckpt is not None:
                self.save_checkpoint(False)
            self._write_metrics(record)

    def _end_epoch_valid(self, vloss: float) -> None:
        self.valid_losses.append(vloss)
        is_best = vloss < self.best_valid_loss
        self.best_valid_loss = min(vloss, self.best_valid_loss)
        self.save_checkpoint(is_best)

    @torch.no_grad()
    def predict(self, generator: Iterator[Graph], n_batches: int,
                concat: bool = True):
        """Sigmoid probabilities over ``n_batches``; returns
        ``(preds, targets, masks)`` as numpy, flattened when ``concat``."""
        preds, targets, masks = [], [], []
        for _ in range(n_batches):
            g = next(generator)
            p = torch.sigmoid(self._logits(g)).cpu().numpy()
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
        if self.ckpt is None:
            return
        self.ckpt.save(self._state(), self._meta(), is_best)

    def load_checkpoint(self, best: bool = False) -> bool:
        """Restore the weights, optimizer and schedule state and the loss
        histories; False when there is no checkpoint."""
        if self.ckpt is None or not self.ckpt.exists(best):
            return False
        state, meta = self.ckpt.restore(best)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
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
        self.model.load_state_dict(state_dict)
        if apply_masks:
            apply_masks_to_params(self.model, self.masks)
        self.optimizer, self.scheduler = make_optimizer(
            self.cfg, self.model.parameters())

    def _write_metrics(self, record) -> None:
        if not self.metrics_path:
            return
        os.makedirs(os.path.dirname(os.path.abspath(self.metrics_path)),
                    exist_ok=True)
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")
