"""A record of the window-cut workload on the card, and of the cost of
capturing a long stack of steps: the counterpart of
``benchmarks/probe_windowcut.py``.

Trains the SegmentClassifier (f32, hidden 32, 4 iterations, input
``[x, z, r / r_max]``; ``aggregation="auto"``, the dense route at this
size) on two-coordinate window-cut graphs
(``data/toy2d.py::make_window_segment_graphs``: 10 layers x 4 tracks,
2^14 events) in batches of 64, so an epoch is a stack of 256 steps that
``Trainer.run_steps`` runs as one captured 256-step graph, at the cosine
rate from 3e-3 over ``epochs x steps`` steps.  The first epoch captures;
the rest are timed.  Evaluates on the seed-99 set (16 batches of 32) and
prints one JSON line with throughput, the full metric set and MFU; below
the AUC gate of 0.995 it refuses.  f32: the window cut's discrimination
lives at coordinate differences below bf16's feature resolution.

The record also gives what the 256-step capture costs: the first call's
eager run, capture and instantiation seconds, the memory that call took
beyond the stack's input buffers, and the replayed ms a step.  Where a
stack of 256 steps does not fit, the epoch is split into the fewest
equal calls that do (``calls_per_epoch``); the epoch is never shrunk.

The initial weights are the JAX package's ``PRNGKey(0)`` draw, the TPU
record's, unless ``--seed`` or ``--init torch`` (the port's own
``torch.Generator`` draw) says otherwise: the AUC reached depends on the
draw (``PERF.md``).

Usage: python -m gnn_fpga_tpu_torch.probes.windowcut [--epochs 64
           --batch 64 --n-events 16384 --seed 0 --init jax|torch]
           [--device cpu]
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import numpy as np
import torch

from gnn_fpga_tpu_torch.core.capture import signature
from gnn_fpga_tpu_torch.core.device import default_device
from gnn_fpga_tpu_torch.core.graph import index_fields
from gnn_fpga_tpu_torch.data import toy2d
from gnn_fpga_tpu_torch.models import mpnn
from gnn_fpga_tpu_torch.probes import common
from gnn_fpga_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                              stack_batches)
from gnn_fpga_tpu_torch.utils import flops as fl

HIDDEN, N_ITERS, INPUT_DIM = 32, 4, 3
AUC_GATE = 0.995
EVAL_SEED, EVAL_EVENTS, EVAL_BATCH = 99, 512, 32


def split_epoch(g, steps: int) -> list:
    """The batched graph ``g`` cut into ``steps`` consecutive batches."""
    per = g.x.shape[0] // steps
    return [index_fields(g, slice(i * per, (i + 1) * per))
            for i in range(steps)]


def make_trainer(epochs, steps, device=None, seed=0, init="jax") -> Trainer:
    """The probe's Trainer: a SegmentClassifier from the initial weights
    of ``seed`` (``common.segment_classifier``; by default the JAX
    package's ``PRNGKey(0)``), the cosine rate over ``epochs * steps``
    steps."""
    return common.make_trainer(
        mpnn.SegmentClassifierConfig(input_dim=INPUT_DIM, hidden_dim=HIDDEN,
                                     n_iters=N_ITERS),
        TrainConfig(learning_rate=3e-3, lr_schedule="cosine",
                    decay_steps=epochs * steps), device, seed, init)


def eval_batches(device) -> list:
    gv = toy2d.make_window_segment_graphs(
        toy2d.Toy2DConfig(n_layers=10, n_tracks=4, seed=EVAL_SEED),
        EVAL_EVENTS)
    return [b.to(device) for b in split_epoch(gv, EVAL_EVENTS // EVAL_BATCH)]


def tensor_bytes(batch) -> int:
    return sum(t.numel() * t.element_size() for t in batch.tensors())


def first_epoch(trainer, stacks) -> dict:
    """The first epoch (each stack's first call: eager run and capture),
    with what it cost: its seconds, and on the card the seconds of the
    eager runs, the captures and the instantiations (summed over the
    stacks) and the peak memory beyond what was allocated before and
    beyond the stacks (None on the CPU, where nothing is captured)."""
    cuda = trainer.device.type == "cuda"
    if cuda:
        # Count the same allocations whatever ran before in the process:
        # earlier work's garbage is freed now, not inside the window (the
        # capture collects), and the BLAS library's workspaces (one a
        # stream, taken from the caching allocator at a stream's first
        # matmul, and cleared by every capture's start) are freed so that
        # the window allocates its own.
        gc.collect()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    for s in stacks:
        trainer.run_steps(s)
    out = {"first_epoch_s": time.perf_counter() - t0,
           "eager_s": None, "capture_s": None, "instantiate_s": None,
           "memory_beyond_inputs_mib": None}
    if cuda:
        for k in ("eager_s", "capture_s", "instantiate_s"):
            out[k] = sum(trainer._captured[("train", signature(s))]
                         .timings[k] for s in stacks)
        out["memory_beyond_inputs_mib"] = (
            torch.cuda.max_memory_allocated() - before
            - sum(tensor_bytes(s) for s in stacks)) / 2 ** 20
    return out


def train(epochs, n_events, batch, device, calls_per_epoch=1, seed=0,
          init="jax") -> tuple:
    """The window-cut training: ``(trainer, record fields)``.  Each epoch
    is ``calls_per_epoch`` calls of ``run_steps`` on equal parts of the
    stack; on the card a part that runs out of memory at its capture
    doubles the calls (the fewest that fit), with the epoch unchanged."""
    cfg = toy2d.Toy2DConfig(n_layers=10, n_tracks=4, seed=0)
    g = toy2d.make_window_segment_graphs(cfg, n_events)
    steps = n_events // batch
    edges_per_epoch = float(g.edge_mask.sum())
    batches = split_epoch(g, steps)
    while True:
        per = steps // calls_per_epoch
        stacks = [stack_batches(batches[i:i + per], device)
                  for i in range(0, steps, per)]
        trainer = make_trainer(epochs, steps, device, seed, init)
        try:
            cost = first_epoch(trainer, stacks)
            break
        except torch.cuda.OutOfMemoryError:
            del trainer, stacks
            torch.cuda.empty_cache()
            if per % 2:
                raise
            calls_per_epoch *= 2
    t0 = time.perf_counter()
    for _ in range(epochs - 1):
        losses = np.concatenate([trainer.run_steps(s) for s in stacks])
    dt = time.perf_counter() - t0
    n_timed = (epochs - 1) * steps
    fields = {
        "value": edges_per_epoch * (epochs - 1) / dt,
        "final_loss": float(losses[-1]),
        "ms_per_step": dt / n_timed * 1e3,
        "steps_per_epoch": steps,
        "calls_per_epoch": calls_per_epoch,
        "steps_per_call": steps // calls_per_epoch,
        **cost,
    }
    rate = fl.train_step_flops(fl.segment_classifier_flops(
        40 * batch, edges_per_epoch / steps, HIDDEN, N_ITERS,
        INPUT_DIM)) * (n_timed / dt)
    fields["mfu"] = fl.mfu(rate, device) if device.type == "cuda" else None
    return trainer, fields


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("probes.windowcut")
    ap.add_argument("--epochs", type=int, default=64)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n-events", type=int, default=2 ** 14)
    ap.add_argument("--seed", type=int, default=0,
                    help="the initial weights' seed")
    ap.add_argument("--init", choices=common.INITS, default="jax",
                    help="whose draw: the JAX package's PRNGKey(seed) "
                         "(the TPU record's) or the port's torch.Generator")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' for tests")
    args = ap.parse_args(argv)
    if args.epochs < 2:
        ap.error("--epochs must be at least 2: the first epoch captures")
    dev = default_device(args.device)
    tr, fields = train(args.epochs, args.n_events, args.batch, dev,
                       seed=args.seed, init=args.init)
    evals = eval_batches(dev)
    m = tr.evaluate(iter(evals), len(evals))
    record = {
        "metric": "train_edges_per_s_per_chip_windowcut_h32_i4",
        "value": fields.pop("value"),
        "unit": "edges/s",
        "vs_baseline": m["accuracy"] / 0.995,
        "baseline": "reference_fullevent_accuracy",
        **fields,
        **{k: float(v) for k, v in m.items()},
        "seed": args.seed,
        "init": args.init,
    }
    if m["auc"] < AUC_GATE:
        raise SystemExit(f"AUC {m['auc']:.4f} below gate {AUC_GATE}: "
                         f"{json.dumps(record)}")
    record["auc_gate"] = AUC_GATE
    print(json.dumps(record), flush=True)
    print(f"# device: {common.device_line(dev)}", flush=True)
    return record


if __name__ == "__main__":
    main()
