"""The whole train step on the blocked (layered) route against the dense
and sparse routes: the counterpart of ``benchmarks/probe_blocked.py``.

Times the SegmentClassifier train step (forward, backward, Adam; bf16
compute, hidden 64, 6 iterations, ``learning_rate=3e-3``,
``pos_weight=8``) as ``Trainer.run_steps`` runs a stack of distinct
batches (``stack_batches``: one captured K-step graph on the card), with
the aggregation swept:

- ``dense``: the one-hot ``[V, E]`` incidence matmuls
  (``ops/dense_incidence.py``);
- ``blocked group=g``: per-layer-pair block-diagonal incidence
  (``ops/blocked.py``), ``g`` layer pairs a block;
- ``sparse``: the COO gather and ``index_add_`` (``ops/segment.py``).

Three scales (Toy2D kNN sectors, ``k = 12``):

- ``sector`` (bench.py's mu200 config): 16 graphs of V = 440 / E = 5,016
  a batch, 64 steps; dense, blocked, sparse;
- ``fullevent``: 2 graphs of V = 3,200 / E = 36,480 (160 tracks) a batch,
  a quarter of the steps (at least 8); no dense (V E = 117M);
- ``fullevent36`` (bench.py's fullevent workload as a batch of 36
  sectors): V = 440 a graph, a quarter of the steps (at least 8).

Each route is warmed by one call on its stack, then timed as the best of
three calls, the clock stopped by the call's loss readback.  Beside the
wall time a step, each line gives the card's busy time a step
(``torch.profiler`` over one more call) and its idle share against the
wall time with the profiler off; on the CPU neither is measured.  Under
``aggregation="auto"`` the port takes the blocked route whenever blocks
are attached (``models/mpnn.py``), so these lines put a number on that
default.

Usage: python -m gnn_fpga_tpu_torch.probes.blocked [--metric sector|
           fullevent|fullevent36|both] [--steps 64] [--groups 1 2 4]
           [--no-sparse] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import torch

from gnn_fpga_tpu_torch.core.device import default_device
from gnn_fpga_tpu_torch.data import toy2d
from gnn_fpga_tpu_torch.models import mpnn
from gnn_fpga_tpu_torch.ops import blocked as blk
from gnn_fpga_tpu_torch.probes import common
from gnn_fpga_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                              stack_batches)

HIDDEN, N_ITERS, K_NN = 64, 6, 12
TRAIN = dict(learning_rate=3e-3, pos_weight=8.0)
# name -> (n_layers, n_tracks, batch, steps divisor, with dense)
SCALES = {"sector": (20, 22, 16, 1, True),
          "fullevent": (20, 160, 2, 4, False),
          "fullevent36": (20, 22, 36, 4, True)}


def block_e(group: int, n_tracks: int) -> int:
    """The blocked plan's edge capacity a block: ``group`` layer pairs of
    ``n_tracks * K_NN`` kNN edges, rounded up to a multiple of 8."""
    return -(-group * n_tracks * K_NN // 8) * 8


def make_stacked(cfg, n_steps, batch, seed0, group=None, block_e=None,
                 device=None):
    """``n_steps`` stacked batches of ``batch`` kNN toy graphs (seeds
    ``seed0``, ``seed0 + 1``, ...), blocks attached to each batch when
    ``group`` is given, stacked on ``device`` (default: the card)."""
    offs = toy2d.layer_offsets(cfg)
    batches = []
    for s in range(n_steps):
        g = toy2d.make_knn_segment_graphs(
            toy2d.Toy2DConfig(n_layers=cfg.n_layers, n_tracks=cfg.n_tracks,
                              seed=seed0 + s), batch, k=K_NN)
        if group is not None:
            g = blk.attach_blocks_layered(g, offs, group=group,
                                          block_e=block_e)
        batches.append(g)
    return stack_batches(batches, default_device(device))


def make_trainer(aggregation, hidden, n_iters, device=None,
                 compute_dtype=torch.bfloat16) -> Trainer:
    """The probe's Trainer: a SegmentClassifier on ``aggregation`` from
    the JAX package's initial weights of seed 0."""
    return common.make_trainer(mpnn.SegmentClassifierConfig(
        input_dim=2, hidden_dim=hidden, n_iters=n_iters,
        compute_dtype=compute_dtype, aggregation=aggregation),
        TrainConfig(**TRAIN), device)


def time_mode(label, trainer, stacked, n_reps=3) -> dict:
    """One warm call of ``trainer.run_steps(stacked)``, then the best of
    ``n_reps`` calls (each ends in its loss readback): ms a step, real
    edges/s, the last loss and, on the card, the busy time a step and the
    idle share."""
    n_steps = stacked.x.shape[0]
    edges = float(stacked.edge_mask.sum())
    trainer.run_steps(stacked)            # capture + warm
    best, losses = common.best_of(trainer, stacked, n_reps)
    rec = {"route": label, "ms_per_step": best / n_steps * 1e3,
           "edges_per_s": edges / best, "loss": float(losses[-1]),
           "device_ms_per_step": None, "device_idle": None}
    if trainer.device.type == "cuda":
        busy = common.device_busy_ms(lambda: trainer.run_steps(stacked))
        rec["device_ms_per_step"] = busy / n_steps
        rec["device_idle"] = 1 - busy / (best * 1e3)
    dev = ("not measured" if rec["device_ms_per_step"] is None else
           f"device {rec['device_ms_per_step']:8.3f} ms/step, idle "
           f"{rec['device_idle']:.1%}")
    print(f"{label:28s} {rec['ms_per_step']:8.3f} ms/step  "
          f"{rec['edges_per_s'] / 1e6:8.1f} Medge/s  (loss {rec['loss']:.3f})"
          f"  {dev}", flush=True)
    return rec


def run_scale(name, n_layers, n_tracks, hidden, n_iters, n_steps, batch,
              groups, with_dense, with_sparse=True, device=None) -> dict:
    """Every route at one scale; ``{route: record}``."""
    device = default_device(device)
    cfg = toy2d.Toy2DConfig(n_layers=n_layers, n_tracks=n_tracks)
    v = n_layers * n_tracks
    e = (n_layers - 1) * n_tracks * K_NN
    print(f"\n# {name}: V={v} E={e} h={hidden} iters={n_iters} "
          f"batch={batch} steps={n_steps} (V*E={v * e / 1e6:.1f}M)",
          flush=True)
    modes = ([("dense", "dense", None)] if with_dense else []) + \
        [(f"blocked group={g}", "blocked", g) for g in groups] + \
        ([("sparse", "sparse", None)] if with_sparse else [])
    results = {}
    for label, aggregation, group in modes:
        stacked = make_stacked(
            cfg, n_steps, batch, seed0=0, group=group,
            block_e=None if group is None else block_e(group, n_tracks),
            device=device)
        results[label] = time_mode(
            label, make_trainer(aggregation, hidden, n_iters, device),
            stacked)
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("probes.blocked")
    ap.add_argument("--metric",
                    choices=["sector", "fullevent", "fullevent36", "both"],
                    default="both")
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--groups", type=int, nargs="*", default=[1, 2, 4])
    ap.add_argument("--no-sparse", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' for tests")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    names = {"both": ("sector", "fullevent"),
             "fullevent36": ("fullevent36",)}.get(args.metric,
                                                   (args.metric,))
    out = {}
    for name in names:
        n_layers, n_tracks, batch, div, dense = SCALES[name]
        steps = args.steps if div == 1 else max(args.steps // div, 8)
        out[name] = run_scale(name, n_layers, n_tracks, HIDDEN, N_ITERS,
                              steps, batch, args.groups, with_dense=dense,
                              with_sparse=not args.no_sparse, device=dev)
        print(json.dumps({"metric": f"train_step_ms_blocked_probe_{name}",
                          "unit": "ms/step", "steps": steps,
                          "batch": batch, "routes": out[name]}), flush=True)
    print(f"# device: {common.device_line(dev)}", flush=True)
    return out


if __name__ == "__main__":
    main()
