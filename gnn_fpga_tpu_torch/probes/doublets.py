"""The real graph-construction pipeline meets the fused kernels: the
counterpart of ``benchmarks/probe_doublets.py``.

The fullevent-regime training step on graphs built by ``data/doublets.py``
(the ACTS-format construction path): synthetic mu200-scale events (400
particles x 10 barrel layers, exact line tracks within the mu200 cuts),
each cut into 8 recentred phi sectors, doublets selected by the
cross-join kernel (``csrc/doublets.cu``, one call a sector graph) with
the layer-dependent phi-slope and z0 cuts, nodes sorted by (layer, phi),
the sectors of ``events_per_step`` events packed into one graph a step
with the fused kernels' plans attached.

The fused (``pallas``) route trains in bf16 (hidden 64, 6 iterations,
Adam) at the cosine rate from 5e-3 over ``epochs x n_steps`` steps, with
``pos_weight = max((1 - purity) / purity, 1)``; one epoch of the sparse
route on the same stack (plans dropped) is its baseline.  Each route's
time a step is the best of ``--reps`` calls of ``Trainer.run_steps`` on
the stack (one captured K-step graph on the card).  Prints one JSON line
(``vs_baseline`` = sparse / fused time, MFU by ``utils/flops.py``, the
construction time an event) and refuses to print it below the held-out
AUC gate of 0.93.

Deliberate differences: the events are ``data/table.py`` Tables, not
DataFrames (no pandas); each sector graph is padded to an edge capacity
rounded up to 8, the port's capacity rule, where the TPU probe rounds to
its kernel tile of 256 and pins the kernels' gather window; the plans of
the steps are padded to one ``PlanCapacity`` so that the steps stack.

Usage: python -m gnn_fpga_tpu_torch.probes.doublets [--events-per-step 4
           --n-steps 8 --particles 400 --epochs 24 --reps 3 --no-auc
           --seed 0 --init jax|torch] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from gnn_fpga_tpu_torch.core import graph as graph_lib
from gnn_fpga_tpu_torch.core.device import default_device
from gnn_fpga_tpu_torch.data import doublets
from gnn_fpga_tpu_torch.data.table import Table
from gnn_fpga_tpu_torch.models import mpnn
from gnn_fpga_tpu_torch.ops.cuda import spmm
from gnn_fpga_tpu_torch.probes import common
from gnn_fpga_tpu_torch.train import metrics as metrics_lib
from gnn_fpga_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                              stack_batches)
from gnn_fpga_tpu_torch.utils import flops as fl

MU200_CUTS = dict(phi_slope_max=7e-4, phi_slope_outer_max=7e-4,
                  z0_max=500.0)
BARREL_RADII = np.array(
    [32., 72., 116., 172., 260., 360., 500., 660., 820., 1020.])
HIDDEN, N_ITERS, INPUT_DIM = 64, 6, 3
AUC_GATE = 0.93


def synth_event(rng, n_particles) -> Table:
    """One mu200-scale event: exact line tracks in (phi, z) against r,
    slopes within the cuts, so that the construction keeps every true
    doublet; the TPU probe's columns and draws."""
    pid = np.repeat(np.arange(1, n_particles + 1), len(BARREL_RADII))
    phi0 = rng.uniform(-np.pi, np.pi, n_particles)
    slope = rng.uniform(-5e-4, 5e-4, n_particles)
    z0 = rng.uniform(-150.0, 150.0, n_particles)
    cot = rng.uniform(-1.5, 1.5, n_particles)
    r = np.tile(BARREL_RADII, n_particles)
    phi = np.repeat(phi0, 10) + np.repeat(slope, 10) * r
    phi = (phi + np.pi) % (2 * np.pi) - np.pi
    z = np.repeat(z0, 10) + np.repeat(cot, 10) * r
    layer = np.tile(np.arange(10), n_particles)
    return Table({"evtid": np.zeros(len(pid), np.int64), "layer": layer,
                  "r": r, "phi": phi, "z": z, "particle_id": pid})


def build_graphs(n_events, n_particles, seed=0, n_sectors=8,
                 device=None) -> list:
    """Doublet graphs of ``n_events`` events, one a recentred phi sector
    (the recentring also bounds the gather span: a raw phi sort leaves the
    +/-pi wrap adjacent to nothing); the cross-join runs on ``device``
    (default: the card), the graphs come back on the CPU."""
    rng = np.random.default_rng(seed)
    cuts = doublets.SegmentCuts(**MU200_CUTS)
    pairs = doublets.adjacent_layer_pairs(10)
    scale = np.array([1000.0, np.pi / n_sectors, 1000.0])
    width = 2 * np.pi / n_sectors
    graphs = []
    for _ in range(n_events):
        ev = synth_event(rng, n_particles)
        sector = np.floor((ev["phi"] + np.pi) / width)
        sector = np.clip(sector, 0, n_sectors - 1).astype(int)
        for s in range(n_sectors):
            sec = ev.filter(sector == s)
            if not len(sec):
                continue
            sec = sec.assign(phi=sec["phi"] - (-np.pi + (s + 0.5) * width))
            g = doublets.construct_graph(
                sec, pairs, cuts=cuts, feature_scale=scale,
                sort_by_layer=True, device=device)
            if g is not None:
                graphs.append(g)
    return graphs


def pack_batches(graphs, per_step) -> list:
    """``per_step`` doublet graphs packed a step, each first padded to one
    ``(v_cap, e_cap)`` (the edge capacity rounded up to 8), plans attached
    and padded to the least capacity that holds every step's, so that the
    steps stack."""
    v_cap = max(g.n_node for g in graphs) + 8
    e_cap = -(-max(g.n_edge for g in graphs) // 8) * 8
    padded = [graph_lib.pad_graph(g, v_cap, e_cap) for g in graphs]
    packs = [graph_lib.attach_plans(graph_lib.pack_graphs(
                 padded[i:i + per_step]))
             for i in range(0, len(padded) - per_step + 1, per_step)]
    cap = spmm.PlanCapacity.covering(*(p.plans for p in packs))
    return [p.replace(plans=spmm.pad_plans(p.plans, cap)) for p in packs]


def model_config(aggregation, compute_dtype=torch.bfloat16):
    """The probe's SegmentClassifier (input 3, hidden 64, 6 iterations)
    on ``aggregation``."""
    return mpnn.SegmentClassifierConfig(
        input_dim=INPUT_DIM, hidden_dim=HIDDEN, n_iters=N_ITERS,
        compute_dtype=compute_dtype, aggregation=aggregation)


def make_trainer(aggregation, tcfg, device=None,
                 compute_dtype=torch.bfloat16, seed=0,
                 init="jax") -> Trainer:
    """:func:`model_config`'s model under ``tcfg``, from the initial
    weights of ``seed`` (``common.segment_classifier``; by default the JAX
    package's ``PRNGKey(0)``)."""
    return common.make_trainer(model_config(aggregation, compute_dtype),
                               tcfg, device, seed, init)


def train_config(epochs, n_steps, purity) -> TrainConfig:
    """The cosine rate from 5e-3 over ``epochs * n_steps`` steps with the
    purity's positive weight; one epoch (a timing run) takes the default
    config."""
    if epochs <= 1:
        return TrainConfig()
    return TrainConfig(learning_rate=5e-3, lr_schedule="cosine",
                       decay_steps=epochs * n_steps,
                       pos_weight=max((1 - purity) / purity, 1.0))


def run(trainer, stacked, epochs, reps) -> tuple:
    """``epochs - 1`` calls of ``trainer.run_steps(stacked)``, then the
    best of ``reps`` timed calls: ``(seconds a step, last loss)``."""
    n_steps = stacked.x.shape[0]
    for _ in range(epochs - 1):
        trainer.run_steps(stacked)
    best, losses = common.best_of(trainer, stacked, reps)
    return best / n_steps, float(losses[-1])


def prepare(events_per_step, n_steps, particles, device) -> tuple:
    """The probe's data: ``(training batches, the held-out batch, steps,
    events built, seconds of the construction)``; ``n_events`` events are
    built for ``n_steps`` training steps and one held-out step, and the
    steps are as many as the non-empty sectors fill."""
    sps = events_per_step * 8                # sectors a step
    n_events = events_per_step * (n_steps + 1)
    if device.type == "cuda":
        from gnn_fpga_tpu_torch.ops.cuda import _build

        _build.load_library()   # the kernels' first build is not construction
    t0 = time.perf_counter()
    graphs = build_graphs(n_events, particles, device=device)
    n_steps = min(n_steps, len(graphs) // sps - 1)  # empty sectors
    n_train = n_steps * sps
    batches = pack_batches(graphs[:n_train], sps)
    eval_batch = pack_batches(graphs[n_train:n_train + sps], sps)[0]
    return (batches, eval_batch, n_steps, n_events,
            time.perf_counter() - t0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("probes.doublets")
    ap.add_argument("--events-per-step", type=int, default=4)
    ap.add_argument("--n-steps", type=int, default=8)
    ap.add_argument("--particles", type=int, default=400)
    ap.add_argument("--epochs", type=int, default=24)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--no-auc", action="store_true")
    ap.add_argument("--seed", type=int, default=0,
                    help="the initial weights' seed")
    ap.add_argument("--init", choices=common.INITS, default="jax",
                    help="whose draw: the JAX package's PRNGKey(seed) "
                         "(the TPU record's) or the port's torch.Generator")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' for tests")
    args = ap.parse_args(argv)
    dev = default_device(args.device)

    batches, eval_batch, n_steps, n_events, build_s = prepare(
        args.events_per_step, args.n_steps, args.particles, dev)
    stacked = stack_batches(batches, dev)
    edges_per_scan = float(stacked.edge_mask.sum())
    v_real = float(stacked.node_mask.sum()) / n_steps
    purity = float(stacked.y.sum()) / max(edges_per_scan, 1.0)

    sparse = make_trainer("sparse", train_config(1, n_steps, purity), dev,
                          seed=args.seed, init=args.init)
    sparse_s, _ = run(sparse, stacked.replace(plans=None), 1, args.reps)
    tr = make_trainer("pallas", train_config(args.epochs, n_steps, purity),
                      dev, seed=args.seed, init=args.init)
    fused_s, final_loss = run(tr, stacked, args.epochs, args.reps)

    record = {
        "metric": "train_edges_per_s_per_chip_doublets_acts_h64_i6",
        "value": edges_per_scan / n_steps / fused_s,
        "unit": "edges/s",
        "vs_baseline": sparse_s / fused_s,
        "baseline": "sparse_route_same_card",
        "aggregation": "pallas",
        "source": "doublets(acts-format, mu200 cuts)",
        "n_node_per_step": v_real,
        "n_edge_per_step": edges_per_scan / n_steps,
        "purity": purity,
        "ms_per_step": fused_s * 1e3,
        "sparse_ms_per_step": sparse_s * 1e3,
        "final_loss": final_loss,
        "construction_s_per_event": build_s / (n_events
                                               + args.events_per_step),
        "n_steps": n_steps,
        "epochs": args.epochs,
        "seed": args.seed,
        "init": args.init,
    }
    rate = fl.train_step_flops(fl.segment_classifier_flops(
        v_real, edges_per_scan / n_steps, HIDDEN, N_ITERS,
        INPUT_DIM)) / fused_s
    record["mfu"] = fl.mfu(rate, dev) if dev.type == "cuda" else None
    if not args.no_auc:
        probs, y, mask = tr.predict(iter([eval_batch.to(dev)]), 1)
        auc = metrics_lib.roc_auc(probs, y, mask)
        record["auc"] = float(auc)
        record["auc_gate"] = AUC_GATE
        if auc < AUC_GATE:
            raise SystemExit(f"AUC {auc:.4f} below gate: "
                             f"{json.dumps(record)}")
    print(json.dumps(record), flush=True)
    print(f"# device: {common.device_line(dev)}", flush=True)
    return record


if __name__ == "__main__":
    main()
