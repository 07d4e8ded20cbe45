#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``gnn_fpga_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--profile PATH]

Drives the SegmentClassifier at the full width of the fullevent
configuration (hidden 64, 6 iterations, bf16 compute; 36 Toy2D kNN
sectors of 440 nodes) on the fused-kernel ("pallas") route, the 36 sectors
packed into one graph of 15,848 nodes and 180,736 edges, and on the
blocked and dense routes, the 36 sectors as one batch; serving and
training; the SegmentClassifierUnshared at the same width on the packed
graphs, and the NodeClassifier at the hit classifier's width (hidden 64,
7 iterations) on 36 packed events of Toy2D's seeded hit task; and checks
it:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the CUDA kernels from ``gnn_fpga_tpu_torch/csrc``;
3. kernels: each kernel, forward and backward, against its plain PyTorch
   version at the main path's shapes, f32 and bf16, with times (CUDA
   events), its bound (the larger of its bytes over the card's memory rate
   and its operations over the f32 rate) and, where one PyTorch call
   computes the same function, that call's time; then the fused
   iteration's two kernels on the fullevent and the hit graph, the
   lane-group row kernels (gather_pair_bwd, sddmm, sddmm_dual on four
   distinct tables, aggregate_pair, aggregate_pair_bwd and spmm) and the
   stream kernels (sorted_segment_sum, gather_pair) on the fullevent
   graph, each with and without its pad edges: checked, two launches
   equal bit for bit, and timed (gather_pair_bwd's two directions also
   alone, aggregate_pair with its weights read in sorted order beside the
   sorted copy's cost, the kernels at D = 64, the segment sum on a
   1,120-row hub, on a view off 16-byte alignment and with other tiles);
   then the probes' kernels (``ops/cuda/probes.py``, never on the main
   path): the copy and gather kernels bit for bit with their rates in
   GB/s, square matmuls in TFLOP/s beside the card's peaks, the SpMM
   ablation's six modes (``full`` bit for bit against ``spmm_raw``,
   ``aligned`` against ``full``), and the production iteration backward
   from the forward's scores against its variant that forms them, at the
   TPU probes' shapes and on the fullevent graph, each against its plain
   version, timed, with its bound;
4. serving: 8 distinct packed graphs answered by the fused route, with
   kernel launch counts, one request on the unfused route, and
   probabilities checked against the port's plain ``sparse`` route;
5. training: parameter gradients on the kernel route (fused and unfused)
   against the ``sparse`` route on each of the 8 graphs, then 32 Adam
   steps of the ``Trainer`` on the fused bf16 route over the graphs and 8
   warm steps on the unfused route, with launch counts per step, finite
   and falling losses, ms/step, and the unfused step's device time
   (torch.profiler over 3 more steps);
6. ops: the single-direction op API (``spmm`` with its backward,
   ``sddmm``, ``sddmm_dual``, ``sorted_segment_sum`` with its backward) on
   the packed graph, with launch counts, checked against the plain
   versions and against the aggregation backward's ``dw``;
7. blocked: 8 batches of 36 sectors served on the blocked route (bench.py's
   "blocked b36"), checked against the sparse route sector by sector and
   against the dense route; parameter gradients of both against the
   sparse route; 32 Adam steps of the ``Trainer`` on the blocked route;
   no hand-written kernel launched;
8. heads: the unshared head serving the 8 packed graphs on the fused
   route (6 ``iteration_pair`` and 1 ``gather_pair`` a request), checked
   against its sparse route with gradients; the NodeClassifier on 8 packed
   hit graphs (15,848 nodes, 331,264 edges): node logits and gradients
   against its sparse route, 32 Adam steps of the ``Trainer`` with
   ``target="node"`` (7 + 7 kernel launches a step) and one unfused step;
9. cli: 108 fullevent sectors written as NPZ files, the train CLI on the
   fused route in bf16 (2 epochs of 2 steps and a validation batch with
   ``--prefetch 2``, resumed for a third with ``--prefetch 0``, exact
   launch counts), one epoch on the blocked route, the infer CLI's
   ``--benchmark`` on the fused run's model, its scores checked against
   the sparse route; then the host loop timed: the CLI step with and
   without prefetching against a ``run_steps`` step on one pre-built
   batch, ``pack_graphs`` and ``attach_plans`` a batch, the device's busy
   share over a CLI epoch, each printed with the card's name and limit;
10. gcn: the GCRN and the six baselines at the widths the JAX package's
   tests train, logits on the card against the CPU, 50 Adam steps each
   with a falling loss (no hand-written kernel);
11. capture: the captured train step (CUDA graphs, one for each batch
   signature) against the eager one over 5 one-step calls from one init on
   the fused, unfused and blocked routes; the captured serving and infer
   forwards against the eager ones bit for bit; kernels #1-#7 (and sddmm,
   sddmm_dual) on plans padded to a static capacity against the unpadded
   plans bit for bit at the fullevent shape; a batch of another signature
   raising;
12. scan: bench.py's fullevent stack, 32 distinct packed graphs padded
   to one capacity and stacked on the card (``stack_batches``), trained by
   ``Trainer.run_steps`` as one captured 32-step graph (the cosine rate
   computed from a step count on the device): one graph replay for 32
   steps, 32 steps' launches, losses and weights bit for bit against
   one-step calls from the same init under a constant and a cosine rate;
   the same check at 4 steps on the unfused and blocked routes and for
   ``strategy="partitioned"`` at P = 1 over NCCL; each capture's time and
   its memory beyond its input buffers against the one-step graph's
   (at most twice); the stack's copy into the capture's buffers; the
   stacked step timed as bench.py's ``timed_run`` times it beside
   one-step calls, its device idle share, useful TFLOP/s, MFU and the
   attainable MFU (``utils/flops.py``, whose peaks and per-kernel work
   every bound here reads);
13. parallel: the fullevent packed graphs partitioned at P = 1 (a
   world of one over NCCL in this process): the sharded forward's
   probabilities and summed gradients, fused and unfused, against the
   sparse route; 32 captured Adam steps of ``Trainer(strategy=
   "partitioned")`` (the fused step's 6 + 1 + 6 + 1 launches of
   ``iteration_pair``, ``gather_pair`` and their backwards on the
   shard's extended table), 4 unfused steps, its eval loss and predict captured, its step
   timed beside the single-device fused step, and 5 ``strategy="dp"``
   steps on the 36-sector batches equal to the single device's; then 2
   and 4 ranks spawned on the one card over gloo: each shard's
   probabilities gathered and the summed gradients against the sparse
   route, the halo sizes, on an unpacked event whose shards pull whole
   layers the f32 fused route's halo-reading edges and gradients
   against one device's, 8 eager steps with the losses and weights
   identical on every rank, and 2 ranks of dp in f32 against the single
   device (times of ranks that share one card measure no scaling);
14. prepare: 4 synthetic TrackML-format events at mu200 density (10,000
   particles, ~10^4 hits a barrel layer, 10% noise hits, particle ids
   above 2^53) written with numpy; the doublet cross-join kernel
   (``csrc/doublets.cu``) against its plain version, bit for bit, on one
   whole event's barrel (no pT cut, one sector: ~10^8 pair evaluations a
   layer pair), timed, with pair evaluations/s and its bound; the port's
   ``prepare_graphs`` at its defaults on the card (one kernel call a
   sector graph) and with ``--device cpu``, every NPZ array identical,
   ms an event for reading, selecting and building; the train CLI on the
   prepared graphs on the fused route in bf16 at the fullevent widths, 2
   epochs, exact launch counts, finite losses; infer on them.  pandas is
   never imported;
15. probe_steps: the measurement modules (``gnn_fpga_tpu_torch/probes``)
   at full width and cut depth: the blocked probe's sector scale at 8
   steps on every route with device time and idle share, the SpMM probe's
   rows at 20 chained calls in f32 and bf16, each kernel row (forward,
   and gradients) checked against its plain version, the doublet probe
   (2 events a step, 2 epochs, no gate) with one fused step on its first
   batch checked against the sparse route, the window-cut
   probe's 256-step stack captured in one graph with its cost, and the
   scaling harness's dp and partitioned modes at P = 1 over NCCL;
16. ign: the Interaction Network's path (``models/interaction_gnn.py``)
   at its published width (hidden 128, 8 iterations, 3 Linear-LayerNorm-
   ReLU layers an MLP, bf16 over f32) on the packed fullevent graphs:
   ``gather_pair``, ``gather_pair_bwd`` and ``edge_sum`` (forward and
   backward) at H = 128 in f32 and bf16 against their plain versions,
   ``edge_sum`` timed with its bound; the fused hidden layer
   ``layer_norm_relu`` and its backward on the edge and the node rows in
   f32 and bf16 against ``layer_norm_relu_reference`` and its autograd,
   twice bit for bit, each way timed with its bound and beside
   ``F.layer_norm`` + ``F.relu`` (and their autograd and the bias's
   column sum); then a captured IGN_STEPS-step ``run_steps`` against
   one-step calls bit for bit, its replay counted: 8 ``edge_sum``, 18
   ``gather_pair``, 10 ``gather_pair_bwd`` and 57 ``layer_norm_relu``
   launches a step each way.

The packed graphs' plans are padded to one capacity that holds all of
them, as the train CLI pads a bucket's, so that the requests and steps of
phases 4, 5 and 8 share one static signature: the Trainer's steps and the
served forwards run as captured CUDA graphs, each signature's first call
eagerly (reported apart), and the CLI's steps, validation and infer's
forward too.  Each replay adds the launches its capture recorded to the
kernels' counts.

Every reference is the plain ``sparse`` route in f32.  A bf16 route is
held against it at the weights and inputs the bf16 route computes with
(rounded to bf16), so that what differs is only where the route rounds
its activations and how it sums (the sparse route in bf16 sums in bf16,
and is a looser reference than the kernels, which sum in f32).  Gradients
are checked on every graph or batch of a phase.

It prints a JSON line of per-kernel results and ends with one JSON line
``{"ok": true, "device": {...}}`` when every phase passed; any failure
exits non-zero.  ``--profile PATH`` also writes torch.profiler tables of
three fused requests, three fused training steps, one blocked training
step, three NodeClassifier training steps, one 32-step replay of the
stacked step and three replayed partitioned (P = 1) and single-device
steps to PATH.  ``--phase NAME`` (kernels, iteration, rows, stream or probes, on
the first packed graph, prepare, parallel, scan, probe_steps or ign;
repeatable) runs only those phases and prints no result line:
copied into an older checkout, it measures that tree's kernels the same
way.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

N_SECTORS, N_LAYERS, N_TRACKS, K_NN = 36, 20, 22, 12
N_NODE, N_EDGE = 15_848, 180_736      # padded as the JAX bench packs them
HIDDEN, N_ITERS, INPUT_DIM = 64, 6, 2
N_REQUESTS = 8
N_STEPS = 32
N_UNFUSED_STEPS = 8
LEARNING_RATE, POS_WEIGHT = 3e-3, 8.0  # bench.py's fullevent TrainConfig
GROUP, BLOCK_E = 4, 1056              # bench.py's fullevent "blocked b36"
N_REAL_EDGE = N_SECTORS * (N_LAYERS - 1) * N_TRACKS * K_NN   # 180,576
# The hit classifier (MPNN_HitClassifier.ipynb:cell35): 36 events of the
# seeded Toy2D task packed into one graph, every hit pair on adjacent
# layers an edge, padded as the fullevent graph is (8 pad nodes, edges to
# a multiple of 256)
NODE_HIDDEN, NODE_ITERS, NODE_INPUT_DIM, NODE_POS_WEIGHT = 64, 7, 3, 1.0
NODE_N_REAL_EDGE = N_SECTORS * (N_LAYERS - 1) * N_TRACKS ** 2  # 331,056
NODE_N_EDGE = 331_264
SOURCES = {"fwd": "gnn_fpga_tpu_torch/csrc/spmm.cu",
           "bwd": "gnn_fpga_tpu_torch/csrc/spmm_bwd.cu",
           "ops": "gnn_fpga_tpu_torch/csrc/spmm_ops.cu",
           "gather": "gnn_fpga_tpu_torch/csrc/gather.cu",
           "segsum": "gnn_fpga_tpu_torch/csrc/segment_sum.cu",
           "iter_fwd": "gnn_fpga_tpu_torch/csrc/iteration_fwd.cu",
           "iter_bwd": "gnn_fpga_tpu_torch/csrc/iteration_bwd.cu",
           "doublets": "gnn_fpga_tpu_torch/csrc/doublets.cu",
           "probes": "gnn_fpga_tpu_torch/csrc/probes.cu",
           "layer_norm": "gnn_fpga_tpu_torch/csrc/layer_norm.cu"}
# kernel -> (source, line of the Pallas kernel body it replaces)
KERNELS = {
    "iteration_pair": ("iter_fwd", "gnn_fpga_tpu/ops/pallas/spmm.py:1134"),
    "aggregate_pair": ("fwd", "gnn_fpga_tpu/ops/pallas/spmm.py:678"),
    "gather_pair": ("gather", "gnn_fpga_tpu/ops/pallas/spmm.py:950"),
    "iteration_pair_bwd": ("iter_bwd",
                           "gnn_fpga_tpu/ops/pallas/spmm.py:1173"),
    "aggregate_pair_bwd": ("bwd", "gnn_fpga_tpu/ops/pallas/spmm.py:806"),
    "gather_pair_bwd": ("bwd", "gnn_fpga_tpu/ops/pallas/spmm.py:967"),
    # the Interaction Network's sum onto both ends: gather_pair_bwd's
    # kernel, its halves added
    "edge_sum": ("bwd", "gnn_fpga_tpu/ops/pallas/spmm.py:967"),
    "spmm": ("fwd", "gnn_fpga_tpu/ops/pallas/spmm.py:408"),
    "sddmm": ("ops", "gnn_fpga_tpu/ops/pallas/spmm.py:496"),
    "sddmm_dual": ("ops", "gnn_fpga_tpu/ops/pallas/spmm.py:563"),
    "sorted_segment_sum": ("segsum",
                           "gnn_fpga_tpu/ops/pallas/segment_sum.py:82"),
    # the repo's one native (C++) kernel, not a Pallas kernel
    "select_segments": ("doublets", "native/doublets.cpp:37"),
    # the probes' kernels (ops/cuda/probes.py): instruments, never on the
    # main path
    "passthrough": ("probes", "benchmarks/probe_bw.py:49"),
    "gather_rows": ("probes", "benchmarks/probe_ops.py:144"),
    "ablate_rows": ("probes", "benchmarks/probe_spmm_ablate.py:25"),
    "iteration_pair_bwd_recompute": ("iter_bwd",
                                     "benchmarks/probe_iter.py:34"),
    # the Interaction Network's hidden layers (bias, LayerNorm, ReLU): no
    # Pallas kernel, the JAX package has no Interaction Network
    "layer_norm_relu": ("layer_norm", "none"),
    "layer_norm_relu_bwd": ("layer_norm", "none"),
}
# A kernel that stands for a second TPU kernel too.
ALSO_REPLACES = {"passthrough": "benchmarks/probe_ops.py:123"}
# Kernel outputs that are f32 from T-typed tables ([E] edge values): they
# take the f32 tolerance whatever T is.
F32_OUT_SIDES = ("dw", "e")
# Kernels that round each output once from the same f32 value as their
# plain version: held to it bit for bit.
EXACT_KERNELS = ("gather_pair",)

# Kernel vs plain version, |kernel - plain| <= atol + rtol * |plain|:
# f32: the plain version sums in another order (atomics) -> the JAX
#      package's own kernel tolerance;
# bf16: the kernel rounds its f32 accumulator to bf16 once on output
#      (half an ulp = 2^-8 relative at worst) -> twice that.
KERNEL_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (8e-3, 1e-4)}
# The iteration backward's parameter sums (dw2, db1, db2) add one term per
# edge over E = 180,736 edges, and the terms cancel (as do the segment
# sum's column sums over a 1,120-row hub): a reordered f32 sum
# errs in proportion to the terms, not to the result, so their atol is
# this factor times the largest entry of the plain result (rtol as above).
PARAM_SUM_ATOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
# Whole forward, fused kernel route vs the plain sparse route in f32 at the
# same weights and inputs (sparse_reference): f32 logits differ only by
# summation order over 6 iterations; bf16 probabilities by the kernel
# route's bf16 activations.
F32_LOGIT_TOL = (1e-4, 1e-4)           # (rtol, atol)
BF16_PROB_MAX_ABS, BF16_PROB_MEAN_ABS = 3e-2, 3e-3
# Parameter gradients, kernel route vs sparse route, same weights and batch:
# f32 (TF32 off): the JAX package's model-gradient tolerance
# (tests/test_pallas_spmm.py), elementwise;
# bf16: ||g_kernel - g_sparse|| / ||g_sparse|| over all parameters at once:
# the kernel route rounds activations and gradients to bf16 (2^-9
# relative) through 6-7 iterations forward and back.  One parameter's own
# relative norm is no measure: a scalar bias's gradient is a sum over every
# edge that cancels (the unshared head read up to 7e-2 on sound kernels).
# PERF.md (Findings) has the readings 1.5e-2 sits between: sound
# kernels at most 6.9e-3 over every graph of every head, planted faults
# (1% of messages dropped; a node head summing in bf16) 2.2e-2 and above.
F32_GRAD_TOL = (2e-3, 1e-5)
BF16_GRAD_REL = 1.5e-2

# The front door at the fullevent width: 108 Toy2D kNN sectors (3 x 36) as
# NPZ files, batches of 36 (2 train batches and 1 valid batch), the train
# CLI on the fused route in bf16, resumed, and on the blocked route, then
# the infer CLI on 8 files.
CLI_SECTORS, CLI_BATCH, CLI_VALID_FRAC = 3 * N_SECTORS, N_SECTORS, 0.34
CLI_TRAIN_STEPS, CLI_VALID_BATCHES = 2, 1
CLI_TIMING_EPOCHS = 4       # epochs of each prefetch timing run (3 batches)
CLI_INFER_GRAPHS = 8
# Infer's dense route against the sparse route, both f32, same weights:
# summation order only, per-file means of [0, 1] scores.
INFER_SCORE_RTOL = 1e-4
# The GCN and baseline widths the JAX package's tests train
# (tests/test_gcn.py:110-122, tests/test_baselines.py); card against CPU,
# f32 (TF32 off): summation order only.
GCN_TOL = (1e-5, 1e-6)                  # (rtol, atol)
GCN_STEPS = 50
# Captured against eager steps over CAPTURE_STEPS steps from one init: the
# rtol the Trainer's steps are held to against the JAX Trainer's.
CAPTURE_STEPS, CAPTURE_RTOL, CAPTURE_ATOL = 5, 1e-5, 1e-6
# The scan phase: bench.py's fullevent timed stack (bench.py:228-311),
# SCAN_STEPS distinct packed graphs (seeds 0-31) padded to one capacity and
# stacked on the card, run as one K-step graph; the unfused, blocked and
# partitioned (P = 1) routes at SCAN_SHORT_STEPS; the cosine rate decays
# over SCAN_DECAY_STEPS (the clamp is reached inside the 2K steps a check
# runs); the K-step call repeated SCAN_REPS times as bench.py's timed_run
# does.  A K-step graph's memory beyond its input buffers may be at most
# SCAN_MEMORY_FACTOR times the one-step graph's.
SCAN_STEPS, SCAN_SHORT_STEPS, SCAN_REPS = 32, 4, 4
SCAN_DECAY_STEPS = 48
SCAN_MEMORY_FACTOR = 2.0
# The readings of the host loop before steps were captured and plans
# composed (PERF.md's Findings: two runs on an NVIDIA H100 80GB HBM3
# at 700 W; the eager step's device time and idle share with the profiler
# on), printed beside this run's.
BEFORE = {"prefetch 2": "46.297 / 72.325 ms",
         "prefetch 0": "49.336 / 56.101 ms",
         "run_steps": "20.351 / 14.317 ms",
         "attach_plans": "25.202 / 26.026 ms",
         "pack_graphs": "4.584 / 9.721 ms", "infer": "2741.9 / 3079.0 us",
         "busy": "5.5% / 4.5% of a CLI epoch", "device": "2.540 ms",
         "idle": "78.6% (profiler on)"}


# The ign phase: the Interaction Network at its published width (Ju et
# al., arXiv:2103.16701) on the packed fullevent graphs, a captured
# IGN_STEPS-step run_steps; a step launches edge_sum once an iteration,
# gather_pair twice an iteration and twice more (encoder, head),
# gather_pair_bwd once an iteration and twice more, and layer_norm_relu
# and its backward once a hidden layer of the five MLPs (the two encoders,
# the node and edge networks each iteration, the head).
IGN_HIDDEN, IGN_ITERS, IGN_LAYERS, IGN_STEPS = 128, 8, 3, 4
IGN_HIDDEN_LAYERS = IGN_LAYERS * (2 * IGN_ITERS + 3)     # 57


# The prepare phase: synthetic TrackML-format events at mu200 density
# (10,000 particles, ~10^4 hits a barrel layer, 10% noise hits), through
# the port's prepare_graphs -> train -> infer.  TrackML's barrel layers:
# (volume_id, layer_id, radius in mm).
PREP_EVENTS, PREP_PARTICLES, PREP_NOISE = 4, 10_000, 0.1
PREP_LAYERS = ((8, 2, 32.0), (8, 4, 72.0), (8, 6, 116.0), (8, 8, 172.0),
               (13, 2, 260.0), (13, 4, 360.0), (13, 6, 500.0),
               (13, 8, 660.0), (17, 2, 820.0), (17, 4, 1020.0))
PREP_HALF_LENGTH = 1100.0   # mm: |z| of a barrel hit
# pT = 0.2 GeV + an exponential of mean 0.8 / ln 10 GeV: 10% pass 1 GeV
PREP_PT_MIN, PREP_PT_MEAN = 0.2, 0.8 / 2.302585092994046
PREP_BEND = 3e-4            # dphi/dr per mm at 1 GeV in 2 T (1 / 2R)
PREP_Z0_SIGMA, PREP_ETA_MAX = 55.0, 1.0
# The train CLI on the prepared sectors (4 events x 8 sectors): batches of
# 4, one validation batch, 7 train steps an epoch, the fullevent widths
PREP_BATCH, PREP_VALID_FRAC, PREP_EPOCHS = 4, 0.125, 2
PREP_TRAIN_STEPS, PREP_VALID_BATCHES = 7, 1
# The parallel phase: 32 captured partitioned steps at P = 1 over NCCL (as
# the training phase's), N_PART_UNFUSED_STEPS on the unfused body, DP_STEPS
# dp steps on the 36-sector batches; then PARALLEL_STEPS eager steps in
# each spawned gloo world on the one card.
PARALLEL_WORLDS = (2, 4)
PARALLEL_STEPS, N_PART_UNFUSED_STEPS, DP_STEPS = 8, 4, 5
PARALLEL_RANK_TIMEOUT_S = 300
# The halo check of the gloo worlds: one unpacked Toy2D event of the
# fullevent's layers and kNN with HALO_EVENT_TRACKS tracks (the
# partitioned example's mu200-scale event).  Its rows are layer-ordered,
# so at P = 2 and 4 every shard cut falls between two layers and a shard
# pulls a whole layer's rows from its neighbour.  f32, held to the
# single-device fused route at SHARD_F32_PROB_TOL (the sharded forward's
# tolerance in the CPU tests) and F32_GRAD_TOL.
HALO_EVENT_TRACKS = 400
SHARD_F32_PROB_TOL = (1e-4, 1e-5)
# The doublet kernel's bound: the f64 operations of one pair evaluation
# (3 subtractions, 2 divisions, 1 multiplication, 1 subtraction, 2 wrap
# tests, 2 absolute values, 2 comparisons; the rarely taken wrap additions
# not counted) at the card's f64 rate outside the tensor cores
DOUBLET_F64_OPS = 13
# The probe_steps phase: the measurement modules at full width, cut in
# depth (steps of the blocked probe's stacks, chained calls of the SpMM
# probe's rows, events a step of the doublet probe).
PROBE_BLOCKED_STEPS, PROBE_SPMM_CALLS, PROBE_DOUBLET_EVENTS = 8, 20, 2


def fail(msg: str):
    sys.exit(f"chip_smoke: FAILED: {msg}")


def expected_counts(**launched) -> dict:
    """Launch counts of every kernel wrapper: ``launched``, else 0."""
    return {name: launched.get(name, 0) for name in KERNELS}


def launch_counts() -> dict:
    """Every kernel's launches since the last reset, by ``KERNELS`` name
    (``spmm.launch_counts``)."""
    from gnn_fpga_tpu_torch.ops.cuda import spmm

    return expected_counts(**spmm.launch_counts())


def fused_step_counts(steps: int = 1) -> dict:
    """The launch counts of ``steps`` fused SegmentClassifier train steps
    (``utils/flops.py::fused_step_launches``, which the step's roofline
    sums over)."""
    from gnn_fpga_tpu_torch.utils import flops

    return expected_counts(**{k: n * steps for k, n in
                              flops.fused_step_launches(N_ITERS).items()})


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    import gnn_fpga_tpu_torch  # noqa: F401  (fails here, before any output,
    #                            when run outside a checkout of the repo)
    print(card(), flush=True)
    return torch.cuda.get_device_name(0)


def phase_build():
    from gnn_fpga_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{_build.library_path().name}", flush=True)


def make_request(seed: int, device, hits: bool = False):
    """One packed graph of 36 events of Toy2D seed ``seed``: the fullevent
    graph (kNN segment sectors), or with ``hits`` the hit classifier's
    (events of the seeded hit task)."""
    from gnn_fpga_tpu_torch.core import graph as G
    from gnn_fpga_tpu_torch.data import toy2d

    cfg = toy2d.Toy2DConfig(n_layers=N_LAYERS, n_tracks=N_TRACKS, seed=seed)
    if hits:
        gs, n_edge = toy2d.make_seeded_node_graphs(cfg, N_SECTORS), NODE_N_EDGE
    else:
        gs = toy2d.make_knn_segment_graphs(cfg, N_SECTORS, k=K_NN)
        n_edge = N_EDGE
    g = G.pack_graphs(G.unbatch_graphs(gs), n_node=N_NODE, n_edge=n_edge)
    return G.attach_plans(g).to(device)


def pad_to_covering(graphs) -> list:
    """``graphs`` with their plans padded to the least capacity that holds
    them all, as the train CLI pads a bucket's batches: one static
    signature, so one captured step or forward serves every graph."""
    from gnn_fpga_tpu_torch.ops.cuda import spmm

    cap = spmm.PlanCapacity.covering(*(g.plans for g in graphs))
    return [g.replace(plans=spmm.pad_plans(g.plans, cap)) for g in graphs]


def captured_probs(model, device):
    """The served forward, ``sigmoid(model(g))``, as a captured call."""
    from gnn_fpga_tpu_torch.core.capture import CapturedCall

    def forward(g):
        with torch.no_grad():
            return torch.sigmoid(model(g))

    return CapturedCall(forward, device)


def serve_captured(call, g):
    """:func:`serve` through a captured call: ``g`` copied into its
    buffers and the forward replayed."""
    t = time.perf_counter()
    p = call(g).clone()
    torch.cuda.synchronize()
    return p, (time.perf_counter() - t) * 1e3


def one_step_calls(trainer, batches) -> None:
    """``trainer.run_steps([g])`` for each of ``batches``: one replay of
    the trainer's one-step graph a batch, each with its readback."""
    for g in batches:
        trainer.run_steps([g])


def step_times(step_ms) -> str:
    """The first step (eager, then captured) apart from the replays."""
    rest = step_ms[1:]
    return (f"{sum(rest) / len(rest):.3f} ms/step replayed (min "
            f"{min(rest):.3f}, max {max(rest):.3f}, over {len(rest)} "
            f"steps); first step, eager and captured, {step_ms[0]:.3f} ms")


def time_ms(fn, n=20, warmup=3, graph=True) -> tuple:
    """``(device, dispatched)``: mean ms of one call of ``fn`` over ``n``
    calls.  Device: the calls captured once in a CUDA graph and the graph
    replayed between two CUDA events, which leaves the host's dispatch
    out; a call that cannot be captured raises (None with ``graph=False``).
    Dispatched: the calls issued one by one between two CUDA events, which
    takes the host's dispatch in wherever it is slower than the card."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    dispatched = start.elapsed_time(end) / n
    if not graph:
        return None, dispatched
    cuda_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(cuda_graph):
        for _ in range(n):
            fn()
    cuda_graph.replay()
    start.record()
    cuda_graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, dispatched


def fmt_ms(t) -> str:
    """A :func:`time_ms` result as 'device / dispatched' ms."""
    device, dispatched = t
    return (f"{'n/a' if device is None else f'{device:.4f}'} / "
            f"{dispatched:.4f} dispatched")


def device_ms(*times) -> float:
    """The mean device time of :func:`time_ms` results."""
    return sum(d for d, _ in times) / len(times)


def library_ms(fn) -> tuple:
    """``(ms, timer)`` of one library call: its device time from a CUDA
    graph (timer ``"cuda_graph"``), or, for a call that synchronises with
    the host and so cannot be captured, its dispatched time (timer
    ``"dispatched"``, which takes the host in)."""
    try:
        return device_ms(time_ms(fn)), "cuda_graph"
    except RuntimeError as err:
        torch.cuda.synchronize()
        print(f"  (library call not captured: "
              f"{str(err).splitlines()[0][:80]}; timed dispatched)",
              flush=True)
        return time_ms(fn, graph=False)[1], "dispatched"


def time_in_turns(label, fns) -> None:
    """Times each of ``fns`` twice, in turns (a, b, c, a, b, c), and
    prints the mean device time of each."""
    ts = {k: [] for k in fns}
    for _ in range(2):
        for k, f in fns.items():
            ts[k].append(time_ms(f))
    for k, t in ts.items():
        print(f"  {label} {k}: {device_ms(*t):.4f} ms "
              f"({', '.join(fmt_ms(x) for x in t)})", flush=True)


def compare(name, got, ref, rtol, atol) -> float:
    got, ref = got.float().reshape(ref.shape), ref.float()
    err = (got - ref).abs()
    lim = atol + rtol * ref.abs()
    max_abs = err.max().item()
    max_rel = (err / ref.abs().clamp_min(1e-3)).max().item()
    ok = bool((err <= lim).all())
    print(f"  {name}: max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
          f"tol=(rtol {rtol:g}, atol {atol:g}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok or not torch.isfinite(got).all():
        fail(f"{name} disagrees with its plain version")
    return max_abs


def exact(name, got, ref) -> float:
    """Fails unless ``got`` equals ``ref`` bit for bit, dtype included."""
    same = got.dtype == ref.dtype and torch.equal(got, ref)
    max_abs = (got.float() - ref.float()).abs().max().item()
    print(f"  {name}: max_abs={max_abs:.3e} bit for bit "
          f"{'ok' if same else 'FAIL'}", flush=True)
    if not same:
        fail(f"{name} differs from its plain version")
    return max_abs


def hold(name, kern, plain, sides, dt, exact_sides=False) -> float:
    """A kernel's outputs ``kern()`` against its plain version's
    ``plain()`` (tuples named by ``sides``), each at KERNEL_TOL of
    ``dt`` (bit for bit with ``exact_sides``; f32 outputs of ``dt``
    inputs at the f32 tolerance; parameter sums at PARAM_SUM_ATOL);
    fails on any disagreement; the largest |error|."""
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    err = 0.0
    for side, a, b in zip(sides, got, ref):
        if exact_sides:
            err = max(err, exact(f"{name} {side}", a, b))
            continue
        rtol, atol = KERNEL_TOL[dt]
        if side in ("dw2", "db1", "db2"):
            atol = PARAM_SUM_ATOL[dt] * b.abs().max().item()
        elif side in F32_OUT_SIDES:  # f32 output from T inputs
            rtol, atol = KERNEL_TOL[torch.float32]
        err = max(err, compare(f"{name} {side}", a, b, rtol, atol))
    return err


@contextlib.contextmanager
def uncounted():
    """Launches made inside are checks, not the path's: taken back from
    the launch counts on leaving."""
    from gnn_fpga_tpu_torch.ops.cuda import spmm

    before = spmm.launch_counts()
    try:
        yield
    finally:
        after = spmm.launch_counts()
        spmm.add_launch_counts({k: before[k] - after[k] for k in after})


def card_peaks():
    """The card's published peaks (``utils/flops.py``, NVIDIA's data
    sheet): the one table every bound here reads.  Fails for a card the
    table lacks."""
    from gnn_fpga_tpu_torch.utils import flops

    peaks = flops.chip_peaks()
    if peaks is None:
        fail(f"no published peaks for {torch.cuda.get_device_name(0)} in "
             f"gnn_fpga_tpu_torch/utils/flops.py")
    return peaks


def bound_ms(name, dt, *shape) -> tuple:
    """The least time the card could take for one call of kernel
    ``name`` (``utils/flops.py::kernel_work``: its bytes over the memory
    rate, its f32 operations over the f32 rate), and what sets it:
    ``(ms, "bytes" or "operations")``."""
    from gnn_fpga_tpu_torch.utils import flops

    peaks = card_peaks()
    nbytes, ops = flops.kernel_work(name, dt.itemsize, *shape)
    by_bytes = nbytes / (peaks.hbm_gbps * 1e9) * 1e3
    by_ops = ops / (peaks.f32_tflops * 1e12) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def library_calls(g, t, w, seg, n_kept) -> dict:
    """One PyTorch call for each kernel that computes its function on the
    same inputs, where there is one, timed beside the kernel and never
    called by the port.  Sparse operands (CSR matrices of the plans, the
    stacked ``[pa; pb]``) are built here, outside the timed call; a CSR
    matrix holds its weights in the tables' dtype.  A call the installed
    PyTorch refuses for the dtype is left out."""
    import torch.nn.functional as F

    plans, recv, send = g.plans, g.plans.recv, g.plans.send
    dt, dev = t["h"].dtype, g.x.device
    i64 = lambda a: a.long()
    csr = lambda crow, col, val, size: torch.sparse_csr_tensor(
        i64(crow), i64(col), val, size=size, device=dev)
    w_r = w.index_select(0, recv.order.long()).to(dt)
    w_s = w.index_select(0, send.order.long()).to(dt)
    adj_pair = csr(torch.cat([recv.seg_ptr, send.seg_ptr[1:] + N_EDGE]),
                   torch.cat([recv.sorted_oth, send.sorted_oth]),
                   torch.cat([w_r, w_s]), (2 * N_NODE, N_NODE))
    adj_recv = csr(recv.seg_ptr, recv.sorted_oth, w_r, (N_NODE, N_NODE))
    inc = csr(torch.cat([send.seg_ptr, recv.seg_ptr[1:] + N_EDGE]),
              torch.cat([send.order, recv.order]),
              torch.ones(2 * N_EDGE, dtype=dt, device=dev),
              (2 * N_NODE, N_EDGE))
    pattern = csr(recv.seg_ptr, recv.sorted_oth,
                  torch.zeros(N_EDGE, dtype=dt, device=dev),
                  (N_NODE, N_NODE))
    h_t = t["h"].t().contiguous()
    # sddmm_dual(g_mi, h, g_mo, h): <[g_mi, h][seg], [h, g_mo][oth]>
    pv = torch.cat([t["g_mi"], t["h"]], 1)
    qu_t = torch.cat([t["h"], t["g_mo"]], 1).t().contiguous()
    stacked = torch.cat([t["pa"], t["pb"]])
    pair_ids = torch.stack([g.senders.long(), g.receivers.long() + N_NODE], 1)
    lengths = seg.ptr.diff().long()
    kept = t["m_sorted"][:n_kept]
    kept_ids = seg.sorted_ids[:n_kept].long()
    calls = {
        "aggregate_pair": lambda: torch.sparse.mm(adj_pair, t["h"]),
        "spmm": lambda: torch.sparse.mm(adj_recv, t["h"]),
        "gather_pair_bwd": lambda: torch.sparse.mm(inc, t["g"]),
        "sddmm": lambda: torch.sparse.sampled_addmm(pattern, t["g_mi"], h_t,
                                                    beta=0.0),
        "sddmm_dual": lambda: torch.sparse.sampled_addmm(pattern, pv, qu_t,
                                                         beta=0.0),
        "gather_pair": lambda: F.embedding_bag(pair_ids, stacked,
                                               mode="sum"),
        # one scatter of the kept rows into a zeroed table (atomics)
        "sorted_segment_sum": lambda: torch.zeros(
            (N_NODE, kept.shape[1]), dtype=dt, device=dev).index_add_(
                0, kept_ids, kept),
        # the same sum from the CSR lengths; it syncs with the host
        "segment_reduce": lambda: torch.segment_reduce(
            kept, "sum", lengths=lengths),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError, TypeError) as err:
            print(f"  library call for {name} in {dt}: refused "
                  f"({str(err).splitlines()[0][:100]})", flush=True)
            continue
        out[name] = call
    return out


def phase_kernels(g) -> dict:
    """Every kernel against its plain version at the main-path shapes, on
    random tables and gradients over the main path's topology (~1% masked
    edges)."""
    from gnn_fpga_tpu_torch.ops.cuda import segment_sum, spmm

    dev = g.x.device
    gen = torch.Generator().manual_seed(1234)
    d, hdim = HIDDEN + INPUT_DIM, HIDDEN
    rnd = lambda *shape: torch.randn(*shape, generator=gen).to(dev)
    tabs = dict(pa=rnd(N_NODE, hdim), pb=rnd(N_NODE, hdim), h=rnd(N_NODE, d),
                w2=rnd(hdim) * 0.25, b1=rnd(hdim), b2=rnd(1),
                g_mi=rnd(N_NODE, d), g_mo=rnd(N_NODE, d),
                g=rnd(N_EDGE, hdim), m=rnd(N_EDGE, d))
    ids, seg = segment_ids(g, gen)
    em = (torch.rand(N_EDGE, generator=gen) >= 0.01).float().to(dev)
    em = em * g.edge_mask
    w = torch.rand(N_EDGE, generator=gen).to(dev) * em
    plans, recv = g.plans, g.plans.recv
    em_sorted = spmm.sort_edge_weights(em, recv)
    s, r = g.senders, g.receivers
    print(f"kernels: V={N_NODE} E={N_EDGE} D={d} H={hdim}, "
          f"{int((em == 0).sum())} masked edges, "
          f"{int((ids == N_NODE).sum())} dropped segment ids", flush=True)
    n_kept = int(seg.ptr[-1])
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        t = {k: v.to(dt) for k, v in tabs.items()}
        t["m_sorted"] = t["m"].index_select(0, seg.order.long())
        tag = str(dt).replace("torch.", "")
        libs = library_calls(g, t, w, seg, n_kept)
        ip = (t["pa"], t["pb"], t["h"], em_sorted, t["w2"], t["b1"], t["b2"])
        ip_ref = ip + (recv.sorted_oth, recv.sorted_seg, N_NODE)
        grads = (t["g_mi"], t["g_mo"])
        sig = spmm.iteration_pair_fwd(*ip, plans)[2]   # the bwd's input
        runs = {
            "gather_pair": (
                lambda: (spmm.gather_pair_fwd(t["pa"], t["pb"], s, r),),
                lambda: (spmm.gather_pair_reference(t["pa"], t["pb"], s, r),),
                ("out",)),
            "iteration_pair": (
                lambda: spmm.iteration_pair(*ip, plans),
                lambda: spmm.iteration_pair_reference(*ip_ref),
                ("mi", "mo")),
            "aggregate_pair": (
                lambda: spmm.aggregate_pair(t["h"], w, plans),
                lambda: spmm.aggregate_pair_reference(t["h"], w, s, r,
                                                      N_NODE),
                ("mi", "mo")),
            "iteration_pair_bwd": (
                lambda: spmm.iteration_pair_bwd(*ip, *grads, plans, sig),
                lambda: spmm.iteration_pair_bwd_reference(
                    *ip, *grads, recv.sorted_oth, recv.sorted_seg, N_NODE),
                ("dh", "dpa", "dpb", "dw2", "db1", "db2")),
            "aggregate_pair_bwd": (
                lambda: spmm.aggregate_pair_bwd(t["h"], w, *grads, plans),
                lambda: spmm.aggregate_pair_bwd_reference(
                    t["h"], w, *grads, s, r, N_NODE),
                ("dh", "dw")),
            "gather_pair_bwd": (
                lambda: spmm.gather_pair_bwd(t["g"], plans),
                lambda: spmm.gather_pair_bwd_reference(t["g"], s, r, N_NODE),
                ("dpa", "dpb")),
            "spmm": (
                lambda: (spmm.spmm_raw(t["h"], w, recv),),
                lambda: (spmm.spmm_reference(t["h"], w, r, s, N_NODE),),
                ("out",)),
            # forward and backward: dh through the send plan, dw by sddmm
            "spmm_vjp": (
                lambda: spmm_vjp(spmm.spmm, t["h"], w, t["g_mi"], recv,
                                 plans.send),
                lambda: spmm_vjp(spmm.spmm_reference, t["h"].float(), w,
                                 t["g_mi"].float(), r, s, N_NODE),
                ("dh", "dw")),
            "sddmm": (
                lambda: (spmm.sddmm(t["g_mi"], t["h"], recv),),
                lambda: (spmm.sddmm_reference(t["g_mi"], t["h"], r, s),),
                ("e",)),
            "sddmm_dual": (
                lambda: (spmm.sddmm_dual(t["g_mi"], t["h"], t["g_mo"],
                                         t["h"], recv),),
                lambda: (spmm.sddmm_dual_reference(
                    t["g_mi"], t["h"], t["g_mo"], t["h"], r, s),),
                ("e",)),
            "sorted_segment_sum": (
                lambda: (segment_sum.sorted_segment_sum(
                    t["m_sorted"], seg, N_NODE),),
                lambda: (segment_sum.segment_sum_reference(
                    t["m"], ids, N_NODE),),
                ("out",)),
            "sorted_segment_sum_default": (
                lambda: (segment_sum.sorted_segment_sum(
                    t["m_sorted"], seg, N_NODE, "default"),),
                lambda: (segment_sum.segment_sum_reference(
                    t["m"].bfloat16(), ids, N_NODE),),
                ("out",)),
        }
        for name, (kern, plain, sides) in runs.items():
            err = hold(f"{name} {tag}", kern, plain, sides, dt,
                       exact_sides=name in EXACT_KERNELS)
            # plain, kernel, kernel, plain: one card, interleaved
            p1, k1, k2, p2 = (time_ms(f) for f in (plain, kern, kern, plain))
            ms, plain_ms = device_ms(k1, k2), device_ms(p1, p2)
            print(f"  {name} {tag}: kernel {ms:.4f} ms "
                  f"({fmt_ms(k1)}, {fmt_ms(k2)}) plain {plain_ms:.4f} ms "
                  f"({fmt_ms(p1)}, {fmt_ms(p2)})", flush=True)
            out[(name, dt)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
            if name not in KERNELS:
                continue
            lib_ms, lib_timer = (library_ms(libs[name]) if name in libs
                                 else (None, None))
            bound, by = bound_ms(
                name, dt, N_NODE,
                n_kept if name == "sorted_segment_sum" else N_EDGE, d, hdim)
            print(f"  {name} {tag}: bound {bound:.4f} ms ({by}), one "
                  f"PyTorch call "
                  f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}",
                  flush=True)
            out[(name, dt)].update(bound_ms=bound, bound_by=by,
                                   library_ms=lib_ms, timer="cuda_graph",
                                   library_timer=lib_timer)
            if name == "sorted_segment_sum" and "segment_reduce" in libs:
                red_ms, red_timer = library_ms(libs["segment_reduce"])
                print(f"  {name} {tag}: segment_reduce {red_ms:.4f} ms "
                      f"({red_timer})", flush=True)
                out[(name, dt)].update(segment_reduce_ms=red_ms)
    return out


def phase_probes(g_full) -> dict:
    """The probes' kernels (``ops/cuda/probes.py``): each against its plain
    version on the card, launches counted, two launches bit for bit, and
    timed beside its plain version, one PyTorch call where one computes
    the same function, and its bound (``utils/flops.py::kernel_work``):

    - ``passthrough`` (f32 and bf16, 1, 2 and 4 vectors a thread) and
      ``gather_rows`` (f32 and bf16) at the TPU probes' shapes, bit for
      bit against ``x * 2`` and ``index_select``, with the copy and
      gather rates in GB/s; square matmuls (f32 with TF32 off, bf16) in
      TFLOP/s beside the card's peaks;
    - ``ablate_rows``'s six modes on the layered graph in the probe's
      cases (``probes/spmm_ablate.py``: bf16 at D = 128, the TPU probe's
      constants; bf16 and f32 at D = 66) and on the fullevent graph's
      recv plan (D = 66, f32 and bf16): ``full`` bit for bit against ``spmm_raw``
      and ``aligned`` against ``full``, every mode against its plain
      version at KERNEL_TOL (the group sums' atol as PARAM_SUM_ATOL's);
    - the production iteration backward from the forward's scores
      against ``iteration_pair_bwd_recompute`` at the TPU probe's two
      shapes and the fullevent graph, f32 and bf16: the variant against
      its plain version and against the production kernel, the
      production kernel against the stashed-score plain version, all at
      KERNEL_TOL and PARAM_SUM_ATOL; timed in turns (stashed, recompute,
      recompute, stashed) with the share the stash saves.

    Returns the JSON line's row of each kernel (passthrough and
    gather_rows in f32 at the probe shape; ablate_rows' full and the
    recompute variant in bf16 on the fullevent graph)."""
    import numpy as np

    from gnn_fpga_tpu_torch.ops.cuda import probes, spmm
    from gnn_fpga_tpu_torch.probes import bw, spmm_ablate
    from gnn_fpga_tpu_torch.probes import iter as iter_probe
    from gnn_fpga_tpu_torch.probes.common import layered_graph

    t_phase = time.perf_counter()
    dev = g_full.x.device
    peaks = card_peaks()
    # the TPU probes' shapes, as the port's probes take them
    v, e, d = spmm_ablate.V, spmm_ablate.E, spmm_ablate.D
    print(f"probes: the probes' kernels at the TPU probes' shapes (V={v}, "
          f"E={e}, D={d}) and on the fullevent graph, on {card()}",
          flush=True)
    rows = {}

    def launched_twice(name, what, kern):
        """Two launches of ``kern``: counted as ``name``, and equal bit for
        bit."""
        n0 = spmm.launch_counts()[name]
        first, again = kern(), kern()
        torch.cuda.synchronize()
        n = spmm.launch_counts()[name] - n0
        if n != 2:
            fail(f"{name} {what}: {n} launches counted for 2 calls")
        pairs = zip(first, again) if isinstance(first, tuple) else \
            ((first, again),)
        if not all(torch.equal(a, b) for a, b in pairs):
            fail(f"{name} {what}: two launches differ")
        return first

    def measure(name, what, kern, plain, bound_key, dt, shape, lib=None):
        """Kernel and plain device ms (plain, kernel, kernel, plain), the
        library call's and the bound's."""
        p1, k1, k2, p2 = (time_ms(f) for f in (plain, kern, kern, plain))
        ms, plain_ms = device_ms(k1, k2), device_ms(p1, p2)
        lib_ms, lib_timer = library_ms(lib) if lib else (None, None)
        bound, by = bound_ms(bound_key, dt, *shape)
        print(f"  {name} {what}: kernel {ms:.4f} ms ({fmt_ms(k1)}, "
              f"{fmt_ms(k2)}), plain {plain_ms:.4f} ms, one PyTorch call "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
              f"{bound:.4f} ms ({by}): {bound / ms:.1%} of the bound",
              flush=True)
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                    library_ms=lib_ms, timer="cuda_graph",
                    library_timer=lib_timer, dtype=str(dt).replace(
                        "torch.", ""), shape=what)

    # the copy and the gather, at the TPU probes' shapes
    rng = np.random.default_rng(0)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    h32 = f32(rng.standard_normal((v, d)))
    m32 = f32(rng.standard_normal((e, d)))
    ridx = torch.from_numpy(rng.permutation(
        np.sort(rng.integers(0, v, size=e))).astype(np.int32)).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).replace("torch.", "")
        x, h = m32.to(dt), h32.to(dt)
        for vec in probes.PASSTHROUGH_VECTORS:
            what = f"{tag} [{e}, {d}], {vec} vectors a thread"
            got = launched_twice("passthrough", what,
                                 lambda: probes.passthrough(x, vec))
            err = exact(f"passthrough {what}", got,
                        probes.passthrough_reference(x))
            row = measure("passthrough", what,
                          lambda: probes.passthrough(x, vec),
                          lambda: probes.passthrough_reference(x),
                          "passthrough", dt, (v, e, d, d),
                          lib=lambda: x * 2)
            print(f"  passthrough {what}: copy rate "
                  f"{2 * e * d * dt.itemsize / row['ms'] / 1e6:.1f} GB/s "
                  f"of {peaks.hbm_gbps:g} GB/s (data sheet)", flush=True)
            if dt == torch.float32 and vec == 4:
                rows["passthrough"] = dict(max_abs_err=err, **row)
        what = f"{tag} [{v}, {d}] table, {e} random ids"
        got = launched_twice("gather_rows", what,
                             lambda: probes.gather_rows(h, ridx))
        err = exact(f"gather_rows {what}", got,
                    probes.gather_rows_reference(h, ridx))
        row = measure("gather_rows", what,
                      lambda: probes.gather_rows(h, ridx),
                      lambda: probes.gather_rows_reference(h, ridx),
                      "gather_rows", dt, (v, e, d, d),
                      lib=lambda: h.index_select(0, ridx))
        b = dt.itemsize
        print(f"  gather_rows {what}: {(v + e) * d * b / row['ms'] / 1e6:.1f}"
              f" GB/s by the TPU probe's count (V + E) D b, "
              f"{(e * d * b + 4 * e) / row['ms'] / 1e6:.1f} GB/s of rows "
              f"written and ids read (the {v * d * b / 1e6:.1f} MB table "
              f"stays in the 50 MB L2)", flush=True)
        if dt == torch.float32:
            rows["gather_rows"] = dict(max_abs_err=err, **row)
    for n in bw.MATMUL_SIZES:
        a, bm = f32(rng.standard_normal((n, n))), f32(
            rng.standard_normal((n, n)))
        for dt, peak in ((torch.float32, peaks.f32_tflops),
                         (torch.bfloat16, peaks.bf16_tflops)):
            aa, bb = a.to(dt), bm.to(dt)
            ms = device_ms(time_ms(lambda: aa @ bb))
            tflops = 2 * n ** 3 / ms / 1e9
            print(f"  matmul {str(dt).replace('torch.', '')} {n}x{n}"
                  f"{' (TF32 off)' if dt == torch.float32 else ''}: "
                  f"{ms:.4f} ms, {tflops:.2f} TFLOP/s of {peak:g} "
                  f"({tflops / peak:.1%} of the data sheet's peak)",
                  flush=True)

    # the SpMM ablation: the probe's cases (the TPU probe's constants, then
    # D = 66 in bf16 and f32) on its layered graph, with its inputs; then
    # the fullevent graph's recv plan
    s, r = layered_graph(v, e)
    layered = spmm.build_edge_plan(r, s, v).to(dev)
    cases = []
    for width, dt in spmm_ablate.CASES:
        rng = np.random.default_rng(0)
        h_probe = f32(rng.standard_normal((v, width))).to(dt)
        cases.append(("probe", layered, h_probe,
                      f32(rng.standard_normal((e,)))))
    gen = torch.Generator().manual_seed(77)
    w_full = torch.rand(N_EDGE, generator=gen).to(dev) * g_full.edge_mask
    h_full = torch.randn(N_NODE, HIDDEN + INPUT_DIM, generator=gen).to(dev)
    cases += [("fullevent", g_full.plans.recv, h_full.to(dt), w_full)
              for dt in (torch.float32, torch.bfloat16)]
    for label, plan, h, w in cases:
        dt = h.dtype
        n_node, width = h.shape
        what = (f"{str(dt).replace('torch.', '')} {label} (V={n_node}, "
                f"E={plan.n_edge}, D={width})")
        padded = probes.pad_rows(h)
        runs = {m: (lambda m=m: probes.ablate_rows(h, w, plan, m))
                for m in probes.ABLATION_MODES if m != "aligned"}
        runs["aligned"] = lambda: probes.ablate_rows(padded, w, plan,
                                                     "aligned", width=width)
        got = {m: launched_twice("ablate_rows", f"{m} {what}", run)
               for m, run in runs.items()}
        exact(f"ablate_rows full vs spmm_raw {what}", got["full"],
              spmm.spmm_raw(h, w, plan))
        exact(f"ablate_rows aligned vs full {what}", got["aligned"],
              got["full"])
        times = {}
        for mode, run in runs.items():
            plain = (lambda m=mode: probes.ablate_rows_reference(
                h, w, plan, "full" if m == "aligned" else m))
            ref = plain()
            kdt = torch.float32 if mode == "ids_only" else dt
            rtol, atol = KERNEL_TOL[kdt]
            if mode in ("no_scatter", "compute", "ids_only"):
                atol = PARAM_SUM_ATOL[kdt] * ref.abs().max().item()
            err = compare(f"ablate_rows {mode} {what}", got[mode], ref, rtol,
                          atol)
            lib = None
            if mode == "full":
                csr = torch.sparse_csr_tensor(
                    plan.seg_ptr.long(), plan.sorted_oth.long(),
                    spmm.sort_edge_weights(w, plan).to(dt),
                    size=(n_node, n_node), device=dev)
                lib = lambda csr=csr: torch.sparse.mm(csr, h)
            row = measure(f"ablate_rows {mode}", what, run, plain,
                          f"ablate_{mode}", dt,
                          (n_node, plan.n_edge, width, width), lib=lib)
            times[mode] = row["ms"]
            if mode == "full" and label == "fullevent" and \
                    dt == torch.bfloat16:
                rows["ablate_rows"] = dict(max_abs_err=err, **row)
        print(f"  ablate_rows {what}: full {times['full']:.4f} ms; without "
              f"the gather {times['no_gather']:.4f}, without the scatter "
              f"{times['no_scatter']:.4f}, neither {times['compute']:.4f}, "
              f"ids alone {times['ids_only']:.4f}, 16-byte pitch "
              f"{times['aligned']:.4f}", flush=True)

    # the iteration backward: stashed scores (production) against the
    # recompute variant
    shapes = []
    for n_node, n_edge, dd, hd in iter_probe.SHAPES["probe"]:
        rng = np.random.default_rng(0)
        s, r = layered_graph(n_node, n_edge)
        tabs = {k: f32(rng.standard_normal(shape)) for k, shape in (
            ("h", (n_node, dd)), ("pa", (n_node, hd)), ("pb", (n_node, hd)),
            ("w2", (hd,)), ("b1", (hd,)), ("b2", (1,)))}
        rng = np.random.default_rng(1)
        tabs.update(g_mi=f32(rng.standard_normal((n_node, dd))),
                    g_mo=f32(rng.standard_normal((n_node, dd))))
        plans = spmm.build_agg_plans(s, r, n_node).to(dev)
        shapes.append((f"probe (V={n_node}, E={n_edge}, D={dd}, H={hd})",
                       plans, torch.ones(n_edge, device=dev), tabs))
    gen = torch.Generator().manual_seed(1234)
    rnd = lambda *shape: torch.randn(*shape, generator=gen).to(dev)
    dd = HIDDEN + INPUT_DIM
    shapes.append((f"fullevent (V={N_NODE}, E={N_EDGE}, D={dd}, H={HIDDEN})",
                   g_full.plans, g_full.edge_mask, dict(
                       pa=rnd(N_NODE, HIDDEN), pb=rnd(N_NODE, HIDDEN),
                       h=rnd(N_NODE, dd), w2=rnd(HIDDEN) * 0.25,
                       b1=rnd(HIDDEN), b2=rnd(1), g_mi=rnd(N_NODE, dd),
                       g_mo=rnd(N_NODE, dd))))
    sides = ("dh", "dpa", "dpb", "dw2", "db1", "db2")
    for label, plans, em, tabs32 in shapes:
        # On the TPU probe's inputs (w2 ~ N(0, 1) over H = 128: logits of
        # ~10, scores within 2^-14 of 1) 1 - sig keeps only the bits of a
        # score rounded to f32, so each edge's dlogit errs by up to |de
        # em| 2^-24 whatever its size (the kernels' and the plain
        # version's scores round differently), and a node's rows of dh,
        # dpa and dpb err in proportion to its edges' terms, not to the
        # result: the tables there take PARAM_SUM_ATOL's atol, as the
        # parameter sums do everywhere.
        saturated = label.startswith("probe")
        recv = plans.recv
        ems = spmm.sort_edge_weights(em, recv)
        for dt in (torch.float32, torch.bfloat16):
            t = {k: x.to(dt) for k, x in tabs32.items()}
            what = f"{str(dt).replace('torch.', '')} {label}"
            ip = (t["pa"], t["pb"], t["h"], ems, t["w2"], t["b1"], t["b2"])
            grads = (t["g_mi"], t["g_mo"])
            ids = (recv.sorted_oth, recv.sorted_seg, recv.n_node)
            sig = spmm.iteration_pair_fwd(*ip, plans)[2]
            stashed = lambda: spmm.iteration_pair_bwd(*ip, *grads, plans,
                                                      sig)
            recompute = lambda: probes.iteration_pair_bwd_recompute(
                *ip, *grads, plans)
            got = launched_twice("iteration_pair_bwd_recompute", what,
                                 recompute)
            prod = stashed()
            plain = lambda: spmm.iteration_pair_bwd_reference(*ip, *grads,
                                                              *ids)
            stash_plain = spmm.iteration_pair_bwd_stashed_reference(
                *ip[:6], sig, *grads, *ids)
            err, gap = 0.0, 0.0
            for side, a, b, p, q in zip(sides, got, plain(), prod,
                                        stash_plain):
                rtol, atol = KERNEL_TOL[dt]
                if side in ("dw2", "db1", "db2") or saturated:
                    atol = PARAM_SUM_ATOL[dt] * b.abs().max().item()
                err = max(err, compare(
                    f"iteration_pair_bwd_recompute {what} {side}", a, b,
                    rtol, atol))
                gap = max(gap, compare(
                    f"recompute vs stashed (production) {what} {side}", a,
                    p, rtol, atol))
                compare(f"stashed (production) vs its plain version {what} "
                        f"{side}", p, q, rtol, atol)
            print(f"  iteration_pair_bwd {what}: largest gap between the "
                  f"recompute variant and the stashed scores {gap:.3e}",
                  flush=True)
            shape = (recv.n_node, recv.n_edge, t["h"].shape[1],
                     t["pa"].shape[1])
            ts1, tr1, tr2, ts2 = (time_ms(f) for f in (stashed, recompute,
                                                       recompute, stashed))
            ts, tr = device_ms(ts1, ts2), device_ms(tr1, tr2)
            bs, _ = bound_ms("iteration_pair_bwd_stashed", dt, *shape)
            br, by = bound_ms("iteration_pair_bwd_recompute", dt, *shape)
            print(f"  iteration_pair_bwd {what}: stashed scores {ts:.4f} ms "
                  f"({fmt_ms(ts1)}, {fmt_ms(ts2)}; bound {bs:.4f}), "
                  f"recompute {tr:.4f} ms ({fmt_ms(tr1)}, {fmt_ms(tr2)}; "
                  f"bound {br:.4f}, {br / tr:.1%} of it): "
                  f"{(tr - ts) / tr:+.1%} saved by the stash", flush=True)
            if label.startswith("fullevent") and dt == torch.bfloat16:
                p1, p2 = time_ms(plain), time_ms(plain)
                rows["iteration_pair_bwd_recompute"] = dict(
                    max_abs_err=err, ms=tr, plain_ms=device_ms(p1, p2),
                    bound_ms=br, bound_by=by, library_ms=None,
                    timer="cuda_graph", library_timer=None, dtype="bfloat16",
                    shape=what, stashed_ms=ts)
    print(f"probes: phase done in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return rows


def without_pad_edges(g):
    """``g`` with its masked (pad) edges taken out, plans rebuilt."""
    from gnn_fpga_tpu_torch.core import graph as G

    keep = g.edge_mask > 0
    return G.attach_plans(g.replace(
        senders=g.senders[keep], receivers=g.receivers[keep], y=g.y[keep],
        edge_mask=g.edge_mask[keep], plans=None))


def phase_iteration(g_full) -> None:
    """The fused iteration's forward and backward kernels in bf16 on the
    fullevent graph and the hit graph, each with and without its pad
    edges (all on one pad node): against their plain versions, two
    launches bit for bit, and timed (kernel, kernel)."""
    from gnn_fpga_tpu_torch.ops.cuda import spmm

    dev = g_full.x.device
    gen = torch.Generator().manual_seed(99)
    rnd = lambda *shape: torch.randn(*shape, generator=gen).to(
        dev, torch.bfloat16)
    hdim = HIDDEN
    print("iteration kernels, bf16, with and without the pad edges:",
          flush=True)
    for label, g, d in (("fullevent", g_full, HIDDEN + INPUT_DIM),
                        ("hit", make_request(0, dev, hits=True),
                         NODE_HIDDEN + NODE_INPUT_DIM)):
        tabs = dict(pa=rnd(N_NODE, hdim), pb=rnd(N_NODE, hdim),
                    h=rnd(N_NODE, d), w2=rnd(hdim) * 0.25, b1=rnd(hdim),
                    b2=rnd(1), g_mi=rnd(N_NODE, d), g_mo=rnd(N_NODE, d))
        for pad, gg in (("pad", g), ("no pad", without_pad_edges(g))):
            recv = gg.plans.recv
            ems = spmm.sort_edge_weights(gg.edge_mask, recv)
            ip = tuple(tabs[k] for k in ("pa", "pb", "h")) + (ems,) + tuple(
                tabs[k] for k in ("w2", "b1", "b2"))
            grads = (tabs["g_mi"], tabs["g_mo"])
            ids = (recv.sorted_oth, recv.sorted_seg, N_NODE)
            sig = spmm.iteration_pair_fwd(*ip, gg.plans)[2]
            runs = {
                "iteration_pair": (
                    lambda: spmm.iteration_pair(*ip, gg.plans),
                    lambda: spmm.iteration_pair_reference(*ip, *ids),
                    ("mi", "mo")),
                "iteration_pair_bwd": (
                    lambda: spmm.iteration_pair_bwd(*ip, *grads, gg.plans,
                                                    sig),
                    lambda: spmm.iteration_pair_bwd_reference(*ip, *grads,
                                                              *ids),
                    ("dh", "dpa", "dpb", "dw2", "db1", "db2")),
            }
            what = f"{label} ({pad}, E={gg.n_edge}, D={d}, " \
                   f"{gg.plans.items.n_split} split nodes)"
            for name, (kern, plain, sides) in runs.items():
                first, again, ref = kern(), kern(), plain()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(first, again)):
                    fail(f"{name} {what}: two launches differ")
                rtol, atol = KERNEL_TOL[torch.bfloat16]
                for side, a, b in zip(sides, first, ref):
                    if side in ("dw2", "db1", "db2"):
                        atol = (PARAM_SUM_ATOL[torch.bfloat16]
                                * b.abs().max().item())
                    compare(f"{name} {what} {side}", a, b, rtol, atol)
                k1, k2 = time_ms(kern), time_ms(kern)
                print(f"  {name} {what}: kernel {device_ms(k1, k2):.4f} ms "
                      f"({fmt_ms(k1)}, {fmt_ms(k2)}); two launches bit for "
                      f"bit", flush=True)


def phase_rows(g_full) -> None:
    """The lane-group row kernels, gather_pair_bwd, sddmm, sddmm_dual,
    aggregate_pair, aggregate_pair_bwd and spmm, in f32 and bf16 on the
    fullevent graph with and without its pad edges (the pad node's
    160-edge segments, walked by blocks of their own): against their plain
    versions, two launches bit for bit, and timed; sddmm_dual on four
    distinct tables, so that no row it gathers was read as another table's
    (the kernels phase times it as the aggregation backward calls it, h
    as q and v); gather_pair_bwd's two halves, each timed alone by
    emptying the other direction's plan (whose rows are then written as
    zeros); and, timing only, aggregate_pair with its weights read in
    sorted order (each plan's order replaced by the identity, which a
    sorted copy of the weights would allow) beside the cost of making
    that copy (sort_edge_weights for both plans), aggregate_pair_bwd on
    the forward's row layout (spmm.AGG_BWD_LANE_ELEMS off), and the
    aggregation kernels, spmm and sddmm_dual at D = 64, whose rows are
    whole 16-byte items."""
    from gnn_fpga_tpu_torch.ops.cuda import spmm

    dev = g_full.x.device
    gen = torch.Generator().manual_seed(77)
    d, hdim = HIDDEN + INPUT_DIM, HIDDEN
    print("row kernels, with and without the pad edges:", flush=True)

    def emptied(plans, side):
        plan = getattr(plans, side)
        return dataclasses.replace(plans, **{side: dataclasses.replace(
            plan, seg_ptr=torch.zeros_like(plan.seg_ptr),
            long_seg=plan.long_seg[:0])})

    def in_sorted_order(plans):
        ident = lambda p: dataclasses.replace(
            p, order=torch.arange(p.n_edge, dtype=torch.int32,
                                  device=p.order.device))
        return dataclasses.replace(plans, recv=ident(plans.recv),
                                   send=ident(plans.send))

    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).replace("torch.", "")
        rnd = lambda *shape: torch.randn(*shape, generator=gen).to(dev, dt)
        a, b, u, z = (rnd(N_NODE, d) for _ in range(4))
        tol, f32_tol = KERNEL_TOL[dt], KERNEL_TOL[torch.float32]
        for pad, g in (("pad", g_full), ("no pad", without_pad_edges(g_full))):
            grad, plans = rnd(g.n_edge, hdim), g.plans
            w = torch.rand(g.n_edge, generator=gen).to(dev) * g.edge_mask
            s, r = g.senders, g.receivers
            gp_ref = lambda: spmm.gather_pair_bwd_reference(grad, s, r, N_NODE)
            # name -> (kernel, plain version, tolerance of each output)
            runs = {
                "gather_pair_bwd": (lambda: spmm.gather_pair_bwd(grad, plans),
                                    gp_ref, (tol, tol)),
                "sddmm": (lambda: (spmm.sddmm(a, b, plans.recv),),
                          lambda: (spmm.sddmm_reference(a, b, r, s),),
                          (f32_tol,)),
                "aggregate_pair": (
                    lambda: spmm.aggregate_pair(a, w, plans),
                    lambda: spmm.aggregate_pair_reference(a, w, s, r, N_NODE),
                    (tol, tol)),
                "aggregate_pair_bwd": (
                    lambda: spmm.aggregate_pair_bwd(a, w, b, u, plans),
                    lambda: spmm.aggregate_pair_bwd_reference(
                        a, w, b, u, s, r, N_NODE),
                    (tol, f32_tol)),
                "spmm": (lambda: (spmm.spmm_raw(a, w, plans.recv),),
                         lambda: (spmm.spmm_reference(a, w, r, s, N_NODE),),
                         (tol,)),
                "sddmm_dual": (
                    lambda: (spmm.sddmm_dual(a, b, u, z, plans.recv),),
                    lambda: (spmm.sddmm_dual_reference(a, b, u, z, r, s),),
                    (f32_tol,)),
            }
            if pad == "pad":
                recv_only, send_only = (emptied(plans, "send"),
                                        emptied(plans, "recv"))
                runs["gather_pair_bwd, recv half alone"] = (
                    lambda: spmm.gather_pair_bwd(grad, recv_only),
                    lambda: (torch.zeros_like(gp_ref()[0]), gp_ref()[1]),
                    (tol, tol))
                runs["gather_pair_bwd, send half alone"] = (
                    lambda: spmm.gather_pair_bwd(grad, send_only),
                    lambda: (gp_ref()[0], torch.zeros_like(gp_ref()[1])),
                    (tol, tol))
            what = (f"{tag} ({pad}, E={g.n_edge}, long segments "
                    f"{len(plans.recv.long_seg)} recv, "
                    f"{len(plans.send.long_seg)} send)")
            for name, (kern, plain, tols) in runs.items():
                first, again, ref = kern(), kern(), plain()
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(first, again)):
                    fail(f"{name} {what}: two launches differ")
                for x, y, t in zip(first, ref, tols):
                    compare(f"{name} {what}", x, y, *t)
                k1, k2 = time_ms(kern), time_ms(kern)
                print(f"  {name} {what}: kernel {device_ms(k1, k2):.4f} ms "
                      f"({fmt_ms(k1)}, {fmt_ms(k2)}); two launches bit for "
                      f"bit", flush=True)
            if pad == "pad":
                # timing only: weights read in sorted order give other sums
                sorted_plans = in_sorted_order(plans)
                a64, b64, u64, z64 = (t[:, :64].contiguous()
                                      for t in (a, b, u, z))

                def bwd_on_forward_layout():
                    kept = spmm.AGG_BWD_LANE_ELEMS
                    spmm.AGG_BWD_LANE_ELEMS = None
                    try:
                        return spmm.aggregate_pair_bwd(a, w, b, u, plans)
                    finally:
                        spmm.AGG_BWD_LANE_ELEMS = kept

                times = {
                    "aggregate_pair, weights read through the order":
                        lambda: spmm.aggregate_pair(a, w, plans),
                    "aggregate_pair, weights read in sorted order":
                        lambda: spmm.aggregate_pair(a, w, sorted_plans),
                    "the sorted copy (sort_edge_weights, both plans)":
                        lambda: (spmm.sort_edge_weights(w, plans.recv),
                                 spmm.sort_edge_weights(w, plans.send)),
                    "aggregate_pair_bwd on the forward's row layout":
                        bwd_on_forward_layout,
                    "aggregate_pair at D = 64":
                        lambda: spmm.aggregate_pair(a64, w, plans),
                    "aggregate_pair_bwd at D = 64":
                        lambda: spmm.aggregate_pair_bwd(a64, w, b64, u64,
                                                        plans),
                    "spmm at D = 64":
                        lambda: spmm.spmm_raw(a64, w, plans.recv),
                    "sddmm_dual at D = 64":
                        lambda: spmm.sddmm_dual(a64, b64, u64, z64,
                                                plans.recv),
                }
                time_in_turns(what, times)


def phase_stream(g_full) -> None:
    """The two kernels that stream a table through the card rather than
    walk segments, sorted_segment_sum and gather_pair, in f32 and bf16 on
    the fullevent graph with and without its pad edges: against their
    plain versions, two launches bit for bit (gather_pair also bit for bit
    against its plain version), one launch counted a call, and timed; the
    segment sum also on a 1,120-row hub (node 0 takes the ids of the first
    1,120 edges), at D = 64, under precision="default", and on a messages
    view one row into its table (in bf16 at D = 66 its base is 4-byte but
    not 16-byte aligned).  Timing only, where the tree has the tunable:
    the segment sum's tile at 64, 128 and 256 rows."""
    from gnn_fpga_tpu_torch.ops.cuda import segment_sum, spmm

    dev = g_full.x.device
    gen = torch.Generator().manual_seed(55)
    d, hdim = HIDDEN + INPUT_DIM, HIDDEN
    print("stream kernels, with and without the pad edges:", flush=True)

    def check(name, what, kern, plain, rtol_atol=None):
        n0 = spmm.launch_counts()[name]
        first, again = kern(), kern()
        ref = plain()
        torch.cuda.synchronize()
        n = spmm.launch_counts()[name] - n0
        if n != 2:
            fail(f"{name} {what}: {n} launches counted for 2 calls")
        if not torch.equal(first, again):
            fail(f"{name} {what}: two launches differ")
        if rtol_atol is None:
            exact(f"{name} {what}", first, ref)
        else:
            compare(f"{name} {what}", first, ref, *rtol_atol)
        k1, k2 = time_ms(kern), time_ms(kern)
        print(f"  {name} {what}: kernel {device_ms(k1, k2):.4f} ms "
              f"({fmt_ms(k1)}, {fmt_ms(k2)}); two launches bit for bit",
              flush=True)

    graphs = (("pad", g_full), ("no pad", without_pad_edges(g_full)))
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).replace("torch.", "")
        for pad, g in graphs:
            e = g.n_edge
            ids, seg = segment_ids(g, gen)
            hub = ids.clone()
            hub[:1120] = 0
            hub_seg = segment_sum.build_sorted_segments(hub, N_NODE).to(dev)
            m = torch.randn(e + 1, d, generator=gen).to(dev, dt)
            m_sorted = m[:e].index_select(0, seg.order.long())
            view = torch.empty_like(m)
            view[1:] = m_sorted
            n_kept = int(seg.ptr[-1])
            cases = {
                "": (m_sorted, seg, m[:e], ids, "highest"),
                ", 1,120-row hub": (m[:e].index_select(
                    0, hub_seg.order.long()), hub_seg, m[:e], hub, "highest"),
                ", precision=default": (m_sorted, seg, m[:e].bfloat16(), ids,
                                        "default"),
                ", view one row in": (view[1:], seg, m[:e], ids, "highest"),
            }
            for label, (msgs, sg, plain_m, plain_ids, prec) in cases.items():
                what = (f"{tag} ({pad}, E={e}, {n_kept} kept rows, "
                        f"D={d}{label})")
                ref = segment_sum.segment_sum_reference(plain_m, plain_ids,
                                                        N_NODE)
                rtol, atol = KERNEL_TOL[dt]
                if "hub" in label:  # 1,120-term sums: PARAM_SUM_ATOL's case
                    atol = PARAM_SUM_ATOL[dt] * ref.abs().max().item()
                check("sorted_segment_sum", what,
                      lambda: segment_sum.sorted_segment_sum(msgs, sg, N_NODE,
                                                             prec),
                      lambda: ref, (rtol, atol))
            bound, _ = bound_ms("sorted_segment_sum", dt, N_NODE, n_kept, d,
                                hdim)
            m64 = m_sorted[:, :64].contiguous()
            fns = {"D = 64": lambda: segment_sum.sorted_segment_sum(
                m64, seg, N_NODE)}
            if hasattr(segment_sum, "SEGSUM_TILE_ROWS"):
                def tile_of(rows):
                    def run():
                        kept = (segment_sum.SEGSUM_TILE_ROWS,
                                segment_sum.SEGSUM_TILE_BYTES)
                        segment_sum.SEGSUM_TILE_ROWS = rows
                        segment_sum.SEGSUM_TILE_BYTES = rows * d * 4
                        try:
                            return segment_sum.sorted_segment_sum(
                                m_sorted, seg, N_NODE)
                        finally:
                            (segment_sum.SEGSUM_TILE_ROWS,
                             segment_sum.SEGSUM_TILE_BYTES) = kept
                    return run
                fns.update({f"tile of {r} rows": tile_of(r)
                            for r in (64, 128, 256)})
            bound64, _ = bound_ms("sorted_segment_sum", dt, N_NODE, n_kept,
                                  64, hdim)
            print(f"  sorted_segment_sum {tag} ({pad}): bound {bound:.4f} ms "
                  f"at D = {d}, {bound64:.4f} at D = 64", flush=True)
            time_in_turns(f"sorted_segment_sum {tag} ({pad})", fns)

            pa, pb = (torch.randn(N_NODE, hdim, generator=gen).to(dev, dt)
                      for _ in range(2))
            s, r = g.senders, g.receivers
            what = f"{tag} ({pad}, E={e}, H={hdim})"
            check("gather_pair", what,
                  lambda: spmm.gather_pair_fwd(pa, pb, s, r),
                  lambda: spmm.gather_pair_reference(pa, pb, s, r))


def segment_ids(g, gen):
    """The packed graph's receivers with ~1% of the ids set to ``N_NODE``
    (padding, dropped by the segment sum), and their sorted segments."""
    from gnn_fpga_tpu_torch.ops.cuda import segment_sum

    ids = g.receivers.clone()
    drop = torch.rand(len(ids), generator=gen) < 0.01
    ids[drop.to(ids.device)] = N_NODE
    return ids, segment_sum.build_sorted_segments(ids, N_NODE).to(ids.device)


def spmm_vjp(fn, h, w, g_out, *args):
    """``(dh, dw)`` of ``fn(h, w, *args)`` against ``g_out``."""
    h = h.detach().requires_grad_()
    w = w.detach().requires_grad_()
    return torch.autograd.grad(fn(h, w, *args), (h, w), g_out)


def serve(m, g):
    """Probabilities of ``g`` (the sigmoid of the model's logits) and the
    request's ms (host clock, synchronised)."""
    t = time.perf_counter()
    p = torch.sigmoid(m(g))
    torch.cuda.synchronize()
    return p, (time.perf_counter() - t) * 1e3


def variant_of(model, device, **kw):
    """A model of ``model``'s class and config with ``kw`` replaced, and
    its weights."""
    m = type(model)(dataclasses.replace(model.cfg, **kw), torch.Generator(),
                    device=device)
    m.load_state_dict(model.state_dict())
    return m


def sparse_reference(model, device, dtype=None):
    """The plain sparse route in f32 that a route of ``model`` computing
    in ``dtype`` is held against, and the map of a graph to its inputs: for
    bf16, at the weights and inputs that route computes with (every
    parameter and the node features rounded to bf16)."""
    ref = variant_of(model, device, aggregation="sparse", compute_dtype=None)
    if dtype is None:
        return ref, lambda g: g
    with torch.no_grad():
        for p in ref.parameters():
            p.copy_(p.to(dtype).float())
    return ref, lambda g: g.replace(x=g.x.to(dtype).float())


def check_served(served, ref_served, n_out, what) -> None:
    """bf16 probabilities of a kernel route against those of its
    :func:`sparse_reference`."""
    worst_max = worst_mean = 0.0
    for i, ((p, _), (ps, _)) in enumerate(zip(served, ref_served)):
        if p.shape != (n_out,) or not torch.isfinite(p).all() \
                or p.min() < 0 or p.max() > 1:
            fail(f"{what} request {i}: probabilities malformed")
        diff = (p - ps).abs()
        worst_max = max(worst_max, diff.max().item())
        worst_mean = max(worst_mean, diff.mean().item())
    print(f"  bf16 probs, kernel route vs sparse route: "
          f"max|dp|={worst_max:.3e} (tol {BF16_PROB_MAX_ABS:g}) "
          f"worst mean|dp|={worst_mean:.3e} "
          f"(tol {BF16_PROB_MEAN_ABS:g})", flush=True)
    if worst_max > BF16_PROB_MAX_ABS or worst_mean > BF16_PROB_MEAN_ABS:
        fail(f"{what}: bf16 kernel route disagrees with the sparse route")


def phase_serving(device, graphs, profile_path=None) -> dict:
    from gnn_fpga_tpu_torch.models import mpnn
    from gnn_fpga_tpu_torch.ops.cuda import spmm

    cfg = mpnn.SegmentClassifierConfig(
        input_dim=INPUT_DIM, hidden_dim=HIDDEN, n_iters=N_ITERS,
        compute_dtype=torch.bfloat16, aggregation="pallas")
    model = mpnn.init_segment_classifier(
        cfg, torch.Generator().manual_seed(0), device=device)
    unfused = variant_of(model, device, fused_iteration=False)
    sparse, at = sparse_reference(model, device, torch.bfloat16)
    fused_f32 = variant_of(model, device, compute_dtype=None)

    print("serving:", flush=True)
    fused_call = captured_probs(model, device)
    unfused_call = captured_probs(unfused, device)
    with torch.inference_mode():
        serve(sparse, graphs[0])                 # warm-up, not counted
        for call in (fused_call, unfused_call):  # eager, then captured
            serve_captured(call, graphs[0])
        spmm.reset_launch_counts()
        # --- the main path: 8 requests on the fused route, 1 unfused,
        # each copied into its captured forward's buffers and replayed
        served = [serve_captured(fused_call, g) for g in graphs]
        unfused_probs, unfused_ms = serve_captured(unfused_call, graphs[0])
        launches = launch_counts()
        # --- checks against the plain sparse route (not counted)
        print(f"  launches: {launches}", flush=True)
        expect = expected_counts(iteration_pair=N_REQUESTS * N_ITERS,
                                 aggregate_pair=N_ITERS,
                                 gather_pair=N_REQUESTS + N_ITERS + 1)
        if launches != expect:
            fail(f"serving launched {launches}, expected {expect}")
        sparse_served = [serve(sparse, at(g)) for g in graphs]
        check_served(served + [(unfused_probs, unfused_ms)],
                     sparse_served + sparse_served[:1], N_EDGE, "serving")
        lf = mpnn.segment_classifier_logits(fused_f32, graphs[0])
        ls = mpnn.segment_classifier_logits(
            sparse_reference(model, device)[0], graphs[0])
        compare("f32 logits, kernel route vs sparse route", lf, ls,
                *F32_LOGIT_TOL)
        if profile_path:
            write_profile(profile_path, "w", "3 requests",
                          lambda: [mpnn.segment_classifier(model, g)
                                   for g in graphs[:3]])

    ms = [t for _, t in served]
    sparse_ms = [t for _, t in sparse_served]
    n_real = int(graphs[0].edge_mask.sum().item())
    mean_ms = sum(ms) / len(ms)
    print(f"  fused route, captured: {mean_ms:.3f} ms/request (min "
          f"{min(ms):.3f}, max {max(ms):.3f}), "
          f"{n_real / (mean_ms / 1e3):.4e} edges/s", flush=True)
    print(f"  unfused route, captured: {unfused_ms:.3f} ms/request",
          flush=True)
    print(f"  f32 sparse route: {sum(sparse_ms) / len(sparse_ms):.3f} "
          f"ms/request "
          f"(min {min(sparse_ms):.3f}, max {max(sparse_ms):.3f})", flush=True)
    return launches


def _grads(model, g, target, pos_weight):
    from gnn_fpga_tpu_torch.train.trainer import masked_bce_with_logits

    y, mask = (g.node_y, g.node_mask) if target == "node" else (g.y,
                                                                g.edge_mask)
    model.zero_grad(set_to_none=True)
    masked_bce_with_logits(model(g), y, mask, pos_weight).backward()
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def grad_reading(got, want, dtype) -> tuple:
    """How far gradients ``got`` lie from ``want``, and the parameter that
    errs most: f32, the largest |err| / (atol + rtol |ref|) of any element
    (at most 1 within F32_GRAD_TOL); bf16, ||err|| / ||ref|| over all
    parameters at once, and the parameter with the largest ||err||."""
    if dtype is None:
        rtol, atol = F32_GRAD_TOL
        read = {n: ((got[n] - w).abs() / (atol + rtol * w.abs())).max().item()
                for n, w in want.items()}
        name = max(read, key=read.get)
        return read[name], name
    err = {n: (got[n] - w).norm().item() for n, w in want.items()}
    ref = sum(w.norm().item() ** 2 for w in want.values()) ** 0.5
    return sum(e * e for e in err.values()) ** 0.5 / ref, max(err, key=err.get)


def check_gradients(model, graphs, device, routes, target="edge",
                    pos_weight=POS_WEIGHT) -> dict:
    """Parameter gradients of the masked BCE on each of ``routes`` (label
    -> config changes of ``model``), in f32 and in bf16, against those of
    the :func:`sparse_reference` on every graph of ``graphs``: f32 within
    F32_GRAD_TOL elementwise, bf16 within BF16_GRAD_REL.  Prints each
    route's reading per graph; returns them."""
    refs = {dtype: sparse_reference(model, device, dtype)
            for dtype in (None, torch.bfloat16)}
    runs = {(route, dtype): variant_of(model, device, compute_dtype=dtype,
                                       **kw)
            for dtype in refs for route, kw in routes.items()}
    readings = {key: [] for key in runs}  # per graph: (reading, parameter)
    for g in graphs:
        want = {dtype: _grads(ref, at(g), target, pos_weight)
                for dtype, (ref, at) in refs.items()}
        for (route, dtype), m in runs.items():
            got = _grads(m, g, target, pos_weight)
            if not all(torch.isfinite(t).all() for t in got.values()):
                fail(f"{route} gradients are not finite")
            readings[(route, dtype)].append(
                grad_reading(got, want[dtype], dtype))
    ok = True
    for (route, dtype), per_graph in readings.items():
        value, name = max(per_graph)
        bound = BF16_GRAD_REL if dtype else 1.0
        what = ("bf16 grads, ||err|| / ||ref|| of all parameters" if dtype
                else "f32 grads, max |err| / (atol + rtol |ref|)")
        print(f"  {what}, {route} vs sparse, per graph: "
              f"{' '.join(f'{v:.3e}' for v, _ in per_graph)}; worst "
              f"{value:.3e} (graph {per_graph.index((value, name))}, most "
              f"from {name}; tol {bound:g}) "
              f"{'ok' if value <= bound else 'FAIL'}", flush=True)
        ok = ok and value <= bound
    if not ok:
        fail("kernel-route gradients disagree with the sparse route")
    return readings


def phase_training(device, graphs, profile_path=None) -> dict:
    from gnn_fpga_tpu_torch.models import mpnn
    from gnn_fpga_tpu_torch.ops.cuda import spmm
    from gnn_fpga_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = mpnn.SegmentClassifierConfig(
        input_dim=INPUT_DIM, hidden_dim=HIDDEN, n_iters=N_ITERS,
        compute_dtype=torch.bfloat16, aggregation="pallas")
    model = mpnn.init_segment_classifier(
        cfg, torch.Generator().manual_seed(1), device=device)
    tcfg = TrainConfig(learning_rate=LEARNING_RATE, pos_weight=POS_WEIGHT)
    print(f"training: gradients on the {len(graphs)} graphs", flush=True)
    check_gradients(model, graphs, device,
                    {"fused": dict(fused_iteration=True),
                     "unfused": dict(fused_iteration=False)})

    trainer = Trainer(model, tcfg)
    unfused = Trainer(variant_of(model, device, fused_iteration=False), tcfg)
    for kw in ({}, dict(fused_iteration=False)):                # warm-up
        Trainer(variant_of(model, device, **kw), tcfg).run_steps(graphs[:1])
    spmm.reset_launch_counts()
    # --- the main path: 32 fused steps over the 8 graphs, 8 unfused steps
    losses, step_ms = [], []
    for i in range(N_STEPS):
        t = time.perf_counter()
        losses.append(float(trainer.run_steps([graphs[i % N_REQUESTS]])[0]))
        step_ms.append((time.perf_counter() - t) * 1e3)
    fused_counts = launch_counts()
    unfused_losses, unfused_ms = [], []
    for i in range(N_UNFUSED_STEPS):
        t = time.perf_counter()
        unfused_losses.append(
            float(unfused.run_steps([graphs[i % N_REQUESTS]])[0]))
        unfused_ms.append((time.perf_counter() - t) * 1e3)
    launches = launch_counts()
    # --- checks (not counted)
    unfused_counts = {k: (launches[k] - fused_counts[k]) / N_UNFUSED_STEPS
                      for k in launches}
    per_step = {k: v / N_STEPS for k, v in fused_counts.items()}
    print(f"  launches per fused step: {per_step}", flush=True)
    print(f"  launches per unfused step: {unfused_counts}", flush=True)
    expect_fused = fused_step_counts()
    expect_unfused = expected_counts(gather_pair=N_ITERS + 1,
                                     gather_pair_bwd=N_ITERS + 1,
                                     aggregate_pair=N_ITERS,
                                     aggregate_pair_bwd=N_ITERS)
    if per_step != expect_fused:
        fail(f"fused steps launched {per_step} a step, "
             f"expected {expect_fused}")
    if unfused_counts != expect_unfused:
        fail(f"the unfused steps launched {unfused_counts} a step, "
             f"expected {expect_unfused}")
    first, last = sum(losses[:8]) / 8, sum(losses[-8:]) / 8
    print(f"  losses: {' '.join(f'{x:.4f}' for x in losses)}", flush=True)
    print(f"  mean loss, first 8 steps {first:.4f}, last 8 steps "
          f"{last:.4f}; unfused steps "
          f"{' '.join(f'{x:.4f}' for x in unfused_losses)}", flush=True)
    if not torch.isfinite(torch.tensor(losses + unfused_losses)).all():
        fail("a training loss is not finite")
    if not last < first:
        fail("the training loss did not fall over 32 steps")
    if len(trainer._captured) != 1 or len(unfused._captured) != 1:
        fail("the packed graphs' steps took more than one capture")
    n_real = int(graphs[0].edge_mask.sum().item())
    mean_ms = sum(step_ms[1:]) / (N_STEPS - 1)
    print(f"  fused bf16 train step: {step_times(step_ms)}; synchronised "
          f"by the loss readback, {n_real / (mean_ms / 1e3):.4e} edges/s",
          flush=True)
    _, fused_busy = profiled(lambda: one_step_calls(trainer, graphs[:3]))
    print(f"  [{card()}] fused bf16 train step, replayed: device time "
          f"{fused_busy / 3:.3f} ms (torch.profiler over 3 replays; before: "
          f"{BEFORE['device']})", flush=True)
    wall, busy = profiled(lambda: one_step_calls(unfused, graphs[:3]),
                          profile_path and (profile_path,
                                            "3 unfused training steps"))
    print(f"  unfused bf16 train step: {step_times(unfused_ms)}; device "
          f"time {busy / 3:.3f} ms/step (torch.profiler over 3 more "
          f"replays; wall {wall / 3:.3f} ms/step with the profiler on)",
          flush=True)
    if profile_path:
        write_profile(profile_path, "a", "3 training steps",
                      lambda: one_step_calls(trainer, graphs[:3]))
    return launches


def phase_ops(g) -> dict:
    """The single-direction op API on the packed graph in bf16: the main
    path of the spmm, sddmm, sddmm_dual and sorted_segment_sum kernels,
    forward and backward."""
    from gnn_fpga_tpu_torch.ops.cuda import segment_sum, spmm

    dev = g.x.device
    gen = torch.Generator().manual_seed(4321)
    d = HIDDEN + INPUT_DIM
    rnd = lambda *shape: torch.randn(*shape, generator=gen).to(
        dev, torch.bfloat16)
    h, g_mi, g_mo, msgs = (rnd(N_NODE, d), rnd(N_NODE, d), rnd(N_NODE, d),
                           rnd(N_EDGE, d))
    w = torch.rand(N_EDGE, generator=gen).to(dev) * g.edge_mask
    ids, seg = segment_ids(g, gen)
    plans = g.plans
    print("ops: spmm (+ backward), sddmm, sddmm_dual, sorted_segment_sum "
          "(+ backward), bf16", flush=True)
    spmm.reset_launch_counts()
    # --- the main path of the four kernels
    hq = h.clone().requires_grad_()
    wq = w.clone().requires_grad_()
    mi = spmm.spmm(hq, wq, plans.recv, plans.send)
    mi.backward(g_mi)
    e = spmm.sddmm(g_mi, h, plans.recv)
    dw = spmm.sddmm_dual(g_mi, h, g_mo, h, plans.recv)
    mq = msgs.index_select(0, seg.order.long()).requires_grad_()
    agg = segment_sum.sorted_segment_sum(mq, seg, N_NODE)
    agg.backward(g_mi)
    torch.cuda.synchronize()
    launches = launch_counts()
    # --- checks (not counted)
    print(f"  launches: {launches}", flush=True)
    expect = expected_counts(spmm=2, sddmm=2, sddmm_dual=1,
                             sorted_segment_sum=1)
    if launches != expect:
        fail(f"the op API launched {launches}, expected {expect}")
    for name, t, shape in (("spmm", mi, (N_NODE, d)),
                           ("spmm dh", hq.grad, (N_NODE, d)),
                           ("spmm dw", wq.grad, (N_EDGE,)),
                           ("sddmm", e, (N_EDGE,)),
                           ("sddmm_dual", dw, (N_EDGE,)),
                           ("sorted_segment_sum", agg, (N_NODE, d)),
                           ("sorted_segment_sum grad", mq.grad, (N_EDGE, d))):
        if tuple(t.shape) != shape or not torch.isfinite(t).all():
            fail(f"{name}: malformed output")
    r, s = g.receivers, g.senders
    bf16, f32 = KERNEL_TOL[torch.bfloat16], KERNEL_TOL[torch.float32]
    compare("ops spmm", mi, spmm.spmm_reference(h, w, r, s, N_NODE), *bf16)
    dh_ref, dw_ref = spmm_vjp(spmm.spmm_reference, h.float(), w,
                              g_mi.float(), r, s, N_NODE)
    compare("ops spmm dh", hq.grad, dh_ref, *bf16)
    compare("ops spmm dw", wq.grad, dw_ref, *f32)
    compare("ops sddmm", e, spmm.sddmm_reference(g_mi, h, r, s), *f32)
    _, agg_dw = spmm.aggregate_pair_bwd_reference(h, w, g_mi, g_mo, s, r,
                                                  N_NODE)
    compare("ops sddmm_dual vs the aggregation backward's dw", dw, agg_dw,
            *f32)
    compare("ops sorted_segment_sum", agg,
            segment_sum.segment_sum_reference(msgs, ids, N_NODE), *bf16)
    g_pad = torch.cat([g_mi, g_mi.new_zeros((1, d))])
    if not torch.equal(mq.grad, g_pad.index_select(0, seg.sorted_ids.long())):
        fail("sorted_segment_sum's gradient is not the gather of g")
    return launches


def make_sector_batch(seed: int, device):
    """bench.py's fullevent "blocked b36" batch: 36 Toy2D kNN sectors of
    seed ``seed`` as one batched graph, edges permuted into blocks of
    ``GROUP`` layer pairs with ``BLOCK_E`` edge slots."""
    from gnn_fpga_tpu_torch.data import toy2d
    from gnn_fpga_tpu_torch.ops import blocked

    cfg = toy2d.Toy2DConfig(n_layers=N_LAYERS, n_tracks=N_TRACKS, seed=seed)
    gs = toy2d.make_knn_segment_graphs(cfg, N_SECTORS, k=K_NN)
    return blocked.attach_blocks_layered(gs, toy2d.layer_offsets(cfg),
                                         group=GROUP,
                                         block_e=BLOCK_E).to(device)


def phase_blocked(device, profile_path=None) -> dict:
    """The blocked route at full width on the 36-sector batches, checked
    against the sparse and dense routes, then trained."""
    from gnn_fpga_tpu_torch.models import mpnn
    from gnn_fpga_tpu_torch.ops.cuda import spmm
    from gnn_fpga_tpu_torch.train.trainer import TrainConfig, Trainer

    t0 = time.perf_counter()
    batches = [make_sector_batch(seed, device) for seed in range(N_REQUESTS)]
    plan = batches[0].blocks
    n_real = int(batches[0].edge_mask.sum().item())
    print(f"blocked: {N_REQUESTS} batches of {N_SECTORS} sectors built in "
          f"{time.perf_counter() - t0:.2f} s; x {tuple(batches[0].x.shape)}, "
          f"edges {tuple(batches[0].senders.shape)} ({n_real} real), "
          f"blocks {plan.n_blocks} x {plan.block_e} edges x "
          f"{plan.block_n} nodes", flush=True)
    if n_real != N_REAL_EDGE or plan.n_blocks != 5 or plan.block_n != 112:
        fail("the blocked batch does not have bench.py's b36 shape")
    cfg = mpnn.SegmentClassifierConfig(
        input_dim=INPUT_DIM, hidden_dim=HIDDEN, n_iters=N_ITERS,
        compute_dtype=torch.bfloat16, aggregation="blocked")
    model = mpnn.init_segment_classifier(
        cfg, torch.Generator().manual_seed(2), device=device)
    dense = variant_of(model, device, aggregation="dense")
    sparse, at = sparse_reference(model, device, torch.bfloat16)
    unblocked = [b.replace(blocks=None) for b in batches]
    spmm.reset_launch_counts()
    with torch.inference_mode():
        serve(model, batches[0])                 # warm-up, not counted
        serve(dense, unblocked[0])
        # --- serving: 8 batches on the blocked route, then the same
        # batches without blocks on the dense route
        served = [serve(model, b) for b in batches]
        dense_ms = [serve(dense, b)[1] for b in unblocked]
        # --- checks against the sparse route, sector by sector
        worst_max = worst_mean = 0.0
        for i, ((p, _), b) in enumerate(zip(served, unblocked)):
            if p.shape != b.senders.shape or not torch.isfinite(p).all() \
                    or p.min() < 0 or p.max() > 1:
                fail(f"batch {i}: probabilities malformed")
            real = b.edge_mask > 0
            diff = (p - serve(sparse, at(b))[0])[real].abs()
            worst_max = max(worst_max, diff.max().item())
            worst_mean = max(worst_mean, diff.mean().item())
        print(f"  bf16 probs, blocked route vs sparse route (real edges): "
              f"max|dp|={worst_max:.3e} (tol {BF16_PROB_MAX_ABS:g}) "
              f"worst mean|dp|={worst_mean:.3e} "
              f"(tol {BF16_PROB_MEAN_ABS:g})", flush=True)
        if worst_max > BF16_PROB_MAX_ABS or worst_mean > BF16_PROB_MEAN_ABS:
            fail("bf16 blocked route disagrees with the sparse route")
        real = batches[0].edge_mask > 0
        f32 = {route: mpnn.segment_classifier_logits(
                   variant_of(model, device, aggregation=route,
                              compute_dtype=None), batch)[real]
               for route, batch in (("blocked", batches[0]),
                                    ("sparse", unblocked[0]),
                                    ("dense", unblocked[0]))}
        compare("f32 logits, blocked route vs sparse route (real edges)",
                f32["blocked"], f32["sparse"], *F32_LOGIT_TOL)
        compare("f32 logits, dense route vs blocked route (real edges)",
                f32["dense"], f32["blocked"], *F32_LOGIT_TOL)
    ms = [t for _, t in served]
    mean_ms = sum(ms) / len(ms)
    print(f"  blocked route: {mean_ms:.3f} ms/batch (min {min(ms):.3f}, "
          f"max {max(ms):.3f}), {N_REAL_EDGE / (mean_ms / 1e3):.4e} "
          f"edges/s; dense route: {sum(dense_ms) / len(dense_ms):.3f} "
          f"ms/batch", flush=True)

    print(f"  gradients on the {len(batches)} batches", flush=True)
    check_gradients(model, batches, device,
                    {"blocked": {}, "dense": dict(aggregation="dense")})
    tcfg = TrainConfig(learning_rate=LEARNING_RATE, pos_weight=POS_WEIGHT)
    trainer = Trainer(model, tcfg)
    Trainer(variant_of(model, device), tcfg).run_steps(batches[:1])  # warm-up
    losses, step_ms = [], []
    for i in range(N_STEPS):
        t = time.perf_counter()
        losses.append(float(trainer.run_steps([batches[i % N_REQUESTS]])[0]))
        step_ms.append((time.perf_counter() - t) * 1e3)
    first, last = sum(losses[:8]) / 8, sum(losses[-8:]) / 8
    print(f"  losses: {' '.join(f'{x:.4f}' for x in losses)}", flush=True)
    print(f"  mean loss, first 8 steps {first:.4f}, last 8 steps {last:.4f}",
          flush=True)
    if not torch.isfinite(torch.tensor(losses)).all():
        fail("a blocked training loss is not finite")
    if not last < first:
        fail("the blocked training loss did not fall over 32 steps")
    mean_ms = sum(step_ms[1:]) / (N_STEPS - 1)
    print(f"  blocked bf16 train step: {step_times(step_ms)}; "
          f"{len(trainer._captured)} batch signatures captured; "
          f"synchronised by the loss readback, "
          f"{N_REAL_EDGE / (mean_ms / 1e3):.4e} real edges/s", flush=True)
    if profile_path:
        write_profile(profile_path, "a", "1 blocked training step",
                      lambda: trainer.run_steps(batches[:1]))
    launches = launch_counts()
    print(f"  launches on the blocked and dense routes: {launches}",
          flush=True)
    if launches != expected_counts():
        fail("the blocked or dense route launched a hand-written kernel")
    return launches


def phase_unshared(device, graphs, profile_path=None) -> dict:
    """SegmentClassifierUnshared at the fullevent width on the packed
    graphs: 8 requests on the fused route, checked against its sparse
    route, and its gradients."""
    from gnn_fpga_tpu_torch.models import mpnn
    from gnn_fpga_tpu_torch.ops.cuda import spmm

    cfg = mpnn.SegmentClassifierConfig(
        input_dim=INPUT_DIM, hidden_dim=HIDDEN, n_iters=N_ITERS,
        compute_dtype=torch.bfloat16, aggregation="pallas")
    model = mpnn.init_segment_classifier_unshared(
        cfg, torch.Generator().manual_seed(3), device=device)
    sparse, at = sparse_reference(model, device, torch.bfloat16)
    print(f"unshared: SegmentClassifierUnshared, "
          f"{mpnn.count_params(model)} parameters", flush=True)
    call = captured_probs(model, device)
    with torch.inference_mode():
        serve_captured(call, graphs[0])          # eager, then captured
        serve(sparse, at(graphs[0]))
        spmm.reset_launch_counts()
        # --- the main path: 8 requests on the fused route, replayed
        served = [serve_captured(call, g) for g in graphs]
        launches = launch_counts()
        # --- checks against the plain sparse route (not counted)
        print(f"  launches: {launches}", flush=True)
        expect = expected_counts(iteration_pair=N_REQUESTS * N_ITERS,
                                 gather_pair=N_REQUESTS)
        if launches != expect:
            fail(f"the unshared head launched {launches}, expected {expect}")
        sparse_served = [serve(sparse, at(g)) for g in graphs]
        check_served(served, sparse_served, N_EDGE, "unshared")
        compare("f32 logits, kernel route vs sparse route",
                variant_of(model, device, compute_dtype=None)(graphs[0]),
                sparse_reference(model, device)[0](graphs[0]),
                *F32_LOGIT_TOL)
        if profile_path:
            write_profile(profile_path, "a", "3 unshared requests",
                          lambda: [model(g) for g in graphs[:3]])
    ms = [t for _, t in served]
    mean_ms = sum(ms) / len(ms)
    n_real = int(graphs[0].edge_mask.sum().item())
    print(f"  fused route: {mean_ms:.3f} ms/request (min {min(ms):.3f}, "
          f"max {max(ms):.3f}), {n_real / (mean_ms / 1e3):.4e} edges/s; "
          f"f32 sparse route "
          f"{sum(t for _, t in sparse_served) / N_REQUESTS:.3f}"
          f" ms/request", flush=True)
    print(f"  gradients on the {len(graphs)} graphs", flush=True)
    check_gradients(model, graphs, device, {"fused": {}})
    return launches


def phase_node(device, profile_path=None) -> dict:
    """The NodeClassifier at the hit classifier's width on 8 packed
    hit graphs: node logits and gradients against its sparse route, 32
    Adam steps with target="node" on the fused route, one unfused step."""
    from gnn_fpga_tpu_torch.models import mpnn
    from gnn_fpga_tpu_torch.ops.cuda import spmm
    from gnn_fpga_tpu_torch.train.trainer import TrainConfig, Trainer

    t0 = time.perf_counter()
    graphs = pad_to_covering([make_request(seed, device, hits=True)
                              for seed in range(N_REQUESTS)])
    g0 = graphs[0]
    n_real = int(g0.edge_mask.sum().item())
    print(f"node: {N_REQUESTS} packed hit graphs built in "
          f"{time.perf_counter() - t0:.2f} s; V={g0.n_node} "
          f"({int(g0.node_mask.sum().item())} real, "
          f"{int(g0.node_y.sum().item())} on track 0), E={g0.n_edge} "
          f"({n_real} real)", flush=True)
    if n_real != NODE_N_REAL_EDGE or g0.n_node != N_NODE:
        fail("the hit graph does not have the expected shape")
    cfg = mpnn.NodeClassifierConfig(
        input_dim=NODE_INPUT_DIM, hidden_dim=NODE_HIDDEN, n_iters=NODE_ITERS,
        compute_dtype=torch.bfloat16, aggregation="pallas")
    model = mpnn.init_node_classifier(
        cfg, torch.Generator().manual_seed(4), device=device)
    print(f"  NodeClassifier, {mpnn.count_params(model)} parameters",
          flush=True)
    with torch.inference_mode():
        sparse, at = sparse_reference(model, device, torch.bfloat16)
        served = [serve(model, g) for g in graphs]
        sparse_served = [serve(sparse, at(g)) for g in graphs]
        check_served(served, sparse_served, N_NODE, "node")
        compare("f32 node logits, kernel route vs sparse route",
                variant_of(model, device, compute_dtype=None)(g0),
                sparse_reference(model, device)[0](g0), *F32_LOGIT_TOL)
    print(f"  gradients on the {len(graphs)} graphs", flush=True)
    check_gradients(model, graphs, device,
                    {"fused": dict(fused_iteration=True),
                     "unfused": dict(fused_iteration=False)},
                    target="node", pos_weight=NODE_POS_WEIGHT)

    tcfg = TrainConfig(learning_rate=LEARNING_RATE, target="node",
                       pos_weight=NODE_POS_WEIGHT)
    trainer = Trainer(model, tcfg)
    unfused = Trainer(variant_of(model, device, fused_iteration=False), tcfg)
    Trainer(variant_of(model, device), tcfg).run_steps(graphs[:1])  # warm-up
    spmm.reset_launch_counts()
    # --- the main path: 32 fused steps over the 8 graphs, 1 unfused step
    losses, step_ms = [], []
    for i in range(N_STEPS):
        t = time.perf_counter()
        losses.append(float(trainer.run_steps([graphs[i % N_REQUESTS]])[0]))
        step_ms.append((time.perf_counter() - t) * 1e3)
    fused_counts = launch_counts()
    t = time.perf_counter()
    unfused_loss = float(unfused.run_steps(graphs[:1])[0])
    unfused_ms = (time.perf_counter() - t) * 1e3
    launches = launch_counts()
    # --- checks (not counted)
    unfused_counts = {k: launches[k] - fused_counts[k] for k in launches}
    per_step = {k: v / N_STEPS for k, v in fused_counts.items()}
    print(f"  launches per fused step: {per_step}", flush=True)
    print(f"  launches in the unfused step: {unfused_counts}", flush=True)
    expect_fused = expected_counts(iteration_pair=NODE_ITERS,
                                   iteration_pair_bwd=NODE_ITERS)
    expect_unfused = expected_counts(
        gather_pair=NODE_ITERS, aggregate_pair=NODE_ITERS,
        gather_pair_bwd=NODE_ITERS, aggregate_pair_bwd=NODE_ITERS)
    if per_step != expect_fused:
        fail(f"node steps launched {per_step} a step, expected "
             f"{expect_fused}")
    if unfused_counts != expect_unfused:
        fail(f"the unfused node step launched {unfused_counts}, "
             f"expected {expect_unfused}")
    first, last = sum(losses[:8]) / 8, sum(losses[-8:]) / 8
    print(f"  losses: {' '.join(f'{x:.4f}' for x in losses)}", flush=True)
    print(f"  mean loss, first 8 steps {first:.4f}, last 8 steps "
          f"{last:.4f}; unfused step {unfused_loss:.4f}", flush=True)
    if not torch.isfinite(torch.tensor(losses + [unfused_loss])).all():
        fail("a node training loss is not finite")
    if not last < first:
        fail("the node training loss did not fall over 32 steps")
    if len(trainer._captured) != 1:
        fail("the hit graphs' steps took more than one capture")
    mean_ms = sum(step_ms[1:]) / (N_STEPS - 1)
    print(f"  fused bf16 node train step: {step_times(step_ms)}; "
          f"synchronised by the loss readback, "
          f"{n_real / (mean_ms / 1e3):.4e} real edges/s; unfused step "
          f"(eager, then captured) {unfused_ms:.3f} ms", flush=True)
    if profile_path:
        write_profile(profile_path, "a", "3 node training steps",
                      lambda: one_step_calls(trainer, graphs[:3]))
    return launches


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def write_sector_files(directory) -> None:
    """The CLI's dataset: CLI_SECTORS Toy2D kNN sectors of the fullevent
    configuration (seeds 0, 1, 2; 36 each) as SparseGraph NPZ files with
    their per-node ``layer`` arrays."""
    import os

    from gnn_fpga_tpu_torch.core import graph as G
    from gnn_fpga_tpu_torch.data import toy2d

    for seed in range(CLI_SECTORS // N_SECTORS):
        cfg = toy2d.Toy2DConfig(n_layers=N_LAYERS, n_tracks=N_TRACKS,
                                seed=seed)
        sectors = G.unbatch_graphs(
            toy2d.make_knn_segment_graphs(cfg, N_SECTORS, k=K_NN))
        layers = toy2d.generate_events(cfg, N_SECTORS)[3]
        for i, g in enumerate(sectors):
            G.save_npz(g, os.path.join(directory,
                                       f"sector{seed}_{i:02d}.npz"),
                       layer=layers[i])


def epoch_times(run_dir) -> list:
    """Seconds of each epoch of a train CLI run (its metrics.jsonl)."""
    import os

    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line)["time_s"] for line in f]


def host_loop_ms(input_dir) -> tuple:
    """Host ms a batch of ``pack_graphs``, of ``attach_plans`` building
    the batch's plans, and of ``attach_plans`` composing them from the
    per-graph plans and padding them to the CLI's capacity (``PlanSetup``),
    on the CLI's batches (36 sectors, the CLI's bucket), mean of 3 each;
    and the last batch with its composed, padded plans, checked equal to
    the built ones."""
    from gnn_fpga_tpu_torch.cli import train
    from gnn_fpga_tpu_torch.core import batching
    from gnn_fpga_tpu_torch.core import graph as G

    graphs, _ = train.load_graph_files(input_dir, CLI_SECTORS)
    spec = batching.choose_bucket(graphs, edge_multiple=256)
    t = time.perf_counter()
    setup = train.PlanSetup(graphs, spec, CLI_BATCH)
    setup_ms = (time.perf_counter() - t) * 1e3
    pack, plans, composed = [], [], []
    for b in range(3):
        chunk = graphs[b * CLI_BATCH:(b + 1) * CLI_BATCH]
        t = time.perf_counter()
        g = G.pack_graphs(chunk, n_node=spec.n_node * CLI_BATCH,
                          n_edge=spec.n_edge * CLI_BATCH)
        pack.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        built = G.attach_plans(g)
        plans.append((time.perf_counter() - t) * 1e3)
        per_graph = setup.plans[b * CLI_BATCH:(b + 1) * CLI_BATCH]
        t = time.perf_counter()
        gc = G.attach_plans(g, per_graph, setup.capacity)
        composed.append((time.perf_counter() - t) * 1e3)
        unpadded = G.attach_plans(g, per_graph).plans
        if not (unpadded.items.n_recv == built.plans.items.n_recv
                and all(torch.equal(x, y) for x, y in zip(
                    unpadded.tensors(), built.plans.tensors()))):
            fail("cli: composed plans differ from the built ones")
    mean = lambda xs: sum(xs) / len(xs)
    return mean(pack), mean(plans), mean(composed), setup_ms, gc


def phase_cli(device) -> dict:
    """The train and infer CLIs at the fullevent width: 2 epochs on the
    fused route in bf16 with prefetching, resumed for a third without, one
    epoch on the blocked route, and infer --benchmark on the fused run's
    model; then the host loop timed (prefetch on and off, packing and
    plans per batch, the device's busy share over an epoch, a
    ``run_steps`` step on one pre-built batch)."""
    import os
    import tempfile

    from gnn_fpga_tpu_torch.cli import infer, train
    from gnn_fpga_tpu_torch.ops.cuda import spmm

    with tempfile.TemporaryDirectory() as tmp:
        data, runs = os.path.join(tmp, "graphs"), os.path.join(tmp, "runs")
        os.makedirs(data)
        t0 = time.perf_counter()
        write_sector_files(data)
        print(f"cli: {CLI_SECTORS} sector files written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        common = ["--input-dir", data, "--n-samples", str(CLI_SECTORS),
                  "--batch-size", str(CLI_BATCH), "--hidden-dim", str(HIDDEN),
                  "--n-iters", str(N_ITERS),
                  "--learning-rate", str(LEARNING_RATE),
                  "--pos-weight", str(POS_WEIGHT), "--bf16",
                  "--test-frac", "0"]
        fused = common + ["--aggregation", "pallas", "--valid-frac",
                          str(CLI_VALID_FRAC), "--output-dir",
                          os.path.join(runs, "pallas")]
        spmm.reset_launch_counts()
        # --- the main path: 2 fused epochs with prefetching, then resumed
        # for a third without, one blocked epoch, the infer CLI
        first = train.main(fused + ["--n-epochs", "2", "--prefetch", "2"])
        first_counts = launch_counts()
        resumed = train.main(fused + ["--n-epochs", "1", "--resume",
                                      "--prefetch", "0"])
        resumed_counts = launch_counts()
        blocked = train.main(common + [
            "--aggregation", "blocked", "--group", str(GROUP),
            "--valid-frac", str(CLI_VALID_FRAC), "--n-epochs", "1",
            "--output-dir", os.path.join(runs, "blocked")])
        model_path = os.path.join(runs, "pallas", "model.npz")
        results, latency = infer.run(infer.parse_args([
            "--model", model_path, "--input-dir", data,
            "--n-graphs", str(CLI_INFER_GRAPHS), "--hidden-dim", str(HIDDEN),
            "--n-iters", str(N_ITERS), "--benchmark"]))
        launches = launch_counts()
        # --- checks (not counted)
        per_epoch = dict(iteration_pair=N_ITERS * (CLI_TRAIN_STEPS
                                                   + CLI_VALID_BATCHES),
                         iteration_pair_bwd=N_ITERS * CLI_TRAIN_STEPS,
                         gather_pair=CLI_TRAIN_STEPS + CLI_VALID_BATCHES,
                         gather_pair_bwd=CLI_TRAIN_STEPS)
        for what, got, epochs in (
                ("2 fused epochs", first_counts, 2),
                ("the resumed epoch",
                 {k: resumed_counts[k] - first_counts[k] for k in launches},
                 1),
                ("the blocked epoch and infer",
                 {k: launches[k] - resumed_counts[k] for k in launches}, 0)):
            want = expected_counts(**{k: v * epochs
                                      for k, v in per_epoch.items()})
            print(f"  launches in {what}: {got}", flush=True)
            if got != want:
                fail(f"cli: {what} launched {got}, expected {want} "
                     f"({CLI_TRAIN_STEPS} steps and {CLI_VALID_BATCHES} "
                     f"validation forward an epoch)")
        losses = resumed.train_losses + resumed.valid_losses \
            + blocked.train_losses + blocked.valid_losses
        print(f"  fused losses: train {resumed.train_losses}, valid "
              f"{resumed.valid_losses}; blocked: train "
              f"{blocked.train_losses}, valid {blocked.valid_losses}",
              flush=True)
        if not torch.isfinite(torch.tensor(losses)).all():
            fail("cli: a loss is not finite")
        if resumed.epoch != 3 or resumed.train_losses[:2] != \
                first.train_losses:
            fail(f"cli: the resumed run is at epoch {resumed.epoch}, "
                 "expected 3 continuing the first two")
        check_infer(results, model_path, data, device)
        measure_host_loop(common, data, runs, device, latency)
    return launches


def check_infer(results, model_path, data, device) -> None:
    """infer's per-file mean scores (dense route, f32) against the sparse
    route in f32 at the same weights."""
    import glob
    import os

    from gnn_fpga_tpu_torch.core import batching
    from gnn_fpga_tpu_torch.core import graph as G
    from gnn_fpga_tpu_torch.models import mpnn
    from gnn_fpga_tpu_torch.utils import serialization

    files = sorted(glob.glob(os.path.join(data, "*.npz")))[:CLI_INFER_GRAPHS]
    graphs = [G.load_npz(f) for f in files]
    spec = batching.choose_bucket(graphs)
    model = mpnn.init_segment_classifier(
        mpnn.SegmentClassifierConfig(input_dim=INPUT_DIM, hidden_dim=HIDDEN,
                                     n_iters=N_ITERS, aggregation="sparse"),
        torch.Generator(), device=device)
    serialization.load_jax_params(
        model, serialization.load_params_npz(model_path))
    want = []
    with torch.inference_mode():
        for g in graphs:
            gp = G.pad_graph(g, spec.n_node, spec.n_edge).to(device)
            em = gp.edge_mask > 0
            want.append(float(mpnn.segment_classifier(model, gp)[em].mean()))
    got = [r["mean_score"] for r in results]
    if [r["file"] for r in results] != [os.path.basename(f) for f in files]:
        fail("cli: infer scored other files")
    err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    print(f"  infer per-file mean scores {' '.join(f'{x:.6f}' for x in got)}"
          f"; max rel err vs the f32 sparse route {err:.3e} (rtol "
          f"{INFER_SCORE_RTOL:g}) {'ok' if err <= INFER_SCORE_RTOL else 'FAIL'}",
          flush=True)
    if not err <= INFER_SCORE_RTOL:
        fail("cli: infer's scores disagree with the sparse route")


def measure_host_loop(common, data, runs, device, infer_latency) -> None:
    """The CLI's step against a ``run_steps`` step on one pre-built batch,
    with and without prefetching, the host time of packing and plans a
    batch, and the device's busy share over an epoch (profiler on)."""
    import os

    from gnn_fpga_tpu_torch.cli import train
    from gnn_fpga_tpu_torch.core import graph as G
    from gnn_fpga_tpu_torch.models import mpnn
    from gnn_fpga_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                                  stack_batches)

    timing = common + ["--aggregation", "pallas", "--valid-frac", "0",
                       "--n-epochs", str(CLI_TIMING_EPOCHS)]
    steps = CLI_SECTORS // CLI_BATCH
    step_ms = {2: [], 0: []}
    first_ms = {2: [], 0: []}
    for i, prefetch in enumerate((2, 0, 0, 2)):     # in turns
        out = os.path.join(runs, f"timing{i}")
        train.main(timing + ["--prefetch", str(prefetch), "--output-dir",
                             out])
        # epoch 0 takes the first batch's build, its eager step and the
        # capture
        times = epoch_times(out)
        first_ms[prefetch].append(times[0] / steps * 1e3)
        step_ms[prefetch] += [t / steps * 1e3 for t in times[1:]]
    pack_ms, plans_ms, compose_ms, setup_ms, g = host_loop_ms(data)
    out = os.path.join(runs, "profiled")
    # two epochs, the second (all replays) read
    wall, busy = profiled(lambda: train.main(
        timing[:-1] + ["2", "--output-dir", out]))
    epoch_ms = sum(epoch_times(out)) * 1e3

    cfg = mpnn.SegmentClassifierConfig(
        input_dim=INPUT_DIM, hidden_dim=HIDDEN, n_iters=N_ITERS,
        compute_dtype=torch.bfloat16, aggregation="pallas")
    trainer = Trainer(mpnn.init_segment_classifier(
        cfg, torch.Generator().manual_seed(0), device=device),
        TrainConfig(learning_rate=LEARNING_RATE, pos_weight=POS_WEIGHT))
    batch = g.to(device)
    one, five, twenty = (stack_batches([batch] * k) for k in (1, 5, 20))
    for stack in (one, one, five, twenty):     # eager and captured first
        trainer.run_steps(stack)
    run_ms = []
    for _ in range(8):
        t = time.perf_counter()
        trainer.run_steps(one)
        run_ms.append((time.perf_counter() - t) * 1e3)
    # the replayed step's device time (a profiled 5-step replay) and its
    # wall time with the profiler off (a 20-step replay, one readback)
    _, dev_busy = profiled(lambda: trainer.run_steps(five))
    t = time.perf_counter()
    trainer.run_steps(twenty)
    replay_ms = (time.perf_counter() - t) * 1e3 / 20
    step_dev_ms = dev_busy / 5
    name = card()
    mean = lambda xs: sum(xs) / len(xs)
    print(f"  [{name}] cli fused bf16 step, captured (epoch wall / {steps} "
          f"steps, epochs 1-{CLI_TIMING_EPOCHS - 1} of two runs each): "
          f"--prefetch 2 {mean(step_ms[2]):.3f} ms "
          f"({' '.join(f'{x:.3f}' for x in step_ms[2])}; before: "
          f"{BEFORE['prefetch 2']}), --prefetch 0 {mean(step_ms[0]):.3f} ms "
          f"({' '.join(f'{x:.3f}' for x in step_ms[0])}; before: "
          f"{BEFORE['prefetch 0']}); epoch 0, whose first step runs eagerly "
          f"and is captured: --prefetch 2 "
          f"{' '.join(f'{x:.3f}' for x in first_ms[2])}, --prefetch 0 "
          f"{' '.join(f'{x:.3f}' for x in first_ms[0])} ms/step",
          flush=True)
    print(f"  [{name}] run_steps fused bf16 step, replayed, on one pre-built "
          f"batch of {batch.n_edge} edges: {mean(run_ms):.3f} ms (min "
          f"{min(run_ms):.3f}, max {max(run_ms):.3f}, 8 steps of one "
          f"readback each; before: {BEFORE['run_steps']}); a 20-step graph "
          f"replayed, one readback: {replay_ms:.3f} ms/step; host loop = "
          f"cli step - run_steps step: "
          f"{mean(step_ms[2]) - mean(run_ms):.3f} ms with prefetch, "
          f"{mean(step_ms[0]) - mean(run_ms):.3f} ms without",
          flush=True)
    print(f"  [{name}] host time a batch of {CLI_BATCH} sectors: pack_graphs "
          f"{pack_ms:.3f} ms (before: {BEFORE['pack_graphs']}), attach_plans "
          f"building the plans {plans_ms:.3f} ms (before: "
          f"{BEFORE['attach_plans']}), composing and padding them "
          f"{compose_ms:.3f} ms; the per-graph plans of the "
          f"{CLI_SECTORS} sectors built once in {setup_ms:.3f} ms",
          flush=True)
    print(f"  [{name}] replayed fused bf16 step on the CLI batch: device "
          f"time {step_dev_ms:.3f} ms (torch.profiler over a 5-step "
          f"replay), wall {replay_ms:.3f} ms with the profiler off: device "
          f"idle {1 - step_dev_ms / replay_ms:.1%} (before: {BEFORE['idle']})",
          flush=True)
    print(f"  [{name}] two cli epochs ({2 * steps} steps) under "
          f"torch.profiler: epochs {epoch_ms:.3f} ms, device busy "
          f"{busy:.3f} ms ({busy / epoch_ms:.1%} of the epochs; before: "
          f"{BEFORE['busy']}; the whole CLI call {wall:.3f} ms)", flush=True)
    print(f"  [{name}] infer --benchmark (dense route, f32, one sector "
          f"padded, captured forward replayed): "
          f"{infer_latency * 1e6:.1f} us/graph (before: {BEFORE['infer']})",
          flush=True)


def phase_gcn(device) -> dict:
    """The GCN family and the baselines at the widths the JAX package's
    tests train: a forward on the card against the CPU at the same
    weights, then GCN_STEPS Adam steps on the card with a falling loss.
    No hand-written kernel runs here."""
    import numpy as np
    import torch.nn.functional as F

    from gnn_fpga_tpu_torch.data import toy2d
    from gnn_fpga_tpu_torch.models import baselines as bl
    from gnn_fpga_tpu_torch.models import gcn
    from gnn_fpga_tpu_torch.ops.cuda import spmm

    t = lambda *arrays: [torch.from_numpy(np.asarray(a)) for a in arrays]
    seg_cfg = toy2d.Toy2DConfig(n_layers=5, n_tracks=3, seed=7)
    gcn_x, gcn_a, gcn_y = t(*toy2d.make_gcn_data(
        toy2d.Toy2DConfig(n_layers=6, n_tracks=3, seed=0), 512,
        seed_layers=2))
    seg = toy2d.make_segment_graphs(seg_cfg, 512)
    grids, assoc = t(*toy2d.make_segmenter_data(seg_cfg, 512))
    sgrids, seeds, targets = t(*toy2d.make_seeded_grid_data(seg_cfg, 512,
                                                            seed_size=2))
    lt = dict(n_layers=5, n_tracks=3)
    cases = {   # name -> (model class, config, inputs, targets, loss)
        "gcrn": (gcn.GCNClassifier, gcn.GCNConfig(
            input_dim=3, hidden_dims=(8, 8, 8, 8), residual=True),
            (gcn_x, gcn_a), gcn_y, F.binary_cross_entropy_with_logits),
        "fc_segment_classifier": (
            bl.FCSegmentClassifier, bl.FCSegmentClassifierConfig(
                n_hits=15, n_segments=seg.n_edge, input_dim=2,
                hidden_dim=64), (seg.x,), seg.y,
            F.binary_cross_entropy_with_logits),
        "fc_segmenter": (bl.FCSegmenter, bl.SegmenterConfig(
            hidden_dim=64, **lt), (grids,), assoc, bl.softmax_xent),
        "conv_segmenter": (bl.ConvSegmenter, bl.ConvSegmenterConfig(
            adj_filters=(16, 16), lay_filters=(8,), **lt), (grids,), assoc,
            bl.softmax_xent),
        "seeded_fc": (bl.SeededFC, bl.SeededConfig(
            seed_size=2, hidden_dim=64, **lt), (sgrids, seeds), targets,
            bl.softmax_xent),
        "seeded_cnn": (bl.SeededCNN, bl.SeededCNNConfig(
            seed_size=2, n_conv=3, n_filters=8, **lt), (sgrids, seeds),
            targets, bl.softmax_xent),
        "seeded_lstm": (bl.SeededLSTM, bl.SeededLSTMConfig(
            seed_size=2, hidden_dim=16, **lt), (sgrids, seeds), targets,
            bl.softmax_xent),
    }
    print("gcn:", flush=True)
    spmm.reset_launch_counts()
    for name, (cls, cfg, inputs, target, loss_fn) in cases.items():
        cpu = cls(cfg, torch.Generator().manual_seed(0), device="cpu")
        model = cls(cfg, torch.Generator(), device=device)
        model.load_state_dict(cpu.state_dict())
        on_card = [x.to(device) for x in inputs]
        target = target.to(device)
        with torch.no_grad():
            compare(f"{name} logits, card vs CPU", model(*on_card).cpu(),
                    cpu(*inputs), *GCN_TOL)
        opt = torch.optim.Adam(model.parameters(), lr=3e-3)
        losses = []
        t0 = time.perf_counter()
        for _ in range(GCN_STEPS):
            loss = loss_fn(model(*on_card), target)
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        losses = torch.stack(losses).cpu()
        ms = (time.perf_counter() - t0) * 1e3 / GCN_STEPS
        print(f"  {name}: {sum(p.numel() for p in model.parameters())} "
              f"parameters; loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
              f"{GCN_STEPS} Adam steps ({ms:.3f} ms/step)", flush=True)
        if not torch.isfinite(losses).all() or not losses[-1] < losses[0]:
            fail(f"gcn: {name}'s loss did not fall on the card")
    return launch_counts()


def write_trackml_events(directory, n_events: int, n_particles: int,
                         seed: int, noise: float = PREP_NOISE) -> None:
    """Synthetic TrackML-format events (``event<id>-hits.csv``,
    ``-particles.csv``, ``-truth.csv``, TrackML's columns), written with
    numpy alone: ``n_particles`` tracks from a falling pT spectrum, charge
    +-1, bending ``dphi/dr = PREP_BEND / pT``, z0 ~ N(0, 55 mm), |eta| <
    1, one hit a barrel layer within |z| < PREP_HALF_LENGTH, and a
    ``noise`` share of hits with particle_id 0 uniform over the layers;
    particle ids above 2^53 (odd offsets, which no float64 holds)."""
    import os

    import numpy as np

    rng = np.random.default_rng(seed)
    f = lambda fmt, a: [fmt % v for v in np.asarray(a).tolist()]
    for ev in range(n_events):
        n = n_particles
        pid = (np.int64(2 ** 53) + 1 + np.arange(n, dtype=np.int64) * 4099
               + rng.integers(0, 4099, n))
        pt = PREP_PT_MIN + rng.exponential(PREP_PT_MEAN, n)
        q = rng.choice(np.array([-1, 1]), n)
        phi0 = rng.uniform(-np.pi, np.pi, n)
        eta = rng.uniform(-PREP_ETA_MAX, PREP_ETA_MAX, n)
        z0 = rng.normal(0.0, PREP_Z0_SIGMA, n)
        px, py, pz = pt * np.cos(phi0), pt * np.sin(phi0), pt * np.sinh(eta)
        cols = {k: [] for k in ("layer", "r", "phi", "z", "pid", "track")}
        for li, (_, _, radius) in enumerate(PREP_LAYERS):
            r = radius + rng.uniform(-0.5, 0.5, n)
            phi = phi0 + q * PREP_BEND * r / pt
            phi = (phi + np.pi) % (2 * np.pi) - np.pi
            z = z0 + r * np.sinh(eta)
            keep = np.abs(z) < PREP_HALF_LENGTH
            for k, v in (("layer", np.full(n, li)), ("r", r), ("phi", phi),
                         ("z", z), ("pid", pid), ("track", np.arange(n))):
                cols[k].append(v[keep])
        n_track_hits = sum(len(v) for v in cols["r"])
        m = int(round(noise / (1 - noise) * n_track_hits))
        layer = rng.integers(0, len(PREP_LAYERS), m)
        radii = np.array([x[2] for x in PREP_LAYERS])
        for k, v in (("layer", layer),
                     ("r", radii[layer] + rng.uniform(-0.5, 0.5, m)),
                     ("phi", rng.uniform(-np.pi, np.pi, m)),
                     ("z", rng.uniform(-PREP_HALF_LENGTH, PREP_HALF_LENGTH,
                                       m)),
                     ("pid", np.zeros(m, np.int64)),
                     ("track", np.full(m, -1))):
            cols[k].append(v)
        h = {k: np.concatenate(v) for k, v in cols.items()}
        order = np.argsort(h["layer"], kind="stable")   # TrackML's order
        h = {k: v[order] for k, v in h.items()}
        n_hits = len(order)
        x, y = h["r"] * np.cos(h["phi"]), h["r"] * np.sin(h["phi"])
        vol = np.array([v for v, _, _ in PREP_LAYERS])[h["layer"]]
        lay = np.array([l for _, l, _ in PREP_LAYERS])[h["layer"]]
        hit_id = np.arange(1, n_hits + 1)
        noise_hit = h["track"] < 0
        trk = np.where(noise_hit, 0, h["track"])
        nhits = np.bincount(h["track"][~noise_hit], minlength=n)
        tp = [np.where(noise_hit, 0.0, a[trk]) for a in (px, py, pz)]
        weight = np.where(noise_hit, 0.0, 1.0 / np.maximum(nhits[trk], 1))
        prefix = os.path.join(str(directory), f"event{ev:09d}")
        tables = {
            "hits": (("hit_id", f("%d", hit_id)), ("x", f("%.4f", x)),
                     ("y", f("%.4f", y)), ("z", f("%.4f", h["z"])),
                     ("volume_id", f("%d", vol)),
                     ("layer_id", f("%d", lay)),
                     ("module_id", f("%d", rng.integers(1, 3000, n_hits)))),
            "particles": (("particle_id", f("%d", pid)),
                          ("vx", f("%.6f", rng.normal(0, 0.01, n))),
                          ("vy", f("%.6f", rng.normal(0, 0.01, n))),
                          ("vz", f("%.6f", z0)), ("px", f("%.6f", px)),
                          ("py", f("%.6f", py)), ("pz", f("%.6f", pz)),
                          ("q", f("%d", q)), ("nhits", f("%d", nhits))),
            "truth": (("hit_id", f("%d", hit_id)),
                      ("particle_id", f("%d", h["pid"])),
                      ("tx", f("%.4f", x)), ("ty", f("%.4f", y)),
                      ("tz", f("%.4f", h["z"])),
                      ("tpx", f("%.6f", tp[0])), ("tpy", f("%.6f", tp[1])),
                      ("tpz", f("%.6f", tp[2])),
                      ("weight", f("%.9f", weight))),
        }
        for part, columns in tables.items():
            names, values = zip(*columns)
            with open(f"{prefix}-{part}.csv", "w") as out:
                out.write(",".join(names) + "\n")
                out.write("\n".join(map(",".join, zip(*values))) + "\n")


def doublet_inputs(prefix: str, device) -> tuple:
    """The doublet kernel's arguments for one whole event's barrel (no pT
    cut, one phi sector, nodes in (layer, phi) order as the CLI sorts
    them) at the CLI's default cuts: ``(args, z0_max, evaluations)``."""
    import numpy as np

    from gnn_fpga_tpu_torch.cli import prepare_graphs
    from gnn_fpga_tpu_torch.data import doublets, selection, trackml_io

    a = prepare_graphs.parse_args(["--input-dir", "."])
    hits, particles, truth = trackml_io.load_event(prefix)
    sector = selection.split_phi_sectors(
        selection.select_hits(hits, truth, particles, pt_min=0.0),
        n_phi_sectors=1)[0].sort(["layer", "phi"])
    cuts = doublets.SegmentCuts(phi_slope_max=a.phi_slope_max,
                                phi_slope_outer_max=a.phi_slope_outer_max,
                                z0_max=a.z0_max)
    p = doublets.layer_pair_hits(sector["layer"],
                                 doublets.adjacent_layer_pairs(10), cuts)
    t = lambda v: torch.tensor(np.ascontiguousarray(v), device=device)
    cols = [sector[k].astype(np.float64) for k in ("r", "phi", "z")]
    args = (*(t(c[p.rows1]) for c in cols), *(t(c[p.rows2]) for c in cols),
            t(p.off1), t(p.off2), t(p.phi_slope_cuts))
    evals = int((np.diff(p.off1) * np.diff(p.off2)).sum())
    return args, cuts.z0_max, evals


def check_doublet_kernel(prefix: str, device) -> dict:
    """The doublet kernel against its plain version on one whole event's
    barrel, bit for bit, twice; its device time (count, prefix sum and
    emit replayed from a CUDA graph into outputs sized by a first call),
    the wrapper's and the plain version's dispatched times (both sync with
    the host), pair evaluations/s, the bound, and the C++ library's time
    on the host where it is built."""
    from gnn_fpga_tpu_torch.ops.cuda import _build
    from gnn_fpga_tpu_torch.ops.cuda import doublets as dop

    args, z0_max, evals = doublet_inputs(prefix, device)
    n1, n2, n_pairs = args[0].shape[0], args[3].shape[0], args[8].shape[0]
    kern = lambda: dop.select_segments(*args, z0_max)
    plain = lambda: dop.select_segments_reference(*args, z0_max)
    got, again, ref = kern(), kern(), plain()
    torch.cuda.synchronize()
    n_kept = got[0].shape[0]
    print(f"prepare: doublet kernel on one event's barrel: {n_pairs} layer "
          f"pairs, {n1} inner and {n2} outer hits, {evals} pair "
          f"evaluations, {n_kept} doublets kept", flush=True)
    for side, a, b, c in zip(("i1", "i2"), got, ref, again):
        exact(f"select_segments {side}", a, b)
        exact(f"select_segments {side}, second launch", c, a)

    lib, ptr = _build.load_library(), lambda x: x.data_ptr()
    counts = torch.empty(n1, dtype=torch.int64, device=device)
    ends = torch.empty_like(counts)
    out1, out2 = torch.empty_like(got[0]), torch.empty_like(got[1])
    cargs = (n_pairs, n1, *(ptr(x) for x in args), float(z0_max))

    def launch():
        stream = torch.cuda.current_stream().cuda_stream
        lib.gnn_doublet_count(*cargs, ptr(counts), stream)
        torch.cumsum(counts, 0, out=ends)
        lib.gnn_doublet_emit(*cargs, ptr(ends), ptr(out1), ptr(out2), stream)

    launch()
    exact("select_segments i1, graph-timed launch", out1, got[0])
    p1, k1, w1, k2, w2, p2 = (
        time_ms(plain, n=3, warmup=1, graph=False), time_ms(launch),
        time_ms(kern, n=5, warmup=1, graph=False), time_ms(launch),
        time_ms(kern, n=5, warmup=1, graph=False),
        time_ms(plain, n=3, warmup=1, graph=False))
    ms = device_ms(k1, k2)
    plain_ms = (p1[1] + p2[1]) / 2
    nbytes = 24 * (n1 + n2) + 16 * (n_pairs + 1) + 8 * n_pairs + 16 * n_kept
    peaks = card_peaks()
    by_bytes = nbytes / (peaks.hbm_gbps * 1e9) * 1e3
    by_ops = evals * DOUBLET_F64_OPS / (peaks.f64_tflops * 1e12) * 1e3
    bound, by = ((by_bytes, "bytes") if by_bytes >= by_ops
                 else (by_ops, "operations"))
    native_ms = time_native(args, z0_max, got)
    print(f"  [{card()}] select_segments: kernel {ms:.4f} ms ({fmt_ms(k1)}, "
          f"{fmt_ms(k2)}; count, prefix sum and emit replayed), "
          f"{evals / ms * 1e3:.4e} pair evaluations/s; the wrapper with its "
          f"host sync {(w1[1] + w2[1]) / 2:.4f} ms dispatched; plain "
          f"{plain_ms:.4f} ms dispatched ({p1[1]:.4f}, {p2[1]:.4f}); bound "
          f"{bound:.4f} ms ({by}: {nbytes / 1e6:.1f} MB at "
          f"{peaks.hbm_gbps / 1e3:g} TB/s {by_bytes:.4f} ms, {evals} x "
          f"{DOUBLET_F64_OPS} f64 operations at {peaks.f64_tflops:g} "
          f"TFLOP/s {by_ops:.4f} ms); one PyTorch call: none; the C++ "
          f"library (native/doublets.cpp, {native_cpu()}): "
          f"{'not built' if native_ms is None else f'{native_ms:.1f} ms'}",
          flush=True)
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None)


def native_cpu() -> str:
    """The host's cores as the C++ library's OpenMP sees them."""
    import os

    from gnn_fpga_tpu_torch.data import native

    n = native.num_threads() or os.cpu_count()
    return f"{n} host thread{'s' if n > 1 else ''}"


def time_native(args, z0_max, got):
    """ms of the repo's C++ library (``make -C native``; absent from a
    fresh checkout, then None) on the kernel's inputs, pair by pair on the
    host as the CPU path calls it, mean of 2, checked equal to the
    kernel's doublets."""
    import numpy as np

    from gnn_fpga_tpu_torch.data import doublets, native

    if not native.available():
        return None
    host = [a.cpu().numpy() for a in args]
    run = lambda: doublets.select_segments_batched(
        *host[:6], *host[6:], z0_max, device="cpu")
    out = run()
    if not all(np.array_equal(a, b.cpu().numpy()) for a, b in zip(out, got)):
        fail("select_segments: the C++ library's doublets differ")
    t0 = time.perf_counter()
    for _ in range(2):
        run()
    return (time.perf_counter() - t0) / 2 * 1e3


def same_npz_files(dir_a: str, dir_b: str) -> int:
    """Fails unless the two directories hold the same NPZ files with the
    same arrays, key for key, dtype for dtype, bit for bit; their
    count."""
    import glob
    import os

    import numpy as np

    names = sorted(os.path.basename(f)
                   for f in glob.glob(os.path.join(dir_a, "*.npz")))
    if not names or names != sorted(
            os.path.basename(f)
            for f in glob.glob(os.path.join(dir_b, "*.npz"))):
        fail(f"prepare: the card and the CPU wrote different files")
    for name in names:
        with np.load(os.path.join(dir_a, name)) as a, \
                np.load(os.path.join(dir_b, name)) as b:
            if sorted(a.files) != sorted(b.files) or any(
                    a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k])
                    for k in a.files):
                fail(f"prepare: {name} differs between the card and the CPU")
    return len(names)


def phase_prepare(device) -> tuple:
    """The front door from raw events: PREP_EVENTS synthetic TrackML
    events at mu200 density; the doublet kernel against its plain version
    on one whole event's barrel; the port's prepare_graphs at its defaults
    on the card (the main path: one kernel call a sector) and with
    ``--device cpu``, every NPZ array identical; the train CLI on the
    prepared sectors on the fused route in bf16 at the fullevent widths
    (exact launch counts, finite losses) and infer on them.  No pandas.
    Returns ``(launches, the doublet kernel's row)``."""
    import os
    import tempfile

    from gnn_fpga_tpu_torch.cli import infer, prepare_graphs, train
    from gnn_fpga_tpu_torch.ops.cuda import spmm

    with tempfile.TemporaryDirectory() as tmp:
        raw, card_dir, cpu_dir, run_dir = (os.path.join(tmp, d) for d in (
            "raw", "graphs", "graphs_cpu", "run"))
        os.makedirs(raw)
        t0 = time.perf_counter()
        write_trackml_events(raw, PREP_EVENTS, PREP_PARTICLES, seed=0)
        print(f"prepare: {PREP_EVENTS} TrackML-format events of "
              f"{PREP_PARTICLES} particles written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        row = check_doublet_kernel(os.path.join(raw, "event000000000"),
                                   device)
        argv = ["--input-dir", raw, "--n-files", str(PREP_EVENTS)]
        n_graphs = PREP_EVENTS * prepare_graphs.parse_args(argv).n_phi_sectors
        train_argv = ["--input-dir", card_dir, "--output-dir", run_dir,
                      "--n-samples", str(n_graphs),
                      "--batch-size", str(PREP_BATCH),
                      "--hidden-dim", str(HIDDEN), "--n-iters", str(N_ITERS),
                      "--aggregation", "pallas", "--bf16",
                      "--n-epochs", str(PREP_EPOCHS),
                      "--valid-frac", str(PREP_VALID_FRAC),
                      "--test-frac", "0"]
        infer_argv = ["--model", os.path.join(run_dir, "model.npz"),
                      "--input-dir", card_dir, "--n-graphs", "8",
                      "--hidden-dim", str(HIDDEN), "--n-iters", str(N_ITERS)]
        spmm.reset_launch_counts()
        # --- the main path: prepare on the card, train, infer
        t0 = time.perf_counter()
        graphs, times = prepare_graphs.run(prepare_graphs.parse_args(
            argv + ["--output-dir", card_dir]))
        prep_s = time.perf_counter() - t0
        prep_counts = launch_counts()
        trainer = train.main(train_argv)
        train_counts = launch_counts()
        results, _ = infer.run(infer.parse_args(infer_argv))
        launches = launch_counts()
        # --- checks (not counted)
        summary = prepare_graphs.graphs_summary(graphs)
        mean = lambda k: sum(t[k] for t in times) / len(times) * 1e3
        print(f"  [{card()}] prepare_graphs on the card: {prep_s:.2f} s for "
              f"{PREP_EVENTS} events; ms an event: read {mean('read_s'):.1f},"
              f" select {mean('select_s'):.1f}, build (the cross-join and "
              f"the features) {mean('build_s'):.1f}; {summary['n_events']} "
              f"graphs, {summary['nodes_per_event']:.1f} nodes and "
              f"{summary['edges_per_event']:.1f} edges a graph, purity "
              f"{summary['purity']:.4f}", flush=True)
        if not n_graphs // 2 <= len(graphs) <= prep_counts[
                "select_segments"] <= n_graphs:
            fail(f"prepare: {len(graphs)} graphs from "
                 f"{prep_counts['select_segments']} doublet kernel launches "
                 f"and {n_graphs} sectors")
        if {k: v for k, v in prep_counts.items() if k != "select_segments"
            } != {k: 0 for k in prep_counts if k != "select_segments"}:
            fail(f"prepare: another kernel launched: {prep_counts}")
        t0 = time.perf_counter()
        prepare_graphs.main(argv + ["--output-dir", cpu_dir,
                                    "--device", "cpu"])
        n_files = same_npz_files(card_dir, cpu_dir)
        print(f"  the same with --device cpu in "
              f"{time.perf_counter() - t0:.2f} s: {n_files} NPZ files, every "
              f"array identical", flush=True)
        per_epoch = dict(
            iteration_pair=N_ITERS * (PREP_TRAIN_STEPS + PREP_VALID_BATCHES),
            iteration_pair_bwd=N_ITERS * PREP_TRAIN_STEPS,
            gather_pair=PREP_TRAIN_STEPS + PREP_VALID_BATCHES,
            gather_pair_bwd=PREP_TRAIN_STEPS)
        want = expected_counts(select_segments=prep_counts["select_segments"],
                               **{k: v * PREP_EPOCHS
                                  for k, v in per_epoch.items()})
        print(f"  launches (prepare, train, infer): {launches}", flush=True)
        if train_counts != want or launches != want:
            fail(f"prepare: launched {train_counts} by the train CLI and "
                 f"{launches} with infer, expected {want}")
        losses = trainer.train_losses + trainer.valid_losses
        print(f"  train CLI on the prepared graphs (pallas, bf16, hidden "
              f"{HIDDEN}, {N_ITERS} iterations): train losses "
              f"{trainer.train_losses}, valid {trainer.valid_losses}; infer "
              f"mean scores {[round(r['mean_score'], 4) for r in results]}",
              flush=True)
        if len(trainer.train_losses) != PREP_EPOCHS or not torch.isfinite(
                torch.tensor(losses)).all():
            fail("prepare: the train CLI's losses are not finite")
        scores = torch.tensor([r["mean_score"] for r in results])
        if len(results) != 8 or not ((scores >= 0) & (scores <= 1)).all():
            fail(f"prepare: infer scored {len(results)} graphs: {scores}")
    if "pandas" in sys.modules:
        fail("prepare: pandas was imported")
    return launches, row


def padded_kernel_runs(g, gen) -> dict:
    """The plan-reading kernels (#1-#5, #7, and sddmm, sddmm_dual) and
    gather_pair (#6) on ``g``'s topology with ``plans``, in f32 and bf16,
    on tables from ``gen``: name -> a function of the plans giving the
    kernel's outputs."""
    from gnn_fpga_tpu_torch.ops.cuda import spmm

    dev = g.x.device
    d, hdim = HIDDEN + INPUT_DIM, HIDDEN
    rnd = lambda *shape: torch.randn(*shape, generator=gen).to(dev)
    tabs = dict(pa=rnd(N_NODE, hdim), pb=rnd(N_NODE, hdim), h=rnd(N_NODE, d),
                w2=rnd(hdim) * 0.25, b1=rnd(hdim), b2=rnd(1),
                g_mi=rnd(N_NODE, d), g_mo=rnd(N_NODE, d), g=rnd(N_EDGE, hdim))
    w = torch.rand(N_EDGE, generator=gen).to(dev) * g.edge_mask
    runs = {}
    for dt in (torch.float32, torch.bfloat16):
        t = {k: v.to(dt) for k, v in tabs.items()}
        tag = str(dt).replace("torch.", "")

        def it(p, t=t):
            ems = spmm.sort_edge_weights(g.edge_mask, p.recv)
            args = [t["pa"], t["pb"], t["h"], ems, t["w2"], t["b1"], t["b2"]]
            mi, mo, sig = spmm.iteration_pair_fwd(*args, p)
            return (mi, mo, sig) + spmm.iteration_pair_bwd(
                *args, t["g_mi"], t["g_mo"], p, sig)

        runs.update({
            f"iteration_pair and its bwd {tag}": it,
            f"aggregate_pair {tag}": lambda p, t=t: spmm.aggregate_pair(
                t["h"], w, p),
            f"aggregate_pair_bwd {tag}": lambda p, t=t:
                spmm.aggregate_pair_bwd(t["h"], w, t["g_mi"], t["g_mo"], p),
            f"gather_pair {tag}": lambda p, t=t: (spmm.gather_pair(
                t["pa"], t["pb"], g.senders, g.receivers, p),),
            f"gather_pair_bwd {tag}": lambda p, t=t: spmm.gather_pair_bwd(
                t["g"], p),
            f"spmm {tag}": lambda p, t=t: (spmm.spmm_raw(t["h"], w, p.recv),
                                           spmm.spmm_raw(t["h"], w, p.send)),
            f"sddmm, sddmm_dual {tag}": lambda p, t=t: (
                spmm.sddmm(t["g_mi"], t["h"], p.recv),
                spmm.sddmm_dual(t["g_mi"], t["h"], t["g_mo"], t["h"],
                                p.recv)),
        })
    return runs


def layer_norm_relu_inputs(device, rows, dt, gen) -> dict:
    """The fused hidden layer's operands at H = IGN_HIDDEN: rows ~ N(0,
    1), a bias ~ N(0, 1) / 4, a scale and a shift U(-1, 1) as the
    Interaction Network draws them, an output gradient ~ N(0, 1)."""
    h = IGN_HIDDEN
    n = lambda *shape: torch.randn(*shape, generator=gen).to(device, dt)
    u = lambda *shape: (torch.rand(*shape, generator=gen) * 2 - 1).to(
        device, dt)
    return dict(y=n(rows, h), b=n(h) / 4, g=u(h), beta=u(h), dz=n(rows, h))


def check_layer_norm_relu(device) -> dict:
    """``layer_norm_relu`` and its backward on the edge and the node rows
    in f32 and bf16 against ``layer_norm_relu_reference`` and its
    autograd in f64 (the kernels' ReLU mask, so that a value within f32
    rounding of 0 does not flip one element; the output compared on its
    own): the output and ``dy`` at KERNEL_TOL, the column sums at
    PARAM_SUM_ATOL of their largest entry; twice bit for bit; each way
    timed (CUDA-graph replays) with its bound, its plain version (the
    reference, and its autograd) and the library's ``F.layer_norm`` +
    ``F.relu`` (and their autograd with the bias's column sum).  Returns
    the bf16 edge-row rows of the kernels line."""
    import torch.nn.functional as F

    from gnn_fpga_tpu_torch.models.interaction_gnn import LAYER_NORM_EPS
    from gnn_fpga_tpu_torch.ops.cuda import layer_norm as ln

    eps, h = LAYER_NORM_EPS, IGN_HIDDEN
    gen = torch.Generator().manual_seed(2323)
    rows_out = {}
    for dt in (torch.float32, torch.bfloat16):
        for rows in (N_EDGE, N_NODE):
            t = layer_norm_relu_inputs(device, rows, dt, gen)
            args = (t["y"], t["b"], t["g"], t["beta"])
            tag = f"{str(dt).replace('torch.', '')} rows={rows} H={h}"
            fwd = lambda: ln.layer_norm_relu_fwd(*args, eps)
            out, mean, rstd = fwd()
            bwd = lambda: ln.layer_norm_relu_bwd(t["dz"], *args, mean, rstd)
            grads = bwd()
            again = fwd() + bwd()
            torch.cuda.synchronize()
            exact(f"layer_norm_relu {tag} twice",
                  torch.cat([x.reshape(-1).float() for x in again]),
                  torch.cat([x.reshape(-1).float()
                             for x in (out, mean, rstd) + grads]))
            f64 = lambda x: x.double()
            want = ln.layer_norm_relu_reference(*map(f64, args), eps)
            rtol, atol = KERNEL_TOL[dt]
            err_f = compare(f"layer_norm_relu {tag} out", out, want, rtol,
                            atol)
            ref = ln.layer_norm_relu_bwd_reference(t["dz"], *args, eps,
                                                   live=out > 0)
            err_b = 0.0
            for side, got, w in zip(("dy", "db", "dg", "dbeta"), grads, ref):
                a = atol if side == "dy" else \
                    PARAM_SUM_ATOL[dt] * w.abs().max().item()
                err_b = max(err_b, compare(f"layer_norm_relu_bwd {tag} "
                                           f"{side}", got, w, rtol, a))
            # the mask the backward recomputes is the forward's: with dz
            # all ones the shift's gradient counts the live outputs
            # (integer sums in f32, rounded once)
            exact(f"layer_norm_relu_bwd {tag} mask",
                  ln.layer_norm_relu_bwd(torch.ones_like(out), *args, mean,
                                         rstd)[3],
                  (out > 0).sum(0).float().to(dt))
            # the plain versions and the library's layer, its bias added
            # by the preceding Linear; a backward is timed with its
            # forward (the autograd graph built inside the capture) and
            # the forward's time taken off
            ref_leaves = [x.clone().requires_grad_(True) for x in args]
            lib_leaves = [(t["y"] + t["b"]).requires_grad_(True)] + [
                x.clone().requires_grad_(True) for x in args[2:]]
            plain_f = lambda: ln.layer_norm_relu_reference(*args, eps)
            lib_f = lambda: F.relu(F.layer_norm(t["y"], (h,), t["g"],
                                                t["beta"], eps))
            plain_fb = lambda: torch.autograd.grad(
                ln.layer_norm_relu_reference(*ref_leaves, eps), ref_leaves,
                t["dz"])

            def lib_fb():
                yb, gl, bl = lib_leaves
                dyl, dgl, dbl = torch.autograd.grad(
                    F.relu(F.layer_norm(yb, (h,), gl, bl, eps)), lib_leaves,
                    t["dz"])
                return dyl.sum(0), dgl, dbl

            fwd_plain = fwd_lib = 0.0
            for name, kern, plain, lib, err in (
                    ("layer_norm_relu", fwd, plain_f, lib_f, err_f),
                    ("layer_norm_relu_bwd", bwd, plain_fb, lib_fb, err_b)):
                p1, k1, k2, p2 = (time_ms(f)
                                  for f in (plain, kern, kern, plain))
                ms = device_ms(k1, k2)
                plain_ms = device_ms(p1, p2) - fwd_plain
                lib_ms, lib_timer = library_ms(lib)
                lib_ms -= fwd_lib
                if name == "layer_norm_relu":
                    fwd_plain, fwd_lib = plain_ms, lib_ms
                bound, by = bound_ms(name, dt, N_NODE, rows, h, h)
                print(f"  {name} {tag}: kernel {ms:.4f} ms ({fmt_ms(k1)}, "
                      f"{fmt_ms(k2)}) plain {plain_ms:.4f} ms, library "
                      f"{lib_ms:.4f} ms ({lib_timer}), bound {bound:.4f} ms "
                      f"({by}, {100 * bound / ms:.1f}% of it)", flush=True)
                if dt == torch.bfloat16 and rows == N_EDGE:
                    rows_out[name] = dict(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound, bound_by=by, library_ms=lib_ms,
                        timer="cuda_graph", library_timer=lib_timer)
    return rows_out


def phase_ign(device, graphs) -> tuple:
    """The Interaction Network's path on the packed fullevent graphs:
    kernels #6, #5 and ``edge_sum`` at H = IGN_HIDDEN against their plain
    versions (``edge_sum``'s backward, one ``gather_pair_fwd``, bit for
    bit), the fused hidden layer (:func:`check_layer_norm_relu`), then a
    captured IGN_STEPS-step ``run_steps`` against one-step calls
    (:func:`scan_check`), its replay's launches checked.  Returns those
    launches and the kernels line's bf16 rows of ``edge_sum``,
    ``layer_norm_relu`` and ``layer_norm_relu_bwd``."""
    from gnn_fpga_tpu_torch.models import interaction_gnn as ign
    from gnn_fpga_tpu_torch.ops.cuda import spmm
    from gnn_fpga_tpu_torch.train.trainer import TrainConfig, Trainer

    g = graphs[0]
    s, r, plans = g.senders, g.receivers, g.plans
    gen = torch.Generator().manual_seed(4321)
    rnd = lambda *shape: torch.randn(*shape, generator=gen).to(device)
    tabs = dict(pa=rnd(N_NODE, IGN_HIDDEN), pb=rnd(N_NODE, IGN_HIDDEN),
                g=rnd(N_EDGE, IGN_HIDDEN), gm=rnd(N_NODE, IGN_HIDDEN))
    print(f"ign: V={N_NODE} E={N_EDGE} H={IGN_HIDDEN}", flush=True)
    row = None
    with uncounted():
        for dt in (torch.float32, torch.bfloat16):
            t = {k: v.to(dt) for k, v in tabs.items()}
            tag = f"{str(dt).replace('torch.', '')} H={IGN_HIDDEN}"
            hold(f"gather_pair {tag}",
                 lambda: (spmm.gather_pair_fwd(t["pa"], t["pb"], s, r),),
                 lambda: (spmm.gather_pair_reference(t["pa"], t["pb"], s,
                                                     r),),
                 ("out",), dt, exact_sides=True)
            hold(f"gather_pair_bwd {tag}",
                 lambda: spmm.gather_pair_bwd(t["g"], plans),
                 lambda: spmm.gather_pair_bwd_reference(t["g"], s, r,
                                                        N_NODE),
                 ("dpa", "dpb"), dt)
            e = t["g"].clone().requires_grad_(True)
            m = spmm.edge_sum(e, s, r, plans)
            (de,) = torch.autograd.grad(m, e, t["gm"])
            want = spmm.edge_sum_reference(t["g"].double(), s.long(),
                                           r.long(), N_NODE)
            # in bf16 each half is rounded and then their sum, and the
            # halves may cancel: atol relative to the largest entry
            rtol, atol = KERNEL_TOL[dt]
            err = compare(f"edge_sum {tag} m", m, want, rtol,
                          max(atol, rtol * want.abs().max().item()))
            exact(f"edge_sum {tag} backward", de,
                  spmm.gather_pair_reference(t["gm"], t["gm"], s, r))
            kern = lambda: spmm.edge_sum(t["g"], s, r, plans)
            plain = lambda: spmm.edge_sum_reference(t["g"], s.long(),
                                                    r.long(), N_NODE)
            p1, k1, k2, p2 = (time_ms(f) for f in (plain, kern, kern, plain))
            ms, plain_ms = device_ms(k1, k2), device_ms(p1, p2)
            bound, by = bound_ms("edge_sum", dt, N_NODE, N_EDGE, IGN_HIDDEN,
                                 IGN_HIDDEN)
            print(f"  edge_sum {tag}: kernel {ms:.4f} ms ({fmt_ms(k1)}, "
                  f"{fmt_ms(k2)}) plain {plain_ms:.4f} ms ({fmt_ms(p1)}, "
                  f"{fmt_ms(p2)}), bound {bound:.4f} ms ({by})", flush=True)
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=by, library_ms=None,
                       timer="cuda_graph", library_timer=None)
        rows = dict(check_layer_norm_relu(device), edge_sum=row)
    cfg = ign.InteractionGNNConfig(
        input_dim=INPUT_DIM, hidden_dim=IGN_HIDDEN, n_iters=IGN_ITERS,
        mlp_layers=IGN_LAYERS, compute_dtype=torch.bfloat16)
    base = ign.init_interaction_gnn(cfg, torch.Generator().manual_seed(22),
                                    device)
    tcfg = TrainConfig(learning_rate=1e-3, pos_weight=POS_WEIGHT)
    print(f"  InteractionGNN {IGN_HIDDEN}/{IGN_ITERS}/{IGN_LAYERS}, "
          f"{sum(p.numel() for p in base.parameters())} parameters",
          flush=True)
    launches = scan_check(
        f"InteractionGNN bf16, K = {IGN_STEPS}",
        lambda: tuple(Trainer(variant_of(base, device), tcfg)
                      for _ in range(2)),
        graphs[:IGN_STEPS])["launches"]
    want = expected_counts(edge_sum=IGN_ITERS * IGN_STEPS,
                           gather_pair=(2 * IGN_ITERS + 2) * IGN_STEPS,
                           gather_pair_bwd=(IGN_ITERS + 2) * IGN_STEPS,
                           layer_norm_relu=IGN_HIDDEN_LAYERS * IGN_STEPS,
                           layer_norm_relu_bwd=IGN_HIDDEN_LAYERS * IGN_STEPS)
    print(f"  [{card()}] launches of one {IGN_STEPS}-step replay: "
          f"{launches}", flush=True)
    if launches != want:
        fail(f"ign: the {IGN_STEPS}-step replay launched {launches}, "
             f"expected {want}")
    return launches, rows


def phase_capture(device, graphs, unpadded) -> None:
    """The captured paths against the eager ones: CAPTURE_STEPS train
    steps from one init on the fused, unfused and blocked routes (losses
    and weights at CAPTURE_RTOL); the served forward and infer's forward
    bit for bit; the kernels on ``unpadded[0]``'s plans padded to the
    worst case of the fullevent shape bit for bit against the unpadded
    plans, and timed; a batch of another signature raising."""
    from gnn_fpga_tpu_torch.cli import infer
    from gnn_fpga_tpu_torch.core import capture
    from gnn_fpga_tpu_torch.core import graph as G
    from gnn_fpga_tpu_torch.models import mpnn
    from gnn_fpga_tpu_torch.ops.cuda import spmm
    from gnn_fpga_tpu_torch.train.trainer import TrainConfig, Trainer

    print(f"capture: captured against eager, {CAPTURE_STEPS} steps from one "
          f"init", flush=True)
    tcfg = TrainConfig(learning_rate=LEARNING_RATE, pos_weight=POS_WEIGHT)
    sectors = [make_sector_batch(seed, device) for seed in range(N_REQUESTS)]
    sectors = [b for b in sectors
               if capture.signature(b) == capture.signature(sectors[0])]
    for route, kw, batches in (
            ("fused", dict(aggregation="pallas"), graphs),
            ("unfused", dict(aggregation="pallas", fused_iteration=False),
             graphs),
            ("blocked", dict(aggregation="blocked"), sectors)):
        batches = [batches[i % len(batches)] for i in range(CAPTURE_STEPS)]
        base = mpnn.init_segment_classifier(
            mpnn.SegmentClassifierConfig(
                input_dim=INPUT_DIM, hidden_dim=HIDDEN, n_iters=N_ITERS,
                compute_dtype=torch.bfloat16, **kw),
            torch.Generator().manual_seed(5), device=device)
        got = {}
        for on in (True, False):
            tr = Trainer(variant_of(base, device), tcfg, capture=on)
            # one-step calls: the first eager and captured, then replays
            got[on] = (torch.cat([torch.from_numpy(tr.run_steps([b]))
                                  for b in batches]),
                       params_of(tr.model))
            if on and len(tr._captured) != 1:
                fail(f"capture: the {route} steps took "
                     f"{len(tr._captured)} captures, expected 1")
        print(f"  {route} losses, captured: "
              f"{' '.join(f'{x:.6f}' for x in got[True][0].tolist())}; "
              f"eager: {' '.join(f'{x:.6f}' for x in got[False][0].tolist())}",
              flush=True)
        compare(f"{route} losses, captured vs eager", got[True][0],
                got[False][0], CAPTURE_RTOL, 0.0)
        compare(f"{route} weights after {CAPTURE_STEPS} steps, captured vs "
                f"eager", got[True][1], got[False][1], CAPTURE_RTOL,
                CAPTURE_ATOL)

    # the served forward and infer's forward, captured against eager
    model = mpnn.init_segment_classifier(
        mpnn.SegmentClassifierConfig(
            input_dim=INPUT_DIM, hidden_dim=HIDDEN, n_iters=N_ITERS,
            compute_dtype=torch.bfloat16, aggregation="pallas"),
        torch.Generator().manual_seed(6), device=device)
    call = captured_probs(model, device)
    with torch.no_grad():
        call(graphs[0])
        for g in graphs[1:3]:
            exact("served forward, captured vs eager", call(g).clone(),
                  torch.sigmoid(model(g)))
        other = without_pad_edges(unpadded[0])
        try:
            call(other)
        except ValueError as err:
            print(f"  a batch of another signature ({other.n_edge} edges) "
                  f"raises: {err}", flush=True)
        else:
            fail("capture: a batch of another signature was accepted")
    dense = mpnn.init_segment_classifier(
        mpnn.SegmentClassifierConfig(input_dim=INPUT_DIM, hidden_dim=HIDDEN,
                                     n_iters=N_ITERS),
        torch.Generator().manual_seed(7), device=device)
    sectors = G.unbatch_graphs(make_sector_batch(0, "cpu").replace(
        blocks=None))
    fwd = infer.captured_forward(dense, device)
    fwd(sectors[0])
    with torch.no_grad():
        for g in sectors[1:3]:
            exact("infer's forward, captured vs eager", fwd(g).clone(),
                  mpnn.segment_classifier(dense, g.to(device)))
    _, busy = profiled(lambda: [fwd.replay() for _ in range(10)])
    t = time.perf_counter()
    for _ in range(100):
        fwd.replay()
    torch.cuda.synchronize()
    print(f"  [{card()}] infer's forward (dense route, f32, one sector): "
          f"device time {busy / 10 * 1e3:.1f} us (torch.profiler over 10 "
          f"replays), {(time.perf_counter() - t) * 1e4:.1f} us a replay "
          f"over 100 with the profiler off", flush=True)

    # the kernels on plans padded to the worst case of the shape against
    # the unpadded plans
    plans = unpadded[0].plans
    padded = spmm.pad_plans(plans, spmm.worst_case_capacity(N_NODE, N_EDGE))
    it, real = padded.items, spmm.plan_counts(plans)
    print(f"  kernels on plans padded to {it.n_recv} + {it.n_item - it.n_recv}"
          f" items, {it.n_split} splits, {len(padded.recv.long_seg)} + "
          f"{len(padded.send.long_seg)} long segments (the worst case of "
          f"V = {N_NODE}, E = {N_EDGE}) against the unpadded plans "
          f"({real.recv_items} + {real.send_items} items, {real.splits} "
          f"splits, {real.recv_long} + {real.send_long} long segments):",
          flush=True)
    runs = padded_kernel_runs(unpadded[0], torch.Generator().manual_seed(8))
    with torch.no_grad():
        for name, run in runs.items():
            want, got = run(plans), run(padded)
            torch.cuda.synchronize()
            same = all(a.dtype == b.dtype and torch.equal(a, b)
                       for a, b in zip(got, want))
            print(f"  {name} on padded plans: {len(got)} outputs bit for "
                  f"bit {'ok' if same else 'FAIL'}", flush=True)
            if not same:
                fail(f"capture: {name} on padded plans differs")
        for name in ("iteration_pair and its bwd bfloat16",
                     "aggregate_pair_bwd bfloat16"):
            ts = {label: time_ms(lambda p=p: runs[name](p))
                  for label, p in (("unpadded", plans), ("padded", padded))}
            print(f"  {name}: "
                  + ", ".join(f"{k} {fmt_ms(t)} ms" for k, t in ts.items()),
                  flush=True)



# ---------------------------------------------------------------------------
# The scan phase: a stacked epoch as one captured graph (run_steps on a stack)
# ---------------------------------------------------------------------------

def tensor_bytes(batch) -> int:
    return sum(t.numel() * t.element_size() for t in batch.tensors())


def count_replays(run) -> tuple:
    """``(run(), the CUDA graph replays it made)``."""
    replays = [0]
    replay = torch.cuda.CUDAGraph.replay

    def counted(graph):
        replays[0] += 1
        return replay(graph)

    torch.cuda.CUDAGraph.replay = counted
    try:
        out = run()
    finally:
        torch.cuda.CUDAGraph.replay = replay
    return out, replays[0]


def first_call_memory(trainer, stack) -> tuple:
    """``(losses, bytes)`` of ``trainer``'s first call on ``stack`` (its
    eager run and the capture): the peak memory it allocated beyond what
    was allocated before and beyond the capture's input buffers."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    losses = trainer.run_steps(stack)
    torch.cuda.synchronize()
    return losses, (torch.cuda.max_memory_allocated() - before
                    - tensor_bytes(stack))


def params_of(model) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def scan_check(label, trainers, batches) -> dict:
    """The K-step graph against one-step graphs from one init:
    ``trainers()`` gives two trainers with the same weights; the first
    runs ``stack_batches(batches)`` twice (its first call eager and
    captured, the second one replay of the K-step graph), the second
    runs the same 2K steps one batch a call (its one-step graph replayed
    after the first).  Losses and weights must agree bit for bit, the
    replay must be one CUDA graph replay that launches K steps' kernels,
    and the first call's memory beyond its input buffers is returned
    beside the one-step trainer's."""
    from gnn_fpga_tpu_torch.core.capture import signature
    from gnn_fpga_tpu_torch.ops.cuda import spmm
    from gnn_fpga_tpu_torch.train.trainer import stack_batches

    k = len(batches)
    stacked, one_step = trainers()
    stack = stack_batches(batches)
    first, mem_k = first_call_memory(stacked, stack)
    call = stacked._captured[("train", signature(
        stacked._local(stack, stacked=True)))]
    spmm.reset_launch_counts()
    second, replays = count_replays(lambda: stacked.run_steps(stack))
    launches = launch_counts()
    got = torch.cat([torch.from_numpy(first), torch.from_numpy(second)])
    ones, mem_1 = first_call_memory(one_step, stack_batches(batches[:1]))
    ones = [float(ones[0])] + [float(one_step.run_steps([b])[0])
                               for b in (batches + batches)[1:]]
    want = torch.tensor(ones, dtype=torch.float32)
    same = torch.equal(got, want) and torch.equal(
        params_of(stacked.model), params_of(one_step.model))
    print(f"  [{card()}] {label}: {2 * k} steps, a {k}-step graph (its "
          f"first call eager, then {replays} replay) against {2 * k} one-step "
          f"calls "
          f"(one-step graph replays after the first): losses and weights "
          f"bit for bit {'ok' if same else 'FAIL'}; losses "
          f"{' '.join(f'{x:.4f}' for x in got.tolist())}", flush=True)
    if not same:
        diff = (got - want).abs().max().item()
        fail(f"scan: {label}: the K-step graph differs from one-step calls "
             f"(losses max |diff| {diff:.3e})")
    if replays != 1:
        fail(f"scan: {label}: a {k}-step call made {replays} graph replays")
    if not torch.isfinite(got).all():
        fail(f"scan: {label}: a loss is not finite")
    t = call.timings
    print(f"  [{card()}] {label}: the {k}-step graph: eager first call "
          f"{t['eager_s']:.3f} s, capture {t['capture_s']:.3f} s, capture "
          f"end and instantiation {t['instantiate_s']:.3f} s; memory of "
          f"the first call beyond its {tensor_bytes(stack) / 1e6:.1f} MB of "
          f"input buffers {mem_k / 2**20:.1f} MiB, the one-step trainer's "
          f"{mem_1 / 2**20:.1f} MiB", flush=True)
    if mem_k > SCAN_MEMORY_FACTOR * mem_1:
        fail(f"scan: {label}: the {k}-step graph took {mem_k} bytes beyond "
             f"its inputs, more than {SCAN_MEMORY_FACTOR} x the one-step "
             f"graph's {mem_1}")
    return dict(launches=launches, trainer=stacked, one_step=one_step,
                stack=stack, call=call)


def time_stacked(label, stacked, stack, one_step, batches) -> float:
    """The K-step call timed as bench.py's timed_run times it (SCAN_REPS
    calls, each with its loss readback) in turns with the same K steps as
    one-step calls, each with its readback; returns ms a stacked step."""
    k = len(batches)
    times = {"stacked": [], "one-step": []}
    for kind in ("stacked", "one-step", "one-step", "stacked"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if kind == "stacked":
            for _ in range(SCAN_REPS):
                stacked.run_steps(stack)
            n = SCAN_REPS * k
        else:
            for b in batches:
                one_step.run_steps([b])
            n = k
        times[kind].append((time.perf_counter() - t) / n * 1e3)
    print(f"  [{card()}] {label} step: the {k}-step graph "
          f"{' / '.join(f'{x:.4f}' for x in times['stacked'])} ms a step "
          f"({SCAN_REPS} calls, one readback each), {k} one-step calls "
          f"{' / '.join(f'{x:.4f}' for x in times['one-step'])} ms a step "
          f"(a readback each)", flush=True)
    return sum(times["stacked"]) / 2


def phase_scan(device, unpadded, profile_path=None) -> dict:
    """The stacked epoch: bench.py's fullevent stack of SCAN_STEPS distinct
    packed graphs on the card, run by ``Trainer.run_steps`` as one K-step
    graph against one-step graphs bit for bit under the constant and the
    cosine rate (the main path: the K-step replay, counted); the unfused
    and blocked routes and ``strategy="partitioned"`` at P = 1 over NCCL
    at SCAN_SHORT_STEPS; memory, capture time, the stack's copy into the
    capture's buffers, the stacked step's time beside one-step calls,
    its device idle share, useful TFLOP/s, MFU and the attainable MFU of
    ``utils/flops.py`` (with ``profile_path``, the profiler's table of
    the K-step replay).  Returns the launches of the fused K-step
    replay."""
    import torch.distributed as dist

    from gnn_fpga_tpu_torch.models import mpnn
    from gnn_fpga_tpu_torch.parallel import mesh as mesh_lib
    from gnn_fpga_tpu_torch.parallel import multihost
    from gnn_fpga_tpu_torch.train.trainer import TrainConfig, Trainer
    from gnn_fpga_tpu_torch.utils import flops

    tag = f"[{card()}]"
    t0 = time.perf_counter()
    graphs = pad_to_covering(unpadded + [
        make_request(seed, device)
        for seed in range(len(unpadded), SCAN_STEPS)])
    it = graphs[0].plans.items
    print(f"scan: {tag} {SCAN_STEPS} distinct packed graphs built and "
          f"padded to one capacity in {time.perf_counter() - t0:.2f} s "
          f"({it.n_recv} + {it.n_item - it.n_recv} items, {it.n_split} "
          f"splits)",
          flush=True)
    cfg = mpnn.SegmentClassifierConfig(
        input_dim=INPUT_DIM, hidden_dim=HIDDEN, n_iters=N_ITERS,
        compute_dtype=torch.bfloat16, aggregation="pallas")
    base = mpnn.init_segment_classifier(
        cfg, torch.Generator().manual_seed(13), device=device)
    schedules = {"constant": {},
                 "cosine": dict(lr_schedule="cosine",
                                decay_steps=SCAN_DECAY_STEPS,
                                lr_min_fraction=0.01)}
    tcfgs = {k: TrainConfig(learning_rate=LEARNING_RATE,
                            pos_weight=POS_WEIGHT, **kw)
             for k, kw in schedules.items()}

    def pair(model, tcfg, **kw):
        return lambda: tuple(Trainer(variant_of(model, device), tcfg, **kw)
                             for _ in range(2))

    fused = {name: scan_check(f"fused bf16, {name} rate", pair(base, tcfg),
                              graphs)
             for name, tcfg in tcfgs.items()}
    launches = fused["constant"]["launches"]
    want = fused_step_counts(SCAN_STEPS)
    print(f"  {tag} launches of one {SCAN_STEPS}-step replay: {launches}",
          flush=True)
    if launches != want:
        fail(f"scan: the {SCAN_STEPS}-step replay launched {launches}, "
             f"expected {want}")
    if fused["cosine"]["launches"] != want:
        fail("scan: the cosine-rate replay launched other kernels")
    cos = fused["cosine"]["trainer"]
    rate = cos.optimizer.param_groups[0]["lr"].item()
    print(f"  {tag} cosine rate after {2 * SCAN_STEPS} steps: {rate:.6e} "
          f"on the device, {cos.scheduler.rate():.6e} on the host (step "
          f"{cos.scheduler.last_epoch})", flush=True)
    if cos.scheduler.last_epoch != 2 * SCAN_STEPS or \
            abs(rate - cos.scheduler.rate()) > 1e-6 * cos.scheduler.rate():
        fail("scan: the device's cosine rate and step count left the host's")

    short = graphs[:SCAN_SHORT_STEPS]
    scan_check(f"unfused bf16, K = {SCAN_SHORT_STEPS}",
               pair(variant_of(base, device, fused_iteration=False),
                    tcfgs["cosine"]), short)
    sectors = [make_sector_batch(seed, device) for seed in range(N_REQUESTS)]
    from gnn_fpga_tpu_torch.core.capture import signature
    sectors = [b for b in sectors
               if signature(b) == signature(sectors[0])]
    blocked = mpnn.init_segment_classifier(
        dataclasses.replace(cfg, aggregation="blocked"),
        torch.Generator().manual_seed(14), device=device)
    scan_check(f"blocked bf16, K = {SCAN_SHORT_STEPS}",
               pair(blocked, tcfgs["cosine"]),
               [sectors[i % len(sectors)] for i in range(SCAN_SHORT_STEPS)])
    multihost.initialize_single("nccl")
    gmesh = mesh_lib.make_mesh(axis_names=(mesh_lib.GRAPH_AXIS,),
                               device=device.type)
    pgs = [pg.to(device) for pg in partition_all(short, 1)]
    part = scan_check(
        f"partitioned P = 1 ({dist.get_backend()}) fused bf16, K = "
        f"{SCAN_SHORT_STEPS}",
        pair(base, tcfgs["cosine"], strategy="partitioned", mesh=gmesh), pgs)
    if part["launches"] != fused_step_counts(SCAN_SHORT_STEPS):
        fail(f"scan: the partitioned {SCAN_SHORT_STEPS}-step replay "
             f"launched {part['launches']}")
    dist.destroy_process_group()

    # --- timing, the stack's copy, idle share, FLOP accounting
    run = fused["constant"]
    stacked, stack = run["trainer"], run["stack"]
    ms = time_stacked(f"fused bf16 {SCAN_STEPS}-step", stacked, stack,
                      run["one_step"], graphs)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(5):
        run["call"].load(stack)
    end.record()
    torch.cuda.synchronize()
    print(f"  {tag} copying the {tensor_bytes(stack) / 1e6:.1f} MB stack into "
          f"the capture's buffers: {start.elapsed_time(end) / 5:.3f} ms a "
          f"call (CUDA events over 5 copies)", flush=True)
    _, busy = profiled(lambda: stacked.run_steps(stack), profile_path and (
        profile_path, f"one {SCAN_STEPS}-step replay of the stacked fused "
        f"bf16 step"))
    busy_ms = busy / SCAN_STEPS
    n_node = sum(float(g.node_mask.sum()) for g in graphs) / len(graphs)
    n_edge = sum(float(g.edge_mask.sum()) for g in graphs) / len(graphs)
    useful = flops.train_step_flops(flops.segment_classifier_flops(
        n_node, n_edge, HIDDEN, N_ITERS, INPUT_DIM))
    rate = useful / (ms / 1e3)
    mfu = flops.mfu(rate)
    att, bound, t_tensor, t_f32, t_bytes = flops.attainable(
        useful, *flops.fused_step_cost(N_EDGE, N_NODE, HIDDEN,
                                       HIDDEN + INPUT_DIM, N_ITERS))
    if mfu is None or att is None:
        fail(f"scan: utils/flops.py has no peaks for "
             f"{torch.cuda.get_device_name(0)}")
    print(f"  {tag} stacked fused bf16 step: device time {busy_ms:.4f} ms "
          f"(torch.profiler over one {SCAN_STEPS}-step replay), wall "
          f"{ms:.4f} ms with the profiler off: device idle "
          f"{1 - busy_ms / ms:.1%}; {n_edge / (ms / 1e3):.4e} real edges/s; "
          f"useful {useful / 1e9:.3f} GFLOP a step, {rate / 1e12:.3f} "
          f"TFLOP/s, MFU {mfu:.4%} of {flops.chip_peak_tflops():g} TFLOP/s "
          f"bf16; attainable MFU {att:.2%} ({bound}-bound: tensor "
          f"{t_tensor * 1e3:.4f} ms, f32 {t_f32 * 1e3:.4f} ms, bytes "
          f"{t_bytes * 1e3:.4f} ms a step)", flush=True)
    return launches


# ---------------------------------------------------------------------------
# The parallel phase: graph and data parallelism (gnn_fpga_tpu_torch/parallel)
# ---------------------------------------------------------------------------

def partition_all(graphs, n_parts: int) -> list:
    """``graphs`` (the packed requests) partitioned into ``n_parts``
    receiver-owned shards with plans, pinned to one edge count, halo size
    and plan capacity, as the train CLI pins a dataset's: one static
    signature for the captured steps."""
    from gnn_fpga_tpu_torch.ops.cuda import spmm
    from gnn_fpga_tpu_torch.parallel import partition as part

    cpu = [g.replace(plans=None).to("cpu") for g in graphs]
    free = [part.partition_graph(g, n_parts, plans=True) for g in cpu]
    pins = dict(edge_capacity=max(pg.senders.shape[1] for pg in free),
                halo_capacity=max(pg.halo_size for pg in free))
    cap = part.shard_capacity(*(part.partition_graph(
        g, n_parts, plans=True, **pins) for g in cpu))
    return [part.partition_graph(g, n_parts, plans=True, capacity=cap,
                                 **pins) for g in cpu]


def halo_needs(pg) -> list:
    """``[p][q]``: the distinct rows shard ``p``'s real edges pull from
    shard ``q`` (the padded halo is ``pg.halo_size`` a pair)."""
    s = pg.halo_size
    out = []
    for p in range(pg.n_parts):
        ext = pg.senders_ext[p][pg.edge_mask[p] > 0]
        out.append([int(torch.unique(ext[(ext >= pg.n_local + q * s)
                                         & (ext < pg.n_local + (q + 1) * s)]
                                     ).numel()) for q in range(pg.n_parts)])
    return out


def check_partitioned(label, probs, grads, ref_probs, ref_grads) -> tuple:
    """bf16 probabilities and summed gradients of the sharded route
    against its sparse reference (PERF.md section 2's bounds); returns the
    readings."""
    diff = (probs - ref_probs).abs()
    worst_max, worst_mean = diff.max().item(), diff.mean().item()
    reading, name = grad_reading(grads, ref_grads, torch.bfloat16)
    ok = (worst_max <= BF16_PROB_MAX_ABS and worst_mean <= BF16_PROB_MEAN_ABS
          and reading <= BF16_GRAD_REL and torch.isfinite(probs).all())
    print(f"  {label}: bf16 probs vs sparse route max|dp|={worst_max:.3e} "
          f"(tol {BF16_PROB_MAX_ABS:g}) mean|dp|={worst_mean:.3e} (tol "
          f"{BF16_PROB_MEAN_ABS:g}); grads ||err|| / ||ref|| {reading:.3e} "
          f"(most from {name}; tol {BF16_GRAD_REL:g}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"parallel: {label} disagrees with the sparse route")
    return worst_max, reading


def sharded_grads(model, shard, comm):
    """Parameter gradients of the partitioned loss, summed over ``comm``."""
    from gnn_fpga_tpu_torch.parallel import data_parallel as dp
    from gnn_fpga_tpu_torch.parallel import partition as part

    model.zero_grad(set_to_none=True)
    objective, _ = part.sharded_loss(model, shard, comm,
                                     pos_weight=POS_WEIGHT)
    objective.backward()
    dp.sum_gradients(model.parameters(), comm)
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _loss_curve(losses, what) -> None:
    k = max(1, len(losses) // 4)
    first, last = sum(losses[:k]) / k, sum(losses[-k:]) / k
    print(f"  {what} losses: {' '.join(f'{x:.4f}' for x in losses)}; "
          f"mean of the first {k} {first:.4f}, of the last {k} {last:.4f}",
          flush=True)
    if not torch.isfinite(torch.tensor(losses)).all():
        fail(f"parallel: a {what} loss is not finite")
    if not last < first:
        fail(f"parallel: the {what} loss did not fall")


def dp_batches(device) -> list:
    """DP_STEPS batches of 36 fullevent sectors (bench.py's "b36", the
    blocks dropped: the dense route)."""
    return [make_sector_batch(seed, "cpu").replace(blocks=None).to(device)
            for seed in range(DP_STEPS)]


def phase_parallel(device, graphs, unpadded, profile_path=None) -> dict:
    """Graph and data parallelism on the card: P = 1 over NCCL in this
    process (the captured partitioned step with its collectives, its
    eval loss and predict, checked and timed against the single-device
    step; dp against single), then P = 2 and 4 over gloo in ranks spawned
    on the one card (:func:`run_parallel_world`).  Returns the kernel
    launches of its main path: the captured steps here and the ranks'
    eager steps."""
    import torch.distributed as dist

    from gnn_fpga_tpu_torch.models import mpnn
    from gnn_fpga_tpu_torch.ops.cuda import spmm
    from gnn_fpga_tpu_torch.parallel import mesh as mesh_lib
    from gnn_fpga_tpu_torch.parallel import multihost
    from gnn_fpga_tpu_torch.parallel import partition as part
    from gnn_fpga_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                                  stack_batches)

    tag = f"[{card()}]"
    multihost.initialize_single("nccl")
    gmesh = mesh_lib.make_mesh(axis_names=(mesh_lib.GRAPH_AXIS,))
    comm = part.graph_comm(gmesh)
    t = time.perf_counter()
    pgs = [pg.to(device) for pg in partition_all(unpadded, 1)]
    pg = pgs[0]
    it = pg.shard(0).plans.items
    print(f"parallel: world of 1 ({dist.get_backend()}); {N_REQUESTS} "
          f"packed graphs partitioned in {time.perf_counter() - t:.2f} s: "
          f"{pg.n_local} local rows + {pg.send_idx.shape[1]} halo slots, "
          f"{pg.senders.shape[1]} edges a shard, plans padded to "
          f"{it.n_recv} + {it.n_item - it.n_recv} items", flush=True)
    cfg = mpnn.SegmentClassifierConfig(
        input_dim=INPUT_DIM, hidden_dim=HIDDEN, n_iters=N_ITERS,
        compute_dtype=torch.bfloat16, aggregation="pallas")
    model = mpnn.init_segment_classifier(
        cfg, torch.Generator().manual_seed(11), device=device)
    ref, at = sparse_reference(model, device, torch.bfloat16)
    for label, kw in (("fused", {}), ("unfused",
                                      dict(fused_iteration=False))):
        m = variant_of(model, device, **kw)
        for i in range(2):
            g, shard = unpadded[i], pgs[i].shard(0)
            em = g.edge_mask > 0
            n_real = int(em.sum())
            with torch.no_grad():
                probs = torch.sigmoid(part.sharded_logits(m, shard, comm))
                want = torch.sigmoid(ref(at(g)))[em]
            check_partitioned(f"P = 1 {label}, graph {i}", probs[:n_real],
                              sharded_grads(m, shard, comm), want,
                              _grads(ref, at(g), "edge", POS_WEIGHT))

    tcfg = TrainConfig(learning_rate=LEARNING_RATE, pos_weight=POS_WEIGHT)
    trainer = Trainer(variant_of(model, device), tcfg,
                      strategy="partitioned", mesh=gmesh)
    unfused = Trainer(variant_of(model, device, fused_iteration=False),
                      tcfg, strategy="partitioned", mesh=gmesh)
    dmesh = mesh_lib.make_mesh(axis_names=(mesh_lib.DATA_AXIS,))
    dense = mpnn.init_segment_classifier(
        dataclasses.replace(cfg, aggregation="dense"),
        torch.Generator().manual_seed(12), device=device)
    dp_trainer = Trainer(variant_of(dense, device), tcfg, strategy="dp",
                         mesh=dmesh)
    batches = dp_batches(device)
    spmm.reset_launch_counts()
    # --- the main path: 32 captured partitioned steps, unfused steps, dp
    losses, step_ms = [], []
    for i in range(N_STEPS):
        t = time.perf_counter()
        losses.append(float(trainer.run_steps([pgs[i % N_REQUESTS]])[0]))
        step_ms.append((time.perf_counter() - t) * 1e3)
    fused_counts = launch_counts()
    unfused_losses = [float(x) for x in unfused.run_steps(
        [pgs[i % N_REQUESTS] for i in range(N_PART_UNFUSED_STEPS)])]
    unfused_counts = {k: v - fused_counts[k]
                      for k, v in launch_counts().items()}
    # the 5-step graph run twice: eagerly (and captured), then replayed
    dp_stack = stack_batches(batches)
    dp_losses = torch.cat([torch.from_numpy(dp_trainer.run_steps(dp_stack))
                           for _ in range(2)])
    launches = launch_counts()
    # --- checks (not counted)
    per_step = {k: v / N_STEPS for k, v in fused_counts.items()}
    per_unfused = {k: v / N_PART_UNFUSED_STEPS
                   for k, v in unfused_counts.items()}
    print(f"  launches per partitioned step: fused {per_step}; unfused "
          f"{per_unfused}", flush=True)
    if per_step != fused_step_counts():
        fail(f"parallel: the partitioned steps launched {per_step} a step")
    if per_unfused != expected_counts(gather_pair=N_ITERS + 1,
                                      gather_pair_bwd=N_ITERS + 1,
                                      aggregate_pair=N_ITERS,
                                      aggregate_pair_bwd=N_ITERS):
        fail(f"parallel: the unfused partitioned steps launched "
             f"{per_unfused} a step")
    _loss_curve(losses, "P = 1 captured partitioned")
    if not all(map(math.isfinite, unfused_losses)):
        fail("parallel: an unfused partitioned loss is not finite")
    single_tr = Trainer(variant_of(dense, device), tcfg)
    single = torch.cat([torch.from_numpy(single_tr.run_steps(dp_stack))
                        for _ in range(2)])
    print(f"  dp (world of 1) losses {' '.join(f'{x:.6f}' for x in dp_losses)}"
          f"; single {' '.join(f'{x:.6f}' for x in single)}", flush=True)
    compare("dp losses (world of 1) vs single", dp_losses, single,
            CAPTURE_RTOL, 0.0)
    vloss = [trainer._eval_loss(pgs[0]) for _ in range(2)]
    probs, _, _ = trainer.predict(iter(pgs[:2]), 2)
    kinds = sorted({k for k, _ in trainer._captured})
    print(f"  captured calls of the partitioned Trainer: {kinds} (one "
          f"signature each: {len(trainer._captured)}); eval loss "
          f"{vloss[0]:.6f}, replayed {vloss[1]:.6f}", flush=True)
    if kinds != ["eval", "predict", "train"] or len(trainer._captured) != 3:
        fail("parallel: the partitioned step, eval loss and predict were "
             "not each captured once")
    if vloss[0] != vloss[1] or not math.isfinite(vloss[0]) \
            or not torch.isfinite(torch.from_numpy(probs)).all():
        fail("parallel: the captured eval loss or predict is malformed")

    # --- P = 1 partitioned step against the single-device fused step
    fused_single = Trainer(variant_of(model, device), tcfg)
    fused_single.run_steps(graphs[:1])
    runs = {"partitioned P = 1": (trainer, stack_batches([pgs[0]] * 20)),
            "single device": (fused_single,
                              stack_batches(graphs[:1] * 20))}
    for tr, stack in runs.values():           # eager and captured first
        tr.run_steps(stack)
    times = {label: [] for label in runs}
    for _ in range(2):
        for label, (tr, stack) in runs.items():
            t = time.perf_counter()
            tr.run_steps(stack)
            times[label].append((time.perf_counter() - t) / 20 * 1e3)
    print(f"  {tag} fused bf16 train step, a 20-step graph replayed with "
          f"one readback, twice in turns: " + "; ".join(
              f"{k} {' / '.join(f'{x:.3f}' for x in v)} ms"
              for k, v in times.items())
          + f"; first partitioned steps {step_times(step_ms)}", flush=True)
    for label, run in (
            ("partitioned P = 1",
             lambda: one_step_calls(trainer, [pgs[0]] * 3)),
            ("single device",
             lambda: one_step_calls(fused_single, graphs[:1] * 3))):
        wall, busy = profiled(run, profile_path and (
            profile_path, f"3 replayed {label} fused bf16 train steps"))
        print(f"  {tag} {label} step, replayed: device time {busy / 3:.3f} "
              f"ms (torch.profiler over 3 replays; wall {wall / 3:.3f} ms "
              f"with the profiler on)", flush=True)
    dist.destroy_process_group()

    for world in PARALLEL_WORLDS:
        rank_launches = run_parallel_world(world, device, model, unpadded[0],
                                           dense, batches)
        launches = {k: launches[k] + rank_launches[k] for k in launches}
    return launches


def halo_event():
    """The halo check's graph (HALO_EVENT_TRACKS), on the host, no plans."""
    from gnn_fpga_tpu_torch.core import graph as G
    from gnn_fpga_tpu_torch.data import toy2d

    cfg = toy2d.Toy2DConfig(n_layers=N_LAYERS, n_tracks=HALO_EVENT_TRACKS,
                            seed=0)
    return G.unbatch_graphs(toy2d.make_knn_segment_graphs(cfg, 1, k=K_NN))[0]


def run_parallel_world(world, device, model, g, dense, batches) -> dict:
    """P = ``world`` ranks on the one card over gloo, spawned: each shard's
    logits gathered and the summed gradients against the sparse
    reference; on :func:`halo_event`, whose shards exchange real halos,
    the f32 fused route's probabilities of the edges that read halo rows
    and its summed gradients against the single-device fused route;
    PARALLEL_STEPS eager steps (finite, falling, the weights identical on
    every rank), and with 2 ranks a dp run against the single device, in
    f32.  Times are printed labelled: several ranks share one card, so
    they measure the mechanics, not scaling.  Returns the ranks' launches
    in their steps."""
    import tempfile

    import torch.multiprocessing as mp

    from gnn_fpga_tpu_torch.core import graph as G
    from gnn_fpga_tpu_torch.train.trainer import TrainConfig, Trainer

    ref, at = sparse_reference(model, device, torch.bfloat16)
    em = g.edge_mask > 0
    with torch.no_grad():
        ref_probs = torch.sigmoid(ref(at(g)))[em].cpu()
        single_probs = torch.sigmoid(model(g))[em].float().cpu()
    ref_grads = {k: v.cpu()
                 for k, v in _grads(ref, at(g), "edge", POS_WEIGHT).items()}
    event = halo_event()
    m32, on_card = (variant_of(model, device, compute_dtype=None),
                    G.attach_plans(event).to(device))
    with torch.no_grad():
        event_probs = torch.sigmoid(m32(on_card)).cpu()
    event_grads = {k: v.cpu() for k, v in
                   _grads(m32, on_card, "edge", POS_WEIGHT).items()}
    tcfg = dict(learning_rate=LEARNING_RATE, pos_weight=POS_WEIGHT)
    f32 = variant_of(dense, device, compute_dtype=None)
    inputs = dict(graph=g.replace(plans=None).to("cpu"), event=event,
                  tcfg=tcfg,
                  state={k: v.cpu() for k, v in model.state_dict().items()},
                  cfg=dataclasses.asdict(model.cfg) | {"activation": None},
                  device=device.type, dp=None)
    if world == 2:
        single = Trainer(variant_of(f32, device), TrainConfig(**tcfg),
                         capture=False).run_steps(batches)
        inputs["dp"] = dict(
            state={k: v.cpu() for k, v in f32.state_dict().items()},
            batches=[b.to("cpu") for b in batches])
    with tempfile.TemporaryDirectory() as d:
        torch.save(inputs, f"{d}/inputs.pt")
        ctx = mp.get_context("spawn")
        t = time.perf_counter()
        procs = [ctx.Process(target=parallel_rank, args=(r, world, d))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(PARALLEL_RANK_TIMEOUT_S)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errors = [Path(f"{d}/error_{r}.txt").read_text()
                  for r in range(world) if os.path.exists(f"{d}/error_{r}.txt")]
        if errors or any(p.exitcode != 0 for p in procs):
            fail(f"parallel: a rank of the {world}-rank world failed:\n"
                 + "\n".join(errors))
        outs = [torch.load(f"{d}/out_{r}.pt", weights_only=False)
                for r in range(world)]
    wall = time.perf_counter() - t
    o = outs[0]
    print(f"parallel: {world} ranks on one card over gloo ([{card()}] "
          f"{wall:.1f} s with the spawn; gloo took the CUDA tensors); "
          f"packed graph: halo size a pair {o['halo']} (padded), rows pulled [p][q] "
          f"{o['needs']}; {o['n_local']} local rows, {o['n_edge']} edges a "
          f"shard", flush=True)
    probs = o["probs"][o["edge_mask"] > 0]
    check_partitioned(f"P = {world} fused", probs, o["grads"], ref_probs,
                      ref_grads)
    print(f"  P = {world} fused bf16 vs the single-device fused route: "
          f"max|dp|={(probs - single_probs).abs().max().item():.3e}",
          flush=True)
    check_halo_event(world, o, event, event_probs, event_grads)
    for r, other in enumerate(outs[1:], 1):
        if other["losses"] != o["losses"] or not torch.equal(
                other["params"], o["params"]):
            fail(f"parallel: rank {r} of {world} differs from rank 0 in its "
                 "losses or weights")
    _loss_curve(o["losses"], f"P = {world} eager partitioned")
    print(f"  losses and weights identical on all {world} ranks; "
          f"[{card()}] eager step {' / '.join(f'{x:.2f}' for x in o['step_ms'])}"
          f" ms on rank 0 ({world} ranks sharing one card under gloo: "
          f"mechanics only, no scaling measured)", flush=True)
    if o["dp_losses"] is not None:
        print(f"  dp, 2 ranks, f32: losses "
              f"{' '.join(f'{x:.6f}' for x in o['dp_losses'])}; single "
              f"{' '.join(f'{x:.6f}' for x in single)}", flush=True)
        compare("dp losses (2 ranks) vs single", torch.tensor(o["dp_losses"]),
                torch.from_numpy(single), CAPTURE_RTOL, 0.0)
    counts = {k: sum(out["launches"][k] for out in outs)
              for k in o["launches"]}
    steps = PARALLEL_STEPS * world
    expect = fused_step_counts(steps)
    if counts != expect:
        fail(f"parallel: the {world} ranks' steps launched {counts}, "
             f"expected {expect}")
    return counts


def check_halo_event(world, o, event, want_probs, want_grads) -> None:
    """The gloo world's f32 fused route on :func:`halo_event` (rank 0's
    output ``o``) against the single-device fused route: the
    probabilities of the edges whose sender is a halo row, every edge's,
    and the summed parameter gradients elementwise."""
    n_local, real = o["event_n_local"], o["event_edge_mask"] > 0
    em = event.edge_mask > 0
    # the shards' real edges, concatenated, are the graph's in the order
    # of their receivers' shards
    order = torch.sort(event.receivers[em] // n_local, stable=True).indices
    want = want_probs[em][order]
    got = o["event_probs"][real]
    reads_halo = (o["event_senders_ext"] >= n_local)[real]
    print(f"  halo event ({event.n_node} rows, {int(em.sum())} edges): "
          f"{n_local} local rows a shard, halo size a pair "
          f"{o['event_halo']} (padded), rows pulled [p][q] "
          f"{o['event_needs']}; {int(reads_halo.sum())} edges read a halo "
          f"row", flush=True)
    if not reads_halo.any():
        fail(f"parallel: no edge of the {world}-way halo event reads a "
             "halo row")
    compare(f"P = {world} f32 fused, halo-reading edges' probs vs the "
            f"single-device fused route", got[reads_halo], want[reads_halo],
            *SHARD_F32_PROB_TOL)
    compare(f"P = {world} f32 fused, every edge's probs vs the "
            f"single-device fused route", got, want, *SHARD_F32_PROB_TOL)
    reading, name = grad_reading(o["event_grads"], want_grads, None)
    ok = reading <= 1.0
    print(f"  P = {world} f32 fused, summed gradients vs the single-device "
          f"fused route: max |err| / (atol + rtol |ref|) = {reading:.3e} "
          f"(most in {name}; at most 1 within rtol {F32_GRAD_TOL[0]:g}, "
          f"atol {F32_GRAD_TOL[1]:g}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"parallel: the {world}-way halo event's gradients disagree "
             "with the single-device route")


def parallel_rank(rank: int, world: int, directory: str) -> None:
    """One rank of :func:`run_parallel_world` (a spawned process): joins a
    gloo group on the one card and writes its results."""
    import datetime
    import traceback

    import torch.distributed as dist

    inputs = torch.load(f"{directory}/inputs.pt", weights_only=False)
    if inputs["device"] == "cuda":
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{directory}/rendezvous", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        out = parallel_rank_work(rank, world, inputs)
        torch.save(out, f"{directory}/out_{rank}.pt")
    except BaseException:
        with open(f"{directory}/error_{rank}.txt", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def parallel_rank_work(rank, world, inputs) -> dict:
    from gnn_fpga_tpu_torch.models import mpnn
    from gnn_fpga_tpu_torch.ops.cuda import spmm
    from gnn_fpga_tpu_torch.parallel import mesh as mesh_lib
    from gnn_fpga_tpu_torch.parallel import partition as part
    from gnn_fpga_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                                  stack_batches)

    device = torch.device(inputs["device"])
    gmesh = mesh_lib.make_mesh(axis_names=(mesh_lib.GRAPH_AXIS,),
                               device=device.type)
    comm = part.graph_comm(gmesh)
    cfg = mpnn.SegmentClassifierConfig(**(inputs["cfg"]
                                          | {"activation": torch.tanh}))

    def fresh(state, c=cfg):
        m = mpnn.init_segment_classifier(c, torch.Generator(), device=device)
        m.load_state_dict(state)
        return m

    pg = part.partition_graph(inputs["graph"], world, plans=True)
    shard = pg.shard(rank).to(device)
    # the Trainer takes the whole partitioned graph, each rank its shard
    steps = stack_batches([pg], device)
    model = fresh(inputs["state"])
    with torch.no_grad():
        probs = comm.all_gather(torch.sigmoid(
            part.sharded_logits(model, shard, comm)))
    grads = sharded_grads(model, shard, comm)
    ev = part.partition_graph(inputs["event"], world, plans=True)
    ev_shard = ev.shard(rank).to(device)
    m32 = fresh(inputs["state"], dataclasses.replace(cfg, compute_dtype=None))
    with torch.no_grad():
        ev_probs = comm.all_gather(torch.sigmoid(
            part.sharded_logits(m32, ev_shard, comm)))
    ev_grads = sharded_grads(m32, ev_shard, comm)
    tcfg = TrainConfig(**inputs["tcfg"])
    trainer = Trainer(fresh(inputs["state"]), tcfg, strategy="partitioned",
                      mesh=gmesh, capture=False)
    spmm.reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(PARALLEL_STEPS):
        t = time.perf_counter()
        losses.append(float(trainer.run_steps(steps)[0]))
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = launch_counts()
    dp_losses = None
    if inputs["dp"] is not None:
        dmesh = mesh_lib.make_mesh(axis_names=(mesh_lib.DATA_AXIS,),
                                   device=device.type)
        dcfg = dataclasses.replace(cfg, aggregation="dense",
                                   compute_dtype=None)
        dp = Trainer(fresh(inputs["dp"]["state"], dcfg), tcfg, strategy="dp",
                     mesh=dmesh, capture=False)
        dp_losses = [float(x) for x in dp.run_steps(inputs["dp"]["batches"])]
    return dict(
        probs=probs.float().cpu(), edge_mask=pg.edge_mask,
        grads={k: v.cpu() for k, v in grads.items()}, losses=losses,
        params=params_of(trainer.model).cpu(),
        step_ms=step_ms, launches=launches,
        halo=pg.halo_size, needs=halo_needs(pg), n_local=pg.n_local,
        n_edge=pg.senders.shape[1], dp_losses=dp_losses,
        event_probs=ev_probs.cpu(), event_edge_mask=ev.edge_mask,
        event_senders_ext=ev.senders_ext, event_n_local=ev.n_local,
        event_halo=ev.halo_size, event_needs=halo_needs(ev),
        event_grads={k: v.cpu() for k, v in ev_grads.items()})


# ---------------------------------------------------------------------------
# The probe_steps phase: the measurement modules (gnn_fpga_tpu_torch/probes)
# ---------------------------------------------------------------------------

def check_doublet_step(device) -> None:
    """One fused step of the doublet probe's model (its initial weights)
    on its first packed doublet batch (D = 3 + 64, an odd width), held
    against the :func:`sparse_reference`: the bf16 probabilities of the
    real edges within BF16_PROB_MAX_ABS and BF16_PROB_MEAN_ABS, the
    gradients in f32 and bf16 as :func:`check_gradients` holds them."""
    from gnn_fpga_tpu_torch.probes import common, doublets

    batches, *_ = doublets.prepare(PROBE_DOUBLET_EVENTS, 8, 400, device)
    g = batches[0].to(device)
    model = common.segment_classifier(doublets.model_config("pallas"),
                                      device)
    sparse, at = sparse_reference(model, device, torch.bfloat16)
    mask = g.edge_mask > 0
    n_real = int(mask.sum())
    print(f"  doublet batch: {g.n_node} nodes, {g.n_edge} edges "
          f"({n_real} real)", flush=True)
    with torch.no_grad():
        p = torch.sigmoid(model(g))[mask]
        ps = torch.sigmoid(sparse(at(g)))[mask]
    check_served([(p, 0.0)], [(ps, 0.0)], n_real, "probes.doublets")
    purity = float(g.y[mask].sum()) / n_real
    check_gradients(model, [g], device,
                    {"fused": dict(fused_iteration=True)},
                    pos_weight=max((1 - purity) / purity, 1.0))


def phase_probe_steps(device) -> dict:
    """The five measurement modules at full width and cut depth, each
    checked and its readings printed (their gates run in their own full
    runs):

    - ``probes.blocked``: the sector scale (bench.py's mu200 config) at
      PROBE_BLOCKED_STEPS steps on the dense, blocked (g = 1, 2, 4) and
      sparse routes, each route's step timed with its device time and
      idle share; no hand-written kernel launched;
    - ``probes.spmm``: the layered graph at the TPU probe's defaults, f32
      and bf16, PROBE_SPMM_CALLS chained calls a row; every kernel row
      (forward, and the fwd+bwd rows' gradients) against its plain
      version at KERNEL_TOL (``probes.spmm.checks``); #2, #4-#9 launched;
    - ``probes.doublets``: PROBE_DOUBLET_EVENTS events a step, 2 epochs
      of the fused route in bf16 and one of the sparse route on the
      doublet graphs (the cross-join kernel once a sector graph); finite
      record, the fused route's kernels launched; one fused step on the
      first packed batch against the sparse route
      (:func:`check_doublet_step`);
    - ``probes.windowcut``: the full 256-step stack captured in one graph
      (its cost printed) and one timed epoch;
    - ``probes.scaling``: dp and partitioned at P = 1, one spawned rank
      over NCCL each, the two at once, not marked mechanics only.

    Returns the launches of the whole phase, the checks' taken back."""
    from gnn_fpga_tpu_torch.ops.cuda import spmm
    from gnn_fpga_tpu_torch.probes import (blocked, doublets, scaling,
                                           windowcut)
    from gnn_fpga_tpu_torch.probes import spmm as spmm_probe

    tag = f"[{card()}]"
    t_phase = t_lap = time.perf_counter()

    def lap(what):
        nonlocal t_lap
        now = time.perf_counter()
        print(f"  {what}: {now - t_lap:.1f} s", flush=True)
        t_lap = now

    spmm.reset_launch_counts()
    n_layers, n_tracks, batch, _, dense = blocked.SCALES["sector"]
    print(f"probe_steps: probes.blocked, sector scale, {PROBE_BLOCKED_STEPS} "
          f"steps a stack, on {tag}", flush=True)
    routes = blocked.run_scale("sector", n_layers, n_tracks, blocked.HIDDEN,
                               blocked.N_ITERS, PROBE_BLOCKED_STEPS, batch,
                               [1, 2, 4], with_dense=dense, device=device)
    for label, rec in routes.items():
        if not math.isfinite(rec["loss"]) or rec["ms_per_step"] <= 0:
            fail(f"probe_steps: blocked probe, {label}: {rec}")
    if launch_counts() != expected_counts():
        fail(f"probe_steps: the dense, blocked or sparse route launched a "
             f"hand-written kernel: {launch_counts()}")
    lap("probes.blocked")

    for dt in (torch.float32, torch.bfloat16):
        out = spmm_probe.run(spmm_probe.V, spmm_probe.E, spmm_probe.D, dt,
                             device, n_iters=PROBE_SPMM_CALLS)
        if not all(math.isfinite(t) and t > 0 for k, t in out.items()
                   if k != "max_abs_err"):
            fail(f"probe_steps: probes.spmm {dt}: {out}")
        with uncounted():       # every kernel row against its plain one
            args = spmm_probe.inputs(spmm_probe.V, spmm_probe.E,
                                     spmm_probe.D, dt, device)
            dname = str(dt).replace("torch.", "")
            for row, (kern, plain, sides) in spmm_probe.checks(
                    *args).items():
                hold(f"probe_steps: probes.spmm {dname} {row}", kern, plain,
                     sides, dt)
    spmm_kernels = ("aggregate_pair", "aggregate_pair_bwd", "gather_pair",
                    "gather_pair_bwd", "spmm", "sddmm", "sddmm_dual")
    counts = launch_counts()
    if any(counts[k] == 0 for k in spmm_kernels):
        fail(f"probe_steps: probes.spmm left a kernel unlaunched: {counts}")
    lap("probes.spmm and its checks")

    print(f"probe_steps: probes.doublets, {PROBE_DOUBLET_EVENTS} events a "
          f"step, 2 epochs, no gate, on {tag}", flush=True)
    before = launch_counts()
    rec = doublets.main(["--events-per-step", str(PROBE_DOUBLET_EVENTS),
                         "--epochs", "2", "--no-auc"])
    after = launch_counts()
    if not (math.isfinite(rec["final_loss"]) and rec["vs_baseline"] > 0
            and rec["mfu"] is not None):
        fail(f"probe_steps: doublets record malformed: {rec}")
    for k in ("select_segments", "iteration_pair", "iteration_pair_bwd",
              "gather_pair", "gather_pair_bwd"):
        if after[k] == before[k]:
            fail(f"probe_steps: probes.doublets launched no {k}")
    with uncounted():
        check_doublet_step(device)
    lap("probes.doublets and its check")

    print(f"probe_steps: probes.windowcut, the 256-step stack, one timed "
          f"epoch, on {tag}", flush=True)
    _, fields = windowcut.train(2, 2 ** 14, 64, device)
    print(f"  {tag} windowcut: {fields['steps_per_epoch']} steps an epoch "
          f"in {fields['calls_per_epoch']} call(s): eager first call "
          f"{fields['eager_s']:.3f} s, capture {fields['capture_s']:.3f} s, "
          f"capture end and instantiation {fields['instantiate_s']:.3f} s, "
          f"memory beyond the inputs "
          f"{fields['memory_beyond_inputs_mib']:.1f} MiB; replayed "
          f"{fields['ms_per_step']:.4f} ms a step, "
          f"{fields['value']:.4e} edges/s, MFU {fields['mfu']:.4%}, loss "
          f"{fields['final_loss']:.4f}", flush=True)
    if not math.isfinite(fields["final_loss"]):
        fail("probe_steps: windowcut loss not finite")
    lap("probes.windowcut")

    # the two one-rank worlds start and run at once (most of their time is
    # the spawned processes' start): their rates share the card
    with ThreadPoolExecutor(2) as pool:
        runs = {mode: pool.submit(scaling.run_mode, mode, [1], n_steps=30,
                                  hidden=32, n_iters=4, n_tracks=16,
                                  batch=4, device=device)
                for mode in ("dp", "partitioned")}
    for mode, run in runs.items():
        res = run.result()[1]
        print(f"  {tag} scaling {mode}, P = 1 ({res['backend']}, both "
              f"modes at once): {res['edges_per_s']:.4e} edges/s",
              flush=True)
        if res["backend"] != "nccl" or res["mechanics_only"] or \
                not res["edges_per_s"] > 0:
            fail(f"probe_steps: scaling {mode} at P = 1: {res}")
    lap("probes.scaling")
    launches = launch_counts()
    print(f"probe_steps: done in {time.perf_counter() - t_phase:.1f} s, "
          f"launches {launches}", flush=True)
    return launches


def profiled(run, table_to=None) -> tuple:
    """``(wall ms, device busy ms)`` of ``run()`` under torch.profiler
    (``probes/common.py::profiled``); ``table_to``: ``(path, what)``
    appends the profiler's table to ``path``."""
    from gnn_fpga_tpu_torch.probes import common

    wall_ms, busy_ms, table = common.profiled(run)
    if table_to:
        path, what = table_to
        with open(path, "a") as f:
            f.write(f"==== {what}: wall {wall_ms:.3f} ms, device busy "
                    f"{busy_ms:.3f} ms ====\n")
            f.write(table.table(sort_by="cuda_time_total", row_limit=40))
            f.write("\n")
        print(f"  profile: {what}, wall {wall_ms:.3f} ms, device busy "
              f"{busy_ms:.3f} ms (idle {1 - busy_ms / wall_ms:.1%}, "
              f"profiler on); table in {path}", flush=True)
    return wall_ms, busy_ms


def write_profile(path, mode, what, run):
    if mode == "w":
        open(path, "w").close()
    profiled(run, (path, what))


# The measurement phases, by name, that --phase runs alone.
MEASUREMENTS = {"kernels": phase_kernels, "iteration": phase_iteration,
                "rows": phase_rows, "stream": phase_stream,
                "probes": phase_probes}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="PATH",
                    help="also write torch.profiler tables to PATH")
    ap.add_argument("--phase", action="append",
                    choices=tuple(MEASUREMENTS) + ("prepare", "parallel",
                                                   "scan", "probe_steps",
                                                   "ign"),
                    help="run only this phase (a measurement phase on the "
                         "first packed graph, prepare, parallel, scan, "
                         "probe_steps or ign; repeatable): no result line")
    args = ap.parse_args()
    kind = phase_device()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    if args.phase:
        own = {"prepare", "parallel", "scan", "probe_steps", "ign"}
        g = make_request(0, device) if set(args.phase) - own else None
        for name in args.phase:
            unpadded = [make_request(seed, device)
                        for seed in range(N_REQUESTS)] \
                if name in ("parallel", "scan", "ign") else None
            if name == "prepare":
                phase_prepare(device)
            elif name == "ign":
                phase_ign(device, pad_to_covering(unpadded))
            elif name == "probe_steps":
                phase_probe_steps(device)
            elif name == "parallel":
                phase_parallel(device, pad_to_covering(unpadded), unpadded,
                               args.profile)
            elif name == "scan":
                phase_scan(device, unpadded, args.profile)
            else:
                MEASUREMENTS[name](g)
        return
    t0 = time.perf_counter()
    unpadded = [make_request(seed, device) for seed in range(N_REQUESTS)]
    graphs = pad_to_covering(unpadded)
    it = graphs[0].plans.items
    print(f"graphs: {N_REQUESTS} packed graphs built in "
          f"{time.perf_counter() - t0:.2f} s, plans padded to one capacity "
          f"({it.n_recv} + {it.n_item - it.n_recv} items, {it.n_split} "
          f"splits, {it.n_slot} slots)", flush=True)
    kernels = phase_kernels(graphs[0])
    phase_iteration(graphs[0])
    phase_rows(graphs[0])
    phase_stream(graphs[0])
    probe_rows = phase_probes(graphs[0])
    paths = (phase_serving(device, graphs, args.profile),
             phase_training(device, graphs, args.profile),
             phase_ops(graphs[0]), phase_blocked(device, args.profile),
             phase_unshared(device, graphs, args.profile),
             phase_node(device, args.profile), phase_cli(device),
             phase_gcn(device))
    ign_launches, ign_rows = phase_ign(device, graphs)
    kernels.update({(name, torch.bfloat16): r for name, r in ign_rows.items()})
    paths += (ign_launches,)
    phase_capture(device, graphs, unpadded)
    paths += (phase_scan(device, unpadded, args.profile),
              phase_parallel(device, graphs, unpadded, args.profile))
    prep_launches, kernels[("select_segments", torch.bfloat16)] = \
        phase_prepare(device)
    paths += (prep_launches, phase_probe_steps(device))
    rows = [dict(name=name, route="cuda", source=SOURCES[src],
                 replaces=replaces,
                 **({"also_replaces": ALSO_REPLACES[name]}
                    if name in ALSO_REPLACES else {}),
                 launches=sum(path[name] for path in paths),
                 **(probe_rows[name] if name in probe_rows
                    else kernels[(name, torch.bfloat16)]))
            for name, (src, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
