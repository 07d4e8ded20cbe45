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
   with a falling loss (no hand-written kernel).

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
step and three NodeClassifier training steps to PATH.  ``--phase NAME``
(kernels, iteration, rows or stream; repeatable) runs only those
measurement phases, on the first packed graph, and prints no result line:
copied into an older checkout, it measures that tree's kernels the same
way.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

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
           "iter_bwd": "gnn_fpga_tpu_torch/csrc/iteration_bwd.cu"}
# kernel -> (source, line of the Pallas kernel body it replaces)
KERNELS = {
    "iteration_pair": ("iter_fwd", "gnn_fpga_tpu/ops/pallas/spmm.py:1134"),
    "aggregate_pair": ("fwd", "gnn_fpga_tpu/ops/pallas/spmm.py:678"),
    "gather_pair": ("gather", "gnn_fpga_tpu/ops/pallas/spmm.py:950"),
    "iteration_pair_bwd": ("iter_bwd",
                           "gnn_fpga_tpu/ops/pallas/spmm.py:1173"),
    "aggregate_pair_bwd": ("bwd", "gnn_fpga_tpu/ops/pallas/spmm.py:806"),
    "gather_pair_bwd": ("bwd", "gnn_fpga_tpu/ops/pallas/spmm.py:967"),
    "spmm": ("fwd", "gnn_fpga_tpu/ops/pallas/spmm.py:408"),
    "sddmm": ("ops", "gnn_fpga_tpu/ops/pallas/spmm.py:496"),
    "sddmm_dual": ("ops", "gnn_fpga_tpu/ops/pallas/spmm.py:563"),
    "sorted_segment_sum": ("segsum",
                           "gnn_fpga_tpu/ops/pallas/segment_sum.py:82"),
}
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
# The H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): device
# memory, and f32 outside the tensor cores, which these kernels use.
PEAK_BYTES_PER_S, PEAK_F32_PER_S = 3.35e12, 67e12

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


def fail(msg: str):
    sys.exit(f"chip_smoke: FAILED: {msg}")


def expected_counts(**launched) -> dict:
    """Launch counts of every kernel wrapper: ``launched``, else 0."""
    return {name: launched.get(name, 0) for name in KERNELS}


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


def kernel_work(name, dt, v, e, d, hdim) -> tuple:
    """(bytes, f32 operations) that one call of kernel ``name`` must do on
    ``v`` nodes and ``e`` edges (rows read, for the segment sum) with
    tables of ``d`` and ``hdim`` columns in ``dt``: each input read once
    and each output written once (edge weights, masks and sddmm outputs
    f32, one int32 sender and receiver an edge, or the segment sum's
    offsets), and the arithmetic of the function, each edge's score once
    (a tanh or exp counted as one operation)."""
    t = torch.empty((), dtype=dt).element_size()
    tab = lambda w: v * w * t
    ids, ev = 8 * e, 4 * e
    return {
        "iteration_pair": (2 * tab(hdim) + 3 * tab(d) + ev + ids,
                           e * (6 * hdim + 4 * d + 4)),
        "aggregate_pair": (3 * tab(d) + ev + ids, 4 * e * d),
        "gather_pair": (2 * tab(hdim) + ids + e * hdim * t, e * hdim),
        "iteration_pair_bwd": (4 * tab(hdim) + 4 * tab(d) + ev + ids,
                               e * (13 * hdim + 8 * d + 8)),
        "aggregate_pair_bwd": (4 * tab(d) + 2 * ev + ids, 8 * e * d),
        "gather_pair_bwd": (e * hdim * t + ids + 2 * tab(hdim),
                            2 * e * hdim),
        "spmm": (2 * tab(d) + ev + ids, 2 * e * d),
        "sddmm": (2 * tab(d) + ids + ev, 2 * e * d),
        "sddmm_dual": (4 * tab(d) + ids + ev, 4 * e * d),
        "sorted_segment_sum": (e * d * t + 4 * (v + 1) + tab(d), e * d),
    }[name]


def bound_ms(name, dt, *shape) -> tuple:
    """The least time the card could take for :func:`kernel_work`, and
    what sets it: ``(ms, "bytes" or "operations")``."""
    nbytes, ops = kernel_work(name, dt, *shape)
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_F32_PER_S * 1e3
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
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            err = 0.0
            for side, a, b in zip(sides, got, ref):
                if name in EXACT_KERNELS:
                    err = max(err, exact(f"{name} {tag} {side}", a, b))
                    continue
                rtol, atol = KERNEL_TOL[dt]
                if side in ("dw2", "db1", "db2"):
                    atol = PARAM_SUM_ATOL[dt] * b.abs().max().item()
                elif side in F32_OUT_SIDES:  # f32 output from T inputs
                    rtol, atol = KERNEL_TOL[torch.float32]
                err = max(err, compare(f"{name} {tag} {side}", a, b, rtol,
                                       atol))
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


def print_probe_bounds():
    """The bounds of the TPU-era probe kernels under benchmarks/, not
    ported: the bytes one call moves at the probe's default shapes (inputs
    read once, outputs written once) over the card's memory rate."""
    v, e, d = 16_384, 131_072, 128
    probes = {
        # pa, pb, h, g_mi, g_mo in; dh, dpa, dpb out (H = D, f32); em,
        # sig, two ids an edge; w2, b1
        "probe_iter.py _stash_bwd": 4 * (8 * v * d + 4 * e + 2 * d),
        # bf16 h in; three f32 or int32 values an edge; the f32 rank table
        # out (V + 1 rows rounded up to 8, plus a tile of 256)
        "probe_spmm_ablate.py k_full ... k_onehot":
            2 * v * d + 12 * e + 4 * ((v + 8) // 8 * 8 + 256) * d,
        "probe_ops.py passthrough": 2 * e * d * 4,
        # ids and the f32 table in, one row an id out
        "probe_ops.py gather_kernel_builder": 4 * (e + v * d + e * d),
        "probe_bw.py passthrough": 2 * e * d * 4,
    }
    for name, nbytes in probes.items():
        print(f"  probe {name}: {nbytes} bytes, bound "
              f"{nbytes / PEAK_BYTES_PER_S * 1e3:.4f} ms (bytes)", flush=True)


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

    def check(name, what, kern, plain, counter, rtol_atol=None):
        n0 = counter.launches
        first, again = kern(), kern()
        ref = plain()
        torch.cuda.synchronize()
        if counter.launches != n0 + 2:
            fail(f"{name} {what}: {counter.launches - n0} launches counted "
                 f"for 2 calls")
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
                      lambda: ref, segment_sum.sorted_segment_sum,
                      (rtol, atol))
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
                  lambda: spmm.gather_pair_reference(pa, pb, s, r),
                  spmm.gather_pair)


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
    with torch.inference_mode():
        for m in (model, unfused, sparse):       # warm-up, not counted
            serve(m, graphs[0])
        spmm.reset_launch_counts()
        # --- the main path: 8 requests on the fused route, 1 unfused
        served = [serve(model, g) for g in graphs]
        unfused_probs, unfused_ms = serve(unfused, graphs[0])
        launches = spmm.launch_counts()
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
    print(f"  fused route: {mean_ms:.3f} ms/request (min {min(ms):.3f}, "
          f"max {max(ms):.3f}), {n_real / (mean_ms / 1e3):.4e} edges/s",
          flush=True)
    print(f"  unfused route: {unfused_ms:.3f} ms/request", flush=True)
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
    fused_counts = spmm.launch_counts()
    unfused_losses, unfused_ms = [], []
    for i in range(N_UNFUSED_STEPS):
        t = time.perf_counter()
        unfused_losses.append(
            float(unfused.run_steps([graphs[i % N_REQUESTS]])[0]))
        unfused_ms.append((time.perf_counter() - t) * 1e3)
    launches = spmm.launch_counts()
    # --- checks (not counted)
    unfused_counts = {k: (launches[k] - fused_counts[k]) / N_UNFUSED_STEPS
                      for k in launches}
    per_step = {k: v / N_STEPS for k, v in fused_counts.items()}
    print(f"  launches per fused step: {per_step}", flush=True)
    print(f"  launches per unfused step: {unfused_counts}", flush=True)
    expect_fused = expected_counts(iteration_pair=N_ITERS, gather_pair=1,
                                   iteration_pair_bwd=N_ITERS,
                                   gather_pair_bwd=1)
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
    n_real = int(graphs[0].edge_mask.sum().item())
    mean_ms = sum(step_ms) / len(step_ms)
    print(f"  fused bf16 train step: {mean_ms:.3f} ms/step (min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}, over {N_STEPS} steps, "
          f"synchronised by the loss readback), "
          f"{n_real / (mean_ms / 1e3):.4e} edges/s", flush=True)
    wall, busy = profiled(lambda: unfused.run_steps(graphs[:3]),
                          profile_path and (profile_path,
                                            "3 unfused training steps"))
    print(f"  unfused bf16 train step: "
          f"{sum(unfused_ms) / N_UNFUSED_STEPS:.3f} ms/step (min "
          f"{min(unfused_ms):.3f}, max {max(unfused_ms):.3f}, over "
          f"{N_UNFUSED_STEPS} warm steps); device time {busy / 3:.3f} "
          f"ms/step (torch.profiler over 3 more steps; wall "
          f"{wall / 3:.3f} ms/step with the profiler on)", flush=True)
    if profile_path:
        write_profile(profile_path, "a", "3 training steps",
                      lambda: trainer.run_steps(graphs[:3]))
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
    launches = spmm.launch_counts()
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
    mean_ms = sum(step_ms) / len(step_ms)
    print(f"  blocked bf16 train step: {mean_ms:.3f} ms/step (min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}, over {N_STEPS} steps, "
          f"synchronised by the loss readback), "
          f"{N_REAL_EDGE / (mean_ms / 1e3):.4e} real edges/s", flush=True)
    if profile_path:
        write_profile(profile_path, "a", "1 blocked training step",
                      lambda: trainer.run_steps(batches[:1]))
    launches = spmm.launch_counts()
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
    with torch.inference_mode():
        serve(model, graphs[0])                  # warm-up, not counted
        serve(sparse, at(graphs[0]))
        spmm.reset_launch_counts()
        # --- the main path: 8 requests on the fused route
        served = [serve(model, g) for g in graphs]
        launches = spmm.launch_counts()
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
    graphs = [make_request(seed, device, hits=True)
              for seed in range(N_REQUESTS)]
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
    fused_counts = spmm.launch_counts()
    t = time.perf_counter()
    unfused_loss = float(unfused.run_steps(graphs[:1])[0])
    unfused_ms = (time.perf_counter() - t) * 1e3
    launches = spmm.launch_counts()
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
    mean_ms = sum(step_ms) / len(step_ms)
    print(f"  fused bf16 node train step: {mean_ms:.3f} ms/step (min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}, over {N_STEPS} steps, "
          f"synchronised by the loss readback), "
          f"{n_real / (mean_ms / 1e3):.4e} real edges/s; unfused step "
          f"{unfused_ms:.3f} ms", flush=True)
    if profile_path:
        write_profile(profile_path, "a", "3 node training steps",
                      lambda: trainer.run_steps(graphs[:3]))
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
    """Host ms a batch of ``pack_graphs`` and of ``attach_plans`` on the
    CLI's batches (36 sectors, the CLI's bucket), mean of 3 each."""
    from gnn_fpga_tpu_torch.cli import train
    from gnn_fpga_tpu_torch.core import batching
    from gnn_fpga_tpu_torch.core import graph as G

    graphs, _ = train.load_graph_files(input_dir, CLI_SECTORS)
    spec = batching.choose_bucket(graphs, edge_multiple=256)
    pack, plans = [], []
    for b in range(3):
        chunk = graphs[b * CLI_BATCH:(b + 1) * CLI_BATCH]
        t = time.perf_counter()
        g = G.pack_graphs(chunk, n_node=spec.n_node * CLI_BATCH,
                          n_edge=spec.n_edge * CLI_BATCH)
        pack.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        G.attach_plans(g)
        plans.append((time.perf_counter() - t) * 1e3)
    return sum(pack) / 3, sum(plans) / 3, g


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
        first_counts = spmm.launch_counts()
        resumed = train.main(fused + ["--n-epochs", "1", "--resume",
                                      "--prefetch", "0"])
        resumed_counts = spmm.launch_counts()
        blocked = train.main(common + [
            "--aggregation", "blocked", "--group", str(GROUP),
            "--valid-frac", str(CLI_VALID_FRAC), "--n-epochs", "1",
            "--output-dir", os.path.join(runs, "blocked")])
        model_path = os.path.join(runs, "pallas", "model.npz")
        results, latency = infer.run(infer.parse_args([
            "--model", model_path, "--input-dir", data,
            "--n-graphs", str(CLI_INFER_GRAPHS), "--hidden-dim", str(HIDDEN),
            "--n-iters", str(N_ITERS), "--benchmark"]))
        launches = spmm.launch_counts()
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
    from gnn_fpga_tpu_torch.train.trainer import TrainConfig, Trainer

    timing = common + ["--aggregation", "pallas", "--valid-frac", "0",
                       "--n-epochs", str(CLI_TIMING_EPOCHS)]
    steps = CLI_SECTORS // CLI_BATCH
    step_ms = {2: [], 0: []}
    for i, prefetch in enumerate((2, 0, 0, 2)):     # in turns
        out = os.path.join(runs, f"timing{i}")
        train.main(timing + ["--prefetch", str(prefetch), "--output-dir",
                             out])
        # epoch 0 takes the first batch's build and the warm-up
        step_ms[prefetch] += [t / steps * 1e3 for t in epoch_times(out)[1:]]
    pack_ms, plans_ms, g = host_loop_ms(data)
    out = os.path.join(runs, "profiled")
    wall, busy = profiled(lambda: train.main(
        timing[:-1] + ["1", "--output-dir", out]))
    epoch_ms = epoch_times(out)[0] * 1e3

    cfg = mpnn.SegmentClassifierConfig(
        input_dim=INPUT_DIM, hidden_dim=HIDDEN, n_iters=N_ITERS,
        compute_dtype=torch.bfloat16, aggregation="pallas")
    trainer = Trainer(mpnn.init_segment_classifier(
        cfg, torch.Generator().manual_seed(0), device=device),
        TrainConfig(learning_rate=LEARNING_RATE, pos_weight=POS_WEIGHT))
    batch = G.attach_plans(g).to(device)
    trainer.run_steps([batch, batch])                        # warm-up
    run_ms = []
    for _ in range(8):
        t = time.perf_counter()
        trainer.run_steps([batch])
        run_ms.append((time.perf_counter() - t) * 1e3)
    name = card()
    mean = lambda xs: sum(xs) / len(xs)
    print(f"  [{name}] cli fused bf16 step (epoch wall / {steps} steps, "
          f"epochs 1-{CLI_TIMING_EPOCHS - 1} of two runs each): "
          f"--prefetch 2 {mean(step_ms[2]):.3f} ms "
          f"({' '.join(f'{x:.3f}' for x in step_ms[2])}), --prefetch 0 "
          f"{mean(step_ms[0]):.3f} ms "
          f"({' '.join(f'{x:.3f}' for x in step_ms[0])})", flush=True)
    print(f"  [{name}] run_steps fused bf16 step on one pre-built batch of "
          f"{batch.n_edge} edges: {mean(run_ms):.3f} ms (min "
          f"{min(run_ms):.3f}, max {max(run_ms):.3f}, 8 steps); host loop "
          f"= cli step - run_steps step: {mean(step_ms[2]) - mean(run_ms):.3f}"
          f" ms with prefetch, {mean(step_ms[0]) - mean(run_ms):.3f} ms "
          f"without", flush=True)
    print(f"  [{name}] host time a batch of {CLI_BATCH} sectors: pack_graphs "
          f"{pack_ms:.3f} ms, attach_plans {plans_ms:.3f} ms", flush=True)
    print(f"  [{name}] one cli epoch ({steps} steps) under torch.profiler: "
          f"epoch {epoch_ms:.3f} ms, device busy {busy:.3f} ms "
          f"({busy / epoch_ms:.1%} of the epoch; the whole CLI call "
          f"{wall:.3f} ms)", flush=True)
    print(f"  [{name}] infer --benchmark (dense route, f32, one sector "
          f"padded): {infer_latency * 1e6:.1f} us/graph", flush=True)


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
    return spmm.launch_counts()


def profiled(run, table_to=None) -> tuple:
    """``(wall ms, device busy ms)`` of ``run()`` under torch.profiler;
    ``table_to``: ``(path, what)`` appends the profiler's table to
    ``path``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages()
    # device events only, as the table's own total counts them: the
    # autograd Function's CPU row also carries its kernel's time
    busy_ms = sum(e.self_device_time_total for e in table
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation) / 1e3
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
                "rows": phase_rows, "stream": phase_stream}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="PATH",
                    help="also write torch.profiler tables to PATH")
    ap.add_argument("--phase", action="append", choices=tuple(MEASUREMENTS),
                    help="run only this measurement phase on the first "
                         "packed graph (repeatable): no main path and no "
                         "result line")
    args = ap.parse_args()
    kind = phase_device()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    if args.phase:
        g = make_request(0, device)
        for name in args.phase:
            MEASUREMENTS[name](g)
        return
    t0 = time.perf_counter()
    graphs = [make_request(seed, device) for seed in range(N_REQUESTS)]
    print(f"graphs: {N_REQUESTS} packed graphs built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    kernels = phase_kernels(graphs[0])
    print_probe_bounds()
    phase_iteration(graphs[0])
    phase_rows(graphs[0])
    phase_stream(graphs[0])
    paths = (phase_serving(device, graphs, args.profile),
             phase_training(device, graphs, args.profile),
             phase_ops(graphs[0]), phase_blocked(device, args.profile),
             phase_unshared(device, graphs, args.profile),
             phase_node(device, args.profile), phase_cli(device),
             phase_gcn(device))
    rows = [dict(name=name, route="cuda", source=SOURCES[src],
                 replaces=replaces,
                 launches=sum(path[name] for path in paths),
                 **kernels[(name, torch.bfloat16)])
            for name, (src, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
