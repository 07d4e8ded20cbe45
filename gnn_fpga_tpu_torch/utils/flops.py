"""Useful-FLOP accounting, the card's peaks, MFU and the fused train step's
roofline.

The counterpart of ``gnn_fpga_tpu/utils/flops.py``.  "Useful" FLOPs are
the sparse-equivalent work of the model (the MLPs and one multiply-add an
edge and aggregation direction), whatever the route executes:
:func:`segment_classifier_flops` and :func:`train_step_flops` are the JAX
package's arithmetic, float for float.  MFU divides a useful rate by the
card's dense bf16 tensor-core peak.

The roofline counts what the port's fused train step must do: each
hand-written kernel launch's bytes and f32 operations
(:func:`kernel_work`, the same counts ``chip_smoke.py`` bounds each kernel
by) and each GEMM's tensor-core FLOPs and bytes, every input read once and
every output written once.

Deliberate differences from the JAX package: the peaks are keyed by
``torch.cuda.get_device_name``; :func:`fused_step_cost` counts the port's
kernels and GEMMs (``e_pad``, ``v_pad``, widths, ``n_iters``), not the
TPU's one-hot MXU passes over lane-padded windows (``w_oth``, ``w_seg``,
``prebuilt``), and returns tensor-core FLOPs, f32 operations and bytes;
:func:`attainable` takes those three and names the wall that binds
``"tensor"``, ``"f32"`` or ``"bytes"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def segment_classifier_flops(
    n_node: float,
    n_edge: float,
    hidden_dim: int,
    n_iters: int,
    input_dim: int = 2,
) -> float:
    """Useful forward-pass FLOPs of one SegmentClassifier application.

    Counts 2 FLOPs per MAC in every MLP matmul and 4 FLOPs per edge per
    node width for the two weighted aggregations (multiply by the edge
    weight and accumulate, both directions); gathers count as bytes, not
    FLOPs.  ``n_node``/``n_edge`` are REAL (mask-summed) counts.
    """
    v, e, h, d_in = float(n_node), float(n_edge), hidden_dim, input_dim
    d = h + d_in                      # shortcut-concat width [H, X]
    edge_mlp = 2 * e * h * (2 * d + 1)          # [E,2D]@[2D,h] + [E,h]@[h,1]
    node_mlp = 2 * v * h * (3 * d + h)          # [V,3D]@[3D,h] + [V,h]@[h,h]
    agg = 4 * e * d                             # w*msg + accumulate, 2 dirs
    input_mlp = 2 * v * d_in * h
    return input_mlp + n_iters * (edge_mlp + agg + node_mlp) + edge_mlp


def train_step_flops(fwd_flops: float) -> float:
    """Training-step useful FLOPs: forward and backward, 3x the forward
    (two backward matmuls a forward matmul; the optimizer's update is
    negligible at <200k parameters)."""
    return 3.0 * fwd_flops


@dataclasses.dataclass(frozen=True)
class ChipPeaks:
    """Published peaks of one card, dense (no sparsity), at its full power
    limit: tensor-core bf16, and f32 and f64 outside the tensor cores, in
    TFLOP/s; device memory in GB/s."""

    bf16_tflops: float
    f32_tflops: float
    f64_tflops: float
    hbm_gbps: float


# NVIDIA's H100 Tensor Core GPU data sheet: the SXM5 part at 700 W and the
# PCIe part at 350 W.  The sheet gives tensor-core rates with sparsity
# (1,979 and 1,513 TFLOP/s in bf16), halved here to the dense rates.
# Keyed by torch.cuda.get_device_name; another card reports None rather
# than a guess.
_PEAKS = {
    "NVIDIA H100 80GB HBM3": ChipPeaks(bf16_tflops=989.5, f32_tflops=67.0,
                                       f64_tflops=34.0, hbm_gbps=3350.0),
    "NVIDIA H100 PCIe": ChipPeaks(bf16_tflops=756.5, f32_tflops=51.0,
                                  f64_tflops=26.0, hbm_gbps=2000.0),
}


def _device_name(device) -> Optional[str]:
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.cuda.current_device()
    device = torch.device("cuda", device) if isinstance(device, int) \
        else torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_name(device)


def chip_peaks(device=None) -> Optional[ChipPeaks]:
    """The peaks of ``device`` (default: the current CUDA device); None on
    the CPU, without a card, or for a card not in the table."""
    return _PEAKS.get(_device_name(device))


def chip_peak_tflops(device=None) -> Optional[float]:
    """Peak dense bf16 tensor-core TFLOP/s of ``device``, or None."""
    peaks = chip_peaks(device)
    return None if peaks is None else peaks.bf16_tflops


def chip_hbm_gbps(device=None) -> Optional[float]:
    """Device-memory GB/s of ``device``, or None."""
    peaks = chip_peaks(device)
    return None if peaks is None else peaks.hbm_gbps


def mfu(useful_flops_per_s: float, device=None) -> Optional[float]:
    """The fraction of the bf16 tensor-core peak that a useful FLOP rate
    is, or None off a known card."""
    peak = chip_peak_tflops(device)
    if peak is None:
        return None
    return useful_flops_per_s / (peak * 1e12)


# ---------------------------------------------------------------------------
# The work of the port's kernels and of the fused train step
# ---------------------------------------------------------------------------

def kernel_work(name: str, dtype_bytes: int, v: int, e: int, d: int,
                hdim: int) -> tuple:
    """``(bytes, f32 operations)`` that one call of kernel ``name`` must
    do on ``v`` nodes and ``e`` edges (rows read, for the segment sum)
    with tables of ``d`` and ``hdim`` columns of ``dtype_bytes`` bytes:
    each input read once and each output written once (edge weights,
    masks and sddmm outputs f32, one int32 sender and receiver an edge, or
    the segment sum's offsets), and the arithmetic of the function, each
    edge's score once (a tanh or exp counted as one operation).

    The probes' kernels (``ops/cuda/probes.py``): ``passthrough`` (``e``
    rows of ``d``), ``gather_rows`` (``e`` int32 ids into ``v`` rows of
    ``d``), the iteration backward from stashed scores
    (``iteration_pair_bwd_stashed``: the production kernel's function as
    ``benchmarks/probe_iter.py::_stash_bwd`` counts it, the [E] scores and
    ``w2``, ``b1`` read too) and its ``iteration_pair_bwd_recompute``
    (``b2`` read, no scores), and one entry a mode of the SpMM ablation
    (``ablate_<mode>``), each with the bytes that mode must move: the
    table once (only its first 256 rows without a gather), the plan's
    CSR offsets (by-node modes), other endpoints (with a gather, and
    ``ids_only``), edge order and f32 weights, and its output in the
    tables' dtype (one row a node, or a group of
    ``ops/cuda/probes.py::ABLATE_GROUP`` sorted edges; ``ids_only`` two
    f32 a group);
    ``ablate_aligned`` is ``ablate_full`` on rows padded to a 16-byte
    pitch.

    ``layer_norm_relu`` and ``layer_norm_relu_bwd``
    (``ops/cuda/layer_norm.py``) take ``e`` rows of ``hdim``: the forward
    reads the rows, the bias, the scale and the shift and writes its
    output and each row's f32 mean and rstd; the backward reads the
    output's gradient, the rows, the statistics and the three parameters
    and writes ``dy`` and the three column sums."""
    tab = lambda w: v * w * dtype_bytes
    ids, ev = 8 * e, 4 * e
    rows, par = e * hdim * dtype_bytes, hdim * dtype_bytes
    if name.startswith("ablate_"):
        return _ablation_work(name[len("ablate_"):], dtype_bytes, v, e, d)
    return {
        "iteration_pair": (2 * tab(hdim) + 3 * tab(d) + ev + ids,
                           e * (6 * hdim + 4 * d + 4)),
        "aggregate_pair": (3 * tab(d) + ev + ids, 4 * e * d),
        "gather_pair": (2 * tab(hdim) + ids + e * hdim * dtype_bytes,
                        e * hdim),
        "iteration_pair_bwd": (4 * tab(hdim) + 4 * tab(d) + ev + ids,
                               e * (13 * hdim + 8 * d + 8)),
        "aggregate_pair_bwd": (4 * tab(d) + 2 * ev + ids, 8 * e * d),
        "gather_pair_bwd": (e * hdim * dtype_bytes + ids + 2 * tab(hdim),
                            2 * e * hdim),
        # gather_pair_bwd's kernel, then its two halves read and their
        # sum written
        "edge_sum": (e * hdim * dtype_bytes + ids + 5 * tab(hdim),
                     2 * e * hdim + v * hdim),
        "spmm": (2 * tab(d) + ev + ids, 2 * e * d),
        "sddmm": (2 * tab(d) + ids + ev, 2 * e * d),
        "sddmm_dual": (4 * tab(d) + ids + ev, 4 * e * d),
        "sorted_segment_sum": (e * d * dtype_bytes + 4 * (v + 1) + tab(d),
                               e * d),
        "passthrough": (2 * e * d * dtype_bytes, e * d),
        # a value: the bias add, the statistics' two passes, the
        # normalisation, the scale and shift, the ReLU
        "layer_norm_relu": (2 * rows + 3 * par + 8 * e, 10 * e * hdim),
        # a value: the forward's value again, the mask, the two row sums,
        # dy, the three column sums
        "layer_norm_relu_bwd": (3 * rows + 8 * e + 6 * par,
                                19 * e * hdim),
        "gather_rows": (4 * e + tab(d) + e * d * dtype_bytes, 0),
        "iteration_pair_bwd_stashed": (
            4 * tab(hdim) + 4 * tab(d) + 2 * ev + ids + 2 * hdim * dtype_bytes,
            e * (11 * hdim + 8 * d + 8)),
        "iteration_pair_bwd_recompute": (
            4 * tab(hdim) + 4 * tab(d) + ev + ids
            + (2 * hdim + 1) * dtype_bytes,
            e * (13 * hdim + 8 * d + 8)),
    }[name]


def _ablation_work(mode: str, dtype_bytes: int, v: int, e: int,
                   d: int) -> tuple:
    """:func:`kernel_work` of the SpMM ablation's ``mode``."""
    from gnn_fpga_tpu_torch.ops.cuda.probes import ABLATE_GROUP, STATIC_ROWS

    if mode == "aligned":
        per = 16 // dtype_bytes
        return _ablation_work("full", dtype_bytes, v, e, -(-d // per) * per)
    groups = -(-e // ABLATE_GROUP)
    row = d * dtype_bytes
    order_w = 8 * e                       # the edge order and the weights
    offsets = 4 * (v + 1)
    return {
        "full": (v * row + offsets + 4 * e + order_w + v * row, 2 * e * d),
        "no_gather": (min(v, STATIC_ROWS) * row + offsets + order_w
                      + v * row, 2 * e * d),
        "no_scatter": (v * row + 4 * e + order_w + groups * row, 2 * e * d),
        "compute": (min(v, STATIC_ROWS) * row + order_w
                    + groups * row, 2 * e * d),
        "ids_only": (4 * e + order_w + groups * 8, 2 * e),
    }[mode]


def fused_step_launches(n_iters: int) -> dict:
    """The kernel launches of one fused train step of the
    SegmentClassifier: the fused iteration and its backward each
    iteration, the final edge head's gather pair and its backward once."""
    return {"iteration_pair": n_iters, "iteration_pair_bwd": n_iters,
            "gather_pair": 1, "gather_pair_bwd": 1}


def _gemm(m: int, k: int, n: int, dtype_bytes: int) -> tuple:
    """``(FLOPs, bytes)`` of one ``[m, k] @ [k, n]`` product."""
    return 2 * m * k * n, (m * k + k * n + m * n) * dtype_bytes


def fused_step_gemms(v: int, e: int, hidden_dim: int, d: int, n_iters: int,
                     dtype_bytes: int = 2) -> tuple:
    """``(tensor-core FLOPs, bytes)`` of the GEMMs of one fused train
    step, forward and backward: the input layer ``[V, d - H] @ [d - H,
    H]`` (its weight's gradient only: the input takes none); each
    iteration's projections ``pa``, ``pb`` (``[V, d] @ [d, H]``) and node
    MLP (``[V, 3d] @ [3d, H]``, ``[V, H] @ [H, H]``); the final edge
    head's projections and its ``[E, H] @ [H, 1]``.  A product's backward
    is two products of its size (the input's and the weight's
    gradient)."""
    h = hidden_dim
    shapes = ([(v, d - h, h, 2)]
              + n_iters * [(v, d, h, 3), (v, d, h, 3), (v, 3 * d, h, 3),
                           (v, h, h, 3)]
              + [(v, d, h, 3), (v, d, h, 3), (e, h, 1, 3)])
    flops = nbytes = 0
    for m, k, n, times in shapes:
        f, b = _gemm(m, k, n, dtype_bytes)
        flops, nbytes = flops + times * f, nbytes + times * b
    return float(flops), float(nbytes)


def fused_step_cost(e_pad: int, v_pad: int, hidden_dim: int, d: int,
                    n_iters: int, dtype_bytes: int = 2) -> tuple:
    """``(tensor-core FLOPs, f32 operations, bytes)`` of ONE fused train
    step on a packed graph of ``v_pad`` nodes and ``e_pad`` edges: the
    kernel launches of :func:`fused_step_launches`, each
    :func:`kernel_work`, and :func:`fused_step_gemms`.  Elementwise passes
    (activations, concatenations, casts, the loss and the optimizer) are
    not counted, so the bound it gives is a lower bound."""
    kernel_bytes = kernel_ops = 0
    for name, count in fused_step_launches(n_iters).items():
        b, ops = kernel_work(name, dtype_bytes, v_pad, e_pad, d, hidden_dim)
        kernel_bytes, kernel_ops = (kernel_bytes + count * b,
                                    kernel_ops + count * ops)
    gemm_flops, gemm_bytes = fused_step_gemms(v_pad, e_pad, hidden_dim, d,
                                              n_iters, dtype_bytes)
    return gemm_flops, float(kernel_ops), float(kernel_bytes) + gemm_bytes


def attainable(useful_flops_per_step: float, tensor_flops: float,
               f32_ops: float, nbytes: float, device=None):
    """``(attainable_mfu, bound, t_tensor_s, t_f32_s, t_bytes_s)``: the
    MFU the step would reach in the least time the card could take for
    it, the largest of its tensor-core FLOPs at the bf16 peak, its f32
    operations at the f32 peak and its bytes at the memory rate, and which
    of them binds (``"tensor"``, ``"f32"`` or ``"bytes"``).  Nones off a
    known card."""
    peaks = chip_peaks(device)
    if peaks is None:
        return None, None, None, None, None
    times = {"tensor": tensor_flops / (peaks.bf16_tflops * 1e12),
             "f32": f32_ops / (peaks.f32_tflops * 1e12),
             "bytes": nbytes / (peaks.hbm_gbps * 1e9)}
    bound = max(times, key=times.get)
    t = times[bound]
    return (useful_flops_per_step / t / (peaks.bf16_tflops * 1e12), bound,
            times["tensor"], times["f32"], times["bytes"])
