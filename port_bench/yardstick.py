"""The train step's FLOPs, kernel bytes and the card's peaks: the
benchmark's own frozen copies, so that the work counted stays the same
whatever the program does later.

:func:`train_step_flops`, the peaks and :func:`kernel_work` are copies of
``gnn_fpga_tpu_torch/utils/flops.py``.  A forward's useful FLOPs are the
model family's own frozen count (``families/<model>.py``:
``forward_flops``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


def train_step_flops(fwd_flops: float) -> float:
    """Forward and backward: 3x the forward."""
    return 3.0 * fwd_flops


@dataclasses.dataclass(frozen=True)
class ChipPeaks:
    """Dense peaks at the full power limit: bf16 tensor-core, f32 and f64
    TFLOP/s; device memory GB/s."""

    bf16_tflops: float
    f32_tflops: float
    f64_tflops: float
    hbm_gbps: float


# NVIDIA's H100 data sheet (sparsity halved away), keyed by
# torch.cuda.get_device_name; another card has no peaks, and a share of a
# peak is then not reported.
PEAKS = {
    "NVIDIA H100 80GB HBM3": ChipPeaks(bf16_tflops=989.5, f32_tflops=67.0,
                                       f64_tflops=34.0, hbm_gbps=3350.0),
    "NVIDIA H100 PCIe": ChipPeaks(bf16_tflops=756.5, f32_tflops=51.0,
                                  f64_tflops=26.0, hbm_gbps=2000.0),
}


def peaks(device_name: str) -> Optional[ChipPeaks]:
    return PEAKS.get(device_name)


def kernel_work(name: str, dtype_bytes: int, v: int, e: int, d: int,
                hdim: int) -> tuple:
    """``(bytes, f32 operations)`` that one call of kernel ``name`` must do
    on ``v`` nodes and ``e`` edges with tables of ``d`` and ``hdim``
    columns of ``dtype_bytes`` bytes: each input read once and each
    output written once (edge weights and masks f32, one int32 sender and
    receiver an edge), each edge's score once."""
    tab = lambda w: v * w * dtype_bytes
    ids, ev = 8 * e, 4 * e
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
    }[name]
