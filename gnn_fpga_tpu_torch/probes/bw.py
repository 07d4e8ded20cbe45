"""Copy-rate and matmul-rate probe of the card: the counterpart of
``benchmarks/probe_bw.py``.

Rows: PyTorch's ``x * 2`` over ``[E, D]`` in f32 and bf16; the port's
``passthrough`` kernel (``csrc/probes.cu``) in f32 at 1, 2 and 4 16-byte
vectors a thread, the knob that stands for the TPU probe's tile of rows;
square ``torch.matmul`` at 1,024, 2,048 and 4,096 in f32 (TF32 off) and
bf16, in TFLOP/s beside the card's peaks (``utils/flops.py``).  Each time
is ``common.timed``'s: a call and its share of the chain's sum.

Usage: python -m gnn_fpga_tpu_torch.probes.bw [--e 131072 --d 128]
           [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gnn_fpga_tpu_torch.core.device import default_device
from gnn_fpga_tpu_torch.ops.cuda import probes
from gnn_fpga_tpu_torch.probes.common import device_line, timed
from gnn_fpga_tpu_torch.utils import flops

MATMUL_SIZES = (1024, 2048, 4096)
N_ITERS = 200


def report(name, sec, bytes_moved=None, flop=None, peak=None):
    extra = ""
    if bytes_moved:
        extra += f" {bytes_moved / sec / 1e9:8.1f} GB/s"
    if flop:
        extra += f" {flop / sec / 1e12:8.2f} TFLOP/s"
        extra += (" (no card peak)" if peak is None
                  else f" of {peak:g} peak ({flop / sec / 1e12 / peak:.1%})")
    print(f"{name:44s} {sec * 1e6:9.1f} us {extra}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser("probes.bw")
    ap.add_argument("--e", type=int, default=131072)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' for tests")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    e, d = args.e, args.d
    peaks = flops.chip_peaks(dev)
    print(f"# E={e} D={d} on {device_line(dev)}", flush=True)

    rng = np.random.default_rng(0)
    msgs = torch.from_numpy(rng.standard_normal((e, d)).astype(np.float32))
    msgs = msgs.to(dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t = timed(lambda x: x * 2.0, (msgs,), n_iters=N_ITERS)
        report("torch x*2 f32", t, bytes_moved=2 * e * d * 4)
        bf = msgs.to(torch.bfloat16)
        t = timed(lambda x: x * 2.0, (bf,), n_iters=N_ITERS)
        report("torch x*2 bf16", t, bytes_moved=2 * e * d * 2)

        for vec in probes.PASSTHROUGH_VECTORS:
            t = timed(lambda m, k=vec: probes.passthrough(m, k), (msgs,),
                      n_iters=N_ITERS)
            blocks = -(-e * d * 4 // (16 * 256 * vec))
            report(f"cuda passthrough vectors={vec} ({blocks} blocks)", t,
                   bytes_moved=2 * e * d * 4)

        for n in MATMUL_SIZES:
            a = rng.standard_normal((n, n)).astype(np.float32)
            b = rng.standard_normal((n, n)).astype(np.float32)
            a, b = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
            t = timed(lambda a, b=b: a @ b, (a,), n_iters=N_ITERS)
            report(f"matmul f32 {n}x{n}", t, flop=2 * n ** 3,
                   peak=None if peaks is None else peaks.f32_tflops)
            abf, bbf = a.to(torch.bfloat16), b.to(torch.bfloat16)
            t = timed(lambda a, b=bbf: a @ b, (abf,), n_iters=N_ITERS)
            report(f"matmul bf16 {n}x{n}", t, flop=2 * n ** 3,
                   peak=None if peaks is None else peaks.bf16_tflops)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


if __name__ == "__main__":
    main()
