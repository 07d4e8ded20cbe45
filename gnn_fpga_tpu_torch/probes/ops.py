"""Microbenchmarks of the aggregation's building blocks on the card: the
counterpart of ``benchmarks/probe_ops.py``, rows 1-8.

Rows: a row gather (``index_select``) with random and sorted ids; a
scatter-add (``index_add_``, the counterpart of ``jax.ops.segment_sum``)
with random and sorted ids; a weighted gather and scatter-add; the port's
``sorted_segment_sum`` kernel (``csrc/segment_sum.cu``); the port's
``passthrough`` kernel at 1, 2 and 4 vectors a thread (the TPU probe's
tiles of 256, 512 and 1,024 rows); the port's ``gather_rows`` kernel
(the TPU probe's gather from a table held in VMEM), with its check
against ``index_select``.  Each row gives µs a call (``common.timed``)
and GB/s by the TPU probe's byte count; ``gather_rows`` also by the bytes
it writes (its table stays in L2, so the first count is not an HBM rate).

Usage: python -m gnn_fpga_tpu_torch.probes.ops [--v 16384 --e 131072
           --d 128 --dtype float32] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gnn_fpga_tpu_torch.core.device import default_device
from gnn_fpga_tpu_torch.ops.cuda import probes
from gnn_fpga_tpu_torch.ops.cuda import segment_sum as ss
from gnn_fpga_tpu_torch.probes.common import device_line, timed

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
N_ITERS = 200


def report(name, sec, bytes_moved, extra=""):
    print(f"{name:42s} {sec * 1e6:9.1f} us   "
          f"{bytes_moved / sec / 1e9:7.1f} GB/s{extra}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser("probes.ops")
    ap.add_argument("--v", type=int, default=16384)
    ap.add_argument("--e", type=int, default=131072)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--dtype", default="float32", choices=tuple(DTYPES))
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' for tests")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    v, e, d = args.v, args.e, args.d
    dt = DTYPES[args.dtype]
    b = dt.itemsize

    rng = np.random.default_rng(0)
    tab = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev, dt)
    h = tab(rng.standard_normal((v, d)))
    msgs = tab(rng.standard_normal((e, d)))
    idx_np = np.sort(rng.integers(0, v, size=e)).astype(np.int32)
    ridx_np = rng.permutation(idx_np).astype(np.int32)
    w = tab(rng.standard_normal((e,)))
    idx, ridx = (torch.from_numpy(a).to(dev) for a in (idx_np, ridx_np))
    print(f"# V={v} E={e} D={d} dtype={args.dtype} (h {v * d * b / 1e6:.1f}"
          f"MB, msgs {e * d * b / 1e6:.1f}MB) on {device_line(dev)}",
          flush=True)
    it = dict(n_iters=N_ITERS)

    def scatter(m, i):
        return torch.zeros((v, m.shape[1]), dtype=m.dtype,
                           device=dev).index_add_(0, i, m)

    # 1-2. gather h[idx]
    t = timed(lambda h, i: h.index_select(0, i), (h, ridx), **it)
    report("gather random idx", t, (v + e) * d * b)
    t = timed(lambda h, i: h.index_select(0, i), (h, idx), **it)
    report("gather sorted idx", t, (v + e) * d * b)
    # 3-4. segment sums by a scatter-add
    t = timed(scatter, (msgs, ridx), **it)
    report("segment_sum random", t, (e + v) * d * b)
    t = timed(scatter, (msgs, idx), **it)
    report("segment_sum sorted", t, (e + v) * d * b)
    # 5. the whole aggregation: gather, weight, scatter-add
    t = timed(lambda h, i, ri, w: scatter(h.index_select(0, i) * w[:, None],
                                          ri), (h, ridx, idx, w), **it)
    report("torch gather*w+segsum", t, (v + 2 * e + v) * d * b)
    # 6. the port's sorted segment sum (ids sorted: the rows are in order)
    seg = ss.build_sorted_segments(idx_np, v).to(dev)
    t = timed(lambda m: ss.sorted_segment_sum(m, seg, v), (msgs,), **it)
    report("cuda sorted_segment_sum", t, (e + v) * d * b)
    # 7. the passthrough kernel
    for vec in probes.PASSTHROUGH_VECTORS:
        t = timed(lambda m, k=vec: probes.passthrough(m, k), (msgs,), **it)
        report(f"cuda passthrough vectors={vec}", t, 2 * e * d * b)
    # 8. the row-gather kernel
    ok = torch.equal(probes.gather_rows(h, ridx), h.index_select(0, ridx))
    t = timed(lambda hh: probes.gather_rows(hh, ridx), (h,), **it)
    report(f"cuda gather_rows (correct={ok})", t, (v + e) * d * b,
           f"; {(e * d * b + 4 * e) / t / 1e9:.1f} GB/s of rows written "
           f"and ids read")


if __name__ == "__main__":
    main()
