"""The aggregation paths on the layered graph: the sparse route's gather
and ``index_add_`` against the port's pair kernels; the counterpart of
``benchmarks/probe_spmm.py``.

Rows, each in µs a call (``common.timed``: chained calls in one CUDA
graph), GB/s by the TPU probe's "useful" byte count (``h``, ``mi``,
``mo`` and the ids and weights once) and Medge/s; "fwd+bwd" rows take the
autograd of the sum of squares, so the forward cannot be skipped:

- "sparse pair" (``ops/segment.py``: ``index_select``, weight,
  ``index_add_``; the TPU probe's "XLA pair", what the model's sparse
  route does), forward and forward+backward;
- "cuda aggregate_pair" (#2, backward #4), forward and forward+backward;
- "plain gather_pair" (two ``index_select``) against "cuda gather_pair"
  (#6, backward #5), each forward and forward+backward;
- the backward's components through the op API: ``sddmm_dual`` (#9, the
  whole ``dw`` in one kernel), ``sddmm`` (#8) and ``spmm_raw`` (#7) each
  in one direction;
- the kernel pair's largest error against its plain version.

:func:`checks` pairs each kernel row with its plain version, the
gradients included, for callers that hold them (``chip_smoke.py``).

Deliberate difference: the TPU probe sweeps its tile, subtiles, layer
``boundaries`` and ``precompute`` (prebuilt one-hot operands); the port's
kernels walk CSR segments and have none of these knobs, so each kernel
is timed once.

Usage: python -m gnn_fpga_tpu_torch.probes.spmm [--v 16384 --e 131072
           --d 128 --dtype float32 bfloat16 --iters 200] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gnn_fpga_tpu_torch.core.device import default_device
from gnn_fpga_tpu_torch.ops import segment as ops
from gnn_fpga_tpu_torch.ops.cuda import spmm
from gnn_fpga_tpu_torch.probes.common import device_line, layered_graph, timed

V, E, D = 16384, 131072, 128
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
N_ITERS = 200


def sparse_pair(h, w, s, r, v):
    """``mi + mo`` on the sparse route: gathered rows weighted and summed
    by ``index_add_`` (f32 for a bf16 ``h``, as the TPU probe's "XLA
    pair" promotes)."""
    mi = ops.segment_sum(ops.gather(h, s) * w[:, None], r, v)
    mo = ops.segment_sum(ops.gather(h, r) * w[:, None], s, v)
    return mi + mo


def kernel_pair(h, w, plans):
    """``mi + mo`` by ``aggregate_pair``."""
    mi, mo = spmm.aggregate_pair(h, w, plans)
    return mi + mo


def plain_gather_pair(pa, pb, s, r):
    return pa.index_select(0, s) + pb.index_select(0, r)


def fwdbwd(pair):
    """``ga + sum(gb)``, the gradients of ``sum(pair(a, b) ** 2)`` as the
    TPU probe returns them: the cotangent depends on the forward's
    output, so the forward is needed."""
    def f(a, b):
        xs = [t.detach().requires_grad_() for t in (a, b)]
        ga, gb = torch.autograd.grad((pair(*xs).float() ** 2).sum(), xs)
        return ga.float() + gb.sum()
    return f


def rows(h, w, pa, pb, g, s, r, plans):
    """The timed rows: ``(name, fn, args, bytes moved)``."""
    v, d = h.shape
    b = h.element_size()
    useful = (v * d + 2 * v * d + 3 * w.shape[0]) * b
    gp_bytes = (2 * v * d + w.shape[0] * d) * b
    sp = lambda h, w: sparse_pair(h, w, s, r, v)
    kp = lambda h, w: kernel_pair(h, w, plans)
    pgp = lambda a, b: plain_gather_pair(a, b, s, r)
    kgp = lambda a, b: spmm.gather_pair(a, b, s, r, plans)
    return [
        ("sparse pair fwd", sp, (h, w), useful),
        ("sparse pair fwd+bwd", fwdbwd(sp), (h, w), 3 * useful),
        ("cuda aggregate_pair fwd", kp, (h, w), useful),
        ("cuda aggregate_pair fwd+bwd", fwdbwd(kp), (h, w), 3 * useful),
        ("plain gather_pair fwd", pgp, (pa, pb), gp_bytes),
        ("plain gather_pair fwd+bwd", fwdbwd(pgp), (pa, pb), 3 * gp_bytes),
        ("cuda gather_pair fwd", kgp, (pa, pb), gp_bytes),
        ("cuda gather_pair fwd+bwd", fwdbwd(kgp), (pa, pb), 3 * gp_bytes),
        ("sddmm_dual (full dw, one kernel)",
         lambda a, b: spmm.sddmm_dual(a, b, a, b, plans.recv), (g, h),
         useful),
        ("sddmm single direction",
         lambda a, b: spmm.sddmm(a, b, plans.recv), (g, h), useful),
        ("spmm single direction",
         lambda a, ww: spmm.spmm_raw(a, ww, plans.send), (g, w), useful),
    ]


def _grads(fn, args, cotangent):
    """The gradients of ``fn(*args)`` against ``cotangent``."""
    xs = [a.detach().requires_grad_() for a in args]
    return torch.autograd.grad(fn(*xs), xs, cotangent)


def checks(h, w, pa, pb, g, s, r, plans) -> dict:
    """Each kernel row's function beside its plain version on the same
    inputs: ``{row: (kernel call, plain call, output names)}``, each call
    returning a tuple.  A "fwd+bwd" row's backward kernel is held by its
    gradients against a cotangent drawn from N(0, 1) (seed 2) in the
    output's shape and dtype, as ``chip_smoke.py``'s kernels phase holds
    the backward kernels: the sum of squares' own cotangent, twice the
    output, grows the terms each gradient sums, and with them the error
    of a reordered f32 sum, past the tolerance's ``atol``."""
    v = h.shape[0]
    rng = np.random.default_rng(2)
    normal = lambda like: torch.from_numpy(rng.standard_normal(
        tuple(like.shape)).astype(np.float32)).to(like.device, like.dtype)
    mi, mo = spmm.aggregate_pair_reference(h, w, s, r, v)
    ct_mi, ct_mo = normal(h), normal(h)
    gp = spmm.gather_pair_reference(pa, pb, s, r)
    ct_gp = normal(gp)
    return {
        "cuda aggregate_pair fwd": (
            lambda: spmm.aggregate_pair(h, w, plans), lambda: (mi, mo),
            ("mi", "mo")),
        "cuda aggregate_pair fwd+bwd": (
            lambda: _grads(lambda a, b: spmm.aggregate_pair(a, b, plans),
                           (h, w), (ct_mi, ct_mo)),
            lambda: spmm.aggregate_pair_bwd_reference(h, w, ct_mi, ct_mo, s,
                                                      r, v),
            ("dh", "dw")),
        "cuda gather_pair fwd": (
            lambda: (spmm.gather_pair(pa, pb, s, r, plans),),
            lambda: (gp,), ("out",)),
        "cuda gather_pair fwd+bwd": (
            lambda: _grads(lambda a, b: spmm.gather_pair(a, b, s, r, plans),
                           (pa, pb), ct_gp),
            lambda: spmm.gather_pair_bwd_reference(ct_gp, s, r, v),
            ("dpa", "dpb")),
        "sddmm_dual (full dw, one kernel)": (
            lambda: (spmm.sddmm_dual(g, h, g, h, plans.recv),),
            lambda: (spmm.sddmm_dual_reference(g, h, g, h, r, s),), ("e",)),
        "sddmm single direction": (
            lambda: (spmm.sddmm(g, h, plans.recv),),
            lambda: (spmm.sddmm_reference(g, h, r, s),), ("e",)),
        "spmm single direction": (
            lambda: (spmm.spmm_raw(g, w, plans.send),),
            lambda: (spmm.spmm_reference(g, w, s, r, v),), ("out",)),
    }


def inputs(v, e, d, dt, device):
    """The TPU probe's inputs (its seeds, the layered graph) on
    ``device``: ``(h, w, pa, pb, g, s, r, plans)``."""
    rng = np.random.default_rng(1)
    tab = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(device, dt)
    h = tab(v, d)
    w = torch.from_numpy(rng.standard_normal((e,)).astype(np.float32)
                         ).to(device)
    s_np, r_np = layered_graph(v, e)
    plans = spmm.build_agg_plans(s_np, r_np, v).to(device)
    pa, pb, g = tab(v, d), tab(v, d), tab(v, d)
    s, r = (torch.from_numpy(a).to(device) for a in (s_np, r_np))
    return h, w, pa, pb, g, s, r, plans


def run(v, e, d, dt, device, n_iters=N_ITERS) -> dict:
    """Every row at one width and dtype: ``{name: µs a call}``, and the
    kernel pair's error against its plain version."""
    h, w, pa, pb, g, s, r, plans = inputs(v, e, d, dt, device)
    print(f"# V={v} E={e} D={d} dtype={str(dt).split('.')[-1]}", flush=True)
    out = {}
    for name, fn, args, nbytes in rows(h, w, pa, pb, g, s, r, plans):
        t = timed(fn, args, n_iters=n_iters)
        out[name] = t * 1e6
        print(f"{name:46s} {t * 1e6:9.1f} us  {nbytes / t / 1e9:7.1f} GB/s  "
              f"{e / t / 1e6:8.1f} Medge/s", flush=True)
    mi, mo = spmm.aggregate_pair(h, w, plans)
    emi, emo = spmm.aggregate_pair_reference(h.float(), w, s, r, v)
    err = float((mi.float() - emi).abs().max() + (mo.float() - emo).abs().max())
    out["max_abs_err"] = err
    print(f"max abs err vs plain ({str(dt).split('.')[-1]}): {err:.2e}",
          flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("probes.spmm")
    ap.add_argument("--v", type=int, default=V)
    ap.add_argument("--e", type=int, default=E)
    ap.add_argument("--d", type=int, default=D)
    ap.add_argument("--dtype", nargs="+", default=list(DTYPES),
                    choices=tuple(DTYPES))
    ap.add_argument("--iters", type=int, default=N_ITERS)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' for tests")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    out = {name: run(args.v, args.e, args.d, DTYPES[name], dev, args.iters)
           for name in args.dtype}
    print(f"# device: {device_line(dev)}", flush=True)
    return out


if __name__ == "__main__":
    main()
