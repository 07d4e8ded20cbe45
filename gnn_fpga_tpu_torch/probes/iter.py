"""The fused iteration against the unfused one and the plain chain, and
the iteration backward from stashed edge scores against one that forms
them: the counterpart of ``benchmarks/probe_iter.py``.

One SegmentClassifier message-passing iteration:

    pre = (pa[send] + pb[recv]) * em ; z = tanh(pre + b1)
    e_  = sigmoid(z @ w2 + b2) * em
    mi/mo = weighted segment sums of h rows by e_

Default rows, each "fwd" and "fwd+bwd" (autograd of the sum of squares):
"plain chain" (``spmm.iteration_pair_reference``, the TPU probe's "xla
chain"), "unfused cuda" (the scores in PyTorch, then the
``aggregate_pair`` kernel; "unfused pallas") and "fused iteration"
(``iteration_pair``).  "fused pre:int8" is printed as absent: it is a TPU
operand mechanism (prebuilt int8 one-hot windows) that the port, which
gathers rows, does not have.

``--ablate-stash``: the production backward (``csrc/iteration_bwd.cu``,
which reads the forward's [E] scores: the TPU probe's ``_stash_bwd``
function) against its variant that forms the scores in the recv pass
(``iteration_pair_bwd_recompute``), first checked against each other at
the TPU probe's tolerances, then timed, with the share the stash saves.

Deliberate differences: the TPU probe's ``--tile`` and ``--sub`` (its
edge tile and subtiles) have no counterpart, the port's kernels walk CSR
segments; the kernels take ``w2``, ``b1``, ``b2`` in the tables' dtype.

Usage: python -m gnn_fpga_tpu_torch.probes.iter [--dtype float32
           --iters 200 --ablate-stash --only NAME --shape probe|bench]
           [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gnn_fpga_tpu_torch.core.device import default_device
from gnn_fpga_tpu_torch.ops.cuda import probes, spmm
from gnn_fpga_tpu_torch.probes.common import device_line, layered_graph, timed

SHAPES = {"probe": ((16384, 131072, 128, 128), (4096, 32768, 64, 64)),
          "bench": ((15848, 180736, 66, 64),)}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# The TPU probe's instrument check (benchmarks/probe_iter.py:162-183):
# node tables elementwise; the parameter sums by their cosine.
STASH_TOL = {torch.float32: dict(rtol=2e-3, atol=2e-3),
             torch.bfloat16: dict(rtol=0.1, atol=0.5)}
MIN_COSINE = 0.999


def _cosine(a, b) -> float:
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return float((a * b).sum() / max(float(a.norm() * b.norm()), 1e-9))


def check_instrument(ref, alt, dt) -> str:
    """The two backward forms agree before they are timed: node tables
    elementwise at :data:`STASH_TOL`, the parameter sums (which cancel over
    the edges) by a cosine above :data:`MIN_COSINE`.  Raises if not;
    returns the readings."""
    gap, cos = 0.0, 1.0
    for a, b in zip(ref, alt):
        a, b = a.float(), b.float()
        if a.ndim >= 2:
            torch.testing.assert_close(b, a, **STASH_TOL[dt])
            gap = max(gap, float((a - b).abs().max()))
        else:
            c = _cosine(a, b)
            if not c > MIN_COSINE:
                raise AssertionError(f"parameter sums' cosine {c} <= "
                                     f"{MIN_COSINE}")
            cos = min(cos, c)
    return f"max |table gap| {gap:.3e}, least parameter-sum cosine {cos:.7f}"


def ablate_stash(args, dev, dt, v, e, d, plans, pa, pb, h, ems, w2, b1, b2):
    """Time the stashed-score backward against the recompute variant."""
    rng = np.random.default_rng(1)
    tab = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev, dt)
    gmi, gmo = tab(v, d), tab(v, d)
    recv = plans.recv
    # the scores in sorted order, as the forward emits them
    if dev.type == "cuda":
        sig = spmm.iteration_pair_fwd(pa, pb, h, ems, w2, b1, b2, plans)[2]
    else:
        sig = spmm.edge_scores_reference(pa, pb, ems, w2, b1, b2,
                                         recv.sorted_oth, recv.sorted_seg)
    ip = (pa, pb, h, ems, w2, b1, b2)

    def combine(outs):
        # one tensor carrying every big output (d and hdim may differ)
        hd = outs[1].shape[1]
        out = outs[0].float()
        out[:, :hd] += outs[1] + outs[2]
        return out

    recompute = lambda gmi, gmo: combine(probes.iteration_pair_bwd_recompute(
        *ip, gmi, gmo, plans))
    stashed = lambda gmi, gmo: combine(spmm.iteration_pair_bwd(
        *ip, gmi, gmo, plans, sig))
    reading = check_instrument(
        probes.iteration_pair_bwd_recompute(*ip, gmi, gmo, plans),
        spmm.iteration_pair_bwd(*ip, gmi, gmo, plans, sig), dt)
    tr = timed(recompute, (gmi, gmo), n_iters=args.iters)
    ts = timed(stashed, (gmi, gmo), n_iters=args.iters)
    print(f"V={v:6d} D={d:4d} bwd recompute       {tr * 1e6:8.1f} us   "
          f"bwd stashed-scores {ts * 1e6:8.1f} us "
          f"({(tr - ts) / tr * 100:+.1f}% saved); {reading}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser("probes.iter")
    ap.add_argument("--dtype", default="float32", choices=tuple(DTYPES))
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--ablate-stash", action="store_true")
    ap.add_argument("--only", default=None,
                    help="substring filter on variant names")
    ap.add_argument("--shape", choices=tuple(SHAPES), default="probe",
                    help="bench = the fullevent bench dims "
                    "(V=15848 E=180736 D=66 H=64)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' for tests")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    dt = DTYPES[args.dtype]
    print(f"# dtype={args.dtype} on {device_line(dev)}", flush=True)

    for v, e, d, hd in SHAPES[args.shape]:
        rng = np.random.default_rng(0)
        s, r = layered_graph(v, e)
        tab = lambda *shape, t=dt: torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev, t)
        h, pa, pb = tab(v, d), tab(v, hd), tab(v, hd)
        # the kernels take the edge MLP's weights in the tables' dtype
        w2, b1, b2 = tab(hd), tab(hd), tab(1)
        em = torch.ones(e, device=dev)
        plans = spmm.build_agg_plans(s, r, v).to(dev)
        sj, rj = (torch.from_numpy(a).to(dev) for a in (s, r))
        ems = spmm.sort_edge_weights(em, plans.recv)
        if args.ablate_stash:
            ablate_stash(args, dev, dt, v, e, d, plans, pa, pb, h, ems, w2,
                         b1, b2)
            continue
        em_d = em.to(dt)

        def plain(pa, pb, h):
            mi, mo = spmm.iteration_pair_reference(pa, pb, h, em_d, w2, b1,
                                                   b2, sj, rj, v)
            return mi + mo

        def unfused(pa, pb, h):
            pre = (pa.index_select(0, sj) + pb.index_select(0, rj)) \
                * em_d[:, None]
            z = torch.tanh(pre + b1)
            e_ = torch.sigmoid(z @ w2 + b2[0]) * em_d
            mi, mo = spmm.aggregate_pair(h, e_, plans)
            return mi + mo

        def fused(pa, pb, h):
            mi, mo = spmm.iteration_pair(pa, pb, h, ems, w2, b1, b2, plans)
            return mi + mo

        def fb(fn):
            # sum-of-squares gradient, so that the forward is needed
            def f(pa, pb, h):
                xs = [t.detach().requires_grad_() for t in (pa, pb, h)]
                g = torch.autograd.grad(
                    (fn(*xs).float() ** 2).sum(), xs)
                return (g[0] + g[1] + g[2][:, :hd]).float()
            return f

        for name, f in (("plain chain", plain), ("unfused cuda", unfused),
                        ("fused iteration", fused), ("fused pre:int8", None)):
            if args.only and args.only not in name:
                continue
            if f is None:
                print(f"V={v:6d} D={d:4d} {name:16s} absent: a TPU operand "
                      f"mechanism (prebuilt int8 one-hot windows); the port "
                      f"gathers rows", flush=True)
                continue
            t = timed(f, (pa, pb, h), n_iters=args.iters)
            tb = timed(fb(f), (pa, pb, h), n_iters=args.iters)
            print(f"V={v:6d} D={d:4d} {name:16s} fwd {t * 1e6:8.1f} us   "
                  f"fwd+bwd {tb * 1e6:8.1f} us", flush=True)


if __name__ == "__main__":
    main()
