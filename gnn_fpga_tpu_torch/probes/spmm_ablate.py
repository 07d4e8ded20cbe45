"""Ablation of the single-direction SpMM: where does its time go?  The
counterpart of ``benchmarks/probe_spmm_ablate.py``.

Times ``ops/cuda/probes.py::ablate_rows`` (``csrc/probes.cu``) in each
mode on one plan (seg = receivers, oth = senders, as the TPU probe builds
it) of the layered graph: ``full`` (the production ``spmm_raw``'s walk,
bit for bit), ``no_gather`` (rows ``h[j mod 256]``), ``no_scatter``
(groups of 2,048 sorted edges, one row written a group), ``compute``
(both), ``ids_only`` (the plan's ids and weights alone) and ``aligned``
(``full`` on rows padded to a 16-byte pitch), beside ``spmm_raw`` itself.
The TPU probe's one-hot builds (``k_onehot``) have no counterpart: the
port builds none, and ``ids_only`` reads the ids they were built from.
At the TPU probe's constants (V = 16,384, E = 131,072, D = 128, bf16 h,
500 chained calls), then, which the TPU probe lacks, the same modes at the
fullevent width D = 66 in bf16 and f32 (72 and 68 padded), which asks why
rows of that width run slower in bf16 than in f32.

Usage: python -m gnn_fpga_tpu_torch.probes.spmm_ablate [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gnn_fpga_tpu_torch.core.device import default_device
from gnn_fpga_tpu_torch.ops.cuda import probes, spmm
from gnn_fpga_tpu_torch.probes.common import device_line, layered_graph, timed

V, E, D = 16384, 131072, 128
# (width, dtype) of h: the TPU probe's, then the fullevent width
CASES = ((D, torch.bfloat16), (66, torch.bfloat16), (66, torch.float32))
N_ITERS = 500
# mode -> the row's label (the TPU probe's row it stands for)
ROWS = {
    "full": "full (current: spmm_raw's walk)",
    "no_gather": "scatter only (rows h[j mod 256], no gather)",
    "no_scatter": "gather only (2,048-edge groups, no scatter)",
    "aligned": "full, 16-byte row pitch",
    "compute": "compute only (no gather, no scatter)",
    "ids_only": "ids and weights only (no rows)",
}


def main(argv=None):
    ap = argparse.ArgumentParser("probes.spmm_ablate")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' for tests")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    v, e = V, E
    s, r = layered_graph(v, e)
    plan = spmm.build_edge_plan(r, s, v).to(dev)

    def report(name, sec):
        print(f"{name:52s} {sec * 1e6:9.1f} us  {e / sec / 1e6:8.1f} "
              f"Medge/s", flush=True)

    for d, dt in CASES:
        rng = np.random.default_rng(0)
        h = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
        h = h.to(dev, dt)
        w = torch.from_numpy(rng.standard_normal((e,)).astype(np.float32))
        w = w.to(dev)
        padded = probes.pad_rows(h)
        full = probes.ablate_rows(h, w, plan, "full")
        same = (torch.equal(full, spmm.spmm_raw(h, w, plan))
                and torch.equal(full, probes.ablate_rows(
                    padded, w, plan, "aligned", width=d)))
        tag = str(dt).replace("torch.", "")
        print(f"# V={v} E={e} D={d} (pitch {padded.shape[1]} aligned) "
              f"dtype={tag} on {device_line(dev)}; full equals spmm_raw and "
              f"aligned equals full bit for bit: {same}", flush=True)
        report("spmm_raw (production)",
               timed(lambda hh: spmm.spmm_raw(hh, w, plan), (h,),
                     n_iters=N_ITERS))
        for mode, label in ROWS.items():
            if mode == "aligned":
                run = lambda hh: probes.ablate_rows(hh, w, plan, "aligned",
                                                    width=d)
                table = padded
            else:
                run = lambda hh, m=mode: probes.ablate_rows(hh, w, plan, m)
                table = h
            report(label, timed(run, (table,), n_iters=N_ITERS))


if __name__ == "__main__":
    main()
