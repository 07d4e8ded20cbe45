"""The scaling harness: edges/s a card against the number of ranks, for
data parallelism and for one graph partitioned across ranks, and an
analytic model of the partitioned step's halo traffic; the counterpart of
``bench_scaling.py``.

- ``dp``: weak scaling, the batch a rank fixed
  (``Trainer(strategy="dp")``, ``parallel/data_parallel.py``);
- ``partitioned``: strong scaling, one graph split across the ranks with
  halo exchange (``Trainer(strategy="partitioned")``,
  ``parallel/partition.py::partition_graph``), the ``sector`` graph or
  the ``fullevent`` one (36 packed kNN sectors).

The model is the SegmentClassifier on the sparse route in f32 with Adam
at 1e-3, as ``bench_scaling.py`` runs it.  Each count spawns one process
a rank that joins a ``torch.distributed`` group through a ``file://``
rendezvous: NCCL, one card a rank, where there are that many cards; gloo
otherwise.  A rank stacks ``--steps`` copies of its batch and runs them
with ``Trainer.run_steps``: one warm call (on NCCL it captures the
K-step graph), then one timed call ended by its loss readback.  Ranks
that share a card, or run on the CPU, time the mechanics only: their
record says ``"mechanics_only": true`` and carries no efficiency
(``"value": null``).

``comm_model`` predicts the partitioned fullevent step's efficiency from
a measured one-card step time and the halo sizes of the port's
``partition_graph``, for the packed sectors and for one connected graph
of the same size.

Deliberate differences from ``bench_scaling.py``: the link rate is the
card's, keyed by ``torch.cuda.get_device_name`` (an unknown card raises,
where the TPU model assumes a v5e); a step counts ``4 * n_iters + 2``
halo collectives, one all_to_all each way an iteration forward and back
and the final edge scoring's extend and its adjoint (the TPU model counts
``4 * (n_iters + 1)``); no efficiency with overlap is printed, since
overlap is not measured.

Usage: python -m gnn_fpga_tpu_torch.probes.scaling [--mode dp|partitioned|
           both|comm-model] [--step-ms MS] [--steps 30 --hidden 32
           --n-iters 4 --n-tracks 16 --batch 4] [--device-counts 1 2 4]
           [--scale sector|fullevent] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import traceback

import torch

from gnn_fpga_tpu_torch.core import graph as graph_lib
from gnn_fpga_tpu_torch.core.device import default_device
from gnn_fpga_tpu_torch.data import toy2d
from gnn_fpga_tpu_torch.parallel.partition import partition_graph
from gnn_fpga_tpu_torch.probes.common import (best_of, device_line,
                                              make_trainer)

# One direction of each card's link to its peers, GB/s, from NVIDIA's
# H100 Tensor Core GPU data sheet: the SXM5 part's NVLink 900 GB/s and
# the PCIe part's PCIe Gen5 128 GB/s are both directions together.
LINK_GBPS = {"NVIDIA H100 80GB HBM3": 450.0, "NVIDIA H100 PCIe": 64.0}
RANK_TIMEOUT_S = 600


def _fullevent_graph(n_sectors=36, n_layers=20, n_tracks=22, k=12):
    """One packed V = 15,840 kNN graph of 36 sectors: the fullevent
    regime, for partitioned strong scaling."""
    gs = toy2d.make_knn_segment_graphs(
        toy2d.Toy2DConfig(n_layers=n_layers, n_tracks=n_tracks, seed=0),
        n_sectors, k=k)
    return graph_lib.pack_graphs(graph_lib.unbatch_graphs(gs))


def _connected_fullevent_graph(n_layers=20, n_tracks=792, k=12):
    """One connected kNN graph at fullevent scale (V = 15,840), where
    halo partitioning communicates: the packed sectors are 36
    disconnected components whose halos are near zero."""
    gs = toy2d.make_knn_segment_graphs(
        toy2d.Toy2DConfig(n_layers=n_layers, n_tracks=n_tracks, seed=0),
        1, k=k)
    return graph_lib.unbatch_graphs(gs)[0]


def workload(mode, n_ranks, n_tracks, batch, scale="sector") -> tuple:
    """``(batch a step, real edges a step)`` of ``mode`` at ``n_ranks``:
    dp's batch of ``batch`` graphs a rank; the partitioned graph split
    into ``n_ranks`` shards."""
    if mode == "dp":
        g = toy2d.make_segment_graphs(
            toy2d.Toy2DConfig(n_layers=10, n_tracks=n_tracks, seed=0),
            batch * n_ranks)
        return g, float(g.edge_mask.sum())
    if scale == "fullevent":
        g = _fullevent_graph()
    else:
        g = graph_lib.unbatch_graphs(toy2d.make_segment_graphs(
            toy2d.Toy2DConfig(n_layers=10, n_tracks=n_tracks * batch,
                              seed=0), 1))[0]
    return partition_graph(g, n_ranks), float(g.edge_mask.sum())


def _rank_main(rank: int, world: int, directory: str, spec: dict) -> None:
    """One rank of :func:`run_mode` (a spawned process): joins the group,
    steps, and rank 0 writes ``edges_per_s``."""
    import torch.distributed as dist

    from gnn_fpga_tpu_torch.models import mpnn
    from gnn_fpga_tpu_torch.parallel import mesh as mesh_lib
    from gnn_fpga_tpu_torch.parallel import multihost
    from gnn_fpga_tpu_torch.train.trainer import TrainConfig, stack_batches

    try:
        device = torch.device(spec["device"])
        if device.type == "cpu":
            torch.set_num_threads(1)
        elif spec["backend"] == "gloo":
            torch.cuda.set_device(0)      # ranks sharing the one card
        multihost.initialize(f"file://{directory}/rendezvous", world, rank,
                             backend=spec["backend"])
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        axis = (mesh_lib.DATA_AXIS if spec["mode"] == "dp"
                else mesh_lib.GRAPH_AXIS)
        mesh = mesh_lib.make_mesh((world,), (axis,), device=device.type)
        batch, n_edges = workload(spec["mode"], world, spec["n_tracks"],
                                  spec["batch"], spec["scale"])
        trainer = make_trainer(
            mpnn.SegmentClassifierConfig(
                input_dim=2, hidden_dim=spec["hidden"],
                n_iters=spec["n_iters"], aggregation="sparse"),
            TrainConfig(learning_rate=1e-3), device, strategy=spec["mode"],
            mesh=mesh, capture=spec["backend"] == "nccl")
        stack = stack_batches([batch] * spec["n_steps"], device)
        trainer.run_steps(stack)              # warm (and capture)
        dt, losses = best_of(trainer, stack, 1)
        if rank == 0:
            with open(os.path.join(directory, "result.json"), "w") as f:
                json.dump({"edges_per_s": spec["n_steps"] * n_edges / dt,
                           "loss": float(losses[-1])}, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(directory, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _spawn(world: int, spec: dict) -> dict:
    """Run :func:`_rank_main` on ``world`` spawned processes; rank 0's
    result."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as directory:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, directory, spec))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(RANK_TIMEOUT_S)
        errors = []
        for r, p in enumerate(procs):
            if p.is_alive():
                p.kill()
                p.join()
                errors.append(f"rank {r} timed out after {RANK_TIMEOUT_S} s")
            err = os.path.join(directory, f"error_{r}.txt")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r} exited with {p.exitcode}")
        if errors:
            raise RuntimeError("\n".join(errors))
        with open(os.path.join(directory, "result.json")) as f:
            return json.load(f)


def run_mode(mode: str, device_counts, n_steps: int, hidden: int,
             n_iters: int, n_tracks: int, batch: int,
             scale: str = "sector", device=None) -> dict:
    """``{n: {"edges_per_s", "edges_per_s_per_chip", "backend",
    "mechanics_only"}}`` for each rank count ``n``: NCCL, one card a
    rank, where ``n`` cards exist; else gloo, the ranks sharing the card
    (or on the CPU with ``device="cpu"``), which times the mechanics
    only."""
    if mode not in ("dp", "partitioned"):
        raise ValueError(f"unknown mode {mode!r}")
    device = default_device(device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    results = {}
    for n in device_counts:
        backend = "nccl" if 0 < n <= cards else "gloo"
        spec = dict(mode=mode, device=device.type, backend=backend,
                    n_steps=n_steps, hidden=hidden, n_iters=n_iters,
                    n_tracks=n_tracks, batch=batch, scale=scale)
        eps = _spawn(n, spec)["edges_per_s"]
        results[n] = {"edges_per_s": eps, "edges_per_s_per_chip": eps / n,
                      "backend": backend,
                      "mechanics_only": backend != "nccl"}
    return results


def link_gbps(card=None) -> tuple:
    """``(card, GB/s a direction)``: ``card`` by name, default the CUDA
    device's (raising without one); a card not in :data:`LINK_GBPS`
    raises."""
    if card is None:
        card = torch.cuda.get_device_name(default_device())
    if card not in LINK_GBPS:
        raise ValueError(f"no link rate for {card!r}: the comm model knows "
                         f"{sorted(LINK_GBPS)}")
    return card, LINK_GBPS[card]


def n_collectives(n_iters: int) -> int:
    """Halo collectives of one partitioned train step: an all_to_all each
    way an iteration (pull and push), the final edge scoring's pull, and
    each one's adjoint in the backward."""
    return 2 * (2 * n_iters + 1)


def comm_model(step_ms_1chip: float, device_counts, hidden: int = 64,
               n_iters: int = 6, dtype_bytes: int = 2, card=None) -> list:
    """The partitioned fullevent train step's efficiency at each count of
    ``device_counts`` (from 2), without overlap: compute is the measured
    one-card step over ``P``; each collective moves ``(P - 1) * S * D *
    dtype_bytes`` bytes a card a direction (``S`` the halo rows a pair of
    shards, from the port's ``partition_graph``; ``D`` the
    shortcut-concatenated width); a step makes :func:`n_collectives`
    of them at the card's link rate.  One record for the packed sectors
    and one for a connected graph of the same size; each is printed and
    returned."""
    card, link = link_gbps(card)
    records = []
    for name, g in (("sectors", _fullevent_graph()),
                    ("connected", _connected_fullevent_graph())):
        d = hidden + g.x.shape[-1]
        n_coll = n_collectives(n_iters)
        out = {}
        for p in device_counts:
            if p < 2:
                continue
            s = partition_graph(g, p).halo_size
            bytes_dev = (p - 1) * s * d * dtype_bytes * n_coll
            t_comp = step_ms_1chip / p
            t_comm = bytes_dev / (link * 1e9) * 1e3
            out[str(p)] = {
                "halo_size": int(s),
                "comm_mb_per_step_per_dev": bytes_dev / 1e6,
                "t_comm_ms": t_comm,
                "t_comp_ms": t_comp,
                "eff_no_overlap": t_comp / (t_comp + t_comm),
            }
        record = {
            "metric": f"comm_model_partitioned_fullevent_{name}",
            "unit": "fraction",
            "step_ms_1chip": step_ms_1chip,
            "link_gbps_per_direction": link,
            "device_kind": card,
            "collectives_per_step": n_coll,
            "per_device_counts": out,
            "note": ("analytic: halo volume from the port's partition "
                     "plans, compute from the measured one-card step; no "
                     "overlap figure (overlap is not measured)"),
        }
        print(json.dumps(record), flush=True)
        records.append(record)
    return records


def main(argv=None) -> list:
    ap = argparse.ArgumentParser("probes.scaling")
    ap.add_argument("--mode", choices=["dp", "partitioned", "both",
                                       "comm-model"], default="both")
    ap.add_argument("--step-ms", type=float, default=None,
                    help="comm-model: the measured one-card fullevent "
                    "ms a step")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--n-iters", type=int, default=4)
    ap.add_argument("--n-tracks", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device-counts", type=int, nargs="*")
    ap.add_argument("--scale", choices=["sector", "fullevent"],
                    default="sector",
                    help="partitioned mode's graph: 'fullevent' = 36 "
                    "packed kNN sectors (V = 15,840)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' for tests")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    if args.mode == "comm-model":
        if args.step_ms is None:
            ap.error("--mode comm-model needs --step-ms (the measured "
                     "one-card fullevent ms a step)")
        # the fullevent model (bench.py): hidden 64, 6 iterations, bf16
        records = comm_model(args.step_ms, args.device_counts or [2, 4, 8],
                             hidden=64, n_iters=6)
        print(f"# device: {device_line(dev)}", flush=True)
        return records
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    counts = args.device_counts or [c for c in (1, 2, 4, 8)
                                    if c <= max(cards, 2)]
    modes = ["dp", "partitioned"] if args.mode == "both" else [args.mode]
    records = []
    for mode in modes:
        res = run_mode(mode, counts, args.steps, args.hidden, args.n_iters,
                       args.n_tracks, args.batch, args.scale, dev)
        mechanics = any(v["mechanics_only"] for v in res.values())
        base = res[counts[0]]["edges_per_s_per_chip"]
        eff = res[counts[-1]]["edges_per_s_per_chip"] / base
        suffix = "_fullevent" if (args.scale == "fullevent"
                                  and mode == "partitioned") else ""
        record = {
            "metric": f"scaling_efficiency_{mode}{suffix}",
            "value": None if mechanics else eff,
            "unit": "fraction",
            "devices": counts,
            "mechanics_only": mechanics,
            "per_device_counts": {str(k): v for k, v in res.items()},
        }
        if mechanics:
            record["note"] = ("ranks share a card or the CPU: the times "
                              "check the mechanics, not scaling")
        print(json.dumps(record), flush=True)
        records.append(record)
    print(f"# device: {device_line(dev)}", flush=True)
    return records


if __name__ == "__main__":
    main()
