"""Graph-building CLI for TrackML-format data.

The counterpart of ``gnn_fpga_tpu/cli/prepare_graphs.py``, with its flags
plus ``--device``: hit selection -> phi sectors -> doublet graphs -> NPZ
files with the JAX writer's keys and dtypes (``layer`` included), so
either package reads the other's files.  No pandas: the CSVs are read by
the port's own reader.

The cross-join of every sector runs on ``--device``, the card unless
``--device cpu`` is given (with no card and no ``--device`` the CLI
raises): one CUDA kernel call a graph.  ``--n-workers N`` (> 1) loads,
selects and splits events into sectors in N worker processes (started
with ``spawn``; they do host work only, as a forked child cannot use
CUDA) while the parent builds the graphs of the events already loaded,
in event order.

Usage: python -m gnn_fpga_tpu_torch.cli.prepare_graphs --input-dir ... --output-dir ...
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import logging
import multiprocessing as mp
import os
import time
from typing import List, Tuple

import numpy as np

from gnn_fpga_tpu_torch.core.device import default_device
from gnn_fpga_tpu_torch.core.graph import Graph, _np, save_npz
from gnn_fpga_tpu_torch.data import doublets, selection, trackml_io
from gnn_fpga_tpu_torch.data.table import Table


def parse_args(argv=None):
    parser = argparse.ArgumentParser("prepare_graphs")
    add_arg = parser.add_argument
    add_arg("--input-dir", required=True)
    add_arg("--output-dir")
    add_arg("--n-files", type=int, default=1)
    add_arg("--n-workers", type=int, default=1)
    add_arg("--pt-min", type=float, default=1, help="pt cut")
    add_arg("--n-tracks", type=int, help="Max tracks per event")
    add_arg("--phi-slope-max", type=float, default=0.001, help="phi slope cut")
    add_arg("--phi-slope-mid-max", type=float, default=0.001,
            help="phi slope middle cut")
    add_arg("--phi-slope-outer-max", type=float, default=0.001,
            help="phi slope outer cut")
    add_arg("--z0-max", type=float, default=200, help="z0 cut")
    add_arg("--n-phi-sectors", type=int, default=8,
            help="Break detector into number of phi sectors")
    add_arg("--select-phi-sector", action="store_true",
            help="select one phi sector")
    add_arg("--no-missing-hits", action="store_true",
            help="Require no missing hits")
    add_arg("--show-config", action="store_true")
    add_arg("--device", default=None,
            help="torch device of the cross-join (default: the CUDA device; "
                 "'cpu' to run on the CPU)")
    return parser.parse_args(argv)


def load_sectors(prefix: str, args) -> Tuple[List[Table], dict]:
    """One event's hits, selected and split into phi sectors, and the
    seconds spent reading and selecting: the host part of an event, which
    the worker processes run."""
    evtid = trackml_io.event_id_from_prefix(prefix)
    logging.info("Event %i, loading data", evtid)
    t0 = time.perf_counter()
    hits, particles, truth = trackml_io.load_event(prefix)
    t1 = time.perf_counter()
    hits = selection.select_hits(
        hits, truth, particles, pt_min=args.pt_min,
        no_missing_hits=args.no_missing_hits).assign(evtid=np.int64(evtid))
    sectors = selection.split_phi_sectors(
        hits, n_phi_sectors=args.n_phi_sectors,
        select_phi_sector=args.select_phi_sector)
    t2 = time.perf_counter()
    return sectors, {"read_s": t1 - t0, "select_s": t2 - t1}


def build_graphs(sectors: List[Table], args, device) -> list:
    """One ``(graph, layers)`` a sector (``(None, None)`` where no segment
    survives), nodes sorted by (layer, phi); the cross-join on
    ``device``."""
    cuts = doublets.SegmentCuts(
        phi_slope_max=args.phi_slope_max,
        phi_slope_mid_max=args.phi_slope_mid_max,
        phi_slope_outer_max=args.phi_slope_outer_max,
        z0_max=args.z0_max)
    feature_scale = np.array([1000.0, np.pi / args.n_phi_sectors, 1000.0])
    layer_pairs = doublets.adjacent_layer_pairs(10)
    return [doublets.construct_graph(
                sector, layer_pairs, cuts=cuts,
                feature_names=["r", "phi", "z"], feature_scale=feature_scale,
                max_tracks=args.n_tracks,
                no_missing_hits=args.no_missing_hits,
                sort_by_layer=True, return_layers=True, device=device)
            for sector in sectors]


def graphs_summary(graphs: List[Graph], n_true_expected: int = 90) -> dict:
    """Dataset summary with the reference's missing-true-edge accounting
    (90 expected true edges = 10 tracks x 9 layer pairs for mu10)."""
    n_nodes = [g.n_node for g in graphs]
    n_edges = [g.n_edge for g in graphs]
    n_true = [float(_np(g.y).sum()) for g in graphs]
    n_missed = [n_true_expected - t for t in n_true]
    n_ev = max(len(graphs), 1)
    return {
        "n_events": len(graphs),
        "n_edges": int(sum(n_edges)),
        "edges_per_event": sum(n_edges) / n_ev,
        "nodes_per_event": sum(n_nodes) / n_ev,
        "mean_missed_true_edges": float(np.mean(n_missed)) if graphs else 0.0,
        "purity": (sum(n_true) / max(sum(n_edges), 1)),
    }


def run(args) -> Tuple[List[Graph], List[dict]]:
    """The CLI's work: the graphs of every sector with segments, in event
    then sector order (written to ``--output-dir`` as NPZ files with
    their ``layer`` arrays), and one dict of seconds an event
    (``read_s``, ``select_s``, and ``build_s``: the graphs, their
    cross-join included)."""
    device = default_device(args.device)
    prefixes = trackml_io.find_event_prefixes(args.input_dir, args.n_files)
    logging.info("Processing %i events with %i workers",
                 len(prefixes), args.n_workers)
    pairs, times = [], []
    with contextlib.ExitStack() as stack:
        if args.n_workers > 1:   # events in order, as the workers load them
            pool = stack.enter_context(
                mp.get_context("spawn").Pool(processes=args.n_workers))
            loaded = pool.imap(functools.partial(load_sectors, args=args),
                               prefixes)
        else:
            loaded = (load_sectors(p, args) for p in prefixes)
        for sectors, t in loaded:
            t0 = time.perf_counter()
            built = build_graphs(sectors, args, device)
            times.append(dict(t, build_s=time.perf_counter() - t0))
            pairs += [gl for gl in built if gl[0] is not None]
    graphs = [g for g, _ in pairs]
    logging.info("Graphs summary: %s", graphs_summary(graphs))

    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
        logging.info("Writing outputs to %s", args.output_dir)
        for i, (g, layers) in enumerate(pairs):
            save_npz(g, os.path.join(args.output_dir, f"graph{i:06d}.npz"),
                     layer=layers)
    return graphs, times


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    if args.show_config:
        logging.info("Command line config: %s", args)
    return run(args)[0]


if __name__ == "__main__":
    main()
