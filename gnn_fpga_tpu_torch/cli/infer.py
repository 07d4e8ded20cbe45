"""Standalone inference CLI.

The counterpart of ``gnn_fpga_tpu/cli/infer.py``, with its flags plus
``--device``: load a trained model (``model.npz`` in the JAX package's
parameter format, written by either package's train CLI), score saved
graphs, and with ``--benchmark`` time the forward.  Each graph is padded
to one bucket and scored with ``aggregation="auto"``, which at sector
scale is the dense route.  The forward is one captured CUDA graph
(``core/capture.py``), the counterpart of the JAX CLI's jitted forward:
each file is copied into its static input buffers and the graph
replayed; the first file's forward runs eagerly and is captured.

Usage: python -m gnn_fpga_tpu_torch.cli.infer --model ... --input-dir ... \
           [--hidden-dim 4 --n-iters 1]
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import time

import torch

from gnn_fpga_tpu_torch.core import batching
from gnn_fpga_tpu_torch.core.capture import CapturedCall
from gnn_fpga_tpu_torch.core.device import default_device
from gnn_fpga_tpu_torch.core.graph import load_npz, pad_graph
from gnn_fpga_tpu_torch.models import mpnn
from gnn_fpga_tpu_torch.utils.serialization import (load_jax_params,
                                                    load_params_npz)

N_BENCHMARK = 100


def parse_args(argv=None):
    parser = argparse.ArgumentParser("infer")
    add_arg = parser.add_argument
    add_arg("--model", required=True, help="model.npz from the train CLI")
    add_arg("--input-dir", required=True)
    add_arg("--n-graphs", type=int, default=1)
    add_arg("--hidden-dim", type=int, default=4)
    add_arg("--n-iters", type=int, default=1)
    add_arg("--output")
    add_arg("--benchmark", action="store_true",
            help="time the forward after warm-up")
    add_arg("--device", default=None,
            help="torch device (default: the CUDA device; 'cpu' to run "
                 "on the CPU)")
    return parser.parse_args(argv)


def load_model(path: str, input_dim: int, hidden_dim: int, n_iters: int,
               device) -> mpnn.SegmentClassifier:
    """A SegmentClassifier holding the parameters of ``path``."""
    cfg = mpnn.SegmentClassifierConfig(input_dim=input_dim,
                                       hidden_dim=hidden_dim, n_iters=n_iters)
    model = mpnn.init_segment_classifier(cfg, torch.Generator(),
                                         device=device)
    load_jax_params(model, load_params_npz(path))
    return model


def captured_forward(model, device) -> CapturedCall:
    """The scoring forward ``segment_classifier(model, g)`` as a captured
    call on ``device``, for graphs padded to one bucket."""
    def forward(g):
        with torch.no_grad():
            return mpnn.segment_classifier(model, g)

    return CapturedCall(forward, device)


def benchmark(forward: CapturedCall, g, n_rep: int = N_BENCHMARK) -> float:
    """Seconds per forward of ``g``: ``g`` loaded into the captured
    forward and run once as warm-up, then ``n_rep`` replays (eager calls
    on the CPU) ending in a synchronisation on a CUDA device."""
    cuda = forward.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    forward(g)
    sync()
    t0 = time.perf_counter()
    for _ in range(n_rep):
        if forward.captured:
            forward.replay()
        else:
            forward(g)
    sync()
    return (time.perf_counter() - t0) / n_rep


def run(args):
    """``(results, latency_s)``: per-file scores, and seconds per forward
    under ``--benchmark`` (else None)."""
    device = default_device(args.device)
    files = sorted(glob.glob(os.path.join(args.input_dir, "*.npz")))
    files = files[:args.n_graphs]
    graphs = [load_npz(f) for f in files]
    model = load_model(args.model, graphs[0].n_feature, args.hidden_dim,
                       args.n_iters, device)
    logging.info("Parameters: %i", mpnn.count_params(model))

    bucket = batching.choose_bucket(graphs)
    padded = [pad_graph(g, bucket.n_node, bucket.n_edge) for g in graphs]
    forward = captured_forward(model, device)
    results = []
    for path, gp in zip(files, padded):
        scores = forward(gp)
        em = forward.inputs.edge_mask > 0
        n_edges, mean = int(em.sum()), float(scores[em].mean())
        results.append({"file": os.path.basename(path),
                        "n_edges": n_edges, "mean_score": mean})
        logging.info("%s: %i edges, mean score %.4f", path, n_edges, mean)

    latency = None
    if args.benchmark:
        latency = benchmark(forward, padded[0])
        logging.info("Latency: %.1f us/graph", latency * 1e6)

    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)
    return results, latency


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    return run(parse_args(argv))[0]


if __name__ == "__main__":
    main()
