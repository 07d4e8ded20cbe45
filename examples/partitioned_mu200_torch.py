"""Example: training on one large (mu200-scale) graph partitioned across
ranks, on the PyTorch/CUDA port.

The port's counterpart of ``examples/partitioned_mu200.py``: one Toy2D
event with many tracks, split into one receiver-owned shard a rank
(``gnn_fpga_tpu_torch/parallel/partition.py``), trained by the same
``Trainer`` as single-device training with ``strategy="partitioned"``.
Each rank holds ``[N/P + P*S, D]`` rows of node state (its own rows and
its halo), and each shard's iterations run the fused kernel on that
extended table (on the CPU, its plain version).

Run on one card, or one rank a card with torchrun:
  python examples/partitioned_mu200_torch.py
  torchrun --nproc-per-node 4 examples/partitioned_mu200_torch.py
On the CPU, with four processes:
  torchrun --nproc-per-node 4 examples/partitioned_mu200_torch.py --device cpu
"""

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-tracks", type=int, default=48,
                    help="tracks per event (~mu200 occupancy when large)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--hidden-dim", type=int, default=64)
    ap.add_argument("--n-iters", type=int, default=6)
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 mixed-precision sharded forward")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="default: nccl on the card, gloo on the CPU")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from gnn_fpga_tpu_torch.core import graph as G
    from gnn_fpga_tpu_torch.core.device import default_device
    from gnn_fpga_tpu_torch.data import toy2d
    from gnn_fpga_tpu_torch.models import mpnn
    from gnn_fpga_tpu_torch.parallel import mesh as mesh_lib
    from gnn_fpga_tpu_torch.parallel import multihost
    from gnn_fpga_tpu_torch.parallel import partition
    from gnn_fpga_tpu_torch.train.trainer import Trainer, TrainConfig

    device = default_device(args.device)
    backend = args.backend or multihost.default_backend(device)
    created = not dist.is_initialized()
    multihost.initialize(backend=backend)
    multihost.initialize_single(backend)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = mesh_lib.make_mesh(axis_names=(mesh_lib.GRAPH_AXIS,),
                              device=device.type)
    n_dev = mesh.size(0)
    print(f"{n_dev} ranks ({backend}), this one on {device}")

    cfg = toy2d.Toy2DConfig(n_layers=10, n_tracks=args.n_tracks, seed=0)
    big = G.unbatch_graphs(toy2d.make_segment_graphs(cfg, 1))[0]
    print(f"graph: {big.n_node} nodes, {big.n_edge} edges")
    pg = partition.partition_graph(big, n_dev, plans=True)
    print(f"partitioned: {pg.n_parts} shards x {pg.n_local} nodes, "
          f"{pg.senders.shape[1]} edges/shard, halo {pg.halo_size}/pair")
    pg = pg.to(device)

    mcfg = mpnn.SegmentClassifierConfig(
        input_dim=2, hidden_dim=args.hidden_dim, n_iters=args.n_iters,
        compute_dtype=torch.bfloat16 if args.bf16 else None)
    model = mpnn.init_segment_classifier(
        mcfg, torch.Generator().manual_seed(0), device=device)
    trainer = Trainer(model, TrainConfig(), strategy="partitioned",
                      mesh=mesh, capture=backend == "nccl"
                      or device.type == "cpu")

    def gen():
        while True:
            yield pg

    n_edges = int(np.asarray(big.edge_mask).sum())
    t0 = time.perf_counter()
    trainer.fit(gen(), n_batches=args.steps, n_epochs=1)
    dt = time.perf_counter() - t0
    print(f"loss {trainer.train_losses[-1]:.4f}; "
          f"{args.steps * n_edges / dt / 1e6:.3f}M edges/s over {n_dev} "
          f"ranks (first step of the shape included)")
    m = trainer.evaluate(gen(), 1)
    print({k: round(v, 4) for k, v in m.items()})
    if created:
        dist.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
