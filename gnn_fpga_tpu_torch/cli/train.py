"""Training CLI for the segment classifier.

The counterpart of ``gnn_fpga_tpu/cli/train.py``, with the same flags and
defaults plus ``--device``: load NPZ graphs, split them into train, valid
and test sets rounded to batch multiples, train, report the test metrics,
and save ``model.npz`` (in the JAX package's parameter format, so either
package's infer CLI reads it) and ``losses.npz``.

- ``--aggregation blocked``: per-layer-pair blocks of the batched graphs
  (``ops/blocked.py``); needs per-node ``layer`` arrays in the NPZ graphs.
- ``--aggregation pallas``: batches packed into one flat graph with the
  CUDA kernels' plans attached (``ops/cuda/spmm.py``): each graph's plans
  are built once when the dataset is loaded, and each batch's are
  composed from them and padded to capacities set for the bucket, so
  that every batch has one static shape (:class:`PlanSetup`).
- On the card the train step, the validation loss and the test
  predictions run as captured CUDA graphs (``train/trainer.py``), one
  for each batch shape; the first batch of a shape runs eagerly.
- ``--bf16``: bf16 compute over f32 master weights.
- ``--prefetch N``: batches built and copied to the card by a background
  thread, N ahead of the step (``core/prefetch.py``).
- ``--device``: the card unless ``--device cpu`` is given; with no card
  and no ``--device`` the CLI raises.

- ``--strategy dp``: data parallel, each rank its slice of every batch;
  ``--strategy partitioned``: each packed batch partitioned into one
  receiver-owned shard a rank (``parallel/partition.py``), with the
  fused kernels on each shard's extended table under ``--aggregation
  pallas`` and segment sums under ``auto`` or ``sparse``.  Launch them
  with ``torchrun --nproc-per-node N``; without a launcher they run as a
  world of one.  ``--backend``: NCCL on the card (one card a rank), gloo
  on the CPU; several ranks on one card need ``--backend gloo``, whose
  steps run eagerly (gloo's collectives cannot be captured).  Every rank
  builds the same batches; rank 0 writes the outputs.  Before training
  the partitioned path scans every split's batches for the largest shard
  edge count, halo and plan counts and pins them with 1.25x headroom
  (:class:`PartitionSetup`); a batch over a pin raises.

Usage: python -m gnn_fpga_tpu_torch.cli.train --input-dir ... [--output-dir ...]
       torchrun --nproc-per-node 4 -m gnn_fpga_tpu_torch.cli.train \
           --input-dir ... --strategy partitioned --aggregation pallas
"""

from __future__ import annotations

import argparse
import glob
import logging
import os

import numpy as np
import torch

from gnn_fpga_tpu_torch.core import batching
from gnn_fpga_tpu_torch.core.device import default_device
from gnn_fpga_tpu_torch.core.graph import (attach_plans,
                                           layer_offsets_from_layers,
                                           load_npz_with_extras)
from gnn_fpga_tpu_torch.core.prefetch import prefetch_to_device
from gnn_fpga_tpu_torch.models import mpnn
from gnn_fpga_tpu_torch.ops import blocked as blk
from gnn_fpga_tpu_torch.ops.cuda import spmm
from gnn_fpga_tpu_torch.train.trainer import Trainer, TrainConfig
from gnn_fpga_tpu_torch.utils.serialization import (save_params_npz,
                                                    to_jax_params)


def parse_args(argv=None):
    parser = argparse.ArgumentParser("train")
    add_arg = parser.add_argument
    add_arg("--input-dir", required=True)
    add_arg("--output-dir")
    add_arg("--n-samples", type=int, default=1024)
    add_arg("--valid-frac", type=float, default=0.1)
    add_arg("--test-frac", type=float, default=0.1)
    add_arg("--n-epochs", type=int, default=10)
    add_arg("--batch-size", type=int, default=32)
    add_arg("--hidden-dim", type=int, default=8)
    add_arg("--n-iters", type=int, default=3)
    add_arg("--learning-rate", type=float, default=1e-3)
    add_arg("--l1", type=float, default=0.0)
    add_arg("--pos-weight", type=float, default=1.0,
            help="BCE weight on positive edges (~n_fake/n_true escapes "
                 "base-rate collapse on high-pileup graphs)")
    add_arg("--aggregation", default="auto",
            choices=["auto", "dense", "sparse", "blocked", "pallas"],
            help="aggregation layout: blocked = per-layer-pair blocks "
                 "(needs 'layer' arrays in the NPZ); pallas = packed "
                 "batches + the fused CUDA kernels; auto picks dense for "
                 "small graphs")
    add_arg("--group", type=int, default=4,
            help="blocked path: layer pairs merged per block")
    add_arg("--bf16", action="store_true",
            help="bf16 compute dtype (f32 master weights)")
    add_arg("--strategy", default="single",
            choices=["single", "dp", "partitioned"],
            help="dp = data parallel over the ranks; partitioned = each "
                 "batch's packed graph split into one shard a rank")
    add_arg("--backend", default=None, choices=["nccl", "gloo"],
            help="collectives of dp and partitioned (default: nccl on the "
                 "card, gloo on the CPU; several ranks on one card need "
                 "gloo)")
    add_arg("--lr-schedule", default="constant",
            choices=["constant", "cosine"])
    add_arg("--prefetch", type=int, default=2,
            help="host batches prefetched to the device ahead of the "
                 "train step (0 disables)")
    add_arg("--seed", type=int, default=0)
    add_arg("--n-buckets", type=int, default=1,
            help="size buckets for padding (>1 cuts padding waste on "
                 "heavy-tailed size mixes)")
    add_arg("--resume", action="store_true",
            help="resume from checkpoint in output-dir")
    add_arg("--train-verbosity", type=int, default=0)
    add_arg("--show-config", action="store_true")
    add_arg("--device", default=None,
            help="torch device (default: the CUDA device; 'cpu' to run "
                 "on the CPU)")
    return parser.parse_args(argv)


def load_graph_files(input_dir: str, n_samples: int):
    """NPZ graphs and their per-node ``layer`` arrays (None where a file
    has none) from a directory, in file-name order."""
    files = sorted(glob.glob(os.path.join(input_dir, "*.npz")))[:n_samples]
    if not files:
        raise FileNotFoundError(f"no NPZ graphs under {input_dir}")
    loaded = [load_npz_with_extras(f) for f in files]
    graphs = [g for g, _ in loaded]
    layers = [ex.get("layer") for _, ex in loaded]
    return graphs, layers


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class BlockedSetup:
    """Dataset-wide static capacities and per-split transforms of the
    blocked path: per-graph layer offsets, with ``block_e`` and
    ``block_n`` pinned over the whole dataset so that every batch has one
    shape.  Graphs are named by their position in the dataset."""

    def __init__(self, graphs, layers, group: int):
        if any(l is None for l in layers):
            raise ValueError(
                "--aggregation blocked needs per-node 'layer' arrays in "
                "the NPZ graphs (hits sorted by layer, one layer id each)")
        self.group = group
        self.n_layers = max(int(np.asarray(l).max()) for l in layers) + 1
        n_pairs = self.n_layers - 1
        if n_pairs < 1:
            raise ValueError("blocked path needs >= 2 detector layers")
        n_blocks = _round_up(n_pairs, group) // group
        lo_idx = np.arange(n_blocks) * group
        hi_idx = np.minimum(lo_idx + group + 1, self.n_layers)
        be = bn = 8
        self.offsets = []
        for g, lay in zip(graphs, layers):
            off = layer_offsets_from_layers(lay, self.n_layers)
            self.offsets.append(off)
            pair = np.searchsorted(off, g.senders.numpy(), side="right") - 1
            cnt = np.bincount(np.clip(pair, 0, n_pairs - 1) // group,
                              minlength=n_blocks)
            be = max(be, int(cnt.max()))
            bn = max(bn, int((off[hi_idx] - off[lo_idx]).max()))
        self.block_e = _round_up(be, 8)
        self.block_n = _round_up(bn, 8)

    def transform_for(self, positions):
        """The batch transform of a split whose ``i``-th graph is graph
        ``positions[i]`` of the dataset."""
        offs = [self.offsets[p] for p in positions]

        def transform(batch, idx):
            off_b = np.stack([offs[i] for i in idx])
            return blk.attach_blocks_layered(
                batch, off_b, group=self.group,
                block_e=self.block_e, block_n=self.block_n)

        return transform


class PlanSetup:
    """The fused kernels' plans of the pallas route, built once per graph
    of the dataset, and the static capacities that every batch's composed
    plans are padded to (``ops/cuda/spmm.py::batch_capacity``: the
    ``batch_size`` largest per-graph counts and the pad node's), as
    :class:`BlockedSetup` pins the blocked route's.  Graphs are named by
    their position in the dataset."""

    def __init__(self, graphs, bucket: batching.BucketSpec,
                 batch_size: int):
        self.plans = [spmm.build_agg_plans(g.senders.numpy(),
                                           g.receivers.numpy(), g.n_node)
                      for g in graphs]
        self.capacity = spmm.batch_capacity(
            self.plans, batch_size, bucket.n_node * batch_size,
            bucket.n_edge * batch_size)

    def transform_for(self, positions):
        """The batch transform of a split whose ``i``-th graph is graph
        ``positions[i]`` of the dataset."""
        plans = [self.plans[p] for p in positions]

        def transform(batch, idx):
            return attach_plans(batch, [plans[i] for i in idx],
                                self.capacity)

        return transform


class PartitionSetup:
    """The static capacities of the partitioned path: every split's
    batches (not only the train split's) partitioned once, in order, for
    the largest shard edge count, per-pair halo and plan counts, each
    pinned with 1.25x headroom (the plan counts by
    ``PlanCapacity.with_headroom``), so that one captured step
    serves every batch; shuffled batches regroup graphs, and a batch over
    a pin raises rather than being captured anew."""

    def __init__(self, splits, bucket: batching.BucketSpec, batch_size: int,
                 n_parts: int, plans: bool):
        from gnn_fpga_tpu_torch.parallel import partition as part

        self.n_parts, self.plans = n_parts, plans
        batches = []
        for graphs in splits:
            n = len(graphs) // batch_size
            if n:
                gen = batching.batch_generator(graphs, batch_size, bucket,
                                               shuffle=False, packed=True)
                batches += [next(gen) for _ in range(n)]
        max_e = s_pair = 1
        for b in batches:
            pg = part.partition_graph(b, n_parts)
            max_e = max(max_e, pg.senders.shape[-1])
            s_pair = max(s_pair, pg.halo_size)
        self.edge_capacity = _round_up(int(max_e * 1.25), 8)
        self.halo_capacity = _round_up(int(s_pair * 1.25), 8)
        self.capacity = None
        if plans:
            cover = part.shard_capacity(*(
                part.partition_graph(b, n_parts, plans=True,
                                     edge_capacity=self.edge_capacity,
                                     halo_capacity=self.halo_capacity)
                for b in batches))
            self.capacity = cover.with_headroom(1.25)

    def transform(self, batch, idx):
        from gnn_fpga_tpu_torch.parallel import partition as part

        return part.partition_graph(
            batch, self.n_parts, plans=self.plans,
            edge_capacity=self.edge_capacity,
            halo_capacity=self.halo_capacity, capacity=self.capacity)


def _on_device(gen, device):
    for batch in gen:
        yield batch.to(device)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    if args.show_config:
        logging.info("Command line config: %s", args)
    agg = args.aggregation
    if args.strategy == "partitioned" and agg in ("blocked", "dense"):
        # the JAX CLI partitions such batches and drops the route unsaid
        raise ValueError(f"--aggregation {agg} does not combine with "
                         "--strategy partitioned; use pallas, sparse or auto")
    if agg == "pallas" and args.strategy == "dp":
        raise ValueError("--aggregation pallas (packed batches) does not "
                         "combine with --strategy dp; use partitioned")
    device = default_device(args.device)
    mesh = None
    created_world = False
    if args.strategy != "single":
        from torch import distributed as dist

        from gnn_fpga_tpu_torch.parallel import mesh as mesh_lib
        from gnn_fpga_tpu_torch.parallel import multihost

        backend = args.backend or multihost.default_backend(device)
        created_world = not dist.is_initialized()
        multihost.initialize(backend=backend)
        multihost.initialize_single(backend)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        axis = (mesh_lib.DATA_AXIS if args.strategy == "dp"
                else mesh_lib.GRAPH_AXIS)
        mesh = mesh_lib.make_mesh(axis_names=(axis,), device=device.type)
        n_dev = mesh.size(0)
        logging.info("%s over %i ranks (%s)", args.strategy, n_dev,
                     dist.get_backend())
        if args.strategy == "dp" and args.batch_size % n_dev:
            raise ValueError(f"--batch-size {args.batch_size} not divisible "
                             f"by {n_dev} ranks for --strategy dp")

    logging.info("Loading input graphs")
    graphs, layer_arrays = load_graph_files(args.input_dir, args.n_samples)
    n = len(graphs)

    # Partition sizes rounded to batch multiples.
    bs = args.batch_size
    n_test = int(n * args.test_frac) // bs * bs
    n_valid = int(n * args.valid_frac) // bs * bs
    n_train = (n - n_valid - n_test) // bs * bs
    if n_train <= 0:
        raise ValueError(f"no training data: {n} graphs, batch {bs}")
    rng = np.random.default_rng(args.seed)
    order = rng.permutation(n)
    test_idx = order[:n_test]
    valid_idx = order[n_test:n_test + n_valid]
    train_idx = order[n_test + n_valid:n_test + n_valid + n_train]
    logging.info("Train set size: %i", len(train_idx))
    logging.info("Valid set size: %i", len(valid_idx))
    logging.info("Test set size:  %i", len(test_idx))

    # --- route selection ---------------------------------------------------
    partitioned = args.strategy == "partitioned"
    packed = agg == "pallas" or partitioned
    # The JAX CLI's multiples, so that both packages pad to one shape.
    edge_mult = 256 if packed else 128
    if args.n_buckets > 1 and not packed:
        bucket = batching.choose_buckets(graphs, args.n_buckets,
                                         edge_multiple=edge_mult)
        logging.info("Buckets: %s (padding efficiency %.2f -> %.2f)",
                     bucket,
                     batching.padding_efficiency(
                         graphs, batching.choose_bucket(graphs), bs),
                     batching.padding_efficiency(graphs, bucket, bs))
    else:
        bucket = batching.choose_bucket(graphs, edge_multiple=edge_mult)

    blocked_setup = None
    if agg == "blocked":
        blocked_setup = BlockedSetup(graphs, layer_arrays, args.group)
        logging.info("Blocked plan: %i layers, group %i, block_e %i, "
                     "block_n %i", blocked_setup.n_layers, args.group,
                     blocked_setup.block_e, blocked_setup.block_n)

    plan_setup = part_setup = None
    if partitioned:
        part_setup = PartitionSetup(
            [[graphs[i] for i in idx] for idx in (train_idx, valid_idx,
                                                  test_idx)],
            bucket, bs, n_dev, plans=agg == "pallas")
        logging.info("Partitioned over %i ranks: edge_capacity %i, "
                     "halo_capacity %i, plan capacity %s", n_dev,
                     part_setup.edge_capacity, part_setup.halo_capacity,
                     part_setup.capacity)
    elif packed:
        plan_setup = PlanSetup(graphs, bucket, bs)
        logging.info("Plan capacity: %s", plan_setup.capacity)

    def transform_for(positions):
        if part_setup is not None:
            return part_setup.transform
        setup = blocked_setup or plan_setup
        return None if setup is None else setup.transform_for(positions)

    def make_gen(positions, shuffle, seed=0):
        return batching.batch_generator(
            [graphs[i] for i in positions], bs, bucket, shuffle=shuffle,
            seed=seed, packed=packed, transform=transform_for(positions))

    train_gen = make_gen(train_idx, shuffle=True, seed=args.seed)
    if args.prefetch > 0:
        train_gen = prefetch_to_device(train_gen, size=args.prefetch,
                                       device=device)
    else:
        train_gen = _on_device(train_gen, device)
    valid_gen = (_on_device(make_gen(valid_idx, shuffle=False), device)
                 if n_valid else None)
    test_gen = (_on_device(make_gen(test_idx, shuffle=False), device)
                if n_test else None)

    try:
        logging.info("Building the model")
        mcfg = mpnn.SegmentClassifierConfig(
            input_dim=graphs[0].n_feature, hidden_dim=args.hidden_dim,
            n_iters=args.n_iters, aggregation=agg,
            compute_dtype=torch.bfloat16 if args.bf16 else None)
        model = mpnn.init_segment_classifier(
            mcfg, torch.Generator().manual_seed(args.seed), device=device)
        n_batches = n_train // bs
        tcfg = TrainConfig(learning_rate=args.learning_rate, l1=args.l1,
                           pos_weight=args.pos_weight,
                           lr_schedule=args.lr_schedule,
                           decay_steps=max(args.n_epochs * n_batches, 1))
        ckpt_dir = (os.path.join(args.output_dir, "checkpoints")
                    if args.output_dir else None)
        metrics_path = (os.path.join(args.output_dir, "metrics.jsonl")
                        if args.output_dir else None)
        # gloo's collectives cannot be captured: its steps run eagerly
        capture = not (mesh is not None and device.type == "cuda"
                       and backend == "gloo")
        trainer = Trainer(model, tcfg, checkpoint_dir=ckpt_dir,
                          metrics_path=metrics_path,
                          strategy=args.strategy, capture=capture, mesh=mesh)
        if args.resume and trainer.load_checkpoint():
            logging.info("Resumed from epoch %i", trainer.epoch)

        trainer.fit(train_gen, n_batches=n_batches, n_epochs=args.n_epochs,
                    valid_generator=valid_gen,
                    n_valid_batches=n_valid // bs,
                    verbose=args.train_verbosity)
    finally:
        if args.prefetch > 0:
            train_gen.close()

    if test_gen is not None:
        logging.info("Evaluating the test set")
        metrics = trainer.evaluate(test_gen, n_test // bs)
        for k, v in metrics.items():
            logging.info("%s: %.4f", k.capitalize(), v)

    if args.output_dir and trainer.is_writer:
        os.makedirs(args.output_dir, exist_ok=True)
        logging.info("Writing outputs to %s", args.output_dir)
        save_params_npz(os.path.join(args.output_dir, "model.npz"),
                        to_jax_params(model))
        np.savez(os.path.join(args.output_dir, "losses.npz"),
                 train_losses=np.asarray(trainer.train_losses),
                 valid_losses=np.asarray(trainer.valid_losses))
    if created_world:
        from torch import distributed as dist

        dist.destroy_process_group()
    logging.info("All done!")
    return trainer


if __name__ == "__main__":
    main()
