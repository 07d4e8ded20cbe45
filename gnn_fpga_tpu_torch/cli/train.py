"""Training CLI for the segment classifier.

The counterpart of ``gnn_fpga_tpu/cli/train.py``, with the same flags and
defaults plus ``--device``: load NPZ graphs, split them into train, valid
and test sets rounded to batch multiples, train, report the test metrics,
and save ``model.npz`` (in the JAX package's parameter format, so either
package's infer CLI reads it) and ``losses.npz``.

- ``--aggregation blocked``: per-layer-pair blocks of the batched graphs
  (``ops/blocked.py``); needs per-node ``layer`` arrays in the NPZ graphs.
- ``--aggregation pallas``: batches packed into one flat graph with the
  CUDA kernels' plans attached (``ops/cuda/spmm.py``), built on the host
  as each batch is made.
- ``--bf16``: bf16 compute over f32 master weights.
- ``--prefetch N``: batches built and copied to the card by a background
  thread, N ahead of the step (``core/prefetch.py``).
- ``--device``: the card unless ``--device cpu`` is given; with no card
  and no ``--device`` the CLI raises.

``--strategy dp`` and ``partitioned`` are not ported yet: they raise
``NotImplementedError``.

Usage: python -m gnn_fpga_tpu_torch.cli.train --input-dir ... [--output-dir ...]
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
            help="dp and partitioned are not ported yet")
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


def _on_device(gen, device):
    for batch in gen:
        yield batch.to(device)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    if args.show_config:
        logging.info("Command line config: %s", args)
    if args.strategy != "single":
        raise NotImplementedError(
            f"--strategy {args.strategy} is not ported yet (ROADMAP Queue 1 "
            "item 12, 'Parallelism')")
    device = default_device(args.device)

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
    agg = args.aggregation
    packed = agg == "pallas"
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

    def transform_for(positions):
        if blocked_setup is not None:
            return blocked_setup.transform_for(positions)
        if packed:
            return lambda batch, idx: attach_plans(batch)
        return None

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
        trainer = Trainer(model, tcfg, checkpoint_dir=ckpt_dir,
                          metrics_path=metrics_path)
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

    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
        logging.info("Writing outputs to %s", args.output_dir)
        save_params_npz(os.path.join(args.output_dir, "model.npz"),
                        to_jax_params(model))
        np.savez(os.path.join(args.output_dir, "losses.npz"),
                 train_losses=np.asarray(trainer.train_losses),
                 valid_losses=np.asarray(trainer.valid_losses))
    logging.info("All done!")
    return trainer


if __name__ == "__main__":
    main()
