"""Example: the FPGA compression workflow, iterative magnitude pruning, on
the PyTorch/CUDA port.

The port's counterpart of ``examples/pruning_rounds.py``: train a dense
model, then run threshold -> mask -> transplant -> L1-retrain rounds,
reporting each layer's mask cardinality and the metrics after each round.

Run:  python examples/pruning_rounds_torch.py [--rounds 2] [--threshold 1e-2]
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--threshold", type=float, default=1e-2)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--l1", type=float, default=1e-4)
    ap.add_argument("--hidden-dim", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    import torch

    from gnn_fpga_tpu_torch.compress import pruning
    from gnn_fpga_tpu_torch.core import batching
    from gnn_fpga_tpu_torch.core.device import default_device
    from gnn_fpga_tpu_torch.data import toy2d
    from gnn_fpga_tpu_torch.models import mpnn
    from gnn_fpga_tpu_torch.train.trainer import Trainer, TrainConfig

    device = default_device(args.device)
    cfg = toy2d.Toy2DConfig(n_layers=10, n_tracks=4, seed=0)
    train_g = toy2d.make_segment_graphs(cfg, 1024)
    gen = (b.to(device)
           for b in batching.batch_generator(train_g, 32, seed=0))
    n_batches = 1024 // 32

    mcfg = mpnn.SegmentClassifierConfig(input_dim=2,
                                        hidden_dim=args.hidden_dim, n_iters=4)
    tcfg = TrainConfig(learning_rate=5e-3, l1=args.l1)

    def init(seed):
        return mpnn.init_segment_classifier(
            mcfg, torch.Generator().manual_seed(seed), device=device)

    # Round 0: dense training with the L1 penalty pushing weights to zero.
    tr = Trainer(init(0), tcfg)
    tr.fit(gen, n_batches=n_batches, n_epochs=args.epochs)
    print("dense:", {k: round(float(v), 4)
                     for k, v in tr.evaluate(gen, 8).items()})

    model, masks = tr.model, None
    for rnd in range(1, args.rounds + 1):
        # threshold -> masks, zeroing the pruned weights in place
        model, masks = pruning.prune_round(model, args.threshold)
        print(f"round {rnd} masks:", pruning.mask_summary(masks),
              f"sparsity={pruning.sparsity(masks):.3f}")
        # rebuild + transplant + L1 retrain
        tr = Trainer(init(rnd), tcfg, masks=masks)
        tr.load_weights(model.state_dict())
        tr.fit(gen, n_batches=n_batches, n_epochs=args.epochs)
        metrics = tr.evaluate(gen, 8)
        print(f"round {rnd}:", {k: round(float(v), 4)
                                for k, v in metrics.items()})
        model = tr.model

    n_nonzero = sum(int((m != 0).sum())
                    for lm in masks.values() for m in lm.values())
    print(f"final nonzero masked weights: {n_nonzero} "
          f"(of {mpnn.count_params(model)} total params)")
    return masks, metrics


if __name__ == "__main__":
    main()
