"""Example: Toy2D segment classification end to end, on the PyTorch/CUDA
port.

The port's counterpart of ``examples/train_toy2d.py``: generate
straight-track toy events, train the shared-weight SegmentClassifier,
evaluate, and plot an event display, the ROC curve and the losses.

Run:  python examples/train_toy2d_torch.py [--epochs 40] [--device cpu]
"""

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--events", type=int, default=2048)
    ap.add_argument("--hidden-dim", type=int, default=32)
    ap.add_argument("--n-iters", type=int, default=4)
    ap.add_argument("--out", default="toy2d_example")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    import torch

    from gnn_fpga_tpu_torch.core import batching
    from gnn_fpga_tpu_torch.core import graph as G
    from gnn_fpga_tpu_torch.core.device import default_device
    from gnn_fpga_tpu_torch.data import toy2d
    from gnn_fpga_tpu_torch.models import mpnn
    from gnn_fpga_tpu_torch.train.trainer import Trainer, TrainConfig
    from gnn_fpga_tpu_torch.utils import plotting

    device = default_device(args.device)
    cfg = toy2d.Toy2DConfig(n_layers=10, n_tracks=4, seed=0)
    train_g = toy2d.make_segment_graphs(cfg, args.events)
    valid_g = toy2d.make_segment_graphs(
        toy2d.Toy2DConfig(n_layers=10, n_tracks=4, seed=1), args.events // 4)

    batch = 32
    on_device = lambda gen: (b.to(device) for b in gen)
    gen = on_device(batching.batch_generator(train_g, batch, seed=0))
    vgen = on_device(batching.batch_generator(valid_g, batch, shuffle=False))

    mcfg = mpnn.SegmentClassifierConfig(
        input_dim=2, hidden_dim=args.hidden_dim, n_iters=args.n_iters)
    model = mpnn.init_segment_classifier(
        mcfg, torch.Generator().manual_seed(0), device=device)
    tr = Trainer(model, TrainConfig(learning_rate=5e-3),
                 checkpoint_dir=os.path.join(args.out, "ckpt"))
    tr.fit(gen, n_batches=args.events // batch, n_epochs=args.epochs,
           valid_generator=vgen, n_valid_batches=args.events // 4 // batch)

    metrics = tr.evaluate(vgen, args.events // 4 // batch)
    print("validation:", {k: round(float(v), 4) for k, v in metrics.items()})

    os.makedirs(args.out, exist_ok=True)
    preds, targets, mask = tr.predict(vgen, 4)
    plotting.plot_roc(targets, preds, mask,
                      filename=os.path.join(args.out, "roc.png"))
    plotting.plot_losses(tr.train_losses, tr.valid_losses,
                         filename=os.path.join(args.out, "losses.png"))
    one = G.unbatch_graphs(valid_g)[0]
    with torch.no_grad():
        scores = mpnn.segment_classifier(model, one.to(device)).cpu().numpy()
    plotting.draw_sample(one, e=scores, skip_false_edges=False,
                         axes_features=((1, 0), (1, 0)),
                         axis_labels=(("$r$", "$x$"), ("$r$", "$x$")),
                         filename=os.path.join(args.out, "event.png"))
    print("wrote", args.out)
    return metrics


if __name__ == "__main__":
    main()
