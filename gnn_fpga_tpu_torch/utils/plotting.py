"""Host-side graph visualisation (matplotlib).

The counterpart of ``gnn_fpga_tpu/utils/plotting.py``: two panels of hit
scatter and segment lines, edges coloured by truth or score, iteration
panels, loss and ROC curves, weight histograms and the exploration
plots.  matplotlib (Agg) is imported when a function draws, never when the
module is imported, so the package imports where matplotlib is absent.
Graphs are the port's (tensors are read back to the host); the weight
histograms take a model or a nested dict/list of arrays.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from gnn_fpga_tpu_torch.core.graph import Graph, _np


def _plt():
    """matplotlib's pyplot on the Agg backend, imported at first use."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _real_parts(g: Graph):
    x = _np(g.x)
    em = _np(g.edge_mask) > 0
    nm = _np(g.node_mask) > 0
    return (x, _np(g.senders)[em], _np(g.receivers)[em], _np(g.y)[em], nm)


def draw_sample(
    g: Graph,
    e: Optional[np.ndarray] = None,
    axes_features: Tuple[Tuple[int, int], Tuple[int, int]] = ((2, 1), (0, 1)),
    axis_labels: Sequence[Tuple[str, str]] = (("$z$", "$\\phi$"),
                                              ("$r$", "$\\phi$")),
    cmap: str = "bwr_r",
    skip_false_edges: bool = True,
    alpha_labels: bool = False,
    filename: Optional[str] = None,
    title: Optional[str] = None,
):
    """Two-panel hit-and-segment display (`Muon_graph.py:219-264`).

    ``e``: optional per-edge values to colour by (model scores); defaults
    to the truth labels ``g.y``.  ``axes_features`` picks the (x, y)
    feature column per panel.  One LineCollection per panel.
    """
    plt = _plt()
    from matplotlib.collections import LineCollection

    x, senders, receivers, y, nm = _real_parts(g)
    vals = _np(e)[_np(g.edge_mask) > 0] if e is not None else y
    if skip_false_edges:
        keep = y > 0
        senders, receivers, vals = senders[keep], receivers[keep], vals[keep]

    fig, axs = plt.subplots(1, 2, figsize=(20, 12))
    cm = plt.get_cmap(cmap)
    for ax, (fx, fy), (lx, ly) in zip(axs, axes_features, axis_labels):
        ax.scatter(x[nm, fx], x[nm, fy], c="k")
        segs = np.stack([
            np.stack([x[senders, fx], x[senders, fy]], axis=-1),
            np.stack([x[receivers, fx], x[receivers, fy]], axis=-1),
        ], axis=1)
        if alpha_labels:
            colors = [(0, 0, 0, float(np.clip(v, 0, 1))) for v in vals]
        else:
            colors = cm(np.clip(vals.astype(float), 0, 1))
        ax.add_collection(LineCollection(segs, colors=colors))
        ax.set_xlabel(lx)
        ax.set_ylabel(ly)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    if filename:
        os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
        fig.savefig(filename)
        plt.close(fig)
    return fig


def draw_sample_with_properties(
    g: Graph,
    pt: float,
    eta: float,
    output_dir: str,
    output: str = "sample",
    axes_features: Tuple[Tuple[int, int], Tuple[int, int]] = ((10, 3), (0, 3)),
    axis_labels: Sequence[Tuple[str, str]] = (("$layer$ [arb]", "$r$"),
                                              ("$z$ [cm]", "$r$")),
):
    """Truth-coloured display titled with the generated muon's pt/eta,
    written to ``<output_dir>/graph_<output>.png``
    (`Muon_graph.py:266-315`; default feature columns are the muon
    pipeline's [z, ..., r at 3, ..., layer at 10])."""
    return draw_sample(
        g,
        axes_features=axes_features,
        axis_labels=axis_labels,
        cmap="RdYlBu",
        skip_false_edges=False,
        filename=os.path.join(output_dir, f"graph_{output}.png"),
        title=f"Muon properties Pt: {pt:f}, Eta: {eta:f}, from file {output}",
    )


def draw_iterations(
    g: Graph,
    per_iter_scores: Sequence[np.ndarray],
    axes_features: Tuple[int, int] = (0, 1),
    axis_labels: Tuple[str, str] = ("$x$", "$y$"),
    filename: Optional[str] = None,
):
    """Edge-score evolution across message-passing iterations — the
    reference's ``graph_iter`` panels (`MPNN_Seg_ACTS.ipynb:cell39-46`).

    ``per_iter_scores``: list of per-edge score arrays, one per iteration.
    Edge opacity = score; one panel per iteration plus the truth panel.
    """
    plt = _plt()
    from matplotlib.collections import LineCollection

    x, senders, receivers, y, nm = _real_parts(g)
    em = _np(g.edge_mask) > 0
    fx, fy = axes_features
    n_panels = len(per_iter_scores) + 1
    ncols = min(n_panels, 3)
    nrows = (n_panels + ncols - 1) // ncols
    fig, axs = plt.subplots(nrows, ncols, figsize=(6 * ncols, 5 * nrows),
                            squeeze=False)
    flat_axs = axs.ravel()
    segs = np.stack([
        np.stack([x[senders, fx], x[senders, fy]], axis=-1),
        np.stack([x[receivers, fx], x[receivers, fy]], axis=-1),
    ], axis=1)

    def panel(ax, vals, title):
        ax.scatter(x[nm, fx], x[nm, fy], c="k", s=8)
        colors = [(0, 0, 0, float(np.clip(v, 0, 1))) for v in vals]
        ax.add_collection(LineCollection(segs, colors=colors))
        ax.set_title(title)
        ax.set_xlabel(axis_labels[0])
        ax.set_ylabel(axis_labels[1])

    for i, e in enumerate(per_iter_scores):
        panel(flat_axs[i], _np(e)[em], f"iteration {i + 1}")
    panel(flat_axs[len(per_iter_scores)], y, "truth")
    for ax in flat_axs[n_panels:]:
        ax.axis("off")
    fig.tight_layout()
    if filename:
        os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
        fig.savefig(filename)
        plt.close(fig)
    return fig


def plot_losses(train_losses, valid_losses=None, filename=None):
    """Loss-history curves (`MPNN_Seg_ACTS.ipynb:cell26`)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(train_losses, label="train")
    if valid_losses is not None and len(valid_losses):
        ax.plot(valid_losses, label="valid")
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.legend()
    fig.tight_layout()
    if filename:
        fig.savefig(filename)
        plt.close(fig)
    return fig


def plot_roc(targets, preds, mask=None, filename=None):
    """ROC curve + AUC (`MPNN_Seg_ACTS.ipynb:cell31` ``makeROC``)."""
    plt = _plt()
    from sklearn.metrics import auc, roc_curve

    targets = _np(targets).ravel()
    preds = _np(preds).ravel()
    if mask is not None:
        keep = _np(mask).ravel() > 0
        targets, preds = targets[keep], preds[keep]
    fpr, tpr, _ = roc_curve(targets, preds)
    a = auc(fpr, tpr)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(fpr, tpr, label=f"AUC = {a:.4f}")
    ax.plot([0, 1], [0, 1], "k--")
    ax.set_xlabel("false positive rate")
    ax.set_ylabel("true positive rate")
    ax.legend()
    fig.tight_layout()
    if filename:
        fig.savefig(filename)
        plt.close(fig)
    return fig, a


def _leaves(tree, path=""):
    """``(key path, numpy array)`` of every leaf of ``tree``."""
    if hasattr(tree, "named_parameters"):
        for name, p in tree.named_parameters():
            yield name, _np(p)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, _np(tree)


def plot_weight_histograms(params, filename=None, bins=40):
    """Per-layer log-magnitude weight histograms used to pick pruning
    thresholds (`MPNN_Seg_ACTS.ipynb:cell34-35`, ``plotLayerWeights``):
    every 2-D leaf of ``params``, an ``nn.Module`` (its named parameters)
    or a nested dict/list of arrays (titled by key path, ``['edge']['l1']
    ['w']``)."""
    plt = _plt()
    leaves = [(name, leaf) for name, leaf in _leaves(params)
              if leaf.ndim == 2]
    n = len(leaves)
    fig, axs = plt.subplots(1, n, figsize=(4 * n, 3), squeeze=False)
    for ax, (name, w) in zip(axs[0], leaves):
        mag = np.abs(w.ravel())
        mag = mag[mag > 0]
        if len(mag):
            ax.hist(np.log10(mag), bins=bins)
        ax.set_title(name, fontsize=8)
        ax.set_xlabel("log10 |w|")
    fig.tight_layout()
    if filename:
        fig.savefig(filename)
        plt.close(fig)
    return fig


def plot_track_spans(spans, filename=None, bins=40):
    """Three-panel histogram of per-track nhits / delta-phi / delta-eta —
    `ActsExplore1.ipynb:cell15` over :func:`data.exploration.track_spans`
    output."""
    plt = _plt()
    fig, axes = plt.subplots(1, 3, figsize=(9, 3))
    for ax, key, label in zip(axes, ("nhits", "dphi", "deta"),
                              ("Number of hits", r"delta $\phi$",
                               r"delta $\eta$")):
        ax.hist(_np(spans[key]), bins=bins)
        ax.set_xlabel(label)
    fig.tight_layout()
    if filename:
        fig.savefig(filename)
        plt.close(fig)
    return fig


def plot_multiplicities(mult, filename=None, bins=30):
    """Event track/hit multiplicity histograms
    (`ActsExplore1.ipynb:cell20`)."""
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(9, 4))
    axes[0].hist(_np(mult["tracks_per_event"]), bins=bins)
    axes[0].set_xlabel("Event track multiplicity")
    axes[1].hist(_np(mult["hits_per_event"]), bins=bins)
    axes[1].set_xlabel("Event hit multiplicity")
    fig.tight_layout()
    if filename:
        fig.savefig(filename)
        plt.close(fig)
    return fig


def plot_hit_particle_deltas(deltas, filename=None, bins=50,
                             dr_range=(0.0, 1.0)):
    """Signal-vs-background hit-particle delta-R overlay
    (`ActsExplore1.ipynb:cell20`) over
    :func:`data.exploration.hit_particle_deltas` output."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    kw = dict(bins=bins, range=dr_range, alpha=0.7, log=True)
    ax.hist(_np(deltas["background"]["dr"]),
            label="background hits", **kw)
    ax.hist(_np(deltas["signal"]["dr"]), label="signal hits", **kw)
    ax.set_xlabel("delta R")
    ax.legend(loc=1)
    fig.tight_layout()
    if filename:
        fig.savefig(filename)
        plt.close(fig)
    return fig
