"""Toy2D synthetic tracking data.

The counterpart of ``gnn_fpga_tpu/data/toy2d.py``: straight tracks crossing
``n_layers`` 1-D detector layers at radii ``det_r``, hits sorted by
position within each layer.  Generation is numpy with the same random
stream, so equal seeds give arrays identical to the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gnn_fpga_tpu_torch.core.graph import Graph


@dataclasses.dataclass(frozen=True)
class Toy2DConfig:
    n_layers: int = 10
    n_tracks: int = 4
    det_r: Optional[np.ndarray] = None  # default: arange(n_layers)
    seed: int = 0

    def radii(self) -> np.ndarray:
        if self.det_r is not None:
            return np.asarray(self.det_r, dtype=np.float32)
        return np.arange(self.n_layers, dtype=np.float32)


def gen_tracks(rng: np.random.Generator, n: int, det_r: np.ndarray) -> np.ndarray:
    """``n`` straight tracks, uniform entry/exit x in [0, 1), linear in r;
    returns hit x-coordinates ``(n, n_layers)``."""
    xin = rng.uniform(size=n).astype(np.float32)
    xout = rng.uniform(size=n).astype(np.float32)
    slopes = (xout - xin) / (det_r[-1] - det_r[0])
    return np.outer(slopes, det_r) + xin[:, None]


def generate_events(cfg: Toy2DConfig, n_events: int):
    """Returns ``(x, y, r, l)``, each ``(n_events, n_layers * n_tracks)``:
    hit position, track label, layer radius and layer index, with hits
    sorted by position within each layer."""
    rng = np.random.default_rng(cfg.seed)
    det_r = cfg.radii()
    nl, nt = cfg.n_layers, cfg.n_tracks
    tracks = np.stack(
        [gen_tracks(rng, n_events, det_r) for _ in range(nt)], axis=1)
    idx = np.argsort(tracks, axis=1)
    i0 = np.arange(n_events)[:, None, None]
    i2 = np.arange(nl)[None, None, :]
    x = tracks[i0, idx, i2]
    y = idx.astype(np.float32)
    x = x.transpose(0, 2, 1).reshape(n_events, -1).astype(np.float32)
    y = y.transpose(0, 2, 1).reshape(n_events, -1)
    r = np.broadcast_to(np.repeat(det_r, nt)[None, :], x.shape).astype(np.float32)
    l = np.broadcast_to(np.repeat(np.arange(nl), nt)[None, :], x.shape)
    return x, y, r, l.astype(np.int32)


def layer_offsets(cfg: Toy2DConfig) -> np.ndarray:
    """Node-id boundaries of each layer: layer ``l`` holds node ids
    ``[offsets[l], offsets[l+1])`` (toy graphs are layer-major)."""
    return (np.arange(cfg.n_layers + 1) * cfg.n_tracks).astype(np.int64)


def toy_edges(cfg: Toy2DConfig):
    """Every hit pair on adjacent layers: ``(senders, receivers)`` with
    senders on layer k and receivers on layer k+1."""
    nl, nt = cfg.n_layers, cfg.n_tracks
    hit_idx = np.arange(nl * nt).reshape(nl, nt)
    senders, receivers = [], []
    for k in range(nl - 1):
        s, r = np.meshgrid(hit_idx[k], hit_idx[k + 1], indexing="ij")
        senders.append(s.ravel())
        receivers.append(r.ravel())
    return (np.concatenate(senders).astype(np.int32),
            np.concatenate(receivers).astype(np.int32))


def _batched_graph(feats, senders, receivers, ey, edge_mask,
                   node_y=None) -> Graph:
    n_events, n_node = feats.shape[:2]
    return Graph(
        x=torch.from_numpy(np.array(feats, dtype=np.float32)),
        senders=torch.from_numpy(np.array(senders, dtype=np.int32)),
        receivers=torch.from_numpy(np.array(receivers, dtype=np.int32)),
        y=torch.from_numpy(np.array(ey, dtype=np.float32)),
        node_mask=torch.ones((n_events, n_node), dtype=torch.float32),
        edge_mask=torch.from_numpy(np.array(edge_mask, dtype=np.float32)),
        node_y=None if node_y is None
        else torch.from_numpy(np.array(node_y, dtype=np.float32)),
    )


def make_segment_graphs(cfg: Toy2DConfig, n_events: int) -> Graph:
    """Batched all-adjacent-pairs segment graphs: node features
    ``[x, r/r_max]``, edge label = same track on both endpoints."""
    x, y, r, _ = generate_events(cfg, n_events)
    senders, receivers = toy_edges(cfg)
    n_edge = len(senders)
    feats = np.stack([x, r / max(r.max(), 1e-9)], axis=-1)
    ey = (y[:, senders] == y[:, receivers]).astype(np.float32)
    return _batched_graph(
        feats, np.broadcast_to(senders[None], (n_events, n_edge)),
        np.broadcast_to(receivers[None], (n_events, n_edge)), ey,
        np.ones((n_events, n_edge), np.float32))


def make_knn_segment_graphs(cfg: Toy2DConfig, n_events: int,
                            k: int = 12) -> Graph:
    """Batched segment graphs with windowed candidate edges: each hit on
    layer ``l+1`` connects to its ``k`` nearest (in x) hits on layer ``l``,
    so every event has exactly ``(n_layers-1) * n_tracks * min(k, n_tracks)``
    edges."""
    x, y, r, _ = generate_events(cfg, n_events)
    nl, nt = cfg.n_layers, cfg.n_tracks
    kk = min(k, nt)
    xg = x.reshape(n_events, nl, nt)
    senders, receivers = [], []
    for layer in range(nl - 1):
        dx = np.abs(xg[:, layer + 1, :, None] - xg[:, layer, None, :])
        idx = np.argpartition(dx, kk - 1, axis=-1)[..., :kk]
        s = layer * nt + idx
        rcv = np.broadcast_to(
            ((layer + 1) * nt + np.arange(nt))[None, :, None], s.shape)
        senders.append(s.reshape(n_events, -1))
        receivers.append(rcv.reshape(n_events, -1))
    senders = np.concatenate(senders, axis=1).astype(np.int32)
    receivers = np.concatenate(receivers, axis=1).astype(np.int32)
    ev = np.arange(n_events)[:, None]
    ey = (y[ev, senders] == y[ev, receivers]).astype(np.float32)
    feats = np.stack([x, r / max(r.max(), 1e-9)], axis=-1)
    return _batched_graph(feats, senders, receivers, ey,
                          np.ones(senders.shape, np.float32))


def make_seeded_node_graphs(cfg: Toy2DConfig, n_events: int,
                            seed_layers: int = 3) -> Graph:
    """Batched graphs of the seeded hit-classification task: node features
    ``[x, r/r_max, seed]``, where ``seed`` marks track 0's hits on the
    first ``seed_layers`` layers; node label ``node_y`` = the hit belongs
    to track 0; edges are every hit pair on adjacent layers
    (:func:`toy_edges`) with the same-track edge label."""
    x, y, r, l = generate_events(cfg, n_events)
    senders, receivers = toy_edges(cfg)
    n_edge = len(senders)
    y0 = (y == 0).astype(np.float32)
    seed = np.where(l < seed_layers, y0, 0.0).astype(np.float32)
    feats = np.stack([x, r / r.max(), seed], axis=-1)
    ey = (y[:, senders] == y[:, receivers]).astype(np.float32)
    return _batched_graph(
        feats, np.broadcast_to(senders[None], (n_events, n_edge)),
        np.broadcast_to(receivers[None], (n_events, n_edge)), ey,
        np.ones((n_events, n_edge), np.float32), node_y=y0)


def make_window_segment_graphs(cfg: Toy2DConfig, n_events: int,
                               window: Optional[float] = None) -> Graph:
    """Batched segment graphs with two-coordinate window cuts: tracks are
    straight in two transverse coordinates (x, z), node features are
    ``[x, z, r/r_max]``, the edge list is every hit pair on adjacent layers
    (:func:`toy_edges`), and ``edge_mask`` keeps an edge iff ``|dx| <
    window`` and ``|dz| < window``.  The default window keeps every true
    segment."""
    rng = np.random.default_rng(cfg.seed)
    det_r = cfg.radii()
    nl, nt = cfg.n_layers, cfg.n_tracks
    tx = np.stack([gen_tracks(rng, n_events, det_r) for _ in range(nt)],
                  axis=1)
    tz = np.stack([gen_tracks(rng, n_events, det_r) for _ in range(nt)],
                  axis=1)
    # sort hits within each layer by x; z rides along, argsort idx = track
    idx = np.argsort(tx, axis=1)
    i0 = np.arange(n_events)[:, None, None]
    i2 = np.arange(nl)[None, None, :]
    x = tx[i0, idx, i2].transpose(0, 2, 1).reshape(n_events, -1)
    z = tz[i0, idx, i2].transpose(0, 2, 1).reshape(n_events, -1)
    y = idx.transpose(0, 2, 1).reshape(n_events, -1)
    r = np.broadcast_to(np.repeat(det_r, nt)[None, :], x.shape)

    senders, receivers = toy_edges(cfg)
    if window is None:
        dr_adj = float(np.diff(det_r).max()) if nl > 1 else 1.0
        window = dr_adj / max(float(det_r[-1] - det_r[0]), 1e-9)
    n_edge = len(senders)
    feats = np.stack([x, z, r / max(r.max(), 1e-9)], axis=-1
                     ).astype(np.float32)
    dx = np.abs(x[:, receivers] - x[:, senders])
    dz = np.abs(z[:, receivers] - z[:, senders])
    edge_mask = ((dx < window) & (dz < window)).astype(np.float32)
    ey = ((y[:, senders] == y[:, receivers]) & (edge_mask > 0)
          ).astype(np.float32)
    return _batched_graph(
        feats, np.broadcast_to(senders[None], (n_events, n_edge)),
        np.broadcast_to(receivers[None], (n_events, n_edge)), ey, edge_mask)


def make_gcn_data(cfg: Toy2DConfig, n_events: int, seed_layers: int = 3,
                  norm: str = "row"):
    """Dense-adjacency GCN task data, numpy: ``(X, A, y0)``, node features
    ``[x, r/r_max, seed]``, the normalised (``"row"`` or ``"kw"``)
    adjacency of hits on adjacent layers whose line enters and exits the
    detector inside [0, 1), and the track-0 node labels."""
    from gnn_fpga_tpu_torch.models import gcn

    x, y, r, l = generate_events(cfg, n_events)
    y0 = (y == 0).astype(np.float32)
    seed = np.where(l < seed_layers, y0, 0.0).astype(np.float32)
    feats = np.stack([x, r / r.max(), seed], axis=-1)
    adj, _ = gcn.toy_adjacency(x, r, l, y)
    if norm == "row":
        a = gcn.row_norm_adjacency(adj)
    elif norm == "kw":
        a = gcn.kipf_welling_adjacency(adj)
    else:
        raise ValueError(f"unknown adjacency norm {norm!r}")
    return feats, a, y0


def make_segment_gcn_data(cfg: Toy2DConfig, n_events: int,
                          sigma: float = 0.01):
    """Line-graph segment-classification data, numpy: ``(seg_features,
    seg_A, seg_y)``, segments as nodes with features ``[slope,
    r_mid/r_max]``, adjacent through a shared middle hit, weighted by the
    gaussian slope kernel and row-normalised."""
    from gnn_fpga_tpu_torch.models import gcn

    x, y, r, l = generate_events(cfg, n_events)
    hit_adj = gcn.layer_adjacency(l)
    seg_idx = gcn.segment_indices(hit_adj)
    seg_adj = gcn.segment_adjacency(seg_idx)
    slopes = gcn.segment_slopes(x, r, seg_idx)
    kernel = gcn.gaussian_slope_kernel(slopes, sigma)
    a = gcn.row_norm_adjacency(seg_adj * kernel)
    seg_y = gcn.segment_labels(y, seg_idx)
    ev = np.arange(n_events)[:, None, None]
    r_mid = r[ev, seg_idx].mean(axis=-1)
    feats = np.stack([slopes, r_mid / r.max()], axis=-1).astype(np.float32)
    return feats, a, seg_y


def make_hit_grids(cfg: Toy2DConfig, n_events: int):
    """``(grids, pids)``, numpy: hit x-positions per (layer, slot), sorted
    within each layer, ``(n_events, n_layers, n_tracks)``, and the track
    id in each slot."""
    x, y, _, _ = generate_events(cfg, n_events)
    nl, nt = cfg.n_layers, cfg.n_tracks
    return (x.reshape(n_events, nl, nt),
            y.reshape(n_events, nl, nt).astype(np.int32))


def make_segmenter_data(cfg: Toy2DConfig, n_events: int):
    """Hit-clustering segmenter task, numpy: the hit grids and, for every
    hit on layer l, the one-hot over layer-(l+1) slots of the same-track
    hit, ``(n_events, (n_layers-1)*n_tracks, n_tracks)``."""
    grids, pids = make_hit_grids(cfg, n_events)
    assoc = (pids[:, :-1, :, None] == pids[:, 1:, None, :]).astype(np.float32)
    return grids, assoc.reshape(n_events, -1, cfg.n_tracks)


def make_seeded_grid_data(cfg: Toy2DConfig, n_events: int,
                          seed_size: int = 3, track: int = 0):
    """Seeded track finding as an image task, numpy: ``(grids, seeds,
    targets)``, the hit grids ``(n_events, L, T)``, the target track's slot
    one-hots on the first ``seed_size`` layers, and its slot one-hot on
    every layer."""
    grids, pids = make_hit_grids(cfg, n_events)
    target = (pids == track).astype(np.float32)
    return grids, target[:, :seed_size].copy(), target
