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
