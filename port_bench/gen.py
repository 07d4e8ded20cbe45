"""The traffic generator: events made from the seed, the same for the
program and the reference.

An event is a configuration's ``events.sectors`` Toy2D sectors, all drawn
from one random stream (:class:`Event`, numpy, batched over the sectors).
The generators are copies of ``gnn_fpga_tpu_torch/data/toy2d.py``
(``generate_events``, ``make_knn_segment_graphs``,
``make_seeded_node_graphs``) that take a numpy ``Generator`` in place of
a seed; a configuration names one in ``events.generator``.  Every seed
gives the same sizes: a kNN sector has ``(n_layers - 1) * n_tracks * k``
edges and a hit sector every pair on adjacent layers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Event:
    """One event, batched over its sectors: ``x [S, N, F]``, ``senders``,
    ``receivers``, ``y`` ``[S, E]`` (sector-local node ids, every edge
    real), ``node_y [S, N]`` for the hit task."""

    x: np.ndarray
    senders: np.ndarray
    receivers: np.ndarray
    y: np.ndarray
    node_y: Optional[np.ndarray] = None

    @property
    def n_node(self) -> int:
        return self.x.shape[0] * self.x.shape[1]

    @property
    def n_edge(self) -> int:
        return self.senders.size

    def packed(self) -> dict:
        """The sectors concatenated into one graph, node ids offset by each
        sector's first node, in sector order: the reference's input."""
        s, n = self.x.shape[:2]
        off = (np.arange(s) * n)[:, None]
        out = dict(x=self.x.reshape(s * n, -1),
                   senders=(self.senders + off).reshape(-1),
                   receivers=(self.receivers + off).reshape(-1),
                   y=self.y.reshape(-1))
        if self.node_y is not None:
            out["node_y"] = self.node_y.reshape(-1)
        return out


def _tracks(rng, n, det_r):
    xin = rng.uniform(size=n).astype(np.float32)
    xout = rng.uniform(size=n).astype(np.float32)
    slopes = (xout - xin) / (det_r[-1] - det_r[0])
    return np.outer(slopes, det_r) + xin[:, None]


def _hits(rng, n_sectors, n_layers, n_tracks):
    """Straight tracks through ``n_layers`` layers at radii 0..L-1, hits
    sorted by position within each layer: ``(x, y, r, l)`` each ``[S,
    L * T]`` (position, track, radius, layer)."""
    det_r = np.arange(n_layers, dtype=np.float32)
    tracks = np.stack([_tracks(rng, n_sectors, det_r)
                       for _ in range(n_tracks)], axis=1)
    idx = np.argsort(tracks, axis=1)
    i0 = np.arange(n_sectors)[:, None, None]
    i2 = np.arange(n_layers)[None, None, :]
    x = tracks[i0, idx, i2].transpose(0, 2, 1).reshape(n_sectors, -1)
    y = idx.astype(np.float32).transpose(0, 2, 1).reshape(n_sectors, -1)
    r = np.broadcast_to(np.repeat(det_r, n_tracks)[None, :], x.shape)
    l = np.broadcast_to(np.repeat(np.arange(n_layers), n_tracks)[None, :],
                        x.shape)
    return x.astype(np.float32), y, r.astype(np.float32), l


def toy2d_knn_segments(rng, sectors, n_layers, n_tracks, k, **_) -> Event:
    """Segment sectors: each hit on layer ``l + 1`` joined to its ``k``
    nearest hits (in x) on layer ``l``; features ``[x, r / r_max]``, edge
    label: both ends on one track."""
    x, y, r, _ = _hits(rng, sectors, n_layers, n_tracks)
    kk = min(k, n_tracks)
    xg = x.reshape(sectors, n_layers, n_tracks)
    send, recv = [], []
    for layer in range(n_layers - 1):
        dx = np.abs(xg[:, layer + 1, :, None] - xg[:, layer, None, :])
        idx = np.argpartition(dx, kk - 1, axis=-1)[..., :kk]
        s = layer * n_tracks + idx
        rcv = np.broadcast_to(
            ((layer + 1) * n_tracks + np.arange(n_tracks))[None, :, None],
            s.shape)
        send.append(s.reshape(sectors, -1))
        recv.append(rcv.reshape(sectors, -1))
    send = np.concatenate(send, axis=1).astype(np.int32)
    recv = np.concatenate(recv, axis=1).astype(np.int32)
    ev = np.arange(sectors)[:, None]
    ey = (y[ev, send] == y[ev, recv]).astype(np.float32)
    feats = np.stack([x, r / max(r.max(), 1e-9)], axis=-1).astype(np.float32)
    return Event(feats, send, recv, ey)


def toy2d_seeded_hits(rng, sectors, n_layers, n_tracks, seed_layers=3,
                      **_) -> Event:
    """Hit sectors of the seeded task: every hit pair on adjacent layers
    an edge; features ``[x, r / r_max, seed]`` where ``seed`` marks track
    0's hits on the first ``seed_layers`` layers; node label: the hit is
    on track 0."""
    x, y, r, l = _hits(rng, sectors, n_layers, n_tracks)
    hit = np.arange(n_layers * n_tracks).reshape(n_layers, n_tracks)
    send, recv = [], []
    for k in range(n_layers - 1):
        s, rc = np.meshgrid(hit[k], hit[k + 1], indexing="ij")
        send.append(s.ravel())
        recv.append(rc.ravel())
    send = np.concatenate(send).astype(np.int32)
    recv = np.concatenate(recv).astype(np.int32)
    y0 = (y == 0).astype(np.float32)
    seed = np.where(l < seed_layers, y0, 0.0).astype(np.float32)
    feats = np.stack([x, r / r.max(), seed], axis=-1).astype(np.float32)
    ey = (y[:, send] == y[:, recv]).astype(np.float32)
    n_edge = len(send)
    return Event(feats, np.broadcast_to(send, (sectors, n_edge)).copy(),
                 np.broadcast_to(recv, (sectors, n_edge)).copy(), ey, y0)


GENERATORS = {"toy2d_knn_segments": toy2d_knn_segments,
              "toy2d_seeded_hits": toy2d_seeded_hits}


def streams(seed: int, n: int) -> tuple:
    """``(event streams, weight seed)`` from the run's seed: ``n``
    independent numpy generators, one an event, and a 63-bit seed for the
    weights' ``torch.Generator``."""
    root = np.random.SeedSequence(int(seed))
    events, weights = root.spawn(2)
    rngs = [np.random.default_rng(s) for s in events.spawn(n)]
    return rngs, int(weights.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_event(events_cfg: dict, rng) -> Event:
    """One event of a configuration's ``events`` settings."""
    return GENERATORS[events_cfg["generator"]](rng, **events_cfg)


def layer_offsets(events_cfg: dict) -> np.ndarray:
    """Node-id boundaries of a sector's layers (sectors are layer-major)."""
    return (np.arange(events_cfg["n_layers"] + 1)
            * events_cfg["n_tracks"]).astype(np.int64)
