"""Full-event graph construction via adjacency-window cuts.

The counterpart of ``gnn_fpga_tpu/data/full_events.py``: edges are all
adjacent-layer hit pairs within a (|dphi| < dphi_max, |dz| < dz_max)
window, with event-level occupancy filters to bound graph sizes.  The
O(n^2) window is a cross-join too: it runs as tensor ops on ``device``
(the card by default), in float64, and ``torch.nonzero`` gives the edges
in ``np.nonzero``'s row-major order, so the graph equals the JAX
package's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from gnn_fpga_tpu_torch.core.device import default_device
from gnn_fpga_tpu_torch.core.graph import Graph, from_coo
from gnn_fpga_tpu_torch.data.table import Table, groups
from gnn_fpga_tpu_torch.ops.cuda.doublets import wrap_dphi


@dataclasses.dataclass(frozen=True)
class FullEventConfig:
    dphi_max: float = np.pi / 4
    dz_max: float = 300.0
    feature_names: Sequence[str] = ("r", "phi", "z")
    feature_scale: Optional[np.ndarray] = None  # default [1000, pi, 1000]
    # Occupancy filters: None disables
    n_nodes_min: Optional[int] = 50
    n_nodes_max: Optional[int] = 500
    n_edges_max: Optional[int] = 1000
    layer_key: str = "layer"
    label_key: str = "barcode"

    def scale(self) -> np.ndarray:
        if self.feature_scale is not None:
            return np.asarray(self.feature_scale, np.float64)
        return np.array([1000.0, np.pi, 1000.0])


def window_edges(layers: np.ndarray, phi: np.ndarray, z: np.ndarray,
                 dphi_max: float, dz_max: float, device=None):
    """``(senders, receivers)`` int64 on the host: the pairs ``(i, j)``
    with ``layers[j] - layers[i] == 1``, ``|wrap(phi[j] - phi[i])| <
    dphi_max`` and ``|z[j] - z[i]| < dz_max``, row-major; computed on
    ``device``."""
    device = default_device(device)
    as_t = lambda a, dt: torch.tensor(np.asarray(a, dt), device=device)
    lay, phi, z = as_t(layers, np.int64), as_t(phi, np.float64), as_t(z, np.float64)
    adj = (lay[None, :] - lay[:, None]) == 1
    adj &= wrap_dphi(phi[None, :] - phi[:, None]).abs() < dphi_max
    adj &= (z[None, :] - z[:, None]).abs() < dz_max
    senders, receivers = torch.nonzero(adj, as_tuple=True)
    return senders.cpu().numpy(), receivers.cpu().numpy()


def construct_graph(hits: Table, cfg: FullEventConfig = FullEventConfig(),
                    device=None) -> Graph:
    """One event -> COO graph with adjacency-window edges."""
    pid = hits[cfg.label_key]
    senders, receivers = window_edges(hits[cfg.layer_key], hits["phi"],
                                      hits["z"], cfg.dphi_max, cfg.dz_max,
                                      device)
    x = (hits.rows(list(cfg.feature_names), np.float64)
         / cfg.scale()).astype(np.float32)
    y = (pid[senders] == pid[receivers]).astype(np.float32)
    return from_coo(x, senders, receivers, y)


def passes_occupancy(g: Graph, cfg: FullEventConfig) -> bool:
    """Event-level occupancy filter."""
    n, e = g.n_node, g.n_edge
    if cfg.n_nodes_min is not None and n <= cfg.n_nodes_min:
        return False
    if cfg.n_nodes_max is not None and n >= cfg.n_nodes_max:
        return False
    if cfg.n_edges_max is not None and e >= cfg.n_edges_max:
        return False
    return True


def build_event_graphs(hits: Table, event_key: str = "evtid",
                       cfg: FullEventConfig = FullEventConfig(),
                       device=None) -> List[Graph]:
    """All events, in sorted event order -> occupancy-filtered graphs."""
    out = []
    for _, evt_hits in groups(hits, [event_key]):
        g = construct_graph(evt_hits, cfg, device)
        if passes_occupancy(g, cfg):
            out.append(g)
    return out
