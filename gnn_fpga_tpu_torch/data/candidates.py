"""Fixed-size candidate graphs for seeded hit classification.

The counterpart of ``gnn_fpga_tpu/data/candidates.py``: for each true
(signal) track, the ``n_layer_hits`` hits nearest in (eta, phi) to the
track's hit on every detector layer, phi centred on the first true hit, a
seed feature marking the track's hits on the first ``n_seed_layers``
layers, and every adjacent-layer candidate pair an edge.  Every candidate
graph has ``n_det_layers * n_layer_hits`` nodes and a fixed edge count.
Host numpy on the port's :class:`~gnn_fpga_tpu_torch.data.table.Table`,
each step the JAX package's numpy operation on the same shapes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from gnn_fpga_tpu_torch.core.graph import Graph, from_coo
from gnn_fpga_tpu_torch.data.doublets import calc_dphi, calc_eta
from gnn_fpga_tpu_torch.data.table import Table, concat, group_index


@dataclasses.dataclass(frozen=True)
class CandidateConfig:
    n_det_layers: int = 10
    n_layer_hits: int = 5      # candidates per layer
    n_seed_layers: int = 3     # layers whose truth seeds the input
    feature_names: Tuple[str, ...] = ("r", "phi", "z")
    feature_scale: Optional[np.ndarray] = None   # default [1000, pi, 1000]
    event_key: str = "evtid"
    label_key: str = "barcode"

    def scale(self) -> np.ndarray:
        if self.feature_scale is not None:
            return np.asarray(self.feature_scale, np.float64)
        return np.array([1000.0, np.pi, 1000.0])


def eta_phi_distance(eta1, eta2, phi1, phi2) -> np.ndarray:
    """dR = sqrt(deta^2 + dphi^2)."""
    deta = np.asarray(eta2) - np.asarray(eta1)
    dphi = calc_dphi(np.asarray(phi1), np.asarray(phi2))
    return np.sqrt(deta ** 2 + dphi ** 2)


def candidate_edges(n_det_layers: int, n_layer_hits: int):
    """Adjacent-layer all-pairs edges over the fixed candidate layout
    (nodes ordered layer-major), int32."""
    idx = np.arange(n_det_layers * n_layer_hits).reshape(
        n_det_layers, n_layer_hits)
    senders, receivers = [], []
    for k in range(n_det_layers - 1):
        s, r = np.meshgrid(idx[k], idx[k + 1], indexing="ij")
        senders.append(s.ravel())
        receivers.append(r.ravel())
    return (np.concatenate(senders).astype(np.int32),
            np.concatenate(receivers).astype(np.int32))


def _row_dtype(table: Table):
    """The dtype of one row of ``table`` taken whole (``df.iloc[j]``): the
    common type of numeric columns, else objects (floats as doubles)."""
    dts = [table[k].dtype for k in table.columns]
    if all(d.kind in "iuf" for d in dts):
        return np.result_type(*dts)
    return np.float64


def build_candidate_graph(evt_hits: Table, pid,
                          cfg: CandidateConfig = CandidateConfig()
                          ) -> Optional[Graph]:
    """One (event, signal track) -> fixed-size candidate Graph; None when
    the track doesn't hit every layer exactly once."""
    trk_hits = evt_hits.filter(evt_hits[cfg.label_key] == pid)
    if (len(trk_hits) != cfg.n_det_layers
            or not np.array_equal(np.sort(trk_hits["layer"]),
                                  np.arange(cfg.n_det_layers))):
        return None
    trk_hits = trk_hits.sort(["layer"])
    row_dtype = np.dtype(_row_dtype(trk_hits))

    cand_parts = []
    for j in range(cfg.n_det_layers):
        lay_hits = evt_hits.filter(evt_hits["layer"] == j)
        if len(lay_hits) < cfg.n_layer_hits:
            return None
        # the track's hit as scalars of its row's type, the layer's hits as
        # arrays, as the JAX package computes them
        trk_r, trk_z, trk_phi = (row_dtype.type(trk_hits[k][j])
                                 for k in ("r", "z", "phi"))
        trk_eta = calc_eta(trk_r, trk_z)
        lay_eta = calc_eta(lay_hits["r"], lay_hits["z"])
        d = eta_phi_distance(trk_eta, lay_eta, trk_phi, lay_hits["phi"])
        nearest = np.argsort(d, kind="stable")[: cfg.n_layer_hits]
        cand_parts.append(lay_hits.take(nearest))
    cand_hits = concat(cand_parts)

    # Centre phi on the first true hit
    phi0 = trk_hits["phi"][0]
    cand_hits = cand_hits.assign(
        phi=calc_dphi(np.full(len(cand_hits), phi0), cand_hits["phi"]))

    node_y = (cand_hits[cfg.label_key] == pid).astype(np.float32)
    feats = (cand_hits.rows(list(cfg.feature_names), np.float64)
             / cfg.scale()).astype(np.float32)
    layers = cand_hits["layer"]
    seed = np.where(layers < cfg.n_seed_layers, node_y, 0.0)
    x = np.concatenate([feats, seed[:, None].astype(np.float32)], axis=1)

    senders, receivers = candidate_edges(cfg.n_det_layers, cfg.n_layer_hits)
    ey = (node_y[senders] * node_y[receivers]).astype(np.float32)
    return from_coo(x, senders, receivers, ey, node_y=node_y)


def build_candidate_dataset(hits: Table,
                            cfg: CandidateConfig = CandidateConfig(),
                            max_samples: Optional[int] = None) -> List[Graph]:
    """All (event, track) pairs, in sorted key order -> candidate
    graphs."""
    keys = [cfg.event_key, cfg.label_key]
    order, _, first = group_index(hits, keys)
    out = []
    for row in order[first]:
        eid, pid = hits[cfg.event_key][row], hits[cfg.label_key][row]
        evt_hits = hits.filter(hits[cfg.event_key] == eid)
        g = build_candidate_graph(evt_hits, pid, cfg)
        if g is not None:
            out.append(g)
            if max_samples is not None and len(out) >= max_samples:
                break
    return out
