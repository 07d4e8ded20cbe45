"""Doublet (segment) selection and hit-graph construction.

The counterpart of ``gnn_fpga_tpu/data/doublets.py``: one engine for the
TrackML/ACTS and the muon-endcap graph builders, "cross-join hits on a
layer pair, cut on line-fit quantities, label edges by a truth rule", on
the port's :class:`~gnn_fpga_tpu_torch.data.table.Table` in place of a
DataFrame.  The cross-join, the preprocessing hot loop, runs on the card:
:func:`construct_graph` makes one :func:`select_segments_batched` call a
graph, which launches the CUDA kernel of ``ops/cuda/doublets.py`` once
for all its layer pairs.  On the CPU it takes the repo's C++ library
(:mod:`~gnn_fpga_tpu_torch.data.native`) where that is built, else the
kernel's plain PyTorch version.  The edges, their order, the features and
the labels equal the JAX package's bit for bit.

Selection of hits, sorting and labelling stay on the host in numpy.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gnn_fpga_tpu_torch.core.device import default_device
from gnn_fpga_tpu_torch.core.graph import Graph, _np, from_coo
from gnn_fpga_tpu_torch.data import native
from gnn_fpga_tpu_torch.data.table import Table, first_appearance
from gnn_fpga_tpu_torch.ops.cuda import doublets as doublets_op


def calc_dphi(phi1: np.ndarray, phi2: np.ndarray) -> np.ndarray:
    """phi2 - phi1 wrapped into [-pi, pi]."""
    dphi = np.asarray(phi2) - np.asarray(phi1)
    dphi = np.where(dphi > np.pi, dphi - 2 * np.pi, dphi)
    dphi = np.where(dphi < -np.pi, dphi + 2 * np.pi, dphi)
    return dphi


def calc_eta(r: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Pseudorapidity from cylindrical coordinates."""
    theta = np.arctan2(r, z)
    return -np.log(np.tan(theta / 2.0))


@dataclasses.dataclass(frozen=True)
class SegmentCuts:
    """Geometric doublet-selection cuts.

    Layer pairs whose first layer is below ``inner_layer_max`` take
    ``phi_slope_max``, the others ``phi_slope_outer_max``: one threshold a
    layer *pair*.  ``phi_slope_mid_max`` is accepted and unused, as in
    the JAX package.  The defaults are the muon builder's open cuts; the
    TrackML CLI sets slope 0.001 and z0 200.
    """

    phi_slope_max: float = 1e31
    phi_slope_mid_max: float = 1e31
    phi_slope_outer_max: float = 1e31
    z0_max: float = 1e31
    inner_layer_max: int = 5

    def phi_slope_cut_for(self, layer1) -> float:
        return (self.phi_slope_max if layer1 < self.inner_layer_max
                else self.phi_slope_outer_max)


@dataclasses.dataclass(frozen=True)
class ColumnSchema:
    """Column names binding the engine to a dataset's table: TrackML/ACTS
    (evtid, layer, r, phi, z) with particle_id truth, the muon endcap
    (entry, vh_layer, vh_sim_r, vh_sim_phi, vh_sim_z) with isMuon truth."""

    event: str = "evtid"
    layer: str = "layer"
    r: str = "r"
    phi: str = "phi"
    z: str = "z"
    label: str = "particle_id"   # per-hit truth id fed to label_rule


TRACKML_SCHEMA = ColumnSchema()
MUON_SCHEMA = ColumnSchema(event="entry", layer="vh_layer", r="vh_sim_r",
                           phi="vh_sim_phi", z="vh_sim_z", label="isMuon")


def same_particle_label(lbl1: np.ndarray, lbl2: np.ndarray) -> np.ndarray:
    """Edge truth: both endpoints from the same particle."""
    return (lbl1 == lbl2).astype(np.float32)


def both_true_label(lbl1: np.ndarray, lbl2: np.ndarray) -> np.ndarray:
    """Edge truth: both endpoints truth-flagged (the muon rule)."""
    return ((lbl1 != 0) & (lbl2 != 0)).astype(np.float32)


def select_segments_batched(
    r1, phi1, z1, r2, phi2, z2, offsets1, offsets2, phi_slope_cuts,
    z0_max: float, device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """The doublets of many layer pairs in one call: hits concatenated
    pair by pair (inner ``r1, phi1, z1``, outer ``r2, phi2, z2``), pair
    ``p`` owning ``offsets1[p]:offsets1[p+1]`` and ``offsets2[p]:
    offsets2[p+1]``, with the cut ``phi_slope_cuts[p]``.  Returns the kept
    ``(i1, i2)`` as int64 rows of the concatenated hits, on the host, in
    the order of the JAX package's ``select_segments_arrays`` called pair
    by pair.

    On the card (the default device) one launch of the CUDA kernel; with
    ``device="cpu"`` the C++ library pair by pair when it is built, else
    the kernel's plain PyTorch version."""
    device = default_device(device)
    off1 = np.asarray(offsets1, np.int64)
    off2 = np.asarray(offsets2, np.int64)
    cuts = np.asarray(phi_slope_cuts, np.float64)
    f64 = lambda a: np.ascontiguousarray(np.asarray(a, np.float64))
    hits = [f64(a) for a in (r1, phi1, z1, r2, phi2, z2)]
    for off, n in ((off1, len(hits[0])), (off2, len(hits[3]))):
        if (off.shape != (len(cuts) + 1,) or off[0] != 0 or off[-1] != n
                or (np.diff(off) < 0).any()):
            raise ValueError(f"offsets must rise from 0 to {n}, one a pair "
                             "and one more")
    if device.type == "cpu" and native.available():
        parts1, parts2 = [], []
        for p in range(len(cuts)):
            s1, s2 = slice(off1[p], off1[p + 1]), slice(off2[p], off2[p + 1])
            i1, i2 = native.select_segments_native(
                *(a[s1] for a in hits[:3]), *(a[s2] for a in hits[3:]),
                cuts[p], z0_max)
            parts1.append(i1 + off1[p])
            parts2.append(i2 + off2[p])
        if not parts1:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(parts1), np.concatenate(parts2)
    as_t = lambda a: torch.tensor(a, device=device)
    i1, i2 = doublets_op.select_segments(
        *(as_t(a) for a in hits), as_t(off1), as_t(off2), as_t(cuts),
        float(z0_max))
    return i1.cpu().numpy(), i2.cpu().numpy()


@dataclasses.dataclass(frozen=True)
class PairHits:
    """The hits of a graph's layer pairs, concatenated pair by pair, as
    :func:`select_segments_batched` takes them: inner rows ``rows1`` and
    outer rows ``rows2`` (positions in the hits table), pair ``p`` owning
    ``rows1[off1[p]:off1[p+1]]`` and ``rows2[off2[p]:off2[p+1]]``, with its
    phi-slope cut."""

    rows1: np.ndarray
    rows2: np.ndarray
    off1: np.ndarray
    off2: np.ndarray
    phi_slope_cuts: np.ndarray


def layer_pair_hits(layer_vals: np.ndarray,
                    layer_pairs: Sequence[Tuple[int, int]],
                    cuts: SegmentCuts) -> Optional[PairHits]:
    """The :class:`PairHits` of the ``layer_pairs`` whose two layers both
    have hits (the others skipped), in the order given; None when none
    has."""
    layer_index: Dict[int, np.ndarray] = {}
    for lv in np.unique(layer_vals):
        layer_index[lv] = np.nonzero(layer_vals == lv)[0]
    idx1: List[np.ndarray] = []
    idx2: List[np.ndarray] = []
    pair_cuts: List[float] = []
    for (l1, l2) in layer_pairs:
        i1, i2 = layer_index.get(l1), layer_index.get(l2)
        if i1 is None or i2 is None:   # empty-layer skip
            logging.debug("skipping empty layer pair (%s, %s)", l1, l2)
            continue
        idx1.append(i1)
        idx2.append(i2)
        pair_cuts.append(cuts.phi_slope_cut_for(l1))
    if not idx1:
        return None
    off = lambda parts: np.concatenate(
        [[0], np.cumsum([len(p) for p in parts])]).astype(np.int64)
    return PairHits(rows1=np.concatenate(idx1), rows2=np.concatenate(idx2),
                    off1=off(idx1), off2=off(idx2),
                    phi_slope_cuts=np.asarray(pair_cuts, np.float64))


def construct_graph(
    hits: Table,
    layer_pairs: Sequence[Tuple[int, int]],
    cuts: SegmentCuts = SegmentCuts(),
    feature_names: Optional[Sequence[str]] = None,
    feature_scale: Optional[np.ndarray] = None,
    schema: ColumnSchema = TRACKML_SCHEMA,
    label_rule: Callable = same_particle_label,
    max_tracks: Optional[int] = None,
    no_missing_hits: bool = False,
    n_det_layers: int = 10,
    rng: Optional[np.random.Generator] = None,
    sort_by_layer: bool = False,
    return_layers: bool = False,
    device=None,
) -> Optional[Graph]:
    """One hit graph from one event's hits table: node features ``X =
    hits[feature_names] / feature_scale``, the doublets of every layer
    pair as a COO edge list (one :func:`select_segments_batched` call on
    ``device``), labels from ``label_rule``.  None when no segment
    survives.

    ``no_missing_hits`` keeps the tracks that hit all ``n_det_layers``
    layers, rows in order; ``max_tracks`` keeps that many labels, drawn by
    ``rng.shuffle`` of the labels in order of first appearance (one seed
    picks the JAX package's tracks).  ``sort_by_layer`` orders nodes by
    (layer, phi), stably; ``return_layers`` also returns the per-node
    layer array (int32), as ``(graph, layers)`` (``(None, None)`` when no
    segment survives).  The graph's tensors are on the CPU."""
    device = default_device(device)
    if feature_names is None:
        feature_names = [schema.r, schema.phi, schema.z]
    if feature_scale is None:
        feature_scale = np.ones(len(feature_names), np.float32)

    if no_missing_hits:   # perfect-track filter
        n_layers = hits.group_nunique([schema.label], schema.layer)
        hits = hits.filter(n_layers == n_det_layers)
    if max_tracks is not None:   # track subsampling
        keys = first_appearance(hits[schema.label])
        rng = rng or np.random.default_rng()
        rng.shuffle(keys)
        hits = hits.filter(np.isin(hits[schema.label], keys[:max_tracks]))
    if sort_by_layer:
        # layer-major for the blocked path, phi within a layer for the
        # fused kernels' locality
        hits = hits.sort([schema.layer, schema.phi])

    layer_vals = hits[schema.layer]
    r = hits[schema.r].astype(np.float64)
    phi = hits[schema.phi].astype(np.float64)
    z = hits[schema.z].astype(np.float64)
    labels = hits[schema.label]

    pairs = layer_pair_hits(layer_vals, layer_pairs, cuts)
    if pairs is None:
        logging.info("skipping event with no segments")
        return (None, None) if return_layers else None
    rows1, rows2 = pairs.rows1, pairs.rows2
    k1, k2 = select_segments_batched(
        r[rows1], phi[rows1], z[rows1], r[rows2], phi[rows2], z[rows2],
        pairs.off1, pairs.off2, pairs.phi_slope_cuts, cuts.z0_max,
        device=device)
    senders, receivers = rows1[k1], rows2[k2]
    if len(senders) == 0:
        return (None, None) if return_layers else None

    x = (hits.rows(list(feature_names), np.float64)
         / np.asarray(feature_scale)).astype(np.float32)
    y = label_rule(labels[senders], labels[receivers])
    g = from_coo(x, senders, receivers, y)
    if return_layers:
        return g, layer_vals.astype(np.int32)
    return g


def segment_efficiency_purity(
    g: Graph, hits: Table, schema: ColumnSchema = TRACKML_SCHEMA,
    n_true_expected: Optional[int] = None,
) -> Dict[str, float]:
    """Graph-construction quality: purity = fraction of selected edges that
    are true; efficiency against an expected true-edge count when given."""
    y = _np(g.y)[_np(g.edge_mask) > 0]
    out = {"n_edges": float(len(y)), "n_true": float(y.sum()),
           "purity": float(y.mean()) if len(y) else 0.0}
    if n_true_expected:
        out["efficiency"] = float(y.sum()) / n_true_expected
    return out


def adjacent_layer_pairs(n_det_layers: int) -> np.ndarray:
    """[(0,1), (1,2), ...]."""
    l = np.arange(n_det_layers)
    return np.stack([l[:-1], l[1:]], axis=1)


def dynamic_layer_pairs(layers_present: Sequence[float]) -> np.ndarray:
    """Adjacent pairs of the layers an event has, the two z sides apart
    (the muon pipeline): positive layers ascending, negative ones from the
    least negative outward, both pairing inner to outer."""
    l = np.unique(np.asarray(sorted(set(layers_present))))
    lp = l[l > 0]
    lm = l[l < 0]
    pairs = []
    if len(lp) > 1:
        pairs.append(np.stack([lp[:-1], lp[1:]], axis=1))
    if len(lm) > 1:
        pairs.append(np.stack([lm[1:], lm[:-1]], axis=1))
    if not pairs:
        return np.zeros((0, 2), dtype=l.dtype)
    return np.concatenate(pairs, axis=0)
