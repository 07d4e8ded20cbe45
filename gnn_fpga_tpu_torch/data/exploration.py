"""Dataset characterization utilities (the ActsExplore1 workload).

The counterpart of ``gnn_fpga_tpu/data/exploration.py``: per-track angular
spans, hit and track multiplicities, and signal-against-background
hit-to-particle dphi/deta/dR distributions, by lexsort and segment
reductions over flat numpy arrays.  The functions take the tables of
:mod:`gnn_fpga_tpu_torch.data.acts` (``evtid, barcode, r, phi, z[, eta]``
for hits; ``evtid, barcode, pt, eta, phi`` for particles); the
hit-particle join that the JAX package makes with a pandas merge is a
numpy join with the merge's row order.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from gnn_fpga_tpu_torch.data.doublets import calc_dphi, calc_eta
from gnn_fpga_tpu_torch.data.table import Table, inner_join


def calc_dr(eta1, eta2, phi1, phi2) -> np.ndarray:
    """dR = sqrt(deta^2 + dphi^2) with dphi wrapped to [-pi, pi]."""
    deta = np.abs(np.asarray(eta1) - np.asarray(eta2))
    dphi = np.abs(calc_dphi(np.asarray(phi1), np.asarray(phi2)))
    return np.sqrt(deta * deta + dphi * dphi)


def _group_index(evtid: np.ndarray, barcode: np.ndarray,
                 order_key: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sort rows by (evtid, barcode, order_key); return (order, group_id)
    with group_id contiguous per (evtid, barcode)."""
    order = np.lexsort((np.asarray(order_key), np.asarray(barcode),
                        np.asarray(evtid)))
    ev, bc = np.asarray(evtid)[order], np.asarray(barcode)[order]
    new = np.concatenate([[True], (ev[1:] != ev[:-1]) | (bc[1:] != bc[:-1])])
    return order, np.cumsum(new) - 1


def track_spans(hits) -> Dict[str, np.ndarray]:
    """Per-(event, particle) hit count, |dphi| first to last hit (sorted
    by r), and eta span: ``{"nhits", "dphi", "deta"}``, one entry a
    track."""
    order, gid = _group_index(hits["evtid"], hits["barcode"], hits["r"])
    phi = np.asarray(hits["phi"])[order]
    eta = (np.asarray(hits["eta"])[order] if "eta" in hits
           else calc_eta(hits["r"], hits["z"])[order])
    n_groups = gid[-1] + 1 if len(gid) else 0
    first = np.concatenate([[0], np.flatnonzero(np.diff(gid)) + 1])
    last = np.concatenate([np.flatnonzero(np.diff(gid)), [len(gid) - 1]])
    nhits = np.bincount(gid, minlength=n_groups)
    dphi = np.abs(calc_dphi(phi[last], phi[first]))
    eta_max = np.maximum.reduceat(eta, first)
    eta_min = np.minimum.reduceat(eta, first)
    return {"nhits": nhits, "dphi": dphi, "deta": eta_max - eta_min}


def multiplicities(hits, particles) -> Dict[str, np.ndarray]:
    """Per-event track and hit multiplicities."""
    def per_event(df):
        ev = np.asarray(df["evtid"])
        ids = np.unique(ev)
        return np.bincount(np.searchsorted(ids, ev), minlength=len(ids))

    return {"tracks_per_event": per_event(particles),
            "hits_per_event": per_event(hits)}


def hit_particle_deltas(hits: Table, particles: Table
                        ) -> Dict[str, Dict[str, np.ndarray]]:
    """Signal against background hit-particle dphi/deta/dR distributions:
    every (hit, particle) pair within an event (hits in their order, each
    with the event's particles in theirs), split by whether the hit
    belongs to that particle.  Returns ``{"signal": {...},
    "background": {...}}``, each with ``dphi``, ``deta`` and ``dr``."""
    hp = inner_join(hits, particles, on=["evtid"], suffixes=("_hit", "_par"))
    sig = hp["barcode_hit"] == hp["barcode_par"]
    out = {}
    for name, m in (("signal", sig), ("background", ~sig)):
        dphi = np.abs(calc_dphi(hp["phi_hit"][m], hp["phi_par"][m]))
        deta = np.abs(hp["eta_hit"][m] - hp["eta_par"][m])
        out[name] = {"dphi": dphi, "deta": deta,
                     "dr": np.sqrt(deta * deta + dphi * dphi)}
    return out


def layer_occupancy(hits: Table) -> Dict[Tuple[int, int], int]:
    """Hit counts per (volume, layer)."""
    vol = hits["volid"] if "volid" in hits else np.zeros(len(hits), int)
    lay = hits["layer"] if "layer" in hits else hits["layid"]
    keys, counts = np.unique(np.stack([vol, lay]), axis=1, return_counts=True)
    return {(int(v), int(l)): int(c)
            for (v, l), c in zip(keys.T, counts)}
