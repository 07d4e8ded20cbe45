"""Hit selection and phi sectors for TrackML-format events.

The counterpart of ``gnn_fpga_tpu/data/selection.py`` on the port's
:class:`~gnn_fpga_tpu_torch.data.table.Table`: barrel layer
re-enumeration, pt cut, perfect-track filter, duplicate-hit removal and
phi-sector splitting, in numpy on the host, with the rows, their order
and their bits of the JAX package's pandas version.  The (volume_id,
layer_id) lookup, a Python loop over the hits there, is vectorised.
"""

from __future__ import annotations

import logging
from typing import List, Sequence, Tuple

import numpy as np

from gnn_fpga_tpu_torch.data.table import Table, inner_join

# Barrel (volume_id, layer_id) pairs -> layer number 0-9
BARREL_VLIDS: Tuple[Tuple[int, int], ...] = (
    (8, 2), (8, 4), (8, 6), (8, 8),
    (13, 2), (13, 4), (13, 6), (13, 8),
    (17, 2), (17, 4),
)


def barrel_layer(volume_id: np.ndarray, layer_id: np.ndarray,
                 vlids: Sequence[Tuple[int, int]] = BARREL_VLIDS
                 ) -> np.ndarray:
    """int32 layer number of each hit (its (volume_id, layer_id)'s place
    in ``vlids``, the last place for a repeated pair), -1 off ``vlids``."""
    layer = np.full(len(volume_id), -1, np.int32)
    for i, (v, l) in enumerate(vlids):
        layer[(volume_id == v) & (layer_id == l)] = i
    return layer


def select_hits(
    hits: Table,
    truth: Table,
    particles: Table,
    pt_min: float = 0.0,
    no_missing_hits: bool = False,
    vlids: Sequence[Tuple[int, int]] = BARREL_VLIDS,
) -> Table:
    """Barrel selection and truth matching:

    - keep hits on the barrel (volume_id, layer_id) pairs, assign layer;
    - keep particles with pt > pt_min (an inner join drops noise hits);
    - derive cylindrical r, phi;
    - optionally keep the tracks that hit every layer;
    - keep the min-r hit of each (particle, layer), the first of equal
      ones, rows in (particle_id, layer) order.

    Returns columns [hit_id, z, layer, r, phi, particle_id].
    """
    n_det_layers = len(vlids)
    layer = barrel_layer(hits["volume_id"], hits["layer_id"], vlids)
    hits = hits.assign(layer=layer).filter(layer >= 0)

    pt = np.sqrt(particles["px"] ** 2 + particles["py"] ** 2)
    particles = particles.filter(pt > pt_min)
    truth = inner_join(truth.select(["hit_id", "particle_id"]),
                       particles.select(["particle_id"]), on=["particle_id"])

    r = np.sqrt(hits["x"] ** 2 + hits["y"] ** 2)
    phi = np.arctan2(hits["y"], hits["x"])
    hits = inner_join(hits.select(["hit_id", "z", "layer"]).assign(r=r, phi=phi),
                      truth.select(["hit_id", "particle_id"]), on=["hit_id"])

    if no_missing_hits:
        n_layers = hits.group_nunique(["particle_id"], "layer")
        hits = hits.filter(n_layers == n_det_layers)

    return hits.take(hits.group_argmin(["particle_id", "layer"], "r"))


def split_phi_sectors(
    hits: Table,
    n_phi_sectors: int = 8,
    select_phi_sector: bool = False,
) -> List[Table]:
    """Hits in phi sectors (open on both sides), each sector's phi
    re-centred on 0 (``phi - lo - width/2``) and a ``phi_sector`` column
    added.  ``select_phi_sector`` keeps only the sector [0, width)."""
    width = 2 * np.pi / n_phi_sectors
    if select_phi_sector:
        edges = np.linspace(0, width, 2)
        n_phi_sectors = 1
    else:
        edges = np.linspace(-np.pi, np.pi, n_phi_sectors + 1)
    logging.info("Phi sectors: %s", edges)
    sectors = []
    phi = hits["phi"]
    for i in range(n_phi_sectors):
        lo, hi = edges[i], edges[i + 1]
        sel = hits.filter((phi > lo) & (phi < hi))
        sectors.append(sel.assign(phi=sel["phi"] - lo - width / 2,
                                  phi_sector=np.int64(i)))
    return sectors


def hits_summary(hits: Table, event_key: str = "evtid",
                 particle_key: str = "particle_id") -> dict:
    """Events, hits and particles (distinct (event, particle) pairs)."""
    n_events = len(np.unique(hits[event_key]))
    n_hits = len(hits)
    n_particles = len(np.unique(np.stack(
        [hits[event_key], hits[particle_key]], axis=1), axis=0)) \
        if n_hits else 0
    return {
        "n_events": n_events,
        "n_hits": n_hits,
        "n_particles": n_particles,
        "particles_per_event": n_particles / max(n_events, 1),
        "hits_per_event": n_hits / max(n_events, 1),
    }
