"""ACTS event-file ingestion.

The counterpart of ``gnn_fpga_tpu/data/acts.py`` on the port's
:class:`~gnn_fpga_tpu_torch.data.table.Table`: files hold one python-list
literal per line, events separated by blank lines, parsed line by line
with ``ast.literal_eval`` (it is the file format); the derived quantities
are the same float32 numpy expressions, and the barrel selection keeps
the JAX package's rows in its order.  All of it is host work; the
``multiprocessing`` pool of :func:`process_files` parses files in
parallel and touches no card.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Sequence

import numpy as np

from gnn_fpga_tpu_torch.data.table import (Table, column_from_values,
                                           concat, first_appearance, groups,
                                           inner_join)

HITS_COLUMNS = ["hitid", "barcode", "volid", "layid", "lpos",
                "lerr", "gpos", "chans", "dir", "direrr"]
PARTICLES_COLUMNS = ["barcode", "vpos", "kin", "q"]

# Barrel volume ids -> 10 re-enumerated layers
BARREL_VOLIDS = (8, 13, 17)


def _event_table(event_lines: List[list], columns: Sequence[str],
                 evtid: int) -> Table:
    """One event's literal lines as a table, columns typed as the
    DataFrame constructor types them, and an int64 ``evtid``."""
    if any(len(row) != len(columns) for row in event_lines):
        raise ValueError(f"rows of an event do not have {len(columns)} "
                         "entries")
    cols = {name: column_from_values([row[i] for row in event_lines])
            for i, name in enumerate(columns)}
    cols["evtid"] = np.full(len(event_lines), evtid, np.int64)
    return Table(cols)


def load_data_events(file_name: str, columns: Sequence[str],
                     start_evtid: int = 0) -> Table:
    """Parse an ACTS event file into one table with an ``evtid`` column.

    Events are separated by blank lines; lines starting with '#' are
    comments.  A final event not followed by a blank line is kept.
    """
    tables: List[Table] = []
    event_lines: List = []
    with open(file_name) as f:
        for line in f:
            if line.strip() and line[0] != "#":
                event_lines.append(ast.literal_eval(line))
            elif event_lines:
                tables.append(_event_table(event_lines, columns,
                                           len(tables) + start_evtid))
                event_lines = []
    if event_lines:
        tables.append(_event_table(event_lines, columns,
                                   len(tables) + start_evtid))
    return concat(tables)


def process_hits_data(df: Table,
                      copy_keys=("evtid", "barcode", "volid", "layid")) -> Table:
    """Unpack global positions and derive cylindrical r, phi, z in
    float32."""
    gpos = np.stack(df["gpos"])
    x, y, z = (gpos[:, 0].astype(np.float32), gpos[:, 1].astype(np.float32),
               gpos[:, 2].astype(np.float32))
    r = np.sqrt(x ** 2 + y ** 2)
    phi = np.arctan2(y, x)
    return df.select(list(copy_keys)).assign(z=z, r=r, phi=phi)


def process_particles_data(df: Table,
                           copy_keys=("evtid", "barcode", "q")) -> Table:
    """Unpack kinematics into pt, eta, phi in float32."""
    kin = np.stack(df["kin"])
    p, theta, phi = (kin[:, 0].astype(np.float32),
                     kin[:, 1].astype(np.float32),
                     kin[:, 2].astype(np.float32))
    pt = p * np.sin(theta)
    eta = -np.log(np.tan(theta / 2.0))
    return df.select(list(copy_keys)).assign(pt=pt, eta=eta, phi=phi)


def read_hits_worker(hits_file: str) -> Table:
    return process_hits_data(load_data_events(hits_file, HITS_COLUMNS))


def read_particles_worker(particles_file: str) -> Table:
    return process_particles_data(
        load_data_events(particles_file, PARTICLES_COLUMNS))


def _fix_consecutive_evtids(frames: List[Table]) -> List[Table]:
    """Offset evtids so that they run on across files: each file's by the
    previous (already offset) file's last evtid + 1."""
    for i in range(1, len(frames)):
        shift = frames[i - 1]["evtid"][-1] + 1
        frames[i] = frames[i].assign(evtid=frames[i]["evtid"] + shift)
    return frames


def process_hits_files(hits_files: Sequence[str], pool) -> List[Table]:
    return _fix_consecutive_evtids(pool.map(read_hits_worker, list(hits_files)))


def process_particles_files(particles_files: Sequence[str], pool
                            ) -> List[Table]:
    return _fix_consecutive_evtids(
        pool.map(read_particles_worker, list(particles_files)))


def process_files(hits_files, particles_files, pool):
    """Parallel host ingestion of paired hits/particles files through a
    ``multiprocessing`` pool (``pool.map`` keeps the file order)."""
    return (process_hits_files(hits_files, pool),
            process_particles_files(particles_files, pool))


def select_barrel_hits(hits: Table) -> Table:
    """Barrel volumes {8, 13, 17} re-enumerated to layers 0-9:
    ``layer = layid // 2 - 1 + volume * 4`` (int8)."""
    hits = hits.filter(np.isin(hits["volid"], BARREL_VOLIDS))
    volume = np.searchsorted(np.asarray(BARREL_VOLIDS), hits["volid"]
                             ).astype(np.int64)
    layer = (hits["layid"] // 2 - 1 + volume * 4).astype(np.int8)
    return (hits.select(["evtid", "barcode", "r", "phi", "z"])
            .assign(volume=volume.astype(np.int8), layer=layer))


def select_hits(hits: Table, n_det_layers: int = 10) -> Table:
    """Barrel selection, perfect-track filter and min-r dedup: rows in
    (evtid, barcode, layer) order."""
    hits = select_barrel_hits(hits)
    n_layers = hits.group_nunique(["evtid", "barcode"], "layer")
    hits = hits.filter(n_layers == n_det_layers)
    return hits.take(hits.group_argmin(["evtid", "barcode", "layer"], "r"))


def bin_barrel_hits(hits: Table, evtids: Optional[np.ndarray],
                    vols: Sequence[int], bins, ranges) -> List[np.ndarray]:
    """Per-volume (layer, phi, z) occupancy histograms."""
    if evtids is None:
        evtids = first_appearance(hits["evtid"])
    by_event = {key[0]: rows for key, rows in groups(hits, ["evtid"])}
    hists = [np.zeros([len(evtids)] + list(bins[iv]), dtype=np.uint16)
             for iv in range(len(vols))]
    for i, evtid in enumerate(evtids):
        evt_hits = by_event[evtid]
        for iv, vol in enumerate(vols):
            vh = evt_hits.filter(evt_hits["volume"] == vol)
            hists[iv][i] = np.histogramdd(
                (vh["layer"], vh["phi"], vh["z"]),
                bins=bins[iv], range=ranges[iv])[0]
    return hists


def data_consistent(hits: Table, particles: Table) -> bool:
    """Every hit's (evtid, barcode) must appear in particles (the inner
    join of particles and hits has as many rows as hits)."""
    keys = ["evtid", "barcode"]
    matches = inner_join(particles.select(keys), hits.select(keys), on=keys)
    return len(matches) == len(hits)


def check_data_consistency(hits: List[Table], particles: List[Table]):
    """Drop file pairs whose hits and particles don't join cleanly."""
    pairs = [(h, p) for h, p in zip(hits, particles) if data_consistent(h, p)]
    return [hp[0] for hp in pairs], [hp[1] for hp in pairs]
