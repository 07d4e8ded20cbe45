"""Muon-endcap (EMTF) graph-building pipeline.

The counterpart of ``gnn_fpga_tpu/data/muon.py`` on the port's
:class:`~gnn_fpga_tpu_torch.data.table.Table`: pair single-muon signal
hits with PU200 pileup hits, map (type, station, ring) to an EMTF layer,
truth-match, deduplicate per station, mix signal and pileup hits per
event, build per-event layer pairs split by z side, and construct
edge-labelled graphs carrying the generated muon's (pt, eta).  The
cross-join of each graph runs on ``device`` (the card by default).

Input: CSV hit tables (read by the port's CSV reader) or parquet through
``pyarrow`` when it is installed, with the ntuple's columns plus an
``entry`` event index.  ROOT ntuples need ``uproot``, which the port does
not use: convert them to parquet or CSV.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from gnn_fpga_tpu_torch.core.graph import Graph, save_npz
from gnn_fpga_tpu_torch.data import doublets
from gnn_fpga_tpu_torch.data.table import (Table, concat, drop_duplicates,
                                           groups, read_csv)

# Subsystem enums
K_DT, K_CSC, K_RPC, K_GEM, K_ME0 = 0, 1, 2, 3, 4

HIT_FEATURES = ["vh_sim_z", "vh_sim_theta", "vh_sim_phi", "vh_sim_r",
                "vh_bend", "vh_sim_tp1", "vh_sim_tp2", "vh_station",
                "vh_ring", "vh_type"]
STATION_KEYS = ["vh_type", "vh_station", "vh_ring"]


def make_emtf_lut() -> np.ndarray:
    """(type, station, ring) -> EMTF layer 1..12, -99 = unmapped."""
    lut = np.full((5, 5, 5), -99, dtype=np.int32)
    assignments = {
        # CSC (type 1)
        (1, 1, 4): 3,  (1, 1, 1): 3,   # ME1/1a, ME1/1b
        (1, 1, 2): 4,  (1, 1, 3): 4,   # ME1/2, ME1/3
        (1, 2, 1): 8,  (1, 2, 2): 8,   # ME2/1, ME2/2
        (1, 3, 1): 9,  (1, 3, 2): 9,   # ME3/1, ME3/2
        (1, 4, 1): 11, (1, 4, 2): 11,  # ME4/1, ME4/2
        # RPC (type 2)
        (2, 1, 2): 5,                  # RE1/2
        (2, 2, 2): 6,                  # RE2/2
        (2, 3, 1): 10, (2, 3, 2): 10, (2, 3, 3): 10,  # RE3/*
        (2, 4, 1): 12, (2, 4, 2): 12, (2, 4, 3): 12,  # RE4/*
        # GEM (type 3) + ME0 (type 4)
        (3, 1, 1): 2, (3, 2, 1): 7, (4, 1, 1): 1,
    }
    for (t, s, r), layer in assignments.items():
        lut[t, s, r] = layer
    return lut


EMTF_LUT = make_emtf_lut()


def get_layer(hit_type, station, ring) -> int:
    """Scalar LUT lookup."""
    return int(EMTF_LUT[int(hit_type), int(station), int(ring)])


def assign_layers(df: Table) -> Table:
    """``vh_layer`` (int32) from (vh_type, vh_station, vh_ring), unmapped
    hits (layer -99) dropped."""
    layer = EMTF_LUT[df["vh_type"].astype(np.int64),
                     df["vh_station"].astype(np.int64),
                     df["vh_ring"].astype(np.int64)]
    return df.assign(vh_layer=layer).filter(layer > -99)


def load_ntuple(path: str, entry_start: int = 0, entry_stop: int = 100,
                branches: Sequence[str] = tuple(HIT_FEATURES),
                extra_branches: Sequence[str] = ()) -> Table:
    """A flat hit table with an ``entry`` column, entries in [start,
    stop): CSV, or parquet through ``pyarrow``.  ``branches`` name the
    ROOT branches, which only a ROOT reader would need."""
    if path.endswith(".root"):
        raise ImportError(
            "reading ROOT ntuples needs uproot, which gnn_fpga_tpu_torch "
            "does not use; convert the ntuple to parquet/CSV with columns "
            "%s + 'entry'" % list(branches))
    if path.endswith(".parquet"):
        try:
            import pyarrow.parquet as pq
        except ImportError as err:
            raise ImportError("reading parquet needs pyarrow") from err
        pt = pq.read_table(path)
        df = Table({k: c.to_numpy() for k, c in zip(pt.column_names,
                                                     pt.columns)})
    else:
        df = read_csv(path)
    return df.filter((df["entry"] >= entry_start) & (df["entry"] < entry_stop))


@dataclasses.dataclass(frozen=True)
class MuonPipelineConfig:
    muon_only: bool = False
    entry_start: int = 0
    entry_stop: int = 100
    feature_names: Tuple[str, ...] = tuple(HIT_FEATURES) + ("vh_layer",)
    # All-ones feature scale, as the reference commits it
    feature_scale: Optional[np.ndarray] = None


def prepare_hits(df_muon: Table, df_pu: Table,
                 cfg: MuonPipelineConfig = MuonPipelineConfig()):
    """Signal/PU preparation and per-event mixing:

    - EMTF layer assignment, unmapped hits dropped;
    - ``isMuon`` 1.0/0.0 for signal/PU;
    - the layer signed by z: ``vh_layer * sign(vh_sim_z)``;
    - truth matching on the signal: vh_sim_tp1 == 0 & vh_sim_tp2 == 0;
    - per-station dedup within each event (first of each (type, station,
      ring), rows in order);
    - each PU event (in sorted entry order) mixed with the signal event
      of the same position: PU rows, then signal rows.

    Returns (mixed_events, muon_events): dicts entry -> Table.
    """
    df_muon = assign_layers(df_muon).assign(isMuon=1.0)
    df_pu = assign_layers(df_pu).assign(isMuon=0.0)
    df_muon, df_pu = (df.assign(vh_layer=df["vh_layer"]
                                * np.sign(df["vh_sim_z"]))
                      for df in (df_muon, df_pu))
    df_muon = df_muon.filter((df_muon["vh_sim_tp1"] == 0)
                             & (df_muon["vh_sim_tp2"] == 0))

    muon_events: Dict[int, Table] = {
        int(entry): drop_duplicates(g, STATION_KEYS)
        for (entry,), g in groups(df_muon, ["entry"])}

    mixed_events: Dict[int, Table] = {}
    muon_entries = sorted(muon_events)
    for i, ((entry_pu,), g_pu) in enumerate(groups(df_pu, ["entry"])):
        if i >= len(muon_entries):
            break
        g_pu = drop_duplicates(g_pu, STATION_KEYS)
        mixed_events[int(entry_pu)] = concat(
            [g_pu, muon_events[muon_entries[i]]])
    return mixed_events, muon_events


def build_event_graph(event_hits: Table,
                      cfg: MuonPipelineConfig = MuonPipelineConfig(),
                      device=None) -> Optional[Graph]:
    """One event -> Graph: the observed layers' pairs on each z side, open
    cuts, isMuon-AND edge labels; the cross-join on ``device``."""
    pairs = doublets.dynamic_layer_pairs(event_hits["vh_layer"].tolist())
    if len(pairs) == 0:
        return None
    feature_scale = (cfg.feature_scale if cfg.feature_scale is not None
                     else np.ones(len(cfg.feature_names), np.float32))
    return doublets.construct_graph(
        event_hits, pairs, cuts=doublets.SegmentCuts(),
        feature_names=list(cfg.feature_names), feature_scale=feature_scale,
        schema=doublets.MUON_SCHEMA, label_rule=doublets.both_true_label,
        device=device)


def build_graphs(df_muon: Table, df_pu: Table,
                 gen_properties: Optional[Table] = None,
                 cfg: MuonPipelineConfig = MuonPipelineConfig(),
                 device=None):
    """Full pipeline: a list of (entry, Graph, extras), extras holding the
    generated muon's pt/eta (float32) when ``gen_properties`` (columns
    ``entry``, ``vp_pt``, ``vp_eta``, one row an entry) has the entry."""
    mixed, muon_only = prepare_hits(df_muon, df_pu, cfg)
    events = muon_only if cfg.muon_only else mixed
    gen_rows = ({} if gen_properties is None else
                {int(e): i for i, e in enumerate(gen_properties["entry"])})
    out = []
    for entry in sorted(events):
        g = build_event_graph(events[entry], cfg, device)
        if g is None:
            logging.info("entry %d: empty graph skipped", entry)
            continue
        extras = {}
        if entry in gen_rows:
            i = gen_rows[entry]
            extras = {"pt": np.float32(gen_properties["vp_pt"][i]),
                      "eta": np.float32(gen_properties["vp_eta"][i])}
        out.append((entry, g, extras))
    return out


def save_graphs(graphs: Iterable[Tuple[int, Graph, dict]], output_dir: str,
                stem: str = "graph") -> List[str]:
    """NPZ files with the pt/eta extras, the JAX writer's keys and no
    others."""
    os.makedirs(output_dir, exist_ok=True)
    paths = []
    for i, (_, g, extras) in enumerate(graphs):
        path = os.path.join(output_dir, f"{stem}_{i:06d}.npz")
        save_npz(g, path, **extras)
        paths.append(path)
    return paths
