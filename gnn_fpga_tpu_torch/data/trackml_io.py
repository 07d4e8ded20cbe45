"""TrackML event loading from CSV, without pandas.

The counterpart of ``gnn_fpga_tpu/data/trackml_io.py``.  The TrackML
on-disk format is three CSVs per event (``<prefix>-hits.csv``,
``<prefix>-particles.csv``, ``<prefix>-truth.csv``, each possibly
``.csv.gz``), read here into :class:`~gnn_fpga_tpu_torch.data.table.Table`
s by :func:`~gnn_fpga_tpu_torch.data.table.read_csv`: integer columns stay
int64 (particle ids reach ~4.5e17, above 2^53, where a parse through
float64 would merge distinct particles) and floats carry the bits the JAX
package's ``pd.read_csv`` gives them.

Deliberate difference: the JAX module uses the external ``trackml``
library when it is installed; the port always reads the CSVs.
"""

from __future__ import annotations

import glob
import os
import re
from typing import List, Tuple

from gnn_fpga_tpu_torch.data.table import Table, read_csv


def load_event(prefix: str) -> Tuple[Table, Table, Table]:
    """(hits, particles, truth) for one event prefix."""
    tables = []
    for part in ("hits", "particles", "truth"):
        path = f"{prefix}-{part}.csv"
        if not os.path.exists(path):
            if os.path.exists(path + ".gz"):
                path = path + ".gz"
            else:
                raise FileNotFoundError(f"{path} not found")
        tables.append(read_csv(path))
    return tuple(tables)


def find_event_prefixes(input_dir: str, n_files: int | None = None) -> List[str]:
    """Sorted event prefixes in a TrackML directory
    (``event*-hits.csv*``)."""
    paths = sorted(glob.glob(os.path.join(input_dir, "event*-hits.csv*")))
    prefixes = [re.sub(r"-hits\.csv(\.gz)?$", "", p) for p in paths]
    if n_files is not None:
        prefixes = prefixes[:n_files]
    return prefixes


def event_id_from_prefix(prefix: str) -> int:
    """TrackML prefixes end in a 9-digit event id."""
    m = re.search(r"(\d+)$", os.path.basename(prefix))
    return int(m.group(1)) if m else -1
