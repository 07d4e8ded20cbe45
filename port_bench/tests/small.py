"""A copy of the benchmark whose cells are cut to a size the CPU holds:
the configurations' widths as published, a few small sectors an event,
short stacks."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from port_bench import manifest

REPO = manifest.ROOT
EVENTS = dict(sectors=4, n_layers=10, n_tracks=10, k=6, pad_nodes=512,
              pad_edges=4096)
MIX = dict(pool=4, events_per_batch=2, steps_per_call=4, sample=3,
           trace_events=8, block_e=240)


def small_root(tmp: Path) -> Path:
    """``tmp`` holding ``BENCHMARK.json`` and ``port_bench/`` with every
    configuration and mix cut as the module's constants say."""
    root = Path(tmp)
    shutil.copytree(REPO / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for p in (root / "port_bench" / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c["events"].update(EVENTS)
        p.write_text(json.dumps(c))
    for p in (root / "port_bench" / "traffic").glob("*.json"):
        c = json.loads(p.read_text())
        c.update({k: v for k, v in MIX.items()
                  if k in c or k in ("sample", "trace_events")})
        p.write_text(json.dumps(c))
    return root
