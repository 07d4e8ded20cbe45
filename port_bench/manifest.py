"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The configuration is the file the manifest's ``configs`` entry
names (``configs/<config>.json``); the mix is ``traffic/<traffic>.json``;
the limits of the cell's correctness check are ``limits/<cell>.json``; a
per-layer metric's reader is ``metrics/<metric>.py``, loaded by path, with
a function ``read(slice) -> float or None``.  A configuration's ``model``
names its family: the reference side ``families/<model>.py`` and the
program's side ``builders/<model>.py``, both loaded by path
(:func:`family`, :func:`builder`).  A new model, configuration, mix, cell
or metric is new files and new entries: nothing here changes.

:func:`problems` checks the manifest against the rules its names, units
and sizes keep.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# what a model family's two files give (families/__init__.py,
# builders/__init__.py)
FAMILY_FUNCTIONS = ("leaves", "logits", "forward_flops")
BUILDER_FUNCTIONS = ("make_model", "kernel_shapes")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # the manifest's entries that this cell reports
    per_layer: list
    root: Path            # where its files were found


def read_manifest(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def applies(metric: dict, cell: str, e2e_names=None) -> bool:
    """Whether ``metric`` is reported in ``cell``: listed there, or, with
    no ``workloads``, an end-to-end metric of every cell or a per-layer
    metric of every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` with its files; an unknown cell raises
    ``KeyError``."""
    root = Path(root)
    man = read_manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(there are {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in man["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "port_bench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits_file = root / "port_bench" / "limits" / f"{workload}.json"
    limits = (json.loads(limits_file.read_text())["limits"]
              if limits_file.exists() else {})
    e2e = [m for m in man["end_to_end"] if applies(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if applies(m, workload, names)]
    return Cell(workload, w["chips"], config, traffic, limits, e2e, per_layer,
                root)


def metric_reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = Path(root) / "port_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def model_files(model: str, root: Path = ROOT) -> dict:
    """The files of ``model``'s family: ``{"families": path, "builders":
    path}``."""
    return {kind: Path(root) / "port_bench" / kind / f"{model}.py"
            for kind in ("families", "builders")}


@functools.lru_cache(maxsize=None)
def _load(path: Path):
    spec = importlib.util.spec_from_file_location(
        "port_bench_" + re.sub(r"\W", "_", f"{path.parent.name}_{path.stem}"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _model_module(kind: str, model: str, root: Path):
    files = model_files(model, root)
    if not NAME.match(str(model)) or not files[kind].exists():
        raise KeyError(f"no model {model!r}: looked for "
                       + " and ".join(str(p) for p in files.values()))
    return _load(files[kind])


def family(model: str, root: Path = ROOT):
    """The reference side of ``model``: ``families/<model>.py``, with
    :data:`FAMILY_FUNCTIONS`.  An unknown model raises ``KeyError``."""
    return _model_module("families", model, root)


def builder(model: str, root: Path = ROOT):
    """The program's side of ``model``: ``builders/<model>.py``, with
    :data:`BUILDER_FUNCTIONS`.  An unknown model raises ``KeyError``."""
    return _model_module("builders", model, root)


def _model_problems(model, root: Path = ROOT) -> list:
    """What ``model``'s family lacks: a file, or a function of one."""
    if not NAME.match(str(model)):
        return [f"model {model!r}"]
    out = []
    for (kind, path), wanted in zip(model_files(model, root).items(),
                                    (FAMILY_FUNCTIONS, BUILDER_FUNCTIONS)):
        rel = f"port_bench/{kind}/{path.name}"
        if not path.exists():
            out.append(f"model {model}: no {rel}")
            continue
        mod = _load(path)
        out += [f"model {model}: {rel} has no {fn}" for fn in wanted
                if not callable(getattr(mod, fn, None))]
    return out


def kernel_patterns(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "port_bench" / "kernels.json").read_text())


def _line(s, n=200) -> bool:
    return (isinstance(s, str) and 1 <= len(s) <= n and "\n" not in s
            and "\t" not in s)


def problems(man: dict, root: Path = ROOT) -> list:
    """What in ``man`` breaks the manifest's rules (empty: none)."""
    out = []
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    if set(man) != keys:
        out.append(f"top-level keys {sorted(man)}")
    cmd = man.get("command", [])
    if not (1 <= len(cmd) <= 32 and all(_line(c) for c in cmd)):
        out.append("command")
    for p in man.get("paths", []):
        if not PATH.match(p) or p.startswith("/") or ".." in p.split("/"):
            out.append(f"path {p!r}")
    rs = man.get("run_seconds")
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        out.append("run_seconds")
    seen = set()
    for kind, fields in (("configs", {"name", "source", "file", "reduced",
                                      "why"}),
                         ("workloads", {"name", "config", "traffic", "chips",
                                        "why"}),
                         ("end_to_end", {"name", "unit", "better", "bound",
                                         "source"}),
                         ("per_layer", {"name", "unit", "better", "source",
                                        "layer", "moves"})):
        for e in man.get(kind, []):
            extra = set(e) - fields - ({"workloads"} if kind in (
                "end_to_end", "per_layer") else set())
            if set(e) - {"workloads"} != fields or extra:
                out.append(f"{kind} {e.get('name')}: keys {sorted(e)}")
            name = e.get("name", "")
            if not NAME.match(name) or (kind, name) in seen:
                out.append(f"{kind} name {name!r}")
            seen.add((kind, name))
            if kind in ("end_to_end", "per_layer"):
                if not UNIT.match(e.get("unit", "")):
                    out.append(f"unit of {name}")
                if e.get("better") not in ("lower", "higher"):
                    out.append(f"better of {name}")
                if e.get("source") not in SOURCES:
                    out.append(f"source of {name}")
            for k in ("why", "layer", "source"):
                if k in e and k != "source" and not _line(e[k]):
                    out.append(f"{k} of {name}")
    names = [m["name"] for m in man.get("end_to_end", []) + man.get(
        "per_layer", [])]
    if len(names) != len(set(names)):
        out.append("two metrics share a name")
    cfgs = {c["name"] for c in man.get("configs", [])}
    for c in man.get("configs", []):
        if not _line(c["source"]) or len(c["reduced"]) > 16 or not all(
                NAME.match(k) for k in c["reduced"]):
            out.append(f"config {c['name']}")
        file = Path(root) / c["file"]
        if not file.exists():
            out.append(f"config file {c['file']}")
            continue
        out += [f"config {c['name']}: {p}" for p in _model_problems(
            json.loads(file.read_text()).get("model"), root)]
    e2e = {m["name"] for m in man.get("end_to_end", [])}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in man.get("end_to_end", []):
        if m.get("source") not in ("host_clock", "device_trace"):
            out.append(f"end-to-end source of {m['name']}")
        if not (isinstance(m.get("bound"), (int, float))
                and 0.01 <= m["bound"] <= 0.25):
            out.append(f"bound of {m['name']}")
    for m in man.get("per_layer", []):
        if m.get("moves") not in e2e:
            out.append(f"{m['name']} moves {m.get('moves')!r}")
    pairs = set()
    for w in man.get("workloads", []):
        if w.get("config") not in cfgs or w.get("chips") not in (1, 4):
            out.append(f"workload {w.get('name')}")
        for k in ("config", "traffic"):
            if not NAME.match(str(w.get(k, ""))):
                out.append(f"{k} of {w.get('name')}")
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            out.append(f"pair {pair} twice")
        pairs.add(pair)
        reported = [m for m in man.get("end_to_end", [])
                    if applies(m, w["name"])]
        if len(reported) < 2:
            out.append(f"{w['name']} reports no end-to-end metric but setup_s")
        names_w = {m["name"] for m in reported}
        if not any(applies(m, w["name"], names_w)
                   for m in man.get("per_layer", [])):
            out.append(f"{w['name']} reports no per-layer metric")
    if len(json.dumps(man).encode()) > 64 * 1024:
        out.append("larger than 64 KiB")
    return out
