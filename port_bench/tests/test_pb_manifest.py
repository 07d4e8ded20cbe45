"""The manifest keeps its rules, every cell finds its files by name, and a
new configuration, mix, metric, cell and model family come from new files
alone."""

import copy
import json
import os
import shutil
import subprocess
import sys

import pytest

from port_bench import manifest, run
from port_bench.tests.small import small_root

MAN = manifest.read_manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def test_manifest_keeps_the_rules():
    assert manifest.problems(MAN) == []


@pytest.mark.parametrize("change, problem", [
    (lambda m: m["end_to_end"][0].update(unit="edges per s"), "unit of"),
    (lambda m: m["workloads"][0].update(name="a,b"), "workloads name"),
    (lambda m: m["per_layer"][0].update(why="no such key"), "keys"),
    (lambda m: m["end_to_end"][0].update(bound=0.5), "bound of"),
    (lambda m: m["per_layer"][0].update(moves="nothing"), "moves"),
    (lambda m: m["workloads"].append(dict(m["workloads"][0], name="x")),
     "twice"),
])
def test_a_broken_manifest_is_named(change, problem):
    man = copy.deepcopy(MAN)
    change(man)
    assert any(problem in p for p in manifest.problems(man))


@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_finds_its_files_by_name(workload):
    cell = manifest.load_cell(workload)
    w = next(w for w in MAN["workloads"] if w["name"] == workload)
    cfg = next(c for c in MAN["configs"] if c["name"] == w["config"])
    assert cfg["file"] == f"port_bench/configs/{w['config']}.json"
    assert cell.config["name"] == w["config"]
    assert cell.traffic["driver"] in ("train", "infer")
    # every cell compares numbers that fail its control and its faults
    if cell.traffic["driver"] == "train":
        assert {"loss_gap", "change_gap"} <= set(cell.limits) <= {
            "start_loss_gap", "loss_gap", "grad_gap", "change_gap"}
    else:
        assert set(cell.limits) == {"prob_max_gap", "prob_mean_gap"}
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(manifest.metric_reader(m["name"]))
    patterns = manifest.kernel_patterns()
    assert {"iteration_pair", "iteration_pair_bwd", "gemm", "h2d"} <= set(
        patterns)


def test_a_new_config_mix_metric_and_cell_from_files_alone(tmp_path):
    root = small_root(tmp_path)
    pb = root / "port_bench"
    cfg = json.loads((pb / "configs" / "seg_h64i6.json").read_text())
    cfg.update(name="seg_h32i3", hidden_dim=32, n_iters=3)
    (pb / "configs" / "seg_h32i3.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "event_train.json").read_text())
    mix.update(steps_per_call=2, pool=2)
    (pb / "traffic" / "short_train.json").write_text(json.dumps(mix))
    (pb / "metrics" / "steps_counted.py").write_text(
        "def read(s):\n    return float(s.units)\n")
    (pb / "limits" / "seg_h32i3-short_train.json").write_text(json.dumps(
        {"limits": {"start_loss_gap": 1.0, "loss_gap": 1.0, "grad_gap": 1.0,
                    "change_gap": 1.0}}))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "seg_h32i3", "source": "https://x.org/a",
                           "file": "port_bench/configs/seg_h32i3.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "seg_h32i3-short_train",
                             "config": "seg_h32i3", "traffic": "short_train",
                             "chips": 1, "why": "a test"})
    man["end_to_end"][0]["workloads"].append("seg_h32i3-short_train")
    man["per_layer"].append({"name": "steps_counted", "unit": "steps",
                             "better": "higher", "source": "program_counter",
                             "layer": "device", "moves": "train_edges_per_s",
                             "workloads": ["seg_h32i3-short_train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    assert manifest.problems(man, root) == []
    cell = manifest.load_cell("seg_h32i3-short_train", root)
    assert cell.config["hidden_dim"] == 32 and cell.traffic["pool"] == 2
    assert [m["name"] for m in cell.per_layer] == ["steps_counted"]
    out = run.measure(cell, 12345, 0.2, False, "cpu", "cpu")
    assert out["correct"] and out["metrics"]["train_edges_per_s"]["value"] > 0
    assert list(out)[-1] == "checks"
    read = manifest.metric_reader("steps_counted", root)
    assert read(type("S", (), {"units": 7})) == 7.0


# run from the copy's root, so that ``port_bench`` is the copy's, as in a
# checkout; the program comes from the repository
NEW_FAMILY_RUN = """
import json, pathlib
from port_bench import gen, manifest, program, reference, run
cell = manifest.load_cell("segcopy_h64i6-event_train")
cfg = cell.config
rngs, wseed = gen.streams(2**31 + 3, 1)
ev = gen.make_event(cfg["events"], rngs[0])
w = reference.make_weights(cfg, wseed, "cpu")
g = reference.graph_tensors(ev.packed(), "cpu")
model = program.make_model(cfg, cell.traffic, w, "cpu")
out = run.measure(cell, 12345, 0.2, False, "cpu", "cpu")
print(json.dumps(dict(
    harness=str(manifest.ROOT), family=manifest.family(cfg["model"]).__file__,
    builder=manifest.builder(cfg["model"]).__file__,
    loss=float(reference.loss(w, g, cfg)).hex(),
    as_segment_classifier=float(reference.loss(
        w, g, dict(cfg, model="segment_classifier"))).hex(),
    params=sorted(n for n, _ in model.named_parameters()), weights=sorted(w),
    correct=out["correct"])))
"""


def _files(d) -> dict:
    return {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_model_family_from_files_alone(tmp_path):
    """A family and a builder under a new name (copies of the segment
    classifier's), a configuration naming it and its cell: new files and
    new entries, and the cell runs."""
    root = small_root(tmp_path)
    pb = root / "port_bench"
    before = _files(pb)
    man0 = json.loads((root / "BENCHMARK.json").read_text())
    for kind in ("families", "builders"):
        shutil.copy(pb / kind / "segment_classifier.py", pb / kind / "seg_copy.py")
    cfg = json.loads((pb / "configs" / "seg_h64i6.json").read_text())
    cfg.update(name="segcopy_h64i6", model="seg_copy")
    (pb / "configs" / "segcopy_h64i6.json").write_text(json.dumps(cfg))
    shutil.copy(pb / "limits" / "seg_h64i6-event_train.json",
                pb / "limits" / "segcopy_h64i6-event_train.json")
    cell = "segcopy_h64i6-event_train"
    man = copy.deepcopy(man0)
    man["configs"].append(dict(man["configs"][0], name="segcopy_h64i6",
                               file="port_bench/configs/segcopy_h64i6.json",
                               why="a test"))
    man["workloads"].append(dict(name=cell, config="segcopy_h64i6",
                                 traffic="event_train", chips=1, why="a test"))
    for m in man["end_to_end"] + man["per_layer"]:
        if "seg_h64i6-event_train" in m.get("workloads", []):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    assert manifest.problems(man, root) == []

    out = subprocess.run(
        [sys.executable, "-c", NEW_FAMILY_RUN], cwd=root, capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1",
                 PYTHONPATH=os.pathsep.join([str(root), str(manifest.ROOT)])))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["harness"] == str(root.resolve())
    assert got["family"] == str(pb / "families" / "seg_copy.py")
    assert got["builder"] == str(pb / "builders" / "seg_copy.py")
    assert got["loss"] == got["as_segment_classifier"]
    assert got["params"] == sorted(got["weights"])
    assert got["correct"]

    # no file of the copy's harness changed; the manifest only gained entries
    after = _files(pb)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "families/seg_copy.py", "builders/seg_copy.py",
        "configs/segcopy_h64i6.json", "limits/segcopy_h64i6-event_train.json"}
    for m in man["end_to_end"] + man["per_layer"]:
        if cell in m.get("workloads", []):
            m["workloads"].remove(cell)
    man["configs"].pop()
    man["workloads"].pop()
    assert man == man0
