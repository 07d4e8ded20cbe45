"""The manifest keeps its rules, every cell finds its files by name, and a
new configuration, mix, metric and cell come from new files alone."""

import copy
import json

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
