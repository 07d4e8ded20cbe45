"""On the card: each cell runs as the driver runs it, untraced and traced,
prints one result line that is correct, and leaves no JAX loaded."""

import json
import subprocess
import sys

import pytest

from port_bench import manifest

CELLS = [w["name"] for w in manifest.read_manifest()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_runs_correct(card, workload, trace):
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", workload,
         "--seed", str(2**31 + 977 + trace), "--seconds", "2", "--trace",
         str(trace)], cwd=manifest.ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    cell = manifest.load_cell(workload)
    want = cell.per_layer if trace else cell.end_to_end
    assert set(line["metrics"]) <= {m["name"] for m in want}
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        for m in cell.per_layer:
            if m["unit"] == "%" and m["name"] in line["metrics"]:
                assert line["metrics"][m["name"]]["value"] <= 100.0
    else:
        assert set(line["metrics"]) == {m["name"] for m in want}
