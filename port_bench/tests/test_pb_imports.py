"""What the benchmark runs loads neither JAX nor the JAX package, and the
reference loads nothing of the program (whole top-level names)."""

import ast
import json
import subprocess
import sys

from port_bench import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "gnn_fpga_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=manifest.ROOT, capture_output=True, text=True, check=True,
        timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    code = "\n".join([
        "from port_bench import run, train, infer, program, tracing, judge",
        "from port_bench import manifest, readers, gen, reference, yardstick",
        "import gnn_fpga_tpu_torch.train.trainer, gnn_fpga_tpu_torch.cli.infer",
        "import gnn_fpga_tpu_torch.core.prefetch, gnn_fpga_tpu_torch.ops.blocked",
        "import gnn_fpga_tpu_torch.models.mpnn, gnn_fpga_tpu_torch.ops.cuda._build",
        "for w in manifest.read_manifest()['per_layer']:",
        "    manifest.metric_reader(w['name'])",
    ])
    loaded = _loaded(code)
    assert "gnn_fpga_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded("import port_bench.reference, port_bench.judge")
    assert not loaded & (FORBIDDEN | {"gnn_fpga_tpu_torch"})
    for mod in ("reference.py", "judge.py", "yardstick.py", "gen.py"):
        tree = ast.parse((manifest.HERE / mod).read_text())
        names = {a.name.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        assert names <= {"__future__", "math", "typing", "torch", "numpy",
                         "dataclasses", "statistics"}, (mod, names)


def test_no_card_no_result():
    """Without a card (or outside a checkout) a run exits non-zero and
    prints nothing on standard output."""
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "seg_h64i6-event_train", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=manifest.ROOT, capture_output=True, text=True,
        timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                          "HOME": "/tmp"})
    assert out.returncode != 0 and out.stdout == ""
