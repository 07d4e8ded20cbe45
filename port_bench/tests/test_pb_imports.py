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
        "import json",
        "from port_bench import run, train, infer, program, tracing, judge",
        "from port_bench import manifest, readers, gen, reference, yardstick",
        "import gnn_fpga_tpu_torch.train.trainer, gnn_fpga_tpu_torch.cli.infer",
        "import gnn_fpga_tpu_torch.core.prefetch, gnn_fpga_tpu_torch.ops.blocked",
        "import gnn_fpga_tpu_torch.models.mpnn, gnn_fpga_tpu_torch.ops.cuda._build",
        "for w in manifest.read_manifest()['per_layer']:",
        "    manifest.metric_reader(w['name'])",
        "for c in manifest.read_manifest()['configs']:",
        "    cfg = json.loads((manifest.ROOT / c['file']).read_text())",
        "    manifest.family(cfg['model']), manifest.builder(cfg['model'])",
    ])
    loaded = _loaded(code)
    assert "gnn_fpga_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


# what the reference side may import: the standard library's modules
# below, torch, numpy, and of the harness the lookup and the families
ALLOWED = {"__future__", "math", "typing", "dataclasses", "statistics",
           "functools", "importlib", "json", "re", "pathlib", "torch",
           "numpy"}
HARNESS = ("port_bench.manifest", "port_bench.families")


def _imports(path) -> set:
    """Every module a file imports (``from a import b`` as ``a.b``)."""
    out = set()
    for n in ast.walk(ast.parse(path.read_text())):
        if isinstance(n, ast.Import):
            out |= {a.name for a in n.names}
        elif isinstance(n, ast.ImportFrom) and n.module:
            out |= {f"{n.module}.{a.name}" for a in n.names}
    return out


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded("\n".join([
        "import json",
        "import port_bench.reference, port_bench.judge",
        "from port_bench import manifest, reference",
        "for c in manifest.read_manifest()['configs']:",
        "    cfg = json.loads((manifest.ROOT / c['file']).read_text())",
        "    reference.make_weights(cfg, 1, 'cpu')",
    ]))
    assert not loaded & (FORBIDDEN | {"gnn_fpga_tpu_torch"})
    files = [manifest.HERE / m for m in ("reference.py", "judge.py",
                                         "yardstick.py", "gen.py",
                                         "manifest.py")]
    files += sorted((manifest.HERE / "families").glob("*.py"))
    assert len(files) > 5
    for path in files:
        bad = {m for m in _imports(path)
               if m.split(".")[0] not in ALLOWED
               and not any(m == h or m.startswith(h + ".") for h in HARNESS)}
        assert not bad, (path.name, bad)


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
