"""The port stands without JAX, and its GPU smoke run refuses to run (and
to report success) on a machine without a card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    return env


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import gnn_fpga_tpu_torch\n"
        "from gnn_fpga_tpu_torch.core import graph, batching, prefetch, capture\n"
        "from gnn_fpga_tpu_torch.data import toy2d, table, trackml_io\n"
        "from gnn_fpga_tpu_torch.data import doublets, native, selection\n"
        "from gnn_fpga_tpu_torch.data import acts, muon, full_events\n"
        "from gnn_fpga_tpu_torch.data import candidates, exploration\n"
        "from gnn_fpga_tpu_torch.ops import segment, dense_incidence, blocked\n"
        "from gnn_fpga_tpu_torch.ops.cuda import spmm, segment_sum, _build\n"
        "from gnn_fpga_tpu_torch.ops.cuda import doublets as dop\n"
        "from gnn_fpga_tpu_torch.ops.cuda import probes as pop\n"
        "from gnn_fpga_tpu_torch import probes\n"
        "from gnn_fpga_tpu_torch.probes import common, bw, ops, spmm_ablate\n"
        "from gnn_fpga_tpu_torch.probes import iter as iter_probe\n"
        "from gnn_fpga_tpu_torch.models import mpnn, gcn, baselines\n"
        "from gnn_fpga_tpu_torch.utils import serialization, profiling\n"
        "from gnn_fpga_tpu_torch.utils import flops\n"
        "from gnn_fpga_tpu_torch.utils import plotting\n"
        "from gnn_fpga_tpu_torch.cli import train, infer, plot_graph\n"
        "from gnn_fpga_tpu_torch.cli import prepare_graphs, prepare_muon_graphs\n"
        "from gnn_fpga_tpu_torch.train import trainer, checkpoint, metrics\n"
        "from gnn_fpga_tpu_torch.compress import pruning\n"
        "from gnn_fpga_tpu_torch.parallel import collectives, mesh, multihost\n"
        "from gnn_fpga_tpu_torch.parallel import data_parallel, partition\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'optax', 'orbax', 'gnn_fpga_tpu', 'pandas',\n"
        "        'matplotlib')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_prepare_graphs_runs_without_pandas_or_jax(tmp_path):
    """The port's prepare CLI on one small TrackML event written by the
    smoke's numpy writer, on the CPU, in a process of its own: it writes
    graphs, and neither pandas, JAX nor the JAX package is imported."""
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "from gnn_fpga_tpu_torch.cli import prepare_graphs\n"
        f"d = {str(tmp_path)!r}\n"
        "chip_smoke.write_trackml_events(d, 1, 300, seed=0)\n"
        "graphs = prepare_graphs.main(['--input-dir', d, '--output-dir',\n"
        "                              d + '/out', '--device', 'cpu',\n"
        "                              '--pt-min', '0.5'])\n"
        "assert graphs, 'no graph'\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('pandas', 'jax', 'jaxlib', 'gnn_fpga_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(graphs))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) > 0
    assert len(list((tmp_path / "out").glob("graph*.npz"))) == \
        int(proc.stdout.split()[-1])


def test_chip_smoke_fails_without_a_gpu():
    import torch

    if torch.cuda.is_available():
        import pytest
        pytest.skip("a CUDA device is present; this pins the GPU-less case")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]


FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "gnn_fpga_tpu")


def _imported_modules(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_parallel_examples_and_rank_bodies_import_no_jax():
    """Every import statement of the parallel package, the port's three
    examples and the multi-rank tests' rank bodies (function-level ones
    included) names neither JAX nor the JAX package; and a process that
    imports the rank bodies and runs the partitioned example (a world of
    one, on the CPU) loads neither."""
    files = (sorted((ROOT / "gnn_fpga_tpu_torch" / "parallel").glob("*.py"))
             + [ROOT / "examples" / f"{n}_torch.py"
                for n in ("partitioned_mu200", "train_toy2d",
                          "pruning_rounds")]
             + [ROOT / "tests" / "torch_parallel_ranks.py"])
    for f in files:
        bad = [m for m in _imported_modules(f)
               if m.split(".")[0] in FORBIDDEN]
        assert not bad, (f.name, bad)
    code = (
        "import importlib.util, sys\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch_parallel_ranks\n"
        "spec = importlib.util.spec_from_file_location(\n"
        "    'ex', 'examples/partitioned_mu200_torch.py')\n"
        "ex = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(ex)\n"
        "ex.main(['--n-tracks', '3', '--steps', '2', '--hidden-dim', '4',\n"
        "         '--n-iters', '1', '--device', 'cpu'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        f"       {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_probes_import_no_jax_nor_the_tpu_probes():
    """Every import statement of the port's probes and their kernels'
    module (function-level ones included) names neither JAX, the JAX
    package nor the TPU probes under benchmarks/."""
    files = (sorted((ROOT / "gnn_fpga_tpu_torch" / "probes").glob("*.py"))
             + [ROOT / "gnn_fpga_tpu_torch" / "ops" / "cuda" / "probes.py",
                ROOT / "chip_smoke.py"])
    assert len(files) == 8
    for f in files:
        bad = [m for m in _imported_modules(f)
               if m.split(".")[0] in FORBIDDEN + ("benchmarks",)]
        assert not bad, (f.name, bad)
