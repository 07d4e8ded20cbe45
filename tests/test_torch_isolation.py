"""The port stands without JAX, and its GPU smoke run refuses to run (and
to report success) on a machine without a card."""

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
        "from gnn_fpga_tpu_torch.core import graph, batching, prefetch\n"
        "from gnn_fpga_tpu_torch.data import toy2d\n"
        "from gnn_fpga_tpu_torch.ops import segment, dense_incidence, blocked\n"
        "from gnn_fpga_tpu_torch.ops.cuda import spmm, segment_sum, _build\n"
        "from gnn_fpga_tpu_torch.models import mpnn, gcn, baselines\n"
        "from gnn_fpga_tpu_torch.utils import serialization, profiling\n"
        "from gnn_fpga_tpu_torch.cli import train, infer\n"
        "from gnn_fpga_tpu_torch.train import trainer, checkpoint, metrics\n"
        "from gnn_fpga_tpu_torch.compress import pruning\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'optax', 'orbax', 'gnn_fpga_tpu')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


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
