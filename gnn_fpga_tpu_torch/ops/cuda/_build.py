"""Build and load the CUDA kernels of ``gnn_fpga_tpu_torch/csrc``.

The kernels are compiled at first use with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, and loaded
with ``ctypes``.  Every ``csrc/*.cu`` is compiled by its own ``nvcc``
process, all started together, and the objects are linked once.  The
library lands in ``build/gnn_fpga_tpu_torch/`` at the root of the
checkout, named by a hash of every source and header and of the flags, so
an edited source is rebuilt.  ``nvcc`` is looked up as PyTorch's own C++
extension tooling finds it (``CUDA_HOME``, then ``PATH``); a missing
compiler raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "gnn_fpga_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _D = ctypes.c_int64, ctypes.c_double
_SIGNATURES = {
    "gnn_iteration_pair_fwd": ([_I] * 8 + [_P] * 12 + [_I] * 2 + [_P, _I]
                               + [_P] * 6, _I),
    "gnn_aggregate_pair_fwd": ([_I] * 5 + [_P] * 2 + ([_P] * 4 + [_I]) * 2
                               + [_P] * 3, _I),
    "gnn_iteration_pair_bwd": ([_I] * 12 + [_P] * 13 + [_I] * 2 + [_P, _I]
                               + [_P] * 13, _I),
    "gnn_aggregate_pair_bwd": ([_I] * 5 + [_P] * 4 + ([_P] * 4 + [_I]) * 2
                               + [_P] * 3, _I),
    "gnn_gather_pair_bwd": ([_I] * 5 + [_P] + ([_P] * 3 + [_I]) * 2
                            + [_P] * 3, _I),
    "gnn_gather_pair_fwd": ([_I] * 4 + [_P] * 6, _I),
    "gnn_spmm": ([_I] * 5 + [_P] * 6 + [_I] + [_P] * 2, _I),
    "gnn_sddmm": ([_I] * 5 + [_P] * 6 + [_I] + [_P] * 2, _I),
    "gnn_sddmm_dual": ([_I] * 5 + [_P] * 8 + [_I] + [_P] * 2, _I),
    "gnn_sorted_segment_sum": ([_I] * 6 + [_P] * 3 + [_I] + [_P] * 3, _I),
    "gnn_doublet_count": ([_I, _L] + [_P] * 9 + [_D] + [_P] * 2, _I),
    "gnn_doublet_emit": ([_I, _L] + [_P] * 9 + [_D] + [_P] * 4, _I),
    "gnn_iteration_pair_bwd_recompute": ([_I] * 12 + [_P] * 13 + [_I] * 2
                                         + [_P, _I] + [_P] * 13, _I),
    "gnn_passthrough": ([_I, _L, _I] + [_P] * 3, _I),
    "gnn_gather_rows": ([_I] * 4 + [_P] * 4, _I),
    "gnn_ablate_rows": ([_I] * 7 + [_P] * 6 + [_I] + [_P] * 2, _I),
    "gnn_layer_norm_relu_fwd": ([_I, _L, _I, _D] + [_P] * 8, _I),
    "gnn_layer_norm_relu_bwd": ([_I, _L, _I] + [_P] * 13, _I),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = None if CUDA_HOME is None else os.path.join(CUDA_HOME, "bin", "nvcc")
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of gnn_fpga_tpu_torch are "
            "built at first use and need the CUDA toolkit (set CUDA_HOME or "
            "put nvcc on PATH)")
    return nvcc


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"libgnn_spmm_{h.hexdigest()[:16]}.so"


def _run(cmds: list, what: str):
    """Run the commands concurrently; raise with the output of the first
    that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}) on {what} "
                               f"{cmd[-1]}:\n{out}")


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build the library if a source changed, load it, declare the C
    signatures."""
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            nvcc = _nvcc()
            srcs = sorted(CSRC.glob("*.cu"))
            objs = [os.path.join(tmp, f"{src.stem}.o") for src in srcs]
            _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                  for src, obj in zip(srcs, objs)], "source")
            lib = os.path.join(tmp, path.name)
            _run([[nvcc, "-shared", "-o", lib, *objs]], "objects")
            os.replace(lib, path)   # atomic: concurrent builds agree
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
