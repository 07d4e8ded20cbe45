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

Every kernel wrapper (``ops/cuda/*.py``) calls its kernel through
:func:`launch`, which passes tensors as pointers and appends the stream,
turns a failed launch into ``RuntimeError`` and counts the call by wrapper
name (:func:`launch_counts`).  The wrappers' shared checks live here too:
:func:`kernel_device` (the plain version on the CPU, the kernel on CUDA,
any other device refused), :func:`check_cuda` and :func:`check_widths`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import torch

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

# The C interface's dtype codes, and the widest row a kernel takes (8 row
# chunks of 32 lanes in csrc/).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_WIDTH = 256

# Launches by kernel wrapper since the last reset: a wrapper call counts
# as one however many C calls and CUDA launches it makes, a CPU call as
# none.
_COUNTS = dict.fromkeys((
    "iteration_pair", "aggregate_pair", "gather_pair", "iteration_pair_bwd",
    "aggregate_pair_bwd", "gather_pair_bwd", "edge_sum", "spmm", "sddmm",
    "sddmm_dual", "sorted_segment_sum", "select_segments", "layer_norm_relu",
    "layer_norm_relu_bwd", "passthrough", "gather_rows", "ablate_rows",
    "iteration_pair_bwd_recompute"), 0)


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


def _c_arg(a, symbol: str):
    if isinstance(a, torch.Tensor):
        return a.data_ptr()
    if isinstance(a, torch.dtype):
        if a not in DTYPE_CODES:
            raise ValueError(f"{symbol}: unsupported dtype {a}")
        return DTYPE_CODES[a]
    return a


def launch(symbol: str, *args, count: str | None = None) -> None:
    """One call of the library's C function ``symbol``, its arguments in
    :data:`_SIGNATURES`' order but the last: a tensor passes as its data
    pointer, a dtype as its code (:data:`DTYPE_CODES`; another dtype
    raises ``ValueError``), anything else (ints, floats, None for a null
    pointer) as it is, and the current CUDA stream of the first tensor's
    device is appended.  A nonzero return (a ``cudaError_t``) raises
    ``RuntimeError``; else the counter ``count`` adds one."""
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    code = getattr(load_library(), symbol)(
        *(_c_arg(a, symbol) for a in args),
        torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"CUDA kernel {symbol} failed to launch "
                           f"(cudaError_t {code})")
    if count is not None:
        _COUNTS[count] += 1


def launch_counts() -> dict:
    """Launches by kernel wrapper name since the last reset (every
    wrapper's name, 0 where it launched nothing)."""
    return dict(_COUNTS)


def reset_launch_counts() -> None:
    for name in _COUNTS:
        _COUNTS[name] = 0


def add_launch_counts(counts: dict) -> None:
    """Adds ``counts`` (by wrapper name, as :func:`launch_counts` gives
    them): a CUDA graph's replay launches the kernels its capture recorded
    (``core/capture.py``)."""
    for name in _COUNTS:
        _COUNTS[name] += counts.get(name, 0)


def kernel_device(t, name: str):
    """Where a wrapper runs on ``t``: None on the CPU (the plain version),
    ``t.device`` on CUDA (the kernel); any other device is refused rather
    than falling back.  Which dtypes a kernel takes is the wrapper's
    check."""
    if t.device.type == "cpu":
        return None
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {t.device}, expected CPU or "
                         "CUDA")
    return t.device


def check_cuda(device, dtype, **tensors) -> None:
    """Device, dtype and contiguity checks before passing raw pointers."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_widths(name: str, *widths) -> None:
    if max(widths) > MAX_WIDTH:
        raise ValueError(f"{name}: widths above {MAX_WIDTH}")


def alignment(*tensors) -> int:
    """The largest power of two, at most 16, that divides the base address
    of every tensor (an empty tensor's null address divides by all)."""
    align = 16
    for t in tensors:
        ptr = t.data_ptr()
        if ptr:
            align = min(align, ptr & -ptr)
    return align


def grad_as(g, dtype):
    """An output gradient as a kernel operand: in ``dtype``, contiguous
    (autograd hands column slices of a concatenation's gradient)."""
    return g.to(dtype).contiguous()
