"""ctypes binding for the repo's native (C++/OpenMP) preprocessing library.

The counterpart of ``gnn_fpga_tpu/data/native.py``, loading the same
``native/libgnn_native.so`` by path (built by ``make -C native``).
``native/doublets.cpp`` implements the doublet cross-join of one layer
pair without the O(n1*n2) temporaries of the numpy path.  On the CPU,
:func:`gnn_fpga_tpu_torch.data.doublets.construct_graph` uses it when the
library is built; on the card the cross-join is the CUDA kernel of
``ops/cuda/doublets.py`` and this library is never used.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libgnn_native.so"


@functools.cache
def _load() -> Optional[ctypes.CDLL]:
    if not LIB_PATH.exists():
        return None
    lib = ctypes.CDLL(str(LIB_PATH))
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int64)
    lib.select_segments_f64.restype = ctypes.c_int64
    lib.select_segments_f64.argtypes = [
        dp, dp, dp, ctypes.c_int64,
        dp, dp, dp, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double,
        ip, ip, ctypes.c_int64,
    ]
    lib.num_threads.restype = ctypes.c_int
    lib.num_threads.argtypes = []
    return lib


def available() -> bool:
    return _load() is not None


def num_threads() -> int:
    lib = _load()
    return lib.num_threads() if lib else 0


def _as_f64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64))


def select_segments_native(
    r1, phi1, z1, r2, phi2, z2,
    phi_slope_cut: float, z0_max: float,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native cross-join of one layer pair; None if the library is absent.
    Local ``(i1, i2)`` int64, in ``np.nonzero``'s row-major order."""
    lib = _load()
    if lib is None:
        return None
    r1, phi1, z1 = _as_f64(r1), _as_f64(phi1), _as_f64(z1)
    r2, phi2, z2 = _as_f64(r2), _as_f64(phi2), _as_f64(z2)
    n1, n2 = len(r1), len(r2)
    if n1 == 0 or n2 == 0:
        z = np.zeros(0, np.int64)
        return z, z
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int64)

    def run(cap: int):
        out1 = np.empty(cap, np.int64)
        out2 = np.empty(cap, np.int64)
        n = lib.select_segments_f64(
            r1.ctypes.data_as(dp), phi1.ctypes.data_as(dp),
            z1.ctypes.data_as(dp), n1,
            r2.ctypes.data_as(dp), phi2.ctypes.data_as(dp),
            z2.ctypes.data_as(dp), n2,
            float(phi_slope_cut), float(z0_max),
            out1.ctypes.data_as(ip), out2.ctypes.data_as(ip), cap)
        return n, out1, out2

    n, out1, out2 = run(max(1024, (n1 * n2) // 8))
    if n < 0:   # capacity miss: the library returns the size it needs
        n, out1, out2 = run(-n)
    return out1[:n], out2[:n]
