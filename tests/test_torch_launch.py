"""The kernels' launch layer (``ops/cuda/_build.py``) on the CPU: what
:func:`launch` hands the C library, and the one launch counter that every
kernel wrapper counts in, through a reset, an addition and a captured
call's take-back.  The library and the CUDA calls are stood in for; the
kernels themselves run only on the card (``tests/test_torch_cuda.py``)."""

import contextlib

import numpy as np
import pytest
import torch

from gnn_fpga_tpu_torch.core import capture, staging
from gnn_fpga_tpu_torch.core import graph as tg
from gnn_fpga_tpu_torch.ops.cuda import _build, layer_norm, probes, spmm

WRAPPERS = (spmm.iteration_pair, spmm.aggregate_pair, spmm.gather_pair,
            spmm.iteration_pair_bwd, spmm.aggregate_pair_bwd,
            spmm.gather_pair_bwd, spmm.edge_sum, spmm.spmm, spmm.sddmm,
            spmm.sddmm_dual, layer_norm.layer_norm_relu,
            layer_norm.layer_norm_relu_bwd, probes.passthrough,
            probes.gather_rows, probes.ablate_rows,
            probes.iteration_pair_bwd_recompute)


class _Library:
    """The C library's stand-in: each call is logged and returns
    ``code``."""

    def __init__(self, code=0):
        self.code, self.calls = code, []

    def __getattr__(self, symbol):
        def call(*args):
            self.calls.append((symbol, args))
            return self.code
        return call


class _Stream:
    cuda_stream = 1234

    def wait_stream(self, other):
        pass


class _Graph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _stand_in_card(monkeypatch, code=0) -> _Library:
    lib = _Library(code)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    return lib


@pytest.fixture(autouse=True)
def _reset_counts():
    _build.reset_launch_counts()
    yield
    _build.reset_launch_counts()


def test_launch_passes_pointers_codes_and_the_stream(monkeypatch):
    lib = _stand_in_card(monkeypatch)
    a, b = torch.zeros(4), torch.zeros(3, dtype=torch.bfloat16)
    _build.launch("gnn_x", torch.bfloat16, 7, a, None, 0.5, b,
                  count="gather_rows")
    _build.launch("gnn_y", a)
    assert lib.calls == [
        ("gnn_x", (1, 7, a.data_ptr(), None, 0.5, b.data_ptr(), 1234)),
        ("gnn_y", (a.data_ptr(), 1234))]
    counts = _build.launch_counts()
    assert counts["gather_rows"] == 1 and sum(counts.values()) == 1


def test_launch_refuses_a_dtype_and_raises_on_an_error_uncounted(
        monkeypatch):
    lib = _stand_in_card(monkeypatch, code=2)
    with pytest.raises(RuntimeError, match=r"CUDA kernel gnn_x failed to "
                       r"launch \(cudaError_t 2\)"):
        _build.launch("gnn_x", torch.zeros(1), count="spmm")
    lib.code = 0
    with pytest.raises(ValueError, match="gnn_x: unsupported dtype"):
        _build.launch("gnn_x", torch.float64, torch.zeros(1), count="spmm")
    assert len(lib.calls) == 1
    assert not any(_build.launch_counts().values())


def test_counter_reset_add_and_a_captures_take_back(monkeypatch):
    """Every wrapper's name reads 0 after a reset; an addition counts the
    names it gives and ignores others; a capture records the launches it
    made and takes them back, and each replay adds them."""
    counts = _build.launch_counts()
    assert {f.__name__ for f in WRAPPERS} | {
        "sorted_segment_sum", "select_segments"} == set(counts)
    assert not any(counts.values())
    assert spmm.launch_counts() == counts
    _build.add_launch_counts({"edge_sum": 2, "spmm": 1, "no_kernel": 5})
    counts = _build.launch_counts()
    assert (counts["edge_sum"], counts["spmm"]) == (2, 1)
    assert sum(counts.values()) == 3 and "no_kernel" not in counts
    spmm.reset_launch_counts()
    assert not any(_build.launch_counts().values())

    _stand_in_card(monkeypatch)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, **kw: contextlib.nullcontext())
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda t, stream: None)
    monkeypatch.setattr(
        staging.Layout, "buffer",
        lambda self, device, pin_memory=False: torch.zeros(
            self.nbytes, dtype=torch.uint8))

    def body(g):
        _build.launch("gnn_layer_norm_relu_fwd", g.x, count="layer_norm_relu")
        _build.launch("gnn_spmm", g.x, count="spmm")
        _build.launch("gnn_spmm", g.x, count="spmm")
        return g.x.sum()

    rng = np.random.default_rng(0)
    g = tg.from_coo(rng.normal(size=(6, 2)), [0, 1, 2], [1, 2, 3],
                    [1.0, 0.0, 1.0])
    call = capture.CapturedCall(body, "cuda")
    call(g)                       # the eager run counts, the capture not
    want = dict.fromkeys(counts, 0)
    assert call.captured and call.launches == dict(
        want, layer_norm_relu=1, spmm=2)
    assert _build.launch_counts() == dict(want, layer_norm_relu=1, spmm=2)
    call(g)
    call(g)
    assert call.graph.replays == 2
    assert _build.launch_counts() == dict(want, layer_norm_relu=3, spmm=6)
