"""One compiled program per static shape: the port's counterpart of
``jax.jit``.

The JAX package jits its train step, its eval loss and predict and the
infer CLI's forward, so each runs as one program for each static shape
(``gnn_fpga_tpu/train/trainer.py``, ``gnn_fpga_tpu/cli/infer.py``).  Here
the idiom is a CUDA graph: :class:`CapturedCall` runs ``fn(batch)`` on
static input buffers, captures it once in a ``torch.cuda.CUDAGraph`` and
from then on copies each batch into the buffers and replays the graph, so
the host issues one replay where it dispatched ~150 kernels and ops.
A captured call serves the batches of one :func:`signature` (a bucket's
shape); callers keep one for each signature, as jit keeps one program for
each shape.

Capture follows PyTorch's whole-network recipe: the first call runs
``fn`` eagerly on a side stream (a real call, whose result is returned),
then captures it; the kernels' lazy set-up (the library load, first-use
build) therefore happens before capture.  A capture that fails raises: it
never degrades to the eager path.  On the CPU the same static buffers are
filled and ``fn`` runs on them eagerly, so the plumbing runs in tests.

The JAX package also scans an epoch of stacked batches inside one jit
(``lax.scan``, ``Trainer.run_steps``).  Its counterpart is a captured call
whose body is :func:`scan`: ``K`` steps in order over the slices of one
stack in the static buffers, all recorded in one graph, so that one
replay runs the ``K`` steps; the stack's leading axis makes ``K`` part of
the signature.  Memory freed by step ``k`` during the capture goes back
to the capture's pool, where step ``k + 1`` takes it again.

Kernel launch counts (``ops/cuda/spmm.py::launch_counts``): the capture
records the launches it made and takes them back, since capture launches
nothing; each replay adds them, since a replay launches those kernels
(``K`` steps' launches for a K-step graph).
"""

from __future__ import annotations

import dataclasses
import gc
import time

import torch

from gnn_fpga_tpu_torch.core.graph import TensorFields, index_fields
from gnn_fpga_tpu_torch.utils.profiling import span


def signature(batch) -> tuple:
    """The static signature of a batch (a tensor or a
    :class:`~gnn_fpga_tpu_torch.core.graph.TensorFields` tree such as a
    :class:`~gnn_fpga_tpu_torch.core.graph.Graph` with its plans or
    blocks): every tensor's shape and dtype, and every host field (the
    plans' node, edge, item and slot counts), by field.  Batches of one
    signature can share one captured program; the device is not part of
    it (a host batch is copied straight into the buffers)."""
    if isinstance(batch, torch.Tensor):
        return (tuple(batch.shape), batch.dtype)
    if isinstance(batch, TensorFields):
        return (type(batch).__name__,) + tuple(
            (f.name, signature(getattr(batch, f.name)))
            for f in dataclasses.fields(batch))
    return batch


def scan(step, stacked) -> torch.Tensor:
    """``step(stacked[k])`` for each slice ``k`` of the leading axis, in
    order, the ``K`` outputs (0-d tensors, a step's loss) stacked into one
    ``[K]`` tensor: the body of a K-step captured call, the counterpart of
    ``lax.scan`` over a stack of batches."""
    n = next(stacked.tensors()).shape[0]
    return torch.stack([step(index_fields(stacked, k)) for k in range(n)])


def _buffers_like(batch, device):
    """A zeroed copy of ``batch``'s structure on ``device``."""
    if isinstance(batch, torch.Tensor):
        return torch.zeros(batch.shape, dtype=batch.dtype, device=device)
    return batch._map(lambda v: _buffers_like(v, device))


class CapturedCall:
    """``fn(batch)`` for batches of one :func:`signature`, as one
    replayable program on a CUDA device.

    Args:
      fn: the call, reading only its argument and state whose addresses
        stay put (parameters, optimizer state, masks).
      device: the device of the static buffers and of ``fn``'s work.
      pool: a CUDA graph memory pool (``torch.cuda.graph_pool_handle()``)
        shared with other captures that never run at the same time.

    ``call(batch)`` copies ``batch`` into the static buffers (a batch of
    another signature raises ``ValueError``) and returns ``fn``'s output:
    from the second call on it is the captured output, which the next
    call overwrites.  :meth:`replay` runs the program again on the
    buffers as they are.  ``timings`` holds the host seconds of the first
    call's eager run, of recording the capture, and of ending it (where
    the graph is instantiated).  Under a profiler the copies and the
    replay are the spans ``gnn.captured.load`` and ``gnn.captured.replay``
    (:func:`~gnn_fpga_tpu_torch.utils.profiling.span`).
    """

    def __init__(self, fn, device, pool=None):
        self.fn = fn
        self.device = torch.device(device)
        self.pool = pool
        self.signature = None
        self.inputs = None
        self.output = None
        self.graph = None
        self.launches: dict = {}
        self.timings: dict = {}

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def load(self, batch) -> None:
        """Copy ``batch`` into the static buffers (allocated at the first
        batch, whose signature they take)."""
        with span("gnn.captured.load"):
            sig = signature(batch)
            if self.inputs is None:
                self.signature = sig
                self.inputs = _buffers_like(batch, self.device)
            elif sig != self.signature:
                raise ValueError(
                    "a captured call got a batch of another static "
                    "signature; each signature needs its own capture")
            for dst, src in zip(self.inputs.tensors(), batch.tensors()):
                dst.copy_(src, non_blocking=True)

    def __call__(self, batch):
        self.load(batch)
        if self.graph is not None:
            return self.replay()
        if self.device.type != "cuda":
            return self.fn(self.inputs)
        return self._warm_up_and_capture()

    def replay(self):
        """Run the captured program on the buffers; returns its output."""
        from gnn_fpga_tpu_torch.ops.cuda import spmm

        with span("gnn.captured.replay"):
            self.graph.replay()
            spmm.add_launch_counts(self.launches)
        return self.output

    def _warm_up_and_capture(self):
        from gnn_fpga_tpu_torch.ops.cuda import spmm

        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.fn(self.inputs)
        current.wait_stream(side)
        if isinstance(out, torch.Tensor):
            out.record_stream(current)
        torch.cuda.synchronize(self.device)    # as the capture's start does
        t1 = time.perf_counter()
        before = spmm.launch_counts()
        graph = torch.cuda.CUDAGraph()
        # A graph that the collector frees while this one is captured
        # (another call's, in an unreachable cycle) would end the capture:
        # collect first, and not during the capture.
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        try:
            # thread_local: a prefetching thread may copy and allocate on
            # its own stream while the capture runs
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                t2 = time.perf_counter()
                self.output = self.fn(self.inputs)
                t3 = time.perf_counter()
        finally:
            if enabled:
                gc.enable()
        self.timings = dict(eager_s=t1 - t0, capture_s=t3 - t2,
                            instantiate_s=time.perf_counter() - t3)
        after = spmm.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        spmm.add_launch_counts({k: -n for k, n in self.launches.items()})
        self.graph = graph
        return out
