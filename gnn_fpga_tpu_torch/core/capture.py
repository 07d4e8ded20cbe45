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

Kernel launch counts (``ops/cuda/_build.py::launch_counts``): the capture
records the launches it made and takes them back, since capture launches
nothing; each replay adds them, since a replay launches those kernels
(``K`` steps' launches for a K-step graph).
"""

from __future__ import annotations

import gc
import time

import torch

from gnn_fpga_tpu_torch.core import staging
from gnn_fpga_tpu_torch.core.graph import index_fields
# callers take the signature from here, where captures are keyed by it
from gnn_fpga_tpu_torch.core.staging import signature  # noqa: F401
from gnn_fpga_tpu_torch.ops.cuda._build import add_launch_counts, launch_counts
from gnn_fpga_tpu_torch.utils.profiling import span


def scan(step, stacked) -> torch.Tensor:
    """``step(stacked[k])`` for each slice ``k`` of the leading axis, in
    order, the ``K`` outputs (0-d tensors, a step's loss) stacked into one
    ``[K]`` tensor: the body of a K-step captured call, the counterpart of
    ``lax.scan`` over a stack of batches."""
    n = next(stacked.tensors()).shape[0]
    return torch.stack([step(index_fields(stacked, k)) for k in range(n)])


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
    call overwrites.  The static buffers are one byte buffer in the
    signature's staging layout (:class:`~gnn_fpga_tpu_torch.core.staging.
    Layout`), ``inputs`` the batch's tree of views over it.  A batch
    staged in a buffer of that layout (a prefetched batch) is loaded with
    one copy of the whole buffer; any other (a stack on the device, a
    host batch) with one batched copy of its tensors.  ``load_counts``
    counts the two.  :meth:`replay` runs the program again on the
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
        self._buffer = self._inputs = None
        self.load_counts = dict(one_copy=0, batched=0)
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
            mark = staging.staged_in(batch)
            if mark is not None:
                layout, buffer = mark
                sig = layout.signature
            else:
                sig, tensors = staging.flatten(batch)
            if self.inputs is None:
                layout = staging.layout(batch, sig)
                self.signature = layout.signature
                self._buffer = layout.buffer(self.device)
                self.inputs, self._inputs, _ = layout.views(self._buffer)
            elif sig != self.signature:
                raise ValueError(
                    "a captured call got a batch of another static "
                    "signature; each signature needs its own capture")
            if mark is not None:
                self._buffer.copy_(buffer, non_blocking=True)
                self.load_counts["one_copy"] += 1
            else:
                torch._foreach_copy_(self._inputs, tensors, non_blocking=True)
                self.load_counts["batched"] += 1

    def __call__(self, batch):
        self.load(batch)
        if self.graph is not None:
            return self.replay()
        if self.device.type != "cuda":
            return self.fn(self.inputs)
        return self._warm_up_and_capture()

    def replay(self):
        """Run the captured program on the buffers; returns its output."""
        with span("gnn.captured.replay"):
            self.graph.replay()
            add_launch_counts(self.launches)
        return self.output

    def _warm_up_and_capture(self):
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
        before = launch_counts()
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
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        add_launch_counts({k: -n for k, n in self.launches.items()})
        self.graph = graph
        return out
