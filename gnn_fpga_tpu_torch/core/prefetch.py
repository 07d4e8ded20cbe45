"""Host-to-device prefetching of batches.

The counterpart of ``gnn_fpga_tpu/core/prefetch.py``.  A background thread
pulls batches from a host generator (which builds, packs and plans them)
and copies each to the device while the consumer runs its step; a bounded
queue (default depth 2: one in transfer, one ready) applies back-pressure
so host memory stays bounded.

On a CUDA device the thread pins each batch, copies it with
``non_blocking=True`` on a CUDA stream of its own and records an event
after the copy.  :meth:`PrefetchIterator.__next__` makes the consumer's
current stream wait on that event, and marks every tensor of the batch
(plans included) as used on that stream (``record_stream``), so the
caching allocator does not hand the copy's memory out again while the
consumer's work on it is still queued.  On the CPU the iterator only
queues.  A batch is a :class:`~gnn_fpga_tpu_torch.core.graph.Graph` or
another :class:`~gnn_fpga_tpu_torch.core.graph.TensorFields`.

Under a profiler (:func:`~gnn_fpga_tpu_torch.utils.profiling.span`) the
consumer's blocking take from the queue is the span ``gnn.prefetch.wait``
and its stream hand-off ``gnn.prefetch.handoff``; the worker's pull from
the source is ``gnn.prefetch.source``, its pin, copy and event
``gnn.prefetch.copy``, and its blocking put (back-pressure)
``gnn.prefetch.put_wait``.  The worker's spans are recorded only by a
profiler that records every thread (``profiling.trace``).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator, Optional

import torch

from gnn_fpga_tpu_torch.core.device import default_device
from gnn_fpga_tpu_torch.utils.profiling import span


class PrefetchIterator:
    """Wrap a batch iterator with background host-to-device copies.

    Args:
      it: source iterator of host batches.
      size: queue depth (number of batches in flight; >= 1).
      device: target device (None: the CUDA device, which raises without
        one; ``"cpu"`` only queues).
      n_batches: stop after this many batches (None = until ``it`` ends).

    Iterating yields batches on ``device``.  The worker thread is a
    daemon; call :meth:`close` (or exhaust the iterator) to stop it
    eagerly.  An exception in the source iterator or in a copy is raised
    to the consumer on a later ``__next__``.
    """

    _DONE = object()

    def __init__(self, it: Iterator[Any], size: int = 2, device=None,
                 n_batches: Optional[int] = None):
        if size < 1:
            raise ValueError("prefetch size must be >= 1")
        self.device = default_device(device)
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None
        self._q: queue.Queue = queue.Queue(maxsize=size)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None

        def copy(batch):
            if not cuda:
                return batch.to(self.device), None
            with torch.cuda.stream(stream):
                dev = batch.pin_memory().to(self.device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            return dev, done

        def worker():
            try:
                n = 0
                source = iter(it)
                while True:
                    with span("gnn.prefetch.source"):
                        batch = next(source, self._DONE)
                    if batch is self._DONE:
                        break
                    if self._stop.is_set():
                        return
                    if n_batches is not None and n >= n_batches:
                        break
                    with span("gnn.prefetch.copy"):
                        item = copy(batch)
                    # block here (bounded queue): back-pressure
                    with span("gnn.prefetch.put_wait"):
                        while not self._stop.is_set():
                            try:
                                self._q.put(item, timeout=0.1)
                                break
                            except queue.Full:
                                continue
                    n += 1
            except BaseException as e:  # raised to the consumer
                self._err = e
            finally:
                while not self._stop.is_set():
                    try:
                        self._q.put(self._DONE, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        with span("gnn.prefetch.wait"):
            item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        batch, done = item
        with span("gnn.prefetch.handoff"):
            if done is not None:
                current = torch.cuda.current_stream(self.device)
                current.wait_event(done)
                for t in batch.tensors():
                    t.record_stream(current)
        return batch

    def close(self):
        self._stop.set()
        # drain so the worker unblocks
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)


def prefetch_to_device(generator: Iterator[Any], size: int = 2, device=None,
                       n_batches: Optional[int] = None) -> PrefetchIterator:
    """Convenience wrapper: ``for batch in prefetch_to_device(gen): ...``"""
    return PrefetchIterator(generator, size=size, device=device,
                            n_batches=n_batches)
