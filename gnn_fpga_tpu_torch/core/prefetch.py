"""Host-to-device prefetching of batches.

The counterpart of ``gnn_fpga_tpu/core/prefetch.py``.  A background thread
pulls batches from a host generator (which builds, packs and plans them)
and copies each to the device while the consumer runs its step; a bounded
queue (default depth 2: one in transfer, one ready) applies back-pressure
so host memory stays bounded.

On a CUDA device the thread stages each batch (a
:class:`~gnn_fpga_tpu_torch.core.graph.Graph` or another
:class:`~gnn_fpga_tpu_torch.core.graph.TensorFields`) in one device buffer
of a ring kept for its signature (:mod:`~gnn_fpga_tpu_torch.core.staging`):
a slot is one buffer of the signature's layout and the batch's tree of
views over it, built once.  The batch is copied into a free slot on a
CUDA stream of its own, with one batched call where its tensors are in
pinned memory, or with one batched host copy into the slot's pinned twin
and one copy of the whole buffer where they are pageable, and one event
is recorded after the copy.  :meth:`PrefetchIterator.__next__` makes the
consumer's current stream wait on that event and returns the slot's view
tree.  The iterator owns the slot's memory, so nothing is marked per
tensor for the caching allocator; a slot is filled again only when
nothing outside the iterator references its buffer (no tree, tensor or
view that the consumer kept: :meth:`~gnn_fpga_tpu_torch.core.staging.
Staged.held`) and the copy stream has waited on an event recorded on the
consumer's stream after the consumer let go of it.  Otherwise the ring
takes a new slot, so a consumer that keeps batches keeps correct ones.
A consumer that drops each batch before it takes the one after next
needs at most ``size + 3`` slots a signature: ``size`` queued, one in
the worker's hands, the consumer's and the one it is letting go of.  Of
the rings the least recently used past :data:`MAX_RINGS` give their free
slots back; :meth:`PrefetchIterator.close` and exhaustion free them all.
A batch that is not a ``TensorFields`` raises ``TypeError`` on a CUDA
device.  On the CPU the iterator only queues.

``PrefetchIterator.stats`` counts the batches ``staged``, the slots
``recycled`` and ``grown`` (a new slot where the ring had slots but the
consumer held every one), and the batches ``unstaged`` (only queued, on
the CPU).

Under a profiler (:func:`~gnn_fpga_tpu_torch.utils.profiling.span`) the
consumer's blocking take from the queue is the span ``gnn.prefetch.wait``
and its stream hand-off ``gnn.prefetch.handoff``; the worker's pull from
the source is ``gnn.prefetch.source``, its copy and event
``gnn.prefetch.copy``, and its blocking put (back-pressure)
``gnn.prefetch.put_wait``.  The worker's spans are recorded only by a
profiler that records every thread (``profiling.trace``).
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Any, Iterator, Optional

import torch

from gnn_fpga_tpu_torch.core import staging
from gnn_fpga_tpu_torch.core.device import default_device
from gnn_fpga_tpu_torch.core.graph import TensorFields
from gnn_fpga_tpu_torch.utils.profiling import span

MAX_RINGS = 8


class _Slot(staging.Staged):
    """A ring's slot: a device buffer and its view tree, the event after
    its last copy (``done``), the consumer's stream at its last hand-off,
    and a pinned twin for pageable batches (made at the first)."""

    def __init__(self, layout, device):
        super().__init__(layout, device)
        self.done = torch.cuda.Event()
        self.freed = torch.cuda.Event()
        self.stream = None
        self.queued = False
        self.twin = self.twin_tensors = None

    def free(self, copy_stream) -> bool:
        """Whether the slot may be filled again; if so, ``copy_stream``
        waits for the consumer's work queued on it."""
        if self.queued or self.held():
            return False
        if self.stream is not None:
            self.freed.record(self.stream)
            copy_stream.wait_event(self.freed)
        return True

    def fill(self, tensors, pinned: bool, copy_stream) -> None:
        """Copy ``tensors`` (the batch's, in field order) into the slot on
        ``copy_stream`` (the current stream), then record ``done``."""
        if pinned:
            torch._foreach_copy_(self.tensors, tensors, non_blocking=True)
        else:
            if self.twin is None:
                self.twin = self.layout.buffer("cpu", pin_memory=True)
                self.twin_tensors = self.layout.flat_views(self.twin)
            else:
                self.done.synchronize()    # the twin's last copy is read
            torch._foreach_copy_(self.twin_tensors, tensors)
            self.buffer.copy_(self.twin, non_blocking=True)
        self.done.record(copy_stream)

    def release(self) -> None:
        """Let the caching allocator reuse the buffer once the consumer's
        queued work on it is done."""
        if self.stream is not None:
            self.buffer.record_stream(self.stream)


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
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._q: queue.Queue = queue.Queue(maxsize=size)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._rings: dict = {}     # signature -> [_Slot], least recent first
        self.stats = dict(staged=0, recycled=0, grown=0, unstaged=0)

        def worker():
            try:
                n = 0
                source = iter(it)
                with (torch.cuda.stream(self._stream) if cuda
                      else contextlib.nullcontext()):
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
                            item = self._copy(batch)
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

    def _copy(self, batch):
        """The worker's copy of ``batch``: the slot it is staged in on a
        CUDA device, else ``batch`` on the device."""
        if self._stream is None:
            self.stats["unstaged"] += 1
            return batch.to(self.device)
        if not isinstance(batch, TensorFields):
            raise TypeError(f"prefetching to {self.device} stages "
                            f"TensorFields batches, not {type(batch)}")
        sig, tensors = staging.flatten(batch)
        slot = self._take(sig, batch)
        # what a batch's first tensor with memory shows: pin_memory() pins
        # them all (a pageable tensor copied non-blocking is still copied
        # right, only synchronously)
        first = next((t for t in tensors if t.numel()), None)
        pinned = first is None or first.is_pinned()
        slot.fill(tensors, pinned, self._stream)
        self.stats["staged"] += 1
        return slot

    def _take(self, sig, batch) -> _Slot:
        """A free slot of ``sig``'s ring, or a new one."""
        ring = self._rings.pop(sig, None)
        if ring is None:
            ring = []
            self._shrink()
        self._rings[sig] = ring                  # the most recent, last
        # least recently filled first: the likeliest to be free
        for i, slot in enumerate(ring):
            if slot.free(self._stream):
                self.stats["recycled"] += 1
                del ring[i]
                break
        else:
            if ring:
                self.stats["grown"] += 1
            slot = _Slot(staging.layout(batch, sig), self.device)
        ring.append(slot)
        slot.queued = True
        return slot

    def _shrink(self) -> None:
        """Free the free slots of the least recently used rings past
        :data:`MAX_RINGS` - 1 (a new ring is about to be added)."""
        for sig in list(self._rings)[:max(len(self._rings) - MAX_RINGS + 1,
                                          0)]:
            kept = []
            for slot in self._rings[sig]:
                if slot.queued or slot.held():
                    kept.append(slot)
                else:
                    slot.release()
            if kept:
                self._rings[sig] = kept
            else:
                del self._rings[sig]

    def _free_rings(self) -> None:
        for ring in self._rings.values():
            for slot in ring:
                slot.release()
        self._rings.clear()

    def __iter__(self):
        return self

    def __next__(self):
        with span("gnn.prefetch.wait"):
            item = self._q.get()
        if item is self._DONE:
            self._free_rings()
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        with span("gnn.prefetch.handoff"):
            if not isinstance(item, _Slot):
                return item
            item.stream = torch.cuda.current_stream(self.device)
            item.stream.wait_event(item.done)
            # the consumer's reference to the tree now marks it held
            item.queued = False
        return item.tree

    def close(self):
        self._stop.set()
        # drain so the worker unblocks
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
        if not self._thread.is_alive():
            self._free_rings()


def prefetch_to_device(generator: Iterator[Any], size: int = 2, device=None,
                       n_batches: Optional[int] = None) -> PrefetchIterator:
    """Convenience wrapper: ``for batch in prefetch_to_device(gen): ...``"""
    return PrefetchIterator(generator, size=size, device=device,
                            n_batches=n_batches)
