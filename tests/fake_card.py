"""Stand-ins for the CUDA streams, events and pinned memory that
``core/prefetch.py`` uses, so that its staging ring runs on the CPU.

:func:`install` points the prefetching iterator at a device of type
``cuda`` whose slots are CPU buffers; streams and events only log what
is done with them (``Card.log``: ``("record", event, stream)``,
``("wait", stream, event)``, ``("record_stream", stream)``), and
``Tensor.is_pinned`` reads ``Card.pinned``.  The copies are plain CPU
copies, so every value is real; only the ordering on the device is
stood in for, as a log.
"""

import contextlib

import torch

from gnn_fpga_tpu_torch.core import prefetch, staging


class Card:
    def __init__(self):
        self.log: list = []
        self.pinned = True
        self.consumer = Stream(self)


class Stream:
    def __init__(self, card, name="consumer"):
        self.card, self.name = card, name

    def wait_event(self, event):
        self.card.log.append(("wait", self, event))

    def __repr__(self):
        return f"Stream({self.name})"


class Event:
    def __init__(self, card):
        self.card = card

    def record(self, stream):
        self.card.log.append(("record", self, stream))

    def synchronize(self):
        pass


def install(monkeypatch) -> Card:
    """Patch torch and the staging modules for the test's duration."""
    card = Card()
    monkeypatch.setattr(prefetch, "default_device",
                        lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda device=None: Stream(card, "copy"))
    monkeypatch.setattr(torch.cuda, "Event", lambda: Event(card))
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: card.consumer)
    monkeypatch.setattr(
        staging.Layout, "buffer",
        lambda self, device, pin_memory=False: torch.zeros(
            self.nbytes, dtype=torch.uint8))
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda t: card.pinned)
    monkeypatch.setattr(
        torch.Tensor, "record_stream",
        lambda t, stream: card.log.append(("record_stream", stream)))
    return card
