"""Faults planted under the timed path, to show that the check fails them.

:func:`planted` patches :mod:`port_bench.program` so that the trainer or
the captured forward a session builds is broken in one way:

- ``unchanged``: the optimizer's step does nothing (a step that returns
  its state unchanged);
- ``half``: the loss, or the scored event, leaves out the second half of
  the batch (its edges or nodes masked), the mean taken over the rest;
- ``altered``: one edge's probability moved by 0.5 (modulo 1) where it
  is produced;
- ``stale``: each event gets the answer of the event before it.

The benchmark's own runs never import this module; the calibration tool
and the tests do.
"""

from __future__ import annotations

import contextlib

from port_bench import program

TRAIN = ("unchanged", "half")
INFER = ("half", "altered", "stale")


def _halved(mask):
    flat = mask.clone().reshape(-1)
    flat[flat.numel() // 2:] = 0
    return flat.reshape(mask.shape)


class _Stale:
    """A captured forward that answers each event with the previous
    event's probabilities."""

    def __init__(self, call):
        self.call, self.prev = call, None

    @property
    def timings(self):
        return self.call.timings

    def __call__(self, g):
        out = self.call(g).clone()
        prev, self.prev = self.prev, out
        return out if prev is None else prev


@contextlib.contextmanager
def planted(fault: str):
    make_trainer, forward = program.make_trainer, program.captured_forward

    def broken_trainer(model, cfg):
        trainer = make_trainer(model, cfg)
        if fault == "unchanged":
            trainer.optimizer.step = lambda *a, **k: None
        elif fault == "half":
            whole = trainer._target_and_mask
            trainer._target_and_mask = lambda g: (
                lambda t, m: (t, _halved(m)))(*whole(g))
        else:
            raise ValueError(f"no training fault {fault!r}")
        return trainer

    def broken_forward(model, device):
        call = forward(model, device)
        if fault == "stale":
            return _Stale(call)
        fn = call.fn
        if fault == "half":
            call.fn = lambda g: fn(g.replace(edge_mask=_halved(g.edge_mask)))
        elif fault == "altered":
            def altered(g):
                p = fn(g).clone()
                p[0] = (p[0] + 0.5) % 1.0
                return p
            call.fn = altered
        else:
            raise ValueError(f"no scoring fault {fault!r}")
        return call

    program.make_trainer = broken_trainer
    program.captured_forward = broken_forward
    try:
        yield
    finally:
        program.make_trainer, program.captured_forward = make_trainer, forward
