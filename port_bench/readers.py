"""What a per-layer metric's reader gets (:class:`Slice`), and the
arithmetic the readers share.

A reader returns a number, or None where it finds nothing to read (the
cell runs another route, the kernel's name is not in the trace, the card
has no peaks); it says why on standard error, and the metric is left out
of the result.  A share of a roofline or of a peak is never made 0 or
clipped.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional

from port_bench import yardstick
from port_bench.tracing import Trace


@dataclasses.dataclass
class Slice:
    """The traced slice of a run.

    ``kind``: ``"train"`` or ``"infer"``; ``units``: the optimizer steps or
    events in the slice; ``useful_flops``: a unit's useful FLOPs;
    ``launches``: the program's kernel-launch counts over the slice
    (``ops/cuda/spmm.py::launch_counts``); ``shapes``: the padded
    ``v``, ``e``, the widths ``d`` and ``hdim`` and ``dtype_bytes`` of the
    kernels' tables; ``capture_s``: the program's capture timings
    (``CapturedCall.timings``) summed; ``kernels``: ``kernels.json``."""

    trace: Trace
    kind: str
    units: int
    useful_flops: float
    launches: dict
    shapes: dict
    peaks: Optional[yardstick.ChipPeaks]
    capture_s: Optional[float]
    kernels: dict


def say(msg: str) -> None:
    print(f"port_bench: {msg}", file=sys.stderr, flush=True)


def lap(what: str, t0: float) -> float:
    """Says how long ``what`` took since ``t0``; returns the time now."""
    t = time.perf_counter()
    say(f"{what}: {t - t0:.3f} s")
    return t


def step_mfu(s: Slice, kind: str):
    """Useful FLOPs of the slice over the slice's wall time at the card's
    bf16 peak, in %."""
    if s.kind != kind:
        return None
    if s.peaks is None:
        say("no peaks for this card: step_mfu not reported")
        return None
    return 100.0 * s.units * s.useful_flops / (
        s.trace.window_s * s.peaks.bf16_tflops * 1e12)


def idle_share(s: Slice, kind: str):
    """1 - the device's busy time over the slice's wall, in %."""
    if s.kind != kind:
        return None
    return 100.0 * (1.0 - s.trace.busy_s() / s.trace.window_s)


def roofline(s: Slice, kind: str, kernel: str):
    """The least time of one call of ``kernel`` (its bytes from
    :func:`~port_bench.yardstick.kernel_work` at the call's shapes at the
    card's memory rate) over its mean device time (its kernels' time in
    the trace over the calls the program counted), in %."""
    if s.kind != kind:
        return None
    entry = s.kernels[kernel]
    ops = s.trace.matching(entry["patterns"])
    calls = s.launches.get(entry["counter"], 0)
    if not ops or not calls:
        say(f"{kernel}: {len(ops)} kernels in the trace, {calls} calls "
            "counted: its roofline is not reported")
        return None
    if s.peaks is None:
        say("no peaks for this card: rooflines not reported")
        return None
    sh = s.shapes
    nbytes, _ = yardstick.kernel_work(kernel, sh["dtype_bytes"], sh["v"],
                                      sh["e"], sh["d"], sh["hdim"])
    per_call = sum(o.seconds for o in ops) / calls
    return 100.0 * nbytes / (s.peaks.hbm_gbps * 1e9) / per_call


def share_of_busy(s: Slice, kind: str, group: str):
    """The device time of the kernels matching ``kernels.json``'s
    ``group`` over the device's busy time, in %."""
    if s.kind != kind:
        return None
    ops = s.trace.matching(s.kernels[group]["patterns"])
    if not ops:
        say(f"no {group} kernels in the trace: its share is not reported")
        return None
    return 100.0 * sum(o.seconds for o in ops) / s.trace.busy_s()


def ms_per_unit(s: Slice, kind: str, group: str):
    """Device milliseconds of the operations matching ``group`` a unit."""
    if s.kind != kind:
        return None
    ops = s.trace.matching(s.kernels[group]["patterns"])
    if not ops:
        say(f"no {group} operations in the trace")
        return None
    return 1e3 * sum(o.seconds for o in ops) / s.units
