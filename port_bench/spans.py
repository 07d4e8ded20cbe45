"""The arithmetic of the per-layer metrics that read the program's own
spans.

The program opens named ranges of host work on its hot paths
(``gnn_fpga_tpu_torch/utils/profiling.py::span``) while a profiler runs.
They are host events of the traced slice (``Trace.host``), on the same
clock as the device's operations (``Trace.device``), so a span's time and
the device's idle time inside it can be read together.  On one thread the
spans follow one another and never overlap.  The benchmark's profiler
records the calling thread only, so the prefetching worker's spans are not
read here.

Each function takes a :class:`~port_bench.readers.Slice` and returns a
number, or None where the slice is of the other kind or lacks a span it
reads (a program without these spans), saying why on standard error.
"""

from __future__ import annotations

from port_bench.readers import say

PREPARE = "gnn.run_steps.prepare"
LOAD = "gnn.captured.load"
REPLAY = "gnn.captured.replay"
READBACK = "gnn.run_steps.readback"
WAIT = "gnn.prefetch.wait"
HANDOFF = "gnn.prefetch.handoff"


def union(intervals) -> list:
    """``intervals`` (pairs of ns) as sorted, disjoint ``[start, end]``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return out


def overlap_ns(xs: list, ys: list) -> int:
    """Nanoseconds in both of two sorted, disjoint interval lists."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def _clip(ops, window) -> list:
    lo, hi = window
    return [(max(o.start_ns, lo), min(o.end_ns, hi)) for o in ops
            if o.end_ns > lo and o.start_ns < hi]


def _found(s, metric: str, names) -> dict:
    """Each of ``names`` to the ``(start, end)`` of its spans in the
    slice's window, or None (said) where one of them is absent."""
    found = {n: _clip([o for o in s.trace.host if o.name == n],
                      s.trace.window_ns) for n in names}
    missing = [n for n, v in found.items() if not v]
    if missing:
        say(f"{metric}: no {', '.join(missing)} span in the trace (the "
            "program opens none): not reported")
        return None
    return found


def _ms(found: dict, names) -> float:
    return 1e-6 * sum(b - a for n in names for a, b in found[n])


def prologue_ms_per_call(s):
    """Host ms of ``gnn.run_steps.prepare`` and ``gnn.captured.load``
    over the calls (``gnn.run_steps.readback`` spans)."""
    if s.kind != "train":
        return None
    found = _found(s, "prologue_ms_per_call", (PREPARE, LOAD, READBACK))
    if found is None:
        return None
    return _ms(found, (PREPARE, LOAD)) / len(found[READBACK])


def replay_idle_share(s):
    """The share of the window, in %, in which the device runs nothing
    while the host is inside ``gnn.captured.replay`` or
    ``gnn.run_steps.readback``, that is while a replay is outstanding:
    the captured graph's own gaps.  At most the device's idle share."""
    if s.kind != "train":
        return None
    found = _found(s, "replay_idle_share", (REPLAY, READBACK))
    if found is None:
        return None
    outstanding = union(found[REPLAY] + found[READBACK])
    busy = union(_clip(s.trace.device, s.trace.window_ns))
    idle = (sum(b - a for a, b in outstanding)
            - overlap_ns(outstanding, busy))
    lo, hi = s.trace.window_ns
    return 100.0 * idle / (hi - lo)


def input_wait_ms_per_event(s):
    """Host ms of ``gnn.prefetch.wait`` (the consumer blocked on the
    prefetch queue) an event."""
    if s.kind != "infer" or not s.units:
        return None
    found = _found(s, "input_wait_ms_per_event", (WAIT,))
    if found is None:
        return None
    return _ms(found, (WAIT,)) / s.units


def replay_host_ms_per_event(s):
    """Host ms of ``gnn.prefetch.handoff``, ``gnn.captured.load`` and
    ``gnn.captured.replay`` an event: the batch handed to the consumer's
    stream, copied into the capture's buffers and the graph launched."""
    if s.kind != "infer" or not s.units:
        return None
    names = (HANDOFF, LOAD, REPLAY)
    found = _found(s, "replay_host_ms_per_event", names)
    if found is None:
        return None
    return _ms(found, names) / s.units
