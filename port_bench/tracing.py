"""A short steady slice of a run under ``torch.profiler``, read from the
trace's own timeline.

:func:`profile` runs ``fn`` inside one ``record_function`` span, so the
slice's start and end are on the trace's clock; its length is the traced
window.  The device's operations (kernels, copies, sets) are taken from
the trace with their start and end; the device is busy where any of them
runs (the union of their intervals, clipped to the window).  The longest
idle gaps are named by the innermost host operation running when each
began.
"""

from __future__ import annotations

import dataclasses
import re

import torch

SPAN = "port_bench.slice"


@dataclasses.dataclass
class Op:
    name: str
    start_ns: int
    end_ns: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


@dataclasses.dataclass
class Trace:
    window_ns: tuple
    device: list          # Op: kernels, copies, sets
    host: list            # Op: host operations

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) * 1e-9

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(b - a for a, b in self._union()) * 1e-9

    def _union(self) -> list:
        lo, hi = self.window_ns
        spans = sorted((max(o.start_ns, lo), min(o.end_ns, hi))
                       for o in self.device if o.end_ns > lo and o.start_ns < hi)
        out = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def matching(self, patterns) -> list:
        """Device operations whose name matches any of ``patterns``
        (regular expressions, searched)."""
        rx = [re.compile(p) for p in patterns]
        return [o for o in self.device if any(r.search(o.name) for r in rx)]

    def top_ops(self, n: int = 10) -> list:
        total = {}
        for o in self.device:
            total[o.name] = total.get(o.name, 0.0) + o.seconds
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], s] for name, s in top]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest gaps in the device's work inside the window,
        each named by the innermost host operation open at its start."""
        lo, hi = self.window_ns
        busy = self._union()
        edges = [lo] + [x for ab in busy for x in ab] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            open_ = [o for o in self.host
                     if o.start_ns <= a < o.end_ns and o.name != SPAN]
            name = (min(open_, key=lambda o: o.end_ns - o.start_ns).name
                    if open_ else "no host operation")
            out.append([name[:160], (b - a) * 1e-9])
        return out


def profile(fn) -> Trace:
    """``fn()`` under the profiler (host and CUDA activities), with the
    card synchronised before and after inside the span."""
    from torch.profiler import ProfilerActivity, profile as prof, record_function

    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        with record_function(SPAN):
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
    device, host, window = [], [], None
    for e in p.profiler.kineto_results.events():
        op = Op(e.name(), e.start_ns(), e.end_ns())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the span's own copy on the device's timeline is no operation
            if not e.is_user_annotation() and "annotation" not in str(
                    getattr(e, "activity_type", lambda: "")()):
                device.append(op)
        else:
            host.append(op)
            if op.name == SPAN:
                window = (op.start_ns, op.end_ns)
    if window is None:
        raise RuntimeError("the profiler's trace has no span of the slice")
    return Trace(window, device, host)
