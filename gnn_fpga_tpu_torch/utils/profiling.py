"""Tracing, spans and NaN checks.

The counterpart of ``gnn_fpga_tpu/utils/profiling.py``:

- :func:`trace`: ``torch.profiler`` around a block, every thread's host
  work included (the prefetching worker's), written as a Chrome trace
  (``chrome://tracing`` or Perfetto);
- :func:`span`: a named range of host work on the profiler's clock, for
  the port's hot paths; free when no profiler runs;
- :func:`nan_check`: raise on non-finite values in a module's parameters
  or a dict of tensors;
- :func:`debug_nans`: ``torch.autograd.set_detect_anomaly``, scoped.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.autograd import profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` (``gnn.<layer>.<part>``)
    while a profiler runs, else one shared no-op context.

    Under ``torch.profiler`` the range is a host event on the trace's
    clock, beside the device's operations, so an idle gap on the device
    can be put down to the range open at that moment; under
    ``torch.autograd.profiler.emit_nvtx`` it is an NVTX range.  The gate
    is the profiler's module-wide flag, which every thread sees (the
    thread-local ``torch._C._autograd._profiler_enabled()`` reads False
    in a worker thread even when the profiler records all threads)::

        with profiling.span("gnn.captured.replay"):
            graph.replay()
    """
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def _all_threads_config():
    """The profiler's setting that records every thread's host events,
    or None where the installed torch has no such field."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (host and CUDA activity, the host events of every
    thread where the installed torch can record them, so that a
    prefetching worker's spans and copies show) into
    ``log_dir/trace.json``::

        with profiling.trace("/tmp/trace"):
            trainer.run_steps(batches)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 experimental_config=_all_threads_config()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def nan_check(tree, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` if a floating tensor of ``tree`` (an
    ``nn.Module``'s parameters, or a nested dict of tensors) holds a
    non-finite value."""
    if isinstance(tree, torch.nn.Module):
        leaves = [(f"['{k}']", p) for k, p in tree.named_parameters()]
    else:
        leaves = list(_leaves_with_path(tree))
    for path, leaf in leaves:
        a = torch.as_tensor(leaf).detach()
        if a.is_floating_point() and not torch.isfinite(a).all():
            n_bad = int((~torch.isfinite(a)).sum())
            raise FloatingPointError(
                f"{name}{path}: {n_bad} non-finite values "
                f"(shape {tuple(a.shape)})")


def _leaves_with_path(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, f"{path}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    else:
        yield path, tree


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped autograd anomaly detection: a backward that produces NaN
    raises, naming the forward operation."""
    with torch.autograd.set_detect_anomaly(enable):
        yield
