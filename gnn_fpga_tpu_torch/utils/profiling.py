"""Tracing, step timing and NaN checks.

The counterpart of ``gnn_fpga_tpu/utils/profiling.py``:

- :func:`trace`: ``torch.profiler`` around a block, written as a Chrome
  trace (``chrome://tracing`` or Perfetto);
- :class:`StepTimer`: per-step wall times with warm-up discard and edges/s,
  each step ending in a synchronisation when the device is CUDA, so that
  it times the work and not its enqueueing;
- :func:`nan_check`: raise on non-finite values in a module's parameters
  or a dict of tensors;
- :func:`debug_nans`: ``torch.autograd.set_detect_anomaly``, scoped.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (host and CUDA activity) into
    ``log_dir/trace.json``::

        with profiling.trace("/tmp/trace"):
            trainer.run_steps(batches)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Wall-clock step timing with warm-up discard and throughput.

    >>> timer = StepTimer(warmup=2, device="cuda")
    >>> for batch in batches:
    ...     with timer.step(n_edges=batch.n_edge):
    ...         loss = trainer.run_steps([batch])
    >>> timer.summary()
    """

    def __init__(self, warmup: int = 2, device=None):
        self.warmup = warmup
        self.sync = (torch.device(device).type == "cuda"
                     if device is not None else False)
        self.times: List[float] = []
        self.edges: List[int] = []

    @contextlib.contextmanager
    def step(self, n_edges: int = 0):
        t0 = time.perf_counter()
        yield
        if self.sync:
            torch.cuda.synchronize()
        self.times.append(time.perf_counter() - t0)
        self.edges.append(n_edges)

    def summary(self) -> Dict[str, float]:
        times = np.asarray(self.times[self.warmup:] or self.times)
        edges = np.asarray(self.edges[self.warmup:] or self.edges)
        out = {
            "steps": int(len(times)),
            "mean_s": float(times.mean()) if len(times) else 0.0,
            "p50_s": float(np.median(times)) if len(times) else 0.0,
            "p95_s": float(np.percentile(times, 95)) if len(times) else 0.0,
        }
        if edges.sum() > 0 and times.sum() > 0:
            out["edges_per_s"] = float(edges.sum() / times.sum())
        return out


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
