"""What the probes share: the layered test graph, the chained timer, the
card's busy time under the profiler, the SegmentClassifier and Trainer
the measurement modules train (from the JAX package's initial weights by
default), their best-of-N timer and the line that names the device.

``layered_graph`` is ``benchmarks/probe_spmm.py``'s, bit for bit;
``timed`` is the counterpart of ``benchmarks/probe_ops.py``'s, with both
of its defences: each call's first float argument is perturbed by ``c *
1e-30``, ``c`` the sum of the whole previous output (no call can be
skipped or sliced), and the chained calls run as one dispatch, on the card
one captured CUDA graph replayed between two CUDA events.  Its kernel
launch counts are those ``core/capture.py`` keeps: the capture takes back
what it recorded, each replay adds it.
"""

from __future__ import annotations

import contextlib
import io
import subprocess
import time

import numpy as np
import torch

from gnn_fpga_tpu_torch.models import mpnn
from gnn_fpga_tpu_torch.ops.cuda import spmm
from gnn_fpga_tpu_torch.train.trainer import Trainer
from gnn_fpga_tpu_torch.utils import prng
from gnn_fpga_tpu_torch.utils.serialization import load_jax_params


def layered_graph(v, e, n_layers=8, phi_window=128, seed=0):
    """Senders uniformly in layers [0, L - 1), receivers one layer up
    within a phi window: ``(senders, receivers)`` int32, ``v // n_layers``
    nodes a layer ordered by phi."""
    rng = np.random.default_rng(seed)
    per_layer = v // n_layers
    # senders uniformly in layers [0, L-1), receivers one layer up within
    # a phi window
    layer = rng.integers(0, n_layers - 1, size=e)
    phi = rng.integers(0, per_layer, size=e)
    senders = (layer * per_layer + phi).astype(np.int32)
    dphi = rng.integers(-phi_window // 2, phi_window // 2, size=e)
    rphi = np.clip(phi + dphi, 0, per_layer - 1)
    receivers = ((layer + 1) * per_layer + rphi).astype(np.int32)
    return senders, receivers


def _total(out) -> torch.Tensor:
    """The f32 sum of every element of ``out`` (a tensor or a tuple)."""
    if isinstance(out, (tuple, list)):
        return sum(_total(o) for o in out)
    return out.sum(dtype=torch.float32)


def timed(op, args, n_iters=200, n_reps=3):
    """Seconds a call of ``op(*args)`` takes, chained: call ``i + 1``'s
    first float argument (a copy of the caller's) has ``c * 1e-30`` added
    to its first element, ``c`` the f32 sum of the WHOLE output of call
    ``i``, so every call depends on all of the one before.  The
    ``n_iters`` calls run as one dispatch: on the card they are captured
    once in a CUDA graph (after one eager run on a side stream) and the
    graph is replayed between two CUDA events, best of ``n_reps``; a call
    that cannot be captured raises.  On the CPU (tests only) the calls
    loop under ``time.perf_counter``.  Each call's time includes its share
    of the sum and the perturbation, as on the TPU."""
    args = list(args)
    first = next(i for i, a in enumerate(args)
                 if torch.is_tensor(a) and a.is_floating_point())
    x = args[first] = args[first].clone(memory_format=torch.contiguous_format)
    head = x.view(-1)[:1]
    c = torch.zeros((), dtype=torch.float32, device=x.device)

    def chained():
        for _ in range(n_iters):
            head.add_((c * 1e-30).to(x.dtype))
            c.copy_(_total(op(*args)))

    if x.device.type != "cuda":
        chained()
        best = float("inf")
        for _ in range(n_reps):
            t0 = time.perf_counter()
            chained()
            best = min(best, time.perf_counter() - t0)
        return best / n_iters
    side = torch.cuda.Stream(x.device)
    side.wait_stream(torch.cuda.current_stream(x.device))
    with torch.cuda.stream(side):
        chained()
    torch.cuda.current_stream(x.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = spmm.launch_counts()
    with torch.cuda.graph(graph):
        chained()
    after = spmm.launch_counts()
    # the capture launched nothing; each replay launches what it recorded
    recorded = {k: after[k] - before[k] for k in after}
    spmm.add_launch_counts({k: -n for k, n in recorded.items()})

    def replay():
        graph.replay()
        spmm.add_launch_counts(recorded)

    replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    best = float("inf")
    for _ in range(n_reps):
        start.record()
        replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best / n_iters


INITS = ("jax", "torch")


def segment_classifier(cfg, device=None, seed: int = 0, init: str = "jax"):
    """A SegmentClassifier of ``cfg`` (shared weights) on ``device``.
    ``init="jax"``: the JAX package's initial weights of ``PRNGKey(seed)``
    (``utils/prng.py``), the draw the TPU probes' records and AUC gates
    were taken from; ``init="torch"``: the port's own draw from
    ``torch.Generator().manual_seed(seed)``, as the rest of the port
    initialises."""
    if init not in INITS:
        raise ValueError(f"init must be one of {INITS}, not {init!r}")
    gen = torch.Generator().manual_seed(seed)
    model = mpnn.init_segment_classifier(cfg, gen, device=device)
    if init == "jax":
        load_jax_params(model, prng.segment_classifier_params(
            seed, cfg.input_dim, cfg.hidden_dim))
    return model


def make_trainer(cfg, tcfg, device=None, seed: int = 0, init: str = "jax",
                 **trainer_kw) -> Trainer:
    """A Trainer of :func:`segment_classifier` under ``tcfg`` (its
    set-up print silenced); ``trainer_kw`` go to ``Trainer``."""
    model = segment_classifier(cfg, device, seed, init)
    with contextlib.redirect_stdout(io.StringIO()):
        return Trainer(model, tcfg, **trainer_kw)


def best_of(trainer, stacked, n_reps: int = 3) -> tuple:
    """The best of ``n_reps`` calls of ``trainer.run_steps(stacked)``,
    each clock stopped by the call's loss readback: ``(seconds of the
    best call, the last call's losses)``."""
    best = float("inf")
    for _ in range(n_reps):
        t0 = time.perf_counter()
        losses = trainer.run_steps(stacked)
        best = min(best, time.perf_counter() - t0)
    return best, losses


def profiled(run) -> tuple:
    """``run()`` under ``torch.profiler``: ``(wall ms with the profiler
    on, device busy ms, the profiler's key averages)``.  Busy time is the
    device events, as the table's own total counts them (an autograd
    Function's CPU row also carries its kernel's time, so CPU rows are
    left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in table
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation) / 1e3
    return wall_ms, busy_ms, table


def device_busy_ms(run) -> float:
    """Milliseconds the card is busy while ``run()`` runs
    (:func:`profiled`).  Time ``run`` with the profiler off apart; the
    idle share is ``1 - busy / wall``."""
    return profiled(run)[1]


def device_line(device) -> str:
    """The device the probe runs on: the card's name and power limit as
    ``nvidia-smi`` gives them, or the CPU."""
    if device.type != "cuda":
        return "cpu (plain versions; no device metric)"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = ""
    return smi or torch.cuda.get_device_name(device)
