"""The scoring driver: a closed loop of whole events, each scored by the
infer CLI's captured forward (``cli/infer.py::captured_forward``) and its
probabilities read back to the host.

Events come from a pool made from the seed, in the route's layout, held
in pinned host memory; ``core/prefetch.py::prefetch_to_device`` copies
each to the card on its own stream, ``prefetch_depth`` ahead, so one event
copies while the one before it is scored.  An event enters the pipeline
when the prefetching thread takes it from the source; its latency runs
from then to its probabilities on the host.  The source stops once the
window's time has passed, and every event that entered is scored.  A
sample of the answers, drawn from the seed (a reservoir over every event
of the window), is kept for the check.
"""

from __future__ import annotations

import gc
import random
import statistics
import threading
import time

import torch

from port_bench import judge, program, readers, reference, yardstick
from port_bench.train import build_pool


class Session:
    """One cell's scoring run on ``device``: set-up on construction."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.device = cfg, mix, torch.device(device)
        self.seed = seed
        t = time.perf_counter()
        self.events, batches, wseed = build_pool(cfg, mix, seed)
        t = readers.lap("events built", t)
        cuda = self.device.type == "cuda"
        self.pool = [b.pin_memory() if cuda else b for b in batches]
        self.n_real = [program.real_edges(b) for b in batches]
        self.w0 = reference.make_weights(cfg, wseed, self.device)
        self.model = program.make_model(cfg, mix, self.w0, self.device)
        self.forward = program.captured_forward(self.model, self.device)
        self.shapes = program.kernel_shapes(batches[0], cfg)
        # the first call runs eagerly and captures; then the pipeline once
        # over the pool
        t = readers.lap("pool pinned, model", t)
        self.forward(self.pool[0].to(self.device))
        t = readers.lap("first forward (eager, captured)", t)
        self.loop(len(self.pool))
        readers.lap("the pipeline once over the pool", t)
        self.capture_s = program.capture_seconds(self.forward)

    def loop(self, n_events=None, seconds=None) -> dict:
        """The closed loop, until ``n_events`` have entered or ``seconds``
        have passed: every latency, the answers sampled, the window."""
        rng = random.Random(self.seed)
        keep = self.mix["sample"]
        sample = {}
        stop = threading.Event()
        enter = []
        t0 = time.perf_counter()

        def source():
            i = 0
            while not stop.is_set() and (n_events is None or i < n_events):
                enter.append(time.perf_counter())
                yield self.pool[i % len(self.pool)]
                i += 1

        lat = []
        it = program.prefetch(source(), self.mix["prefetch_depth"],
                              self.device)
        try:
            for i, g in enumerate(it):
                probs = self.forward(g).cpu()
                done = time.perf_counter()
                lat.append(done - enter[i])
                # a reservoir: each event of the window sampled alike
                if len(sample) < keep:
                    sample[i] = probs
                else:
                    j = rng.randrange(i + 1)
                    if j < keep:
                        sample.pop(sorted(sample)[j])
                        sample[i] = probs
                if seconds is not None and done - t0 >= seconds:
                    stop.set()
        finally:
            stop.set()
            it.close()
        return dict(latencies=lat, sample=sample, window_s=done - t0)

    def window(self, seconds: float) -> dict:
        run = self.loop(seconds=seconds)
        self.sample = run["sample"]
        lat = run["latencies"]
        p95 = statistics.quantiles(lat, n=100, method="inclusive")[94]
        return dict(infer_events_per_s=len(lat) / run["window_s"],
                    infer_p95_ms=1e3 * p95, attempted=len(lat),
                    window_s=run["window_s"])

    def flops_per_event(self) -> float:
        ev = self.events[0]
        return yardstick.forward_flops(self.cfg["model"], ev.n_node, ev.n_edge,
                                       self.cfg["hidden_dim"],
                                       self.cfg["n_iters"],
                                       self.cfg["input_dim"])

    def free_program(self) -> None:
        self.model = self.forward = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def pairs(self, rounding=None) -> list:
        """``(the program's probabilities, the reference's)`` of each
        sampled event, real edges only; with ``rounding`` the reference in
        that precision stands in for the program (the control)."""
        reference.strict_float32()
        out = []
        for i, probs in sorted(self.sample.items()):
            k = i % len(self.pool)
            g = reference.graph_tensors(self.events[k].packed(), self.device)
            want = reference.probabilities(self.w0, g, self.cfg)
            got = (probs[:self.n_real[k]] if rounding is None else
                   reference.probabilities(self.w0, g, self.cfg, rounding))
            out.append((got, want))
        return out

    def check(self, limits: dict, rounding=None) -> tuple:
        """``(numbers, failed)``: :func:`port_bench.judge.prob_numbers`
        over the sample, and the sampled events whose own numbers are past
        a limit."""
        pairs = self.pairs(rounding)
        failed = sum(not judge.verdict(judge.prob_numbers([p]), limits)[0]
                     for p in pairs)
        return judge.prob_numbers(pairs), failed
