"""The scoring driver: a closed loop of batches of whole events, each
batch (``events_per_batch`` events packed into one graph, default 1)
scored by the infer CLI's captured forward
(``cli/infer.py::captured_forward``) and its probabilities read back to
the host.

Events come from a pool made from the seed, in the route's layout, held
in pinned host memory; ``core/prefetch.py::prefetch_to_device`` copies
each batch to the card on its own stream, ``prefetch_depth`` ahead, so
one batch copies while the one before it is scored.  A batch's events
enter the pipeline when the prefetching thread takes it from the source;
their latency runs from then to the batch's probabilities on the host.
The source stops once the window's time has passed, and every batch that
entered is scored.  A sample of the answers, ``sample`` whole batches
drawn from the seed (a reservoir over every batch of the window), is kept
for the check, which holds each of their events against the reference.
"""

from __future__ import annotations

import gc
import random
import statistics
import threading
import time

import torch

from port_bench import judge, manifest, program, readers, reference
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
        self.per_batch = mix.get("events_per_batch", 1)
        # each batch's events and their real edges' span in its output:
        # every event's real edges in order, then the padding
        self.spans = []
        for k, b in enumerate(batches):
            evs = range(k * self.per_batch, (k + 1) * self.per_batch)
            ends = [0]
            for i in evs:
                ends.append(ends[-1] + self.events[i].n_edge)
            if ends[-1] != program.real_edges(b):
                raise ValueError(f"batch {k} holds {program.real_edges(b)} "
                                 f"real edges, its events {ends[-1]}")
            self.spans.append([(i, a, z) for i, a, z in
                               zip(evs, ends, ends[1:])])
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

    def loop(self, n_batches=None, seconds=None) -> dict:
        """The closed loop, until ``n_batches`` have entered or
        ``seconds`` have passed: every batch's latency, the answers
        sampled (by the batch's place in the window), the window."""
        rng = random.Random(self.seed)
        keep = self.mix["sample"]
        sample = {}
        stop = threading.Event()
        enter = []
        t0 = time.perf_counter()

        def source():
            i = 0
            while not stop.is_set() and (n_batches is None or i < n_batches):
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
                # a reservoir: each batch of the window sampled alike
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
        # a batch's events share its latency: the quantile over batches is
        # the quantile over every event of the window
        lat = run["latencies"]
        p95 = statistics.quantiles(lat, n=100, method="inclusive")[94]
        events = len(lat) * self.per_batch
        return dict(infer_events_per_s=events / run["window_s"],
                    infer_p95_ms=1e3 * p95, attempted=events,
                    window_s=run["window_s"])

    def flops_per_event(self) -> float:
        ev = self.events[0]
        return manifest.family(self.cfg["model"]).forward_flops(
            self.cfg, ev.n_node, ev.n_edge)

    def free_program(self) -> None:
        self.model = self.forward = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def pairs(self, rounding=None) -> list:
        """``(the program's probabilities, the reference's)`` of each event
        of the sampled batches, its real edges only; with ``rounding`` the
        reference in that precision stands in for the program (the
        control)."""
        reference.strict_float32()
        out = []
        for i, probs in sorted(self.sample.items()):
            for ev, a, z in self.spans[i % len(self.pool)]:
                g = reference.graph_tensors(self.events[ev].packed(),
                                            self.device)
                want = reference.probabilities(self.w0, g, self.cfg)
                got = (probs[a:z] if rounding is None else
                       reference.probabilities(self.w0, g, self.cfg,
                                               rounding))
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
