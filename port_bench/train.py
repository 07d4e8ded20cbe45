"""The training driver: ``Trainer.run_steps`` on a stack of ``K``
distinct events, the path users of ``fit_stacked`` take.

Set-up makes the events and the weights from the seed, builds one trainer
and drives it through two calls of the window's own ``run_steps(stack)``:
the first runs eagerly and captures the ``K``-step graph, the second is
its first replay.  Those two calls are what the reference checks
(:mod:`port_bench.judge`).  The window then replays the same call until
``seconds`` have passed; each call reads its losses back.  The traced run
profiles ``trace_calls`` more calls in place of the window.
"""

from __future__ import annotations

import gc
import math
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from port_bench import (gen, judge, manifest, program, readers,
                        reference, yardstick)


# threads that build the pool: numpy and the plans' construction release
# the interpreter lock for most of their time, and a thread pays no import
BUILD_THREADS = 4


def build_pool(cfg: dict, mix: dict, seed: int) -> tuple:
    """``(events, host batches, weight seed)``: ``mix["pool"]`` events
    from the seed and, in the route's layout, batches of
    ``mix["events_per_batch"]`` (default 1) consecutive events, made by a
    few threads."""
    rngs, wseed = gen.streams(seed, mix["pool"])
    ev_cfg = cfg["events"]
    per = mix.get("events_per_batch", 1)
    if mix["pool"] % per:
        raise ValueError(f"a pool of {mix['pool']} events does not split "
                         f"into batches of {per}")

    with ThreadPoolExecutor(BUILD_THREADS) as ex:
        events = list(ex.map(lambda rng: gen.make_event(ev_cfg, rng), rngs))
        batches = list(ex.map(
            lambda i: program.layout(events[i:i + per], ev_cfg, mix),
            range(0, len(events), per)))
    return events, program.one_signature(batches), wseed


def useful_flops_per_step(cfg: dict, events: list) -> float:
    """A step's useful FLOPs, averaged over the pool (every event has the
    same sizes)."""
    count = manifest.family(cfg["model"]).forward_flops
    f = [count(cfg, ev.n_node, ev.n_edge) for ev in events]
    return yardstick.train_step_flops(sum(f) / len(f))


class Session:
    """One cell's training run on ``device``: set-up on construction."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.device = cfg, mix, torch.device(device)
        k = mix["steps_per_call"]
        if mix.get("events_per_batch", 1) != 1:
            raise ValueError("a training mix takes one event a batch")
        t = time.perf_counter()
        self.events, batches, wseed = build_pool(cfg, mix, seed)
        t = readers.lap("events built", t)
        order = [i % len(batches) for i in range(k)]
        self.order = order
        self.w0 = reference.make_weights(cfg, wseed, self.device)
        self.model = program.make_model(cfg, mix, self.w0, self.device)
        self.trainer = program.make_trainer(self.model, cfg)
        self.stack = program.stack([batches[i] for i in order], self.device)
        self.edges_per_call = sum(program.real_edges(batches[i])
                                  for i in order)
        self.shapes = program.kernel_shapes(batches[0], cfg)
        del batches
        t = readers.lap("model, trainer and stack", t)
        self.first = self.call(state=True)
        t = readers.lap("first call (eager, captured)", t)
        self.second = self.call(state=True)
        readers.lap("second call (the first replay)", t)
        self.capture_s = program.capture_seconds(self.trainer)

    def call(self, state: bool = False) -> dict:
        """One call of ``run_steps`` on the stack; its losses (read back),
        and with ``state`` copies of the trainer's state after it."""
        out = {"losses": self.trainer.run_steps(self.stack)}
        if state:
            out.update(program.train_state(self.trainer))
        return out

    def window(self, seconds: float) -> dict:
        """Calls until ``seconds`` have passed: the real edges trained over
        the window's time, the steps attempted, the steps whose loss was
        not finite."""
        calls = bad = 0
        ends = [time.perf_counter()]
        while True:
            losses = self.call()["losses"]
            ends.append(time.perf_counter())
            calls += 1
            bad += sum(not math.isfinite(x) for x in losses.tolist())
            t = ends[-1] - ends[0]
            if t >= seconds:
                break
        ms = sorted(1e3 * (b - a) for a, b in zip(ends, ends[1:]))
        readers.say(f"window: {calls} calls, ms a call: min {ms[0]:.3f}, "
                    f"median {ms[len(ms) // 2]:.3f}, max {ms[-1]:.3f}")
        k = self.mix["steps_per_call"]
        return dict(train_edges_per_s=calls * self.edges_per_call / t,
                    attempted=calls * k, failed=bad, window_s=t)

    def flops_per_step(self) -> float:
        return useful_flops_per_step(self.cfg, self.events)

    def free_program(self) -> None:
        """Drop the program's state (after the peak memory was read)."""
        self.trainer = self.model = self.stack = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def _graphs(self) -> list:
        reference.strict_float32()
        return [reference.graph_tensors(self.events[i].packed(), self.device)
                for i in self.order]

    def check(self, program_run=None) -> dict:
        """The numbers of :func:`port_bench.judge.train_numbers`: the
        reference takes the first call's first step from the benchmark's
        weights and follows the second call from the state the first
        left.  ``program_run`` (the control) replaces the program's two
        calls.  The details they come from stay in ``self.details``."""
        first, second = program_run or (self.first, self.second)
        graphs = self._graphs()
        ref1 = reference.follow(self.w0, graphs[:1], self.cfg)
        ref2 = reference.follow(first["params"], graphs, self.cfg,
                                adam=first["adam"])
        self.details = judge.train_details(first, second, ref1, ref2)
        return judge.train_numbers(self.details)

    def control(self, rounding: str) -> tuple:
        """The reference in a lower precision in the program's place:
        its two calls as :meth:`call` would give them."""
        graphs = self._graphs()
        runs = []
        state = dict(params=self.w0, adam=None)
        for _ in range(2):
            r = reference.follow(state["params"], graphs, self.cfg,
                                 adam=state["adam"], rounding=rounding)
            state = dict(params=r["params"],
                         adam=dict(step=r["step"], exp_avg=r["exp_avg"],
                                   exp_avg_sq=r["exp_avg_sq"]))
            runs.append(dict(losses=r["losses"], **state))
        return tuple(runs)
