"""The port's spans (``utils/profiling.py::span``) on its hot paths, on
the CPU.

A span is a ``record_function`` range while a profiler runs and one
shared no-op context otherwise.  ``Trainer.run_steps`` is the spans
``gnn.run_steps.prepare``, ``gnn.captured.load`` and
``gnn.run_steps.readback`` a call, one after another (``gnn.captured.
replay`` between the last two once a graph is captured, which on the CPU
is stood in for); the prefetching iterator's consumer is
``gnn.prefetch.wait`` and ``gnn.prefetch.handoff`` a batch, and its
worker's spans show in ``profiling.trace``, which records every thread.
Tracing changes no result.
"""

import json
import threading

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import fake_card

from gnn_fpga_tpu_torch.core import capture
from gnn_fpga_tpu_torch.core import graph as tg
from gnn_fpga_tpu_torch.core.prefetch import prefetch_to_device
from gnn_fpga_tpu_torch.data import toy2d
from gnn_fpga_tpu_torch.models import mpnn as tm
from gnn_fpga_tpu_torch.ops.cuda import spmm as tsp
from gnn_fpga_tpu_torch.train import trainer as ttrainer
from gnn_fpga_tpu_torch.utils import profiling

N_STEPS, N_EVENTS = 3, 4


def _spans(prof) -> list:
    """``(start_ns, end_ns, name)`` of the host events named ``gnn.*`` in
    a finished profile, by start."""
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("gnn.")
                  and e.device_type() == torch.autograd.DeviceType.CPU)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _stack(seed=0):
    """``N_STEPS`` batches of ``N_EVENTS`` Toy2D segment graphs, stacked."""
    batches = [toy2d.make_segment_graphs(
        toy2d.Toy2DConfig(n_layers=5, n_tracks=3, seed=seed + k), N_EVENTS)
        for k in range(N_STEPS)]
    return ttrainer.stack_batches(batches)


def _trainer():
    model = tm.init_segment_classifier(
        tm.SegmentClassifierConfig(input_dim=2, hidden_dim=8, n_iters=2,
                                   aggregation="sparse"),
        torch.Generator().manual_seed(0), "cpu")
    return ttrainer.Trainer(model, ttrainer.TrainConfig(learning_rate=5e-3))


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    return tg.from_coo(rng.normal(size=(6, 2)), [0, 1, 2, 3], [1, 2, 3, 4],
                       [1.0, 0.0, 1.0, 0.0])


class _StandInGraph:
    """A captured graph's stand-in on the CPU: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_span_is_one_shared_no_op_without_a_profiler():
    a, b = profiling.span("gnn.a"), profiling.span("gnn.b")
    assert a is b
    with a:
        pass
    with _cpu_profile() as prof:
        s = profiling.span("gnn.test")
        assert isinstance(s, torch.profiler.record_function)
        with s:
            torch.ones(2).sum()
    assert [n for _, _, n in _spans(prof)] == ["gnn.test"]
    assert profiling.span("gnn.after") is a


def test_span_in_a_worker_thread_sees_the_profiler():
    seen = []
    worker = threading.Thread(
        target=lambda: seen.append(profiling.span("gnn.worker")))
    with _cpu_profile():
        worker.start()
        worker.join(timeout=10)
    assert not worker.is_alive()
    assert isinstance(seen[0], torch.profiler.record_function)


def test_run_steps_is_prepare_load_readback_once_a_call():
    trainer, stack = _trainer(), _stack()
    trainer.run_steps(stack)
    with _cpu_profile() as prof:
        trainer.run_steps(stack)
        trainer.run_steps(stack)
    spans = _spans(prof)
    assert [n for _, _, n in spans] == [
        "gnn.run_steps.prepare", "gnn.captured.load",
        "gnn.run_steps.readback"] * 2
    for (_, end, _), (start, _, _) in zip(spans, spans[1:]):
        assert end <= start


def test_fit_stacked_is_prepare_load_readback_an_epoch():
    trainer = _trainer()
    with _cpu_profile() as prof:
        trainer.fit_stacked(_stack(), n_epochs=2)
    assert [n for _, _, n in _spans(prof)] == [
        "gnn.run_steps.prepare", "gnn.captured.load",
        "gnn.run_steps.readback"] * 2


def test_a_replay_is_a_span_and_counts_its_launches_once():
    call = capture.CapturedCall(lambda g: g.x.sum(), "cpu")
    g = _graph()
    call(g)                       # the buffers, eagerly (no graph on a CPU)
    call.graph = _StandInGraph()
    call.output = torch.zeros(())
    call.launches = {"iteration_pair": 3}
    tsp.reset_launch_counts()
    call(g)
    untraced = tsp.launch_counts()["iteration_pair"]
    with _cpu_profile() as prof:
        call(g)
    assert [n for _, _, n in _spans(prof)] == [
        "gnn.captured.load", "gnn.captured.replay"]
    assert untraced == 3
    assert tsp.launch_counts()["iteration_pair"] == 6
    assert call.graph.replays == 2
    tsp.reset_launch_counts()


def test_prefetch_consumer_waits_and_hands_off_once_a_batch(monkeypatch):
    """The same spans whether the batches are only queued (the CPU) or
    staged in the ring's slots (a card, stood in for by ``fake_card``)."""
    n = 5
    for staged in (False, True):
        if staged:
            fake_card.install(monkeypatch)
        it = prefetch_to_device((_graph(i) for i in range(50)), size=2,
                                device=None if staged else "cpu")
        with _cpu_profile() as prof:
            got = [next(it) for _ in range(n)]
        it.close()
        assert not it._thread.is_alive()
        names = [s for _, _, s in _spans(prof)]
        assert names.count("gnn.prefetch.wait") == n
        assert names.count("gnn.prefetch.handoff") == n
        consumer = [s for s in names if s in ("gnn.prefetch.wait",
                                              "gnn.prefetch.handoff")]
        assert consumer == ["gnn.prefetch.wait", "gnn.prefetch.handoff"] * n
        torch.testing.assert_close(got[3].x, _graph(3).x)
        assert (it.stats["staged"] >= n) == staged
        assert (it.stats["unstaged"] >= n) != staged


def test_trace_records_the_prefetch_workers_spans(tmp_path):
    assert profiling._all_threads_config() is not None
    n = 4
    with profiling.trace(str(tmp_path / "trace")):
        it = prefetch_to_device((_graph(i) for i in range(n)), size=2,
                                device="cpu")
        assert len(list(it)) == n
        it._thread.join(timeout=10)
        assert not it._thread.is_alive()
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = [e.get("name") for e in events["traceEvents"]]
    for span in ("gnn.prefetch.source", "gnn.prefetch.copy",
                 "gnn.prefetch.put_wait"):
        assert names.count(span) >= n, span
    assert names.count("gnn.prefetch.handoff") == n


def test_traced_run_steps_equals_untraced():
    stack = _stack(seed=3)
    plain, traced = _trainer(), _trainer()
    tsp.reset_launch_counts()
    want = [plain.run_steps(stack) for _ in range(2)]
    counts = tsp.launch_counts()
    tsp.reset_launch_counts()
    with _cpu_profile():
        got = [traced.run_steps(stack) for _ in range(2)]
    assert tsp.launch_counts() == counts
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for (k, p), q in zip(traced.model.named_parameters(),
                         plain.model.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=k)


def test_interaction_gnn_forward_is_encode_messages_head():
    """The Interaction Network's forward is the spans ``gnn.ign.encode``,
    one ``gnn.ign.message`` an iteration and ``gnn.ign.head``, in order;
    its sum onto both ends is counted in ``launch_counts`` (on the CPU
    it launches nothing); tracing changes no logit."""
    from gnn_fpga_tpu_torch.models import interaction_gnn as ign

    g = tg.attach_plans(tg.pack_graphs(tg.unbatch_graphs(
        toy2d.make_knn_segment_graphs(
            toy2d.Toy2DConfig(n_layers=5, n_tracks=3), 2, k=3))))
    model = ign.init_interaction_gnn(
        ign.InteractionGNNConfig(hidden_dim=8, n_iters=3, mlp_layers=2),
        torch.Generator().manual_seed(0), "cpu")
    tsp.reset_launch_counts()
    with torch.no_grad():
        want = model(g)
        with _cpu_profile() as prof:
            got = model(g)
    spans = _spans(prof)
    assert [n for _, _, n in spans] == (["gnn.ign.encode"]
                                        + ["gnn.ign.message"] * 3
                                        + ["gnn.ign.head"])
    for (_, end, _), (start, _, _) in zip(spans, spans[1:]):
        assert end <= start
    assert tsp.launch_counts()["edge_sum"] == 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)
