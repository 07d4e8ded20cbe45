"""The four metrics that read the program's spans (``port_bench/spans.py``),
on traces built by hand: the values worked out by hand, None where the
spans are absent (a program without them), the replay's idle share held
under the device's, and the manifest's rules kept with their entries."""

import random

import pytest

from port_bench import manifest, readers
from port_bench.tracing import SPAN, Op, Trace

MS = 1_000_000       # ns
TRAIN_CELLS = ["seg_h64i6-event_train", "hit_h64i7-event_train",
               "seg_h64i6-sector_train_blocked"]
INFER_CELLS = ["seg_h64i6-event_infer_b16"]
NEW = {"prologue_ms_per_call.train": TRAIN_CELLS,
       "replay_idle_share.train": TRAIN_CELLS,
       "input_wait_ms_per_event.infer": INFER_CELLS,
       "replay_host_ms_per_event.infer": INFER_CELLS}


def _op(name, a, b):
    return Op(name, int(a * MS), int(b * MS))


def _slice(kind, host, device, units):
    window = (0, 10 * MS)
    host = [Op(SPAN, *window), _op("aten::copy_", 0.5, 0.6)] + host
    return readers.Slice(trace=Trace(window, device, host), kind=kind,
                         units=units, useful_flops=0.0, launches={},
                         shapes={}, peaks=None, capture_s=None, kernels={})


def _train_slice(with_spans=True):
    """Two calls in a 10 ms window: prologues 0.4 and 0.4 ms (0.4 a call);
    the device idle 0.2 + 0.1 ms inside call 1's readback, 0.05 ms inside
    call 2's replay, 0.05 and 0.1 ms inside its readback (0.5 ms, 5%)."""
    host = [_op("gnn.run_steps.prepare", 0.1, 0.3),
            _op("gnn.captured.load", 0.3, 0.5),
            _op("gnn.captured.replay", 0.5, 0.7),
            _op("gnn.run_steps.readback", 0.7, 4.7),
            _op("gnn.run_steps.prepare", 5.0, 5.1),
            _op("gnn.captured.load", 5.1, 5.4),
            _op("gnn.captured.replay", 5.4, 5.5),
            _op("gnn.run_steps.readback", 5.5, 9.5)]
    device = [_op("load copy", 0.4, 1.0), _op("k", 1.2, 3.0),
              _op("k", 2.0, 4.6), _op("k", 5.45, 7.0), _op("k", 7.05, 9.4)]
    if not with_spans:
        host = [o for o in host if not o.name.startswith("gnn.")]
    return _slice("train", host, device, 64)


def _infer_slice(with_spans=True):
    """Two events: waits 1.0, 0.5 and 0.2 ms (the end of the queue) are
    0.85 ms an event; hand-offs 0.1 + 0.1, loads 0.3 + 0.2, replays
    0.1 + 0.1 ms are 0.45 ms an event."""
    host = [_op("gnn.prefetch.wait", 0.0, 1.0),
            _op("gnn.prefetch.handoff", 1.0, 1.1),
            _op("gnn.captured.load", 1.1, 1.4),
            _op("gnn.captured.replay", 1.4, 1.5),
            _op("gnn.prefetch.wait", 3.0, 3.5),
            _op("gnn.prefetch.handoff", 3.5, 3.6),
            _op("gnn.captured.load", 3.6, 3.8),
            _op("gnn.captured.replay", 3.8, 3.9),
            _op("gnn.prefetch.wait", 6.0, 6.2)]
    device = [_op("k", 1.5, 2.5), _op("k", 3.9, 4.9)]
    if not with_spans:
        host = [o for o in host if not o.name.startswith("gnn.")]
    return _slice("infer", host, device, 2)


HAND = {"prologue_ms_per_call.train": (_train_slice, 0.4),
        "replay_idle_share.train": (_train_slice, 5.0),
        "input_wait_ms_per_event.infer": (_infer_slice, 0.85),
        "replay_host_ms_per_event.infer": (_infer_slice, 0.45)}


@pytest.mark.parametrize("metric", sorted(HAND))
def test_each_reader_gives_the_value_worked_by_hand(metric):
    make, want = HAND[metric]
    assert manifest.metric_reader(metric)(make()) == pytest.approx(want)
    # the other kind of slice is not this metric's
    other = _infer_slice if make is _train_slice else _train_slice
    assert manifest.metric_reader(metric)(other()) is None


@pytest.mark.parametrize("metric", sorted(HAND))
def test_each_reader_without_its_spans_is_none(metric, capsys):
    make, _ = HAND[metric]
    assert manifest.metric_reader(metric)(make(with_spans=False)) is None
    assert "not reported" in capsys.readouterr().err


def _random_train_slice(rng):
    """Calls of random spans one after another, random device operations
    (some crossing the window's ends)."""
    host, t = [], 0.0
    while t < 9.0:
        for name in ("gnn.run_steps.prepare", "gnn.captured.load",
                     "gnn.captured.replay", "gnn.run_steps.readback"):
            d = rng.uniform(0.01, 0.8)
            host.append(_op(name, t, t + d))
            t += d
        t += rng.uniform(0.0, 0.3)
    device = []
    for _ in range(rng.randrange(1, 40)):
        a = rng.uniform(-1.0, 10.5)
        device.append(_op("k", a, a + rng.uniform(0.001, 1.0)))
    return _slice("train", host, device, 32)


def test_replay_idle_share_is_at_most_the_device_idle_share():
    s = _train_slice()
    assert readers.idle_share(s, "train") == pytest.approx(21.0)
    rng = random.Random(7)
    for _ in range(200):
        s = _random_train_slice(rng)
        share = manifest.metric_reader("replay_idle_share.train")(s)
        assert 0.0 <= share <= readers.idle_share(s, "train") + 1e-9


def test_the_manifest_keeps_its_rules_with_the_span_metrics():
    man = manifest.read_manifest()
    assert manifest.problems(man) == []
    entries = {m["name"]: m for m in man["per_layer"]}
    for name, cells in NEW.items():
        assert entries[name]["source"] == "program_span"
        assert entries[name]["workloads"] == cells
        for cell in cells:
            assert name in [m["name"]
                            for m in manifest.load_cell(cell).per_layer]
