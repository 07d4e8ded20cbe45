"""One buffer a batch (``core/staging.py``) and the prefetching iterator's
ring of staging slots (``core/prefetch.py``), on the CPU.

The layout's offsets, the view trees (every tensor bit for bit, empty
ones and the plans' host fields included), the signature read from a
staged tree, what :meth:`Staged.held` sees, a captured call's one-copy
load; and the ring run on the CPU through ``fake_card``'s stand-ins for
streams, events and pinned memory: slots recycled or grown, the copy
stream waiting on the consumer's stream before a slot is filled again,
the pinned and pageable copies, and the rings freed.  The ring on the
card is tested in ``tests/test_torch_cuda.py``."""

import dataclasses

import numpy as np
import pytest
import torch

import fake_card
from gnn_fpga_tpu_torch.core import batching as tb
from gnn_fpga_tpu_torch.core import capture, prefetch, staging
from gnn_fpga_tpu_torch.core import graph as tg
from gnn_fpga_tpu_torch.data import toy2d
from gnn_fpga_tpu_torch.ops.cuda import segment_sum as tss


def _planned(n=1, seed=1):
    """``n`` packed 4-sector Toy2D batches with plans (some plan tensors
    empty: no long segments)."""
    cfg = toy2d.Toy2DConfig(n_layers=8, n_tracks=6, seed=seed)
    graphs = tg.unbatch_graphs(toy2d.make_knn_segment_graphs(cfg, 24, k=3))
    gen = tb.batch_generator(graphs, 4, seed=seed, packed=True,
                             transform=lambda b, idx: tg.attach_plans(b))
    return [next(gen) for _ in range(n)]


def _graph(i, n_node=6, n_edge=9, node_y=False):
    """A small graph whose values say ``i``; its signature is its sizes."""
    rng = np.random.default_rng(i)
    return tg.from_coo(
        np.full((n_node, 2), float(i), np.float32),
        rng.integers(0, n_node, n_edge), rng.integers(0, n_node, n_edge),
        rng.random(n_edge), node_y=rng.random(n_node) if node_y else None)


def _batches():
    return {"planned": _planned()[0],
            "node_y": _graph(3, node_y=True),
            "segments": tss.build_sorted_segments(
                np.array([2, 0, 2, 3, 1]), 3)}


def _host_fields(tree) -> dict:
    """Every non-tensor field of ``tree``, by path."""
    out = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if isinstance(v, tg.TensorFields):
            out.update({f"{f.name}.{k}": w
                        for k, w in _host_fields(v).items()})
        elif not isinstance(v, torch.Tensor):
            out[f.name] = v
    return out


def _staged(batch) -> staging.Staged:
    st = staging.Staged(staging.layout(batch), "cpu")
    torch._foreach_copy_(st.tensors, list(batch.tensors()))
    return st


@pytest.mark.parametrize("kind", ["planned", "node_y", "segments"])
def test_layout_offsets_are_aligned_and_hold_every_tensor(kind):
    batch = _batches()[kind]
    lay = staging.layout(batch)
    tensors = list(batch.tensors())
    assert len(lay.offsets) == len(tensors)
    ends = [o + t.numel() * t.element_size()
            for o, t in zip(lay.offsets, tensors)]
    assert all(o % staging.ALIGN == 0 for o in lay.offsets)
    assert all(e <= o for e, o in zip(ends, lay.offsets[1:]))
    assert ends[-1] <= lay.nbytes and lay.nbytes % staging.ALIGN == 0
    # a function of the signature: cached, and built anew the same
    sig = capture.signature(batch)
    assert staging.layout(batch) is lay and lay.signature == sig
    again = staging.Layout(sig, batch)
    assert (again.offsets, again.nbytes) == (lay.offsets, lay.nbytes)


@pytest.mark.parametrize("kind", ["planned", "node_y", "segments"])
def test_views_round_trip_every_tensor_bit_for_bit(kind):
    batch = _batches()[kind]
    st = _staged(batch)
    got, want = list(st.tree.tensors()), list(batch.tensors())
    assert len(got) == len(want)
    if kind == "planned":
        assert any(t.numel() == 0 for t in want)
    base = st.buffer.data_ptr()
    for a, b, o in zip(got, want, st.layout.offsets):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
        if a.numel():
            assert a.data_ptr() - base == o
    assert _host_fields(st.tree) == _host_fields(batch)
    assert type(st.tree) is type(batch)


def test_signature_of_a_view_tree_equals_the_batchs():
    batch = _planned()[0]
    lay = staging.layout(batch)
    tree, _, _ = lay.views(lay.buffer("cpu"))    # unmarked: walked
    assert staging.staged_in(tree) is None
    assert capture.signature(tree) == capture.signature(batch)
    st = _staged(batch)                          # marked: from the layout
    assert staging.staged_in(st.tree) == (lay, st.buffer)
    assert capture.signature(st.tree) is lay.signature
    assert staging.flatten(batch)[0] == capture.signature(batch)
    # a tree derived from a staged one is not staged
    assert staging.staged_in(st.tree.replace(y=st.tree.y.clone())) is None


@pytest.mark.parametrize("keep", ["tree", "subtree", "tensor", "view",
                                  "saved", "buffer"])
def test_held_sees_what_the_consumer_keeps(keep):
    st = _staged(_planned()[0])
    assert not st.held()
    if keep == "tree":
        kept = st.tree
    elif keep == "subtree":
        kept = st.tree.plans.items
    elif keep == "tensor":
        kept = st.tree.plans.recv.seg_ptr
    elif keep == "view":
        kept = st.tree.x[1:, :1]
    elif keep == "saved":
        w = torch.ones(st.tree.x.shape[-1], requires_grad=True)
        kept = (st.tree.x * w).sum()          # autograd keeps x
    else:
        kept = staging.staged_in(st.tree)[1]
    assert st.held()
    del kept
    assert not st.held()


def test_captured_call_loads_a_staged_batch_with_one_copy():
    batch = _planned()[0]
    call = capture.CapturedCall(lambda g: (g.x * 2).sum(-1), "cpu")
    want = call(batch).clone()
    got = call(_staged(batch).tree)
    assert torch.equal(got, want)
    assert call.load_counts == dict(one_copy=1, batched=1)
    for a, b in zip(call.inputs.tensors(), batch.tensors()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="another static signature"):
        call(_staged(_graph(0)).tree)
    assert call.load_counts == dict(one_copy=1, batched=1)


# ---------------------------------------------------------------------------
# The ring, on the CPU through fake_card
# ---------------------------------------------------------------------------

def _slots(it) -> int:
    return sum(len(r) for r in it._rings.values())


@pytest.mark.parametrize("size", [1, 2])
def test_ring_recycles_the_slots_a_consumer_lets_go(monkeypatch, size):
    card = fake_card.install(monkeypatch)
    n = 40
    it = prefetch.PrefetchIterator((_graph(i) for i in range(n)), size=size)
    most = 0
    for i, g in enumerate(it):
        assert staging.staged_in(g) is not None
        assert torch.equal(g.x, _graph(i).x) and torch.equal(g.y, _graph(i).y)
        most = max(most, _slots(it))
    assert i == n - 1
    del g
    s = it.stats
    assert s["staged"] == n and s["unstaged"] == 0
    assert s["recycled"] + s["grown"] + 1 == n
    assert s["grown"] <= size + 2 and most <= size + 3
    # exhausted: the rings are freed, each slot released on the consumer's
    # stream
    assert it._rings == {}
    released = [e for e in card.log if e[0] == "record_stream"]
    assert len(released) == s["grown"] + 1
    assert all(e[1] is card.consumer for e in released)


def test_a_slot_is_filled_again_after_the_consumers_stream(monkeypatch):
    """Before a recycled slot is filled, an event is recorded on the
    consumer's stream (where its work on the slot is queued) and the copy
    stream waits on it; the fill's own event is recorded after, on the
    copy stream."""
    card = fake_card.install(monkeypatch)
    it = prefetch.PrefetchIterator((_graph(i) for i in range(12)), size=1)
    assert sum(1 for _ in it) == 12
    assert it.stats["recycled"] > 0
    log = card.log
    waits = [k for k, e in enumerate(log)
             if e[0] == "wait" and e[1].name == "copy"]
    assert len(waits) == it.stats["recycled"]
    for k in waits:
        event = log[k][2]
        rec = [e for e in log[:k] if e[0] == "record" and e[1] is event]
        assert rec and rec[-1][2] is card.consumer
        after = next(e for e in log[k + 1:] if e[0] == "record")
        assert after[1] is not event and after[2].name == "copy"


def test_a_consumer_that_keeps_every_batch_keeps_correct_ones(monkeypatch):
    fake_card.install(monkeypatch)
    n = 12
    kept = list(prefetch.PrefetchIterator((_graph(i) for i in range(n)),
                                          size=2))
    for i, g in enumerate(kept):
        assert torch.equal(g.x, _graph(i).x), i
    assert len({id(g) for g in kept}) == n


def test_a_consumer_that_keeps_batches_makes_the_ring_grow(monkeypatch):
    fake_card.install(monkeypatch)
    n = 12
    it = prefetch.PrefetchIterator((_graph(i) for i in range(n)), size=2)
    kept = []
    for g in it:
        kept.append(g)
        # a derived view alone holds the slot too
        kept.append(g.y[:2])
    del g
    assert it.stats["grown"] == n - 1 and it.stats["recycled"] == 0
    for i in range(n):
        assert torch.equal(kept[2 * i].x, _graph(i).x)
        assert torch.equal(kept[2 * i + 1], _graph(i).y[:2])


@pytest.mark.parametrize("pinned", [True, False])
def test_pinned_batches_copy_straight_and_pageable_through_a_twin(
        monkeypatch, pinned):
    card = fake_card.install(monkeypatch)
    card.pinned = pinned
    it = prefetch.PrefetchIterator((_graph(i) for i in range(6)), size=1)
    for i, g in enumerate(it):
        assert torch.equal(g.x, _graph(i).x)
        slots = [s for r in it._rings.values() for s in r]
        assert all((s.twin is None) == pinned for s in slots)


def test_two_signatures_alternate_in_two_rings(monkeypatch):
    fake_card.install(monkeypatch)
    n = 20
    sizes = [(6, 9), (5, 7)]
    src = [_graph(i, *sizes[i % 2]) for i in range(n)]
    it = prefetch.PrefetchIterator(iter(src), size=2)
    for i, g in enumerate(it):
        assert capture.signature(g) == capture.signature(src[i])
        for a, b in zip(g.tensors(), src[i].tensors()):
            assert torch.equal(a, b)
        assert len(it._rings) <= 2
    assert it.stats["staged"] == n


def test_rings_past_the_limit_give_back_their_free_slots(monkeypatch):
    card = fake_card.install(monkeypatch)
    n = prefetch.MAX_RINGS + 6
    it = prefetch.PrefetchIterator(
        (_graph(i, n_node=4 + i) for i in range(n)), size=1)
    for i, g in enumerate(it):
        assert torch.equal(g.x, _graph(i, n_node=4 + i).x)
        assert len(it._rings) <= prefetch.MAX_RINGS
    assert sum(e[0] == "record_stream" for e in card.log) == n


def test_close_frees_the_rings(monkeypatch):
    fake_card.install(monkeypatch)
    it = prefetch.PrefetchIterator((_graph(i) for i in range(10 ** 9)),
                                   size=2)
    g = next(it)
    it.close()
    assert not it._thread.is_alive()
    assert it._rings == {}
    assert torch.equal(g.x, _graph(0).x)       # what the consumer kept


def test_a_batch_that_is_not_tensor_fields_raises_on_a_card(monkeypatch):
    """A card's prefetcher stages TensorFields only: anything else raises
    ``TypeError`` naming its type, at the consumer's next take."""
    fake_card.install(monkeypatch)
    it = prefetch.PrefetchIterator(iter([_graph(0), {"x": torch.ones(3)}]),
                                   size=2)
    assert torch.equal(next(it).x, _graph(0).x)
    with pytest.raises(TypeError, match="dict"):
        next(it)
    it.close()


def test_ring_under_frequent_thread_switches(monkeypatch):
    """The worker and the consumer switched every microsecond: a consumer
    that keeps every third batch for a while and drops the rest reads
    each batch's own values, kept ones too."""
    import sys

    fake_card.install(monkeypatch)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        n = 150
        it = prefetch.PrefetchIterator((_graph(i) for i in range(n)), size=2)
        kept = {}
        for i, g in enumerate(it):
            assert torch.equal(g.x, _graph(i).x), i
            if i % 3 == 0:
                kept[i] = g
            kept.pop(i - 9, None)
            for k, h in kept.items():
                assert torch.equal(h.x, _graph(k).x), (i, k)
        assert i == n - 1
    finally:
        sys.setswitchinterval(interval)
    assert it.stats["recycled"] > 0 and it.stats["staged"] == n
