"""The port's batching, NPZ extras, prefetching and profiling helpers:
buckets and batches against the JAX package's bit for bit per seed, and
the prefetch iterator's order, back-pressure, ``close()`` and error
propagation (as ``tests/test_utils.py`` holds the JAX package's)."""

import itertools
import time
import warnings

import numpy as np
import pytest
import torch

from gnn_fpga_tpu.core import batching as jb
from gnn_fpga_tpu.core import graph as jg
from gnn_fpga_tpu.data import toy2d as jtoy
from gnn_fpga_tpu_torch.core import batching as tb
from gnn_fpga_tpu_torch.core import graph as tg
from gnn_fpga_tpu_torch.core.prefetch import PrefetchIterator, \
    prefetch_to_device
from gnn_fpga_tpu_torch.data import toy2d as ttoy
from gnn_fpga_tpu_torch.utils import profiling

FIELDS = ("x", "senders", "receivers", "y", "node_mask", "edge_mask")


def _graph_pairs(sizes, seed=0):
    """JAX and port graphs from the same random COO arrays, one per
    ``(n_node, n_edge)`` of ``sizes``."""
    rng = np.random.default_rng(seed)
    jgs, tgs = [], []
    for n, e in sizes:
        x = rng.normal(size=(n, 3)).astype(np.float32)
        s, r = rng.integers(0, n, e), rng.integers(0, n, e)
        y = (rng.random(e) < 0.3).astype(np.float32)
        jgs.append(jg.from_coo(x, s, r, y))
        tgs.append(tg.from_coo(x, s, r, y))
    return jgs, tgs


SIZES = [(5, 9), (7, 20), (4, 3), (9, 40), (6, 12), (8, 150), (3, 5),
         (10, 33), (7, 19), (5, 140)]


def _assert_same_graph(t, j):
    for name in FIELDS:
        got, want = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("kw", [{}, dict(node_multiple=4, edge_multiple=16)])
def test_buckets_match_jax(kw):
    jgs, tgs = _graph_pairs(SIZES)
    assert tb.choose_bucket(tgs, **kw).__dict__ == \
        jb.choose_bucket(jgs, **kw).__dict__
    for n in (1, 2, 3):
        got = tb.choose_buckets(tgs, n, **kw)
        want = jb.choose_buckets(jgs, n, **kw)
        assert [s.__dict__ for s in got] == [s.__dict__ for s in want]
        for t, j in zip(tgs, jgs):
            assert tb.assign_bucket(t, got).__dict__ == \
                jb.assign_bucket(j, want).__dict__
        for bs in (1, 2, 3):
            assert tb.padding_efficiency(tgs, got, bs) == \
                jb.padding_efficiency(jgs, want, bs)
    assert tb.n_batches_per_epoch(10, 3) == jb.n_batches_per_epoch(10, 3)


def test_assign_bucket_rejects_a_graph_too_large():
    _, tgs = _graph_pairs([(5, 9), (50, 500)])
    with pytest.raises(ValueError, match="no bucket fits"):
        tb.assign_bucket(tgs[1], [tb.choose_bucket(tgs[:1])])


@pytest.mark.parametrize("n_buckets,bs", [(3, 2), (4, 3), (5, 4)])
def test_bucket_pools_merge_upward_as_jax(n_buckets, bs):
    """Undersized pools merge into the next larger bucket (its spec grown
    on both axes); a last undersized pool is dropped with a warning."""
    jgs, tgs = _graph_pairs(SIZES)
    specs_t = tb.choose_buckets(tgs, n_buckets, edge_multiple=8)
    specs_j = jb.choose_buckets(jgs, n_buckets, edge_multiple=8)
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        got = tb._bucket_pools(tgs, specs_t, bs)
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        want = jb._bucket_pools(jgs, specs_j, bs)
    assert [(s.__dict__, p.tolist()) for s, p in got] == \
        [(s.__dict__, p.tolist()) for s, p in want]
    assert [str(w.message) for w in wt] == [str(w.message) for w in wj]


def _record(indices):
    def transform(batch, idx):
        indices.append(list(idx))
        return batch.replace(y=batch.y + 1)
    return transform


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("n_buckets", [1, 3])
def test_batch_generator_matches_jax_bit_for_bit(packed, shuffle, n_buckets):
    """The same graphs in the same order for equal seeds, over three
    epochs, with a transform given each batch's source indices."""
    jgs, tgs = _graph_pairs(SIZES)
    bucket_t = (tb.choose_bucket(tgs) if n_buckets == 1
                else tb.choose_buckets(tgs, n_buckets))
    bucket_j = (jb.choose_bucket(jgs) if n_buckets == 1
                else jb.choose_buckets(jgs, n_buckets))
    idx_t, idx_j = [], []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gen_t = tb.batch_generator(tgs, 2, bucket_t, shuffle=shuffle,
                                   seed=5, packed=packed,
                                   transform=_record(idx_t))
        gen_j = jb.batch_generator(jgs, 2, bucket_j, shuffle=shuffle,
                                   seed=5, packed=packed,
                                   transform=_record(idx_j))
        n = 3 * sum(len(p) // 2 for _, p in
                    jb._bucket_pools(jgs, bucket_j if n_buckets > 1
                                     else [bucket_j], 2))
        for _ in range(n):
            _assert_same_graph(next(gen_t), next(gen_j))
    assert idx_t == idx_j


def test_batch_generator_takes_a_batched_graph():
    cfg = dict(n_layers=4, n_tracks=3, seed=2)
    gen_t = tb.batch_generator(
        ttoy.make_knn_segment_graphs(ttoy.Toy2DConfig(**cfg), 6, k=2), 2,
        seed=1)
    gen_j = jb.batch_generator(
        jtoy.make_knn_segment_graphs(jtoy.Toy2DConfig(**cfg), 6, k=2), 2,
        seed=1)
    for _ in range(5):
        _assert_same_graph(next(gen_t), next(gen_j))


def test_batch_generator_needs_a_full_batch():
    _, tgs = _graph_pairs(SIZES[:3])
    with pytest.raises(ValueError, match="fewer graphs"):
        next(tb.batch_generator(tgs, 4))


def test_load_npz_with_extras_reads_a_jax_written_file(tmp_path):
    jgs, _ = _graph_pairs([(6, 11)])
    layer = np.array([0, 0, 1, 1, 2, 2])
    path = tmp_path / "g.npz"
    jg.save_npz(jgs[0], path, layer=layer, pt=np.float32(2.5))
    got, extras = tg.load_npz_with_extras(path)
    want, want_extras = jg.load_npz_with_extras(path)
    _assert_same_graph(got, want)
    assert sorted(extras) == sorted(want_extras) == ["layer", "pt"]
    np.testing.assert_array_equal(extras["layer"], layer)
    assert extras["pt"] == np.float32(2.5)


def _planned_graph():
    cfg = ttoy.Toy2DConfig(n_layers=4, n_tracks=3, seed=0)
    g = tg.pack_graphs(tg.unbatch_graphs(
        ttoy.make_knn_segment_graphs(cfg, 2, k=2)), n_node=32, n_edge=64)
    return tg.attach_plans(g)


def _leaves(obj):
    """Every field of a graph and its plans, tensors and host values, by
    dotted name."""
    import dataclasses
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, tg.TensorFields):
            out.update({f"{f.name}.{k}": w for k, w in _leaves(v).items()})
        else:
            out[f.name] = v
    return out


def _assert_same_leaves(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k, v in la.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == lb[k].dtype and torch.equal(v, lb[k]), k
        else:
            assert v == lb[k], k


def test_non_blocking_copy_on_the_cpu_is_a_plain_copy():
    g = _planned_graph()
    moved = g.to("cpu", non_blocking=True)
    _assert_same_leaves(moved, g)
    assert isinstance(moved.plans.recv.seg_ptr, torch.Tensor)
    assert moved.plans.items.n_recv == g.plans.items.n_recv
    assert len(list(g.tensors())) == sum(
        isinstance(v, torch.Tensor) for v in _leaves(g).values())


def test_pin_memory_pins_every_tensor_and_keeps_host_fields(monkeypatch):
    """``pin_memory`` walks the graph and its plans: every tensor goes
    through ``Tensor.pin_memory`` (stubbed here, where no card can pin),
    host ints such as ``SortedSegments.n_kept`` stay as they are."""
    from gnn_fpga_tpu_torch.ops.cuda import segment_sum as tss

    seen = []

    def fake_pin(t):
        seen.append(t)
        return t.clone()

    monkeypatch.setattr(torch.Tensor, "pin_memory", fake_pin)
    g = _planned_graph()
    _assert_same_leaves(g.pin_memory(), g)
    assert len(seen) == len(list(g.tensors()))
    segs = tss.build_sorted_segments(np.array([2, 0, 2, 3, 1]), 3)
    pinned = segs.pin_memory()
    assert pinned.n_kept == segs.n_kept == 4
    assert torch.equal(pinned.ptr, segs.ptr)


def _numbered(n):
    for i in range(n):
        yield tg.from_coo(np.full((2, 1), i, np.float32), [0], [1], [1.0])


def test_prefetch_iterator_order_and_n_batches():
    out = list(prefetch_to_device(_numbered(10), size=2, device="cpu",
                                  n_batches=5))
    assert len(out) == 5
    for i, b in enumerate(out):
        assert b.x.device.type == "cpu"
        assert torch.equal(b.x, torch.full((2, 1), float(i)))
    assert len(list(prefetch_to_device(_numbered(3), device="cpu"))) == 3


def test_prefetch_iterator_applies_back_pressure():
    pulled = []

    def source():
        for i in itertools.count():
            pulled.append(i)
            yield tg.from_coo(np.zeros((2, 1), np.float32), [0], [1], [1.0])

    it = PrefetchIterator(source(), size=2, device="cpu")
    try:
        time.sleep(0.5)
        # two queued, one held by the blocked worker
        assert len(pulled) <= 3, pulled
        next(it)
        time.sleep(0.3)
        assert len(pulled) <= 4, pulled
    finally:
        it.close()


def test_prefetch_iterator_raises_the_source_error():
    def bad():
        yield tg.from_coo(np.zeros((2, 1), np.float32), [0], [1], [1.0])
        raise RuntimeError("boom")

    it = prefetch_to_device(bad(), size=1, device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        # the failure may land on either of the next pulls
        next(it)
        next(it)


def test_prefetch_close_stops_worker():
    it = prefetch_to_device(_numbered(10 ** 9), size=2, device="cpu")
    next(it)
    it.close()
    assert not it._thread.is_alive()
    with pytest.raises(ValueError, match="size"):
        PrefetchIterator(_numbered(1), size=0, device="cpu")


def test_prefetch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the GPU-less case")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PrefetchIterator(_numbered(1))


def test_step_timer_summary():
    timer = profiling.StepTimer(warmup=1, device="cpu")
    for _ in range(4):
        with timer.step(n_edges=1000):
            time.sleep(0.001)
    s = timer.summary()
    assert s["steps"] == 3
    assert set(s) == {"steps", "mean_s", "p50_s", "p95_s", "edges_per_s"}
    assert s["edges_per_s"] > 0 and s["mean_s"] >= 0.001


def test_nan_check():
    profiling.nan_check({"a": torch.ones(3), "b": {"c": torch.zeros(2)}})
    profiling.nan_check({"idx": torch.tensor([1, 2, 3])})
    with pytest.raises(FloatingPointError,
                       match=r"params\['a'\]: 1 non-finite values"):
        profiling.nan_check({"a": torch.tensor([1.0, float("nan")])},
                            "params")
    model = torch.nn.Linear(2, 2)
    profiling.nan_check(model)
    with torch.no_grad():
        model.bias[0] = float("inf")
    with pytest.raises(FloatingPointError, match=r"model\['bias'\]"):
        profiling.nan_check(model, "model")


def test_debug_nans_flags_a_nan_backward():
    x = torch.tensor([-1.0], requires_grad=True)
    with profiling.debug_nans(), warnings.catch_warnings():
        warnings.simplefilter("ignore")   # anomaly mode's forward trace
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    assert not torch.is_anomaly_enabled()


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
