"""Plans composed per batch and padded to static capacities
(``ops/cuda/spmm.py``: ``compose_agg_plans``, ``pad_plans``,
``PlanCapacity``, ``batch_capacity``; ``core/graph.py::attach_plans``;
the train CLI's ``PlanSetup``), on the CPU.

The composed plans are held field for field against ``build_agg_plans``
on the packed graph; the padded ones keep every real entry and add only
no-op entries; and the composed, padded plans through the port's pallas
route give the JAX package's logits."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from gnn_fpga_tpu.core import graph as jg
from gnn_fpga_tpu.models import mpnn as jm
from gnn_fpga_tpu_torch.cli import train as tcli
from gnn_fpga_tpu_torch.core import batching as tb
from gnn_fpga_tpu_torch.core import graph as tg
from gnn_fpga_tpu_torch.data import toy2d
from gnn_fpga_tpu_torch.models import mpnn as tm
from gnn_fpga_tpu_torch.ops.cuda import spmm as tsp
from gnn_fpga_tpu_torch.utils import serialization as tser

F32_TOL = dict(rtol=1e-4, atol=1e-5)
KINDS = ["padded", "degree_zero", "hub64", "hub1120", "all_pad"]


def _graph(rng, kind):
    """One graph of a kind: random edges, 12 of them masked on its last
    node (``padded``); edges on the lower half of the nodes only
    (``degree_zero``); random edges and 64 or 1,120 more that node 0
    receives from node 1 (``hub64``, ``hub1120``: 2 or 35 work items); no
    edges at all (``all_pad``)."""
    v = int(rng.integers(6, 30))
    e = 0 if kind == "all_pad" else int(rng.integers(1, 120))
    hi = v // 2 if kind == "degree_zero" else v
    s, r = rng.integers(0, hi, e), rng.integers(0, hi, e)
    em = np.ones(e, np.float32)
    if kind == "padded":
        s[-12:] = r[-12:] = v - 1
        em[-12:] = 0
    hub = {"hub64": 64, "hub1120": 1120}.get(kind, 0)
    s = np.concatenate([s, np.ones(hub, np.int64)])
    r = np.concatenate([r, np.zeros(hub, np.int64)])
    em = np.concatenate([em, np.ones(hub, np.float32)])
    x = rng.normal(size=(v, 3)).astype(np.float32)
    return tg.from_coo(x, s, r, (rng.random(len(s)) < 0.3).astype(
        np.float32)).replace(edge_mask=torch.from_numpy(em))


def _plans(g):
    return tsp.build_agg_plans(g.senders.numpy(), g.receivers.numpy(),
                               g.n_node)


def _assert_same_plans(got, want, path="plans"):
    """Field for field: every tensor equal in dtype and value, every host
    field equal."""
    assert type(got) is type(want), path
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        where = f"{path}.{f.name}"
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape, where
            assert torch.equal(a, b), where
        elif dataclasses.is_dataclass(b):
            _assert_same_plans(a, b, where)
        else:
            assert a == b, where


def _compose(graphs, n_node=None, n_edge=None):
    """(the packed graph, its built plans, its composed plans)."""
    packed = tg.pack_graphs(graphs, n_node, n_edge)
    per = [_plans(g) for g in graphs]
    nodes = np.array([g.n_node for g in graphs])
    edges = np.array([g.n_edge for g in graphs])
    got = tsp.compose_agg_plans(per, np.cumsum(nodes) - nodes,
                                np.cumsum(edges) - edges, packed.n_node,
                                packed.n_edge)
    return packed, _plans(packed), got


@pytest.mark.parametrize("pad", [(None, None), (8, 64), (1, 0), (40, 2048)])
@pytest.mark.parametrize("kind", KINDS)
def test_composed_plans_equal_built_plans(kind, pad):
    """A batch of 5 graphs of a kind (3 of them of the kind, 2 mixed in),
    packed with extra pad nodes and pad edges on the one pad node
    (``pad``): (nodes, edges) beyond the real ones, or none."""
    rng = np.random.default_rng(KINDS.index(kind))
    graphs = [_graph(rng, k) for k in (kind, "padded", kind, "degree_zero",
                                       kind)]
    real_n = sum(g.n_node for g in graphs)
    real_e = sum(g.n_edge for g in graphs)
    n_node = None if pad[0] is None else real_n + pad[0]
    n_edge = None if pad[1] is None else real_e + pad[1]
    _, want, got = _compose(graphs, n_node, n_edge)
    _assert_same_plans(got, want)
    assert got.items.n_split == want.items.n_split
    if kind == "hub1120":
        assert got.items.n_split >= 3 and len(got.recv.long_seg) >= 3


def test_composed_plans_of_all_pad_batches():
    """Graphs without edges, and a batch of nothing but pad edges (1,120
    of them: the pad node a split node and a long segment)."""
    rng = np.random.default_rng(3)
    graphs = [_graph(rng, "all_pad") for _ in range(4)]
    n = sum(g.n_node for g in graphs)
    for n_edge in (0, 1120):
        packed, want, got = _compose(graphs, n + 3, n_edge)
        _assert_same_plans(got, want)
    assert got.items.n_split == 1
    assert got.recv.long_seg.tolist() == [n]


def test_composition_refuses_graphs_out_of_place():
    rng = np.random.default_rng(4)
    graphs = [_graph(rng, "padded") for _ in range(2)]
    per = [_plans(g) for g in graphs]
    n0, e0 = graphs[0].n_node, graphs[0].n_edge
    n = n0 + graphs[1].n_node
    e = e0 + graphs[1].n_edge
    with pytest.raises(ValueError, match="one after the other"):
        tsp.compose_agg_plans(per, [0, n0 + 1], [0, e0], n + 2, e)
    with pytest.raises(ValueError, match="one after the other"):
        tsp.compose_agg_plans(per, [0, n0], [0, e0 - 1], n + 2, e)
    with pytest.raises(ValueError, match="do not fit"):
        tsp.compose_agg_plans(per, [0, n0], [0, e0], n + 2, e - 1)
    # built plans would send pad edges to node 0; composition refuses
    with pytest.raises(ValueError, match="pad node"):
        tsp.compose_agg_plans(per, [0, n0], [0, e0], n, e + 5)


def _cli_sectors(n_sectors, seed=0):
    """Toy2D kNN sectors at the fullevent configuration (440 hits, ~5,000
    edges each), as the train CLI loads them."""
    cfg = toy2d.Toy2DConfig(n_layers=20, n_tracks=22, seed=seed)
    return tg.unbatch_graphs(toy2d.make_knn_segment_graphs(cfg, n_sectors,
                                                           k=12))


def test_composed_plans_on_the_cli_bucket():
    """The CLI's bucket (448 nodes and 5,120 edges a sector, the pad edges
    of a batch on its one pad node): each batch's composed plans equal the
    built ones, and padded to the dataset's capacity they keep every real
    entry."""
    graphs = _cli_sectors(10)
    bucket = tb.choose_bucket(graphs, edge_multiple=256)
    assert (bucket.n_node, bucket.n_edge) == (448, 5120)
    bs = 4
    setup = tcli.PlanSetup(graphs, bucket, bs)
    gen = tb.batch_generator(graphs, bs, bucket, seed=1, packed=True,
                             transform=lambda b, idx: (b, idx))
    for _ in range(4):
        batch, idx = next(gen)
        want = tg.attach_plans(batch).plans
        composed = tg.attach_plans(batch, [setup.plans[i] for i in idx])
        _assert_same_plans(composed.plans, want)
        padded = tg.attach_plans(batch, [setup.plans[i] for i in idx],
                                 setup.capacity).plans
        assert tsp.plan_counts(padded) == tsp.plan_counts(want)
        assert padded.items.n_recv == setup.capacity.recv_items
        assert len(padded.items.items) == (setup.capacity.recv_items
                                           + setup.capacity.send_items)


def test_batch_capacity_holds_every_batch():
    """Over every batch of many shuffled epochs of hub-heavy graphs, the
    dataset's capacity holds the composed plans, and the closed-form
    worst case holds the capacity."""
    rng = np.random.default_rng(5)
    graphs = [_graph(rng, k) for k in KINDS * 3]
    bucket = tb.choose_bucket(graphs)
    bs = 4
    setup = tcli.PlanSetup(graphs, bucket, bs)
    cap = setup.capacity
    worst = tsp.worst_case_capacity(bucket.n_node * bs, bucket.n_edge * bs)
    assert worst.covers(cap)
    gen = tb.batch_generator(graphs, bs, bucket, seed=2, packed=True,
                             transform=setup.transform_for(
                                 range(len(graphs))))
    for _ in range(60):
        plans = next(gen).plans
        assert cap.covers(tsp.plan_counts(plans))
        assert plans.items.n_recv == cap.recv_items


def test_worst_case_capacity_holds_extreme_graphs():
    """Stars, chains and a graph of one hub every way."""
    for v, s, r in (
            (50, np.zeros(3000), np.arange(3000) % 50),       # out-star
            (50, np.arange(3000) % 50, np.zeros(3000)),       # in-star
            (4000, np.arange(3999), np.arange(1, 4000)),      # chain
            (40, np.repeat(np.arange(40), 70),
             np.tile(np.arange(40), 70))):                    # all long
        plans = tsp.build_agg_plans(s.astype(np.int32), r.astype(np.int32),
                                    v)
        assert tsp.worst_case_capacity(v, len(s)).covers(
            tsp.plan_counts(plans))


@pytest.mark.parametrize("kind", KINDS)
def test_pad_plans_appends_only_no_op_entries(kind):
    rng = np.random.default_rng(10 + KINDS.index(kind))
    g = tg.pack_graphs([_graph(rng, kind), _graph(rng, "padded")], None,
                       None)
    plans = _plans(g)
    it = plans.items
    n_send = it.n_item - it.n_recv
    real = tsp.plan_counts(plans)
    cap = tsp.PlanCapacity(
        recv_items=real.recv_items + 7, send_items=real.send_items + 3,
        splits=real.splits + 2, slots=real.slots + 5,
        recv_long=real.recv_long + 1, send_long=real.send_long + 4)
    padded = tsp.pad_plans(plans, cap)
    pit = padded.items
    assert (pit.n_recv, pit.n_item, pit.n_split, pit.n_slot) == (
        cap.recv_items, cap.recv_items + cap.send_items, cap.splits,
        cap.slots)
    items = pit.items
    # the real entries, in order, then no-op entries: node -1, no edges
    assert torch.equal(items[:it.n_recv], it.items[:it.n_recv])
    assert torch.equal(items[cap.recv_items:cap.recv_items + n_send],
                       it.items[it.n_recv:])
    pads = torch.cat([items[it.n_recv:cap.recv_items],
                      items[cap.recv_items + n_send:]])
    assert len(pads) == 10
    assert (pads == torch.tensor([0, 0, -1, -1], dtype=torch.int32)).all()
    assert torch.equal(pit.splits[:it.n_split], it.splits)
    assert (pit.splits[it.n_split:] == torch.tensor(
        [-1, 0, 0, 0], dtype=torch.int32)).all()
    for side, extra in (("recv", 1), ("send", 4)):
        a, b = getattr(padded, side), getattr(plans, side)
        n = len(b.long_seg)
        assert torch.equal(a.long_seg[:n], b.long_seg)
        assert a.long_seg[n:].tolist() == [-1] * extra
        for f in ("order", "inv_order", "sorted_seg", "sorted_oth",
                  "seg_ptr"):
            assert torch.equal(getattr(a, f), getattr(b, f))
    assert torch.equal(padded.send_in_recv, plans.send_in_recv)
    assert tsp.plan_counts(padded) == real
    # padding padded plans again to the same capacity changes nothing
    _assert_same_plans(tsp.pad_plans(padded, cap), padded)


@pytest.mark.parametrize("field", [f.name for f in dataclasses.fields(
    tsp.PlanCapacity)])
def test_pad_plans_raises_on_overflow(field):
    rng = np.random.default_rng(20)
    g = tg.pack_graphs([_graph(rng, "hub1120"), _graph(rng, "hub64")])
    plans = _plans(g)
    real = tsp.plan_counts(plans)
    assert min(dataclasses.astuple(real)) > 0
    short = dataclasses.replace(real, **{field: getattr(real, field) - 1})
    with pytest.raises(ValueError, match="exceed their capacity"):
        tsp.pad_plans(plans, short)
    with pytest.raises(ValueError, match="exceed their capacity"):
        tg.attach_plans(g, capacity=short)


def test_composed_padded_plans_through_the_pallas_route_match_jax():
    """Four graphs packed with pad edges on the pad node: the port's
    pallas route on the composed plans padded to a larger capacity gives
    the JAX package's pallas logits (interpreted)."""
    rng = np.random.default_rng(30)
    graphs = [_graph(rng, k) for k in ("padded", "hub64", "degree_zero",
                                       "padded")]
    n = sum(g.n_node for g in graphs) + 4
    e = -(-sum(g.n_edge for g in graphs) // 32) * 32 + 64
    packed = tg.pack_graphs(graphs, n, e)
    per = [_plans(g) for g in graphs]
    cap = tsp.worst_case_capacity(n, e)
    t = tg.attach_plans(packed, per, cap)
    j = jg.attach_plans(jg.from_coo(
        packed.x.numpy(), packed.senders.numpy(), packed.receivers.numpy(),
        packed.y.numpy()).replace(edge_mask=packed.edge_mask.numpy(),
                                  node_mask=packed.node_mask.numpy()),
        tile_e=32)
    cfg_j = jm.SegmentClassifierConfig(input_dim=3, hidden_dim=8, n_iters=2,
                                       aggregation="pallas")
    params = jm.init_segment_classifier(jax.random.PRNGKey(3), cfg_j)
    for fused in (True, False):
        cfg_t = tm.SegmentClassifierConfig(input_dim=3, hidden_dim=8,
                                           n_iters=2, aggregation="pallas",
                                           fused_iteration=fused)
        model = tm.init_segment_classifier(cfg_t, torch.Generator(),
                                           device="cpu")
        tser.load_jax_params(model, jax.tree.map(np.asarray, params))
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jm.segment_classifier_logits(
                params, j, dataclasses.replace(cfg_j,
                                               fused_iteration=fused)))
        with torch.no_grad():
            got = tm.segment_classifier_logits(model, t)
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
