"""The fused iteration kernels' work items and launch arguments
(``ops/cuda/spmm.py``: ``IterItems``, ``build_iter_items``,
``iteration_launch``), on the CPU.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
Here a numpy emulation of their summation order over the items (f32 sums,
each item's partial row summed in item order by the combine pass) is held
against the JAX package's ``iteration_pair`` and its VJP, interpreted as
``tests/test_torch_spmm_grad.py`` runs them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from gnn_fpga_tpu.ops.pallas import spmm as jsp
from gnn_fpga_tpu_torch.ops.cuda import spmm as tsp

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
BWD_TOL = dict(rtol=2e-3, atol=1e-5)

KINDS = ["padded", "degree_zero", "dense", "bare"]
# Edges from node 1 to node 0 on top of a kind's: none, two items' worth
# (node 0's recv and node 1's send segments split into 3 items, the last
# one partial) and 36 items' worth.  E stays a multiple of the JAX plans'
# tile of 32.
HUBS = [0, 64, 1120]


def _topology(seed, kind, hub=0, v=72, e=192):
    """Senders, receivers and the edge mask of a small graph: random edges
    with 20 masked pad edges on node v-1; ``degree_zero``: the upper half
    of the nodes has no edges; ``dense``: the random edges on 24 nodes
    (~8 a node and direction, under one item each); ``bare``: no random
    edges.  Then ``hub`` edges that node 0 receives from node 1 (a bare
    graph without them has no edges)."""
    rng = np.random.default_rng(seed)
    e = 0 if kind == "bare" else e
    hi = {"degree_zero": v // 2, "dense": 24}.get(kind, v - 1)
    s = rng.integers(0, hi, e)
    r = rng.integers(0, hi, e)
    em = np.ones(e, np.float32)
    if kind == "padded":
        s[-20:] = r[-20:] = v - 1
        em[-20:] = 0
    s = np.concatenate([s, np.full(hub, 1)])
    r = np.concatenate([r, np.zeros(hub, np.int64)])
    em = np.concatenate([em, np.ones(hub, np.float32)])
    return s.astype(np.int32), r.astype(np.int32), em, v


def _tables(seed, v, d, hdim):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return dict(pa=f(v, hdim), pb=f(v, hdim), h=f(v, d), w2=f(hdim) * 0.5,
                b1=f(hdim), b2=f(1), g_mi=f(v, d), g_mo=f(v, d))


def _np(t):
    return t.numpy().astype(np.int64)


# ---------------------------------------------------------------------------
# The work items
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hub", HUBS)
@pytest.mark.parametrize("kind", KINDS)
def test_items_cover_each_direction_once_in_order(kind, hub):
    """Each direction's items tile its sorted edges [0, E): every edge in
    exactly one item, at most ``ITEM_EDGES`` an item, a node's items
    contiguous and in order over its CSR segment, one empty item for a
    node without edges; the split nodes' items first, then the others',
    each part in node order."""
    s, r, _, v = _topology(1, kind, hub)
    plans = tsp.build_agg_plans(s, r, v)
    it = plans.items
    items = _np(it.items)
    split = set(_np(it.splits)[:, 0])
    assert split == ({0, 1} if hub else set())
    assert items.shape == (it.n_item, 4)
    for lo, hi, plan in ((0, it.n_recv, plans.recv),
                         (it.n_recv, it.n_item, plans.send)):
        beg, end, node = items[lo:hi, 0], items[lo:hi, 1], items[lo:hi, 2]
        ptr = _np(plan.seg_ptr)
        assert (end - beg <= tsp.ITEM_EDGES).all() and (end >= beg).all()
        is_split = np.isin(node, sorted(split))
        n_first = is_split.sum()
        assert is_split[:n_first].all() and not is_split[n_first:].any()
        for part in (slice(0, n_first), slice(n_first, None)):
            assert (np.diff(node[part]) >= 0).all()
        # in edge order, the items tile [0, E), each node once or more
        by_beg = np.lexsort((end, beg))
        assert beg[by_beg][0] == 0 and end[by_beg][-1] == len(s)
        np.testing.assert_array_equal(beg[by_beg][1:], end[by_beg][:-1])
        np.testing.assert_array_equal(np.unique(node), np.arange(v))
        for n in range(v):
            mine = node == n
            deg = ptr[n + 1] - ptr[n]
            assert mine.sum() == max(1, -(-deg // tsp.ITEM_EDGES))
            assert beg[mine][0] == ptr[n] and end[mine][-1] == ptr[n + 1]
        counts = np.zeros(len(s), int)
        for b, e in zip(beg, end):
            counts[b:e] += 1
        assert (counts == 1).all()


@pytest.mark.parametrize("hub", HUBS)
@pytest.mark.parametrize("kind", KINDS)
def test_slots_and_splits_are_consistent(kind, hub):
    """A node is split when it has more than one item in a direction; its
    items, and only theirs, write partial rows, to slots that its split
    entry lists in item order, its recv items' before its send items'."""
    s, r, _, v = _topology(2, kind, hub)
    it = tsp.build_agg_plans(s, r, v).items
    items, splits = _np(it.items), _np(it.splits)
    node, slot = items[:, 2], items[:, 3]
    side = np.arange(it.n_item) >= it.n_recv
    count = lambda n, send: ((node == n) & (side == send)).sum()
    split = {n for n in range(v) if count(n, False) > 1 or count(n, True) > 1}
    assert set(splits[:, 0]) == split and len(splits) == it.n_split
    assert ((slot >= 0) == np.isin(node, sorted(split))).all()
    np.testing.assert_array_equal(np.sort(slot[slot >= 0]),
                                  np.arange(it.n_slot))
    for n, beg, mid, end in splits:
        np.testing.assert_array_equal(slot[(node == n) & ~side],
                                      np.arange(beg, mid))
        np.testing.assert_array_equal(slot[(node == n) & side],
                                      np.arange(mid, end))


def test_items_of_a_graph_without_nodes_are_empty():
    plans = tsp.build_agg_plans(np.zeros(0, np.int32), np.zeros(0, np.int32),
                                0)
    it = plans.items
    assert (it.n_item, it.n_split, it.n_slot) == (0, 0, 0)
    assert it.items.shape == (0, 4) and it.splits.shape == (0, 4)


def test_items_follow_the_plans_to_a_device():
    s, r, _, v = _topology(3, "padded", 1120)
    plans = tsp.build_agg_plans(s, r, v).to("cpu")
    # node 0 receives and node 1 sends over 1,120 edges: 36+ items each
    deg = lambda ptr, n: int(ptr[n + 1] - ptr[n])
    n_items = lambda d: max(1, -(-d // tsp.ITEM_EDGES))
    it = plans.items
    assert it.n_split == 2 and set(it.splits[:, 0].tolist()) == {0, 1}
    assert it.n_slot == sum(n_items(deg(p.seg_ptr, n)) for n in (0, 1)
                            for p in (plans.recv, plans.send))
    assert n_items(deg(plans.recv.seg_ptr, 0)) >= 36
    for t in (plans.items.items, plans.items.splits):
        assert t.dtype == torch.int32 and t.is_contiguous()


# ---------------------------------------------------------------------------
# Launch arguments
# ---------------------------------------------------------------------------

def test_launch_arguments_at_the_fullevent_widths():
    """bf16: 8 lanes an edge, one 16-byte item each (the 128-byte pa / pb
    row) and, in the backward, 5 of the D row's 33 pairs; f32: 16 lanes;
    4 edges a lane in the score pass, 256 threads a block."""
    e = 180_736
    # a bf16 row of 128 or 132 bytes in a 144-byte slot: 14 edges of 432
    # bytes fit 6 KB in the recv pass, 21 of 288 in the send pass, cut to
    # multiples of the 4 groups
    assert tsp.iteration_launch(e, 66, 64, torch.bfloat16) == tsp.IterLaunch(
        vec_h=True, vec_d=True, log_lanes=3, edge_blocks=1412,
        bwd_h_bytes=16, bwd_log_lanes=3, recv_chunk=12, send_chunk=20,
        slot_h=144, slot_d=144)
    assert tsp.iteration_launch(e, 66, 64, torch.float32) == tsp.IterLaunch(
        vec_h=True, vec_d=True, log_lanes=4, edge_blocks=2824,
        bwd_h_bytes=16, bwd_log_lanes=4, recv_chunk=6, send_chunk=10,
        slot_h=272, slot_d=272)
    # the hit classifier's D = 67 is odd: its D rows go one element an
    # item, 9+ lanes' worth at 8 a lane, so the backward takes 16 lanes
    # and 8-byte H items to fill them
    hit = tsp.iteration_launch(331_264, 67, 64, torch.bfloat16)
    assert (hit.vec_h, hit.vec_d, hit.log_lanes, hit.bwd_log_lanes,
            hit.bwd_h_bytes) == (True, False, 3, 4, 8)
    assert not tsp.iteration_launch(e, 66, 64, torch.bfloat16,
                                    aligned_h=False).vec_h
    assert not tsp.iteration_launch(e, 66, 64, torch.bfloat16,
                                    aligned_d=False).vec_d
    empty = tsp.iteration_launch(0, 66, 64, torch.float32)
    assert empty.edge_blocks == 0
    # f32 H = 256 is 64 items of 16 bytes: more than one a lane, so the
    # scalar path, 8 elements a lane
    wide = tsp.iteration_launch(e, 66, 256, torch.float32)
    assert (wide.vec_h, wide.log_lanes) == (False, 5)


def test_send_pass_grid():
    """Two blocks of eight warps an SM at most, one warp an item below
    that, none without items."""
    assert tsp.walk_blocks(15_848, 132) == 264
    assert tsp.walk_blocks(100, 132) == 13
    assert tsp.walk_blocks(0, 132) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
def test_launch_arguments_fit_every_width(dtype, aligned):
    """For D and H in 1-256: at most 32 lanes an edge, at most 8 H items a
    lane, and in the backward at most 8 D items a lane too
    (csrc/iteration.cuh checks these), the vector paths only where the
    widths divide, and blocks that cover every edge."""
    per = 16 // torch.empty((), dtype=dtype).element_size()
    for d in (1, 2, 8, 33, 66, 67, 256):
        for hdim in (1, 8, 12, 33, 64, 66, 256):
            for e in (0, 1, 1000, 180_736):
                la = tsp.iteration_launch(e, d, hdim, dtype, aligned,
                                          aligned)
                assert la.vec_h == (aligned and hdim % per == 0
                                    and hdim // per <= 32)
                assert la.vec_d == (aligned and d % 2 == 0)
                item = 16 // per
                nb = la.bwd_h_bytes
                assert nb in (0, 8, 16)
                if nb:
                    assert aligned and hdim * item % nb == 0
                row_h = hdim // per if la.vec_h else hdim
                row_hb = hdim * item // nb if nb else hdim
                row_d = d // 2 if la.vec_d else d
                assert 0 <= la.log_lanes <= 5 and 0 <= la.bwd_log_lanes <= 5
                assert -(-row_h // (1 << la.log_lanes)) <= 8
                lanes = 1 << la.bwd_log_lanes
                assert -(-row_hb // lanes) <= (1 if nb else 8)
                assert -(-row_d // lanes) <= 8
                # as few lanes as hold the rows
                if la.bwd_log_lanes > 0:
                    assert row_hb > lanes // 2 or -(-row_d // (lanes // 2)) > 8
                # staged rows fit their slots; chunks of 1-32 edges in at
                # most 48 KB a block of eight warps
                item = torch.empty((), dtype=dtype).element_size()
                for slot, width in ((la.slot_h, hdim), (la.slot_d, d)):
                    assert slot % 16 == 0 and width * item + 4 <= slot
                groups = 32 >> la.bwd_log_lanes
                for chunk, edge in ((la.recv_chunk,
                                     la.slot_h + 2 * la.slot_d),
                                    (la.send_chunk, la.slot_h + la.slot_d)):
                    assert 1 <= chunk <= 32
                    assert chunk % groups == 0 or chunk < groups
                    assert 8 * chunk * edge <= 49152
                per_block = (256 >> la.log_lanes) * 4
                assert la.edge_blocks * per_block >= e
                assert (la.edge_blocks - 1) * per_block < max(e, 1)


# ---------------------------------------------------------------------------
# The kernels' summation order, emulated, against the JAX package
# ---------------------------------------------------------------------------

def _edge_values(t, s, r, em):
    """Per recv-sorted edge, in f32 as the edge passes compute it: z, sig
    and e = sig * em."""
    pre = (t["pa"][s] + t["pb"][r]) * em[:, None]
    z = np.tanh(pre + t["b1"]).astype(np.float32)
    sig = (1 / (1 + np.exp(-(z @ t["w2"] + t["b2"][0])))).astype(np.float32)
    return z, sig, (sig * em).astype(np.float32)


def emulate_forward(t, plans, em_sorted):
    """The forward kernels' sums: each item's edges in sorted order into
    an f32 row, written to its node or its slot; split nodes' slots summed
    in slot order."""
    it = plans.items
    recv, send = plans.recv, plans.send
    s, r = _np(recv.sorted_oth), _np(recv.sorted_seg)
    _, _, e = _edge_values(t, s, r, em_sorted)
    sir = _np(plans.send_in_recv)
    v, d = t["h"].shape
    out = np.zeros((2, v, d), np.float32)
    part = np.zeros((it.n_slot, d), np.float32)
    for i, (beg, end, node, slot) in enumerate(_np(it.items)):
        by_send = i >= it.n_recv
        oth = _np(send.sorted_oth) if by_send else s
        acc = np.zeros(d, np.float32)
        for j in range(beg, end):
            acc += e[sir[j] if by_send else j] * t["h"][oth[j]]
        if slot < 0:
            out[int(by_send), node] = acc
        else:
            part[slot] = acc
    for node, beg, mid, end in _np(it.splits):
        for k, (lo, hi) in enumerate(((beg, mid), (mid, end))):
            acc = np.zeros(d, np.float32)
            for slot in range(lo, hi):
                acc += part[slot]
            out[k, node] = acc
    return out[0], out[1]


def emulate_backward(t, plans, em_sorted, la, sm_count=132):
    """The backward kernels' sums, for the launch arguments ``la``.  Recv
    pass, one warp a recv item: each edge's z, sig, e, de and dlogit once;
    dpb and the recv part of dh over the item's edges in chunks of
    ``la.recv_chunk``, edge j - beg on group ((j - beg) % chunk) % groups,
    each group's rows in edge order, then the groups' rows added pairwise
    (the xor shuffles' order).  Send pass, one warp a send item: dpa and
    dh's send part as dpb (chunks of ``la.send_chunk``), z recomputed; dh
    = recv part + send part; the parameter sums per warp of the send pass
    (warp w of W takes items w, w + W, ...), then over warps.  A split
    node's items write partial rows, summed in slot order by the finish
    pass."""
    it = plans.items
    recv, send = plans.recv, plans.send
    s, r = _np(recv.sorted_oth), _np(recv.sorted_seg)
    sir = _np(plans.send_in_recv)
    z, sig, e = _edge_values(t, s, r, em_sorted)
    de = ((t["g_mi"][r] * t["h"][s]).sum(1)
          + (t["g_mo"][s] * t["h"][r]).sum(1))
    dlogit = (de * em_sorted * sig * (1 - sig)).astype(np.float32)
    v, d = t["h"].shape
    hdim = t["pa"].shape[1]
    groups = 32 >> la.bwd_log_lanes
    items = _np(it.items)
    terms = np.concatenate([z * dlogit[:, None],
                            dlogit[:, None] * t["w2"] * (1 - z * z),
                            dlogit[:, None]], 1)
    params = np.zeros(2 * hdim + 1, np.float32)
    n_warps = 8 * tsp.walk_blocks(it.n_item - it.n_recv, sm_count)
    for w in range(n_warps):
        mine = items[it.n_recv + w::n_warps]
        if len(mine):
            params += terms[np.concatenate(
                [sir[b:e] for b, e, _, _ in mine])].sum(0)
    dh_recv = np.zeros((v, d), np.float32)
    dh = np.zeros((v, d), np.float32)
    dp = np.zeros((2, v, hdim), np.float32)           # dpb, dpa
    hpart = np.zeros((it.n_slot, hdim), np.float32)
    dpart = np.zeros((it.n_slot, d), np.float32)
    for i, (beg, end, node, slot) in enumerate(items):
        by_send = i >= it.n_recv
        own = (t["pa"] if by_send else t["pb"])[node]
        tab = t["pb"] if by_send else t["pa"]
        gtab = t["g_mi"] if by_send else t["g_mo"]
        oth = _np(send.sorted_oth) if by_send else s
        chunk = la.send_chunk if by_send else la.recv_chunk
        parts = np.zeros((groups, hdim + d), np.float32)
        for j in range(beg, end):
            jr = sir[j] if by_send else j
            zz = np.tanh((tab[oth[j]] + own) * em_sorted[jr] + t["b1"])
            parts[((j - beg) % chunk) % groups] += np.concatenate([
                dlogit[jr] * t["w2"] * (1 - zz * zz) * em_sorted[jr],
                e[jr] * gtab[oth[j]]])
        while len(parts) > 1:
            parts = parts[0::2] + parts[1::2]
        parts, dh_acc = parts[:, :hdim], parts[0, hdim:]
        if slot >= 0:
            hpart[slot], dpart[slot] = parts[0], dh_acc
            continue
        dp[int(by_send), node] = parts[0]
        if by_send:
            dh[node] = dh_recv[node] + dh_acc
        else:
            dh_recv[node] = dh_acc
    for node, beg, mid, end in _np(it.splits):
        dp[0, node] = hpart[beg:mid].sum(0) if mid > beg else 0
        dp[1, node] = hpart[mid:end].sum(0) if end > mid else 0
        acc = np.zeros(d, np.float32)
        for slot in range(beg, end):
            acc += dpart[slot]
        dh[node] = acc
    return (dh, dp[1], dp[0], params[:hdim], params[hdim:2 * hdim],
            params[2 * hdim:])


def _jax_iteration(t, s, r, em, v):
    plans_j = jsp.build_agg_plans(s, r, v, tile_e=32)
    ems_j = jsp.sort_edge_weights(jnp.asarray(em), plans_j.recv)
    names = ("pa", "pb", "h", "w2", "b1", "b2")
    f = lambda pa, pb, h, w2, b1, b2: jsp.iteration_pair(
        pa, pb, h, ems_j, w2, b1, b2, plans_j)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(f, *(jnp.asarray(t[k]) for k in names))
        grads = vjp((jnp.asarray(t["g_mi"]), jnp.asarray(t["g_mo"])))
    return out, dict(zip(names, grads))


@pytest.mark.parametrize("hub", HUBS[:2])
@pytest.mark.parametrize("kind", ["padded", "degree_zero", "dense"])
def test_emulated_kernels_match_jax_iteration_pair(kind, hub):
    s, r, em, v = _topology(4, kind, hub)
    t = _tables(5, v, 10, 12)
    plans = tsp.build_agg_plans(s, r, v)
    assert (plans.items.n_split > 0) == (hub > 0)
    em_sorted = em[_np(plans.recv.order)]
    (mi_j, mo_j), g_j = _jax_iteration(t, s, r, em, v)
    mi, mo = emulate_forward(t, plans, em_sorted)
    np.testing.assert_allclose(mi, np.asarray(mi_j), **FWD_TOL)
    np.testing.assert_allclose(mo, np.asarray(mo_j), **FWD_TOL)
    la = tsp.iteration_launch(len(s), 10, 12, torch.float32)
    got = emulate_backward(t, plans, em_sorted, la)
    for name, a in zip(("h", "pa", "pb", "w2", "b1", "b2"), got):
        np.testing.assert_allclose(a.reshape(np.shape(g_j[name])),
                                   np.asarray(g_j[name]), **BWD_TOL,
                                   err_msg=name)


def test_emulated_kernels_on_a_graph_without_edges():
    """No edges: zero rows and zero parameter sums, as the plain version."""
    s, r, em, v = _topology(6, "bare")
    t = _tables(7, v, 10, 12)
    plans = tsp.build_agg_plans(s, r, v)
    for a in (emulate_forward(t, plans, em)
              + emulate_backward(t, plans, em, tsp.iteration_launch(
                  0, 10, 12, torch.float32))):
        assert not np.any(a)
    ref = tsp.iteration_pair_reference(
        *(torch.from_numpy(t[k]) for k in ("pa", "pb", "h")),
        torch.from_numpy(em),
        *(torch.from_numpy(t[k]) for k in ("w2", "b1", "b2")),
        torch.from_numpy(s), torch.from_numpy(r), v)
    assert not any(x.any() for x in ref)
