"""The lane-group row kernels' launch arguments (``ops/cuda/spmm.py``:
``RowLaunch``, ``row_launch``) and their summation order, on the CPU.

``sddmm``, ``sddmm_dual``, ``gather_pair_bwd``, ``aggregate_pair``,
``aggregate_pair_bwd`` and ``spmm`` (``csrc/spmm_ops.cu``,
``csrc/spmm_bwd.cu``, ``csrc/spmm.cu``, ``csrc/rows.cuh``) run only on the
card (``tests/test_torch_cuda.py``).  Here a numpy emulation of their f32
summation order for a call's launch arguments (lane groups, items a lane,
the groups' fixed-order combine, long segments' blocks in warp order) is
held against the JAX package's ``sddmm``, ``sddmm_dual``,
``aggregate_pair``, ``spmm`` and the ``gather_pair``, ``aggregate_pair``
and ``spmm`` VJPs, interpreted as ``tests/test_torch_ops.py``,
``tests/test_torch_spmm.py`` and ``tests/test_torch_spmm_grad.py`` run
them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from gnn_fpga_tpu.ops.pallas import spmm as jsp
from gnn_fpga_tpu_torch.ops.cuda import _build
from gnn_fpga_tpu_torch.ops.cuda import spmm as tsp

F32_TOL = dict(rtol=1e-4, atol=1e-5)
VJP_TOL = dict(rtol=2e-3, atol=1e-5)

KINDS = ["padded", "degree_zero", "dense", "hub"]
WIDTHS = [12, 64, 66]


def _topology(seed, kind, v=72, e=192):
    """Senders and receivers of a small graph: random edges with 48 pad
    edges on node v-1, a long segment each way (``padded``); the upper
    half of the nodes without edges (``degree_zero``); the edges on 24
    nodes, ~8 a node and direction (``dense``); or random edges and 1,120
    more that node 0 receives from node 1 (``hub``, 35 chunks of 32
    edges).  E stays a multiple of the JAX plans' tile of 32."""
    rng = np.random.default_rng(seed)
    hi = {"degree_zero": v // 2, "dense": 24}.get(kind, v - 1)
    s = rng.integers(0, hi, e)
    r = rng.integers(0, hi, e)
    if kind == "padded":
        s[-48:] = r[-48:] = v - 1
    if kind == "hub":
        s = np.concatenate([s, np.full(1120, 1)])
        r = np.concatenate([r, np.zeros(1120, np.int64)])
    return s.astype(np.int32), r.astype(np.int32), v


def _launches(width, lane_elems=None):
    """The launch arguments a call of this width takes in either dtype,
    from aligned tables and from tables off 16-byte alignment."""
    return sorted({tsp.row_launch(width, dt, align, lane_elems)
                   for dt in (torch.float32, torch.bfloat16)
                   for align in (16, 4, 2) if align >= dt.itemsize},
                  key=lambda la: (la.item_bytes, la.log_lanes))


def _np(t):
    return t.numpy().astype(np.int64)


def _butterfly(parts, step=1):
    """``parts`` [..., G, ...] (G on axis -2) added as xor shuffles add
    them: partner offsets ``step``, ``2 step``, ... below G; every entry
    ends with the sum, entry 0 as the kernels read it."""
    g = parts.shape[-2]
    idx = np.arange(g)
    off = step
    while off < g:
        parts = parts + parts[..., idx ^ off, :]
        off *= 2
    return parts


# ---------------------------------------------------------------------------
# Emulations of the kernels' f32 arithmetic
# ---------------------------------------------------------------------------

def _items(t, la: tsp.RowLaunch, elem):
    """Rows ``t`` [E, width] as a launch's lanes hold them: [E, kI, lanes,
    per], item c = i * lanes + lane, zero past the row."""
    per = la.item_bytes // elem
    lanes = 1 << la.log_lanes
    row = t.shape[1] // per
    k_i = -(-row // lanes)
    return np.pad(t.reshape(len(t), row, per),
                  ((0, 0), (0, k_i * lanes - row), (0, 0))
                  ).reshape(len(t), k_i, lanes, per)


def _lane_dots(pairs, la: tsp.RowLaunch, elem):
    """Per edge, the group's dot product of each (x, y) pair of [E, width]
    row tables: lane c adds x * y of its items c, c + lanes, ... in order,
    element by element, the pairs' products in turn; the group's lanes
    are then added by xor shuffles (offsets lanes / 2, ..., 1)."""
    held = [(_items(x, la, elem), _items(y, la, elem)) for x, y in pairs]
    n_e, k_i, lanes, per = held[0][0].shape
    part = np.zeros((n_e, lanes), np.float32)
    for i in range(k_i):
        for q in range(per):
            for x, y in held:
                part = part + x[:, i, :, q] * y[:, i, :, q]
    # xor offsets lanes / 2 down to 1: the same pairs as 1 up to lanes / 2
    # in another order of rounds, so add them in the kernel's order
    off = lanes // 2
    idx = np.arange(lanes)
    while off:
        part = part + part[:, idx ^ off]
        off //= 2
    return part[:, 0]


def _segment_rows(terms, ptr, long_nodes, la: tsp.RowLaunch):
    """Each node's sum of its sorted positions' rows ``terms`` [E, width]
    as ``rows.cuh`` adds them: one warp walks the segment in chunks of 32
    edges, or for a node of ``long_nodes`` warp w of a block of 8 its
    chunks w, w + 8, ...; a chunk's edge k goes to group k % G (G = 32 /
    lanes groups a warp), each group sums its edges in order, a warp's
    groups are added by xor shuffles (group offsets 1, 2, ..., G / 2) and
    a block's warps' rows then in warp order."""
    groups = 32 // (1 << la.log_lanes)
    v = len(ptr) - 1
    res = np.zeros((v, terms.shape[1]), np.float32)
    for n in range(v):
        warps = 8 if n in long_nodes else 1
        acc = np.zeros((warps, groups, terms.shape[1]), np.float32)
        for k, j in enumerate(range(ptr[n], ptr[n + 1])):
            acc[(k // 32) % warps, k % groups] += terms[j]
        rows = _butterfly(acc)[:, 0]
        res[n] = rows[0]
        for w in range(1, warps):
            res[n] += rows[w]
    return res


def emulate_sddmm(a, b, plan, la: tsp.RowLaunch, elem):
    """``sddmm_kernel``: per edge, the group's dot product of a[n] and
    b[o] (:func:`_lane_dots`), written to the edge's slot ``order[j]``."""
    return emulate_sddmm_dual(a, b, None, None, plan, la, elem)


def emulate_sddmm_dual(p, q, u, v, plan, la: tsp.RowLaunch, elem):
    """``sddmm_kernel`` with its second pair of tables (none when ``u`` is
    None): per edge, the group's sum of the products of (p[n], q[o]) and
    (u[o], v[n]), element by element in that order (:func:`_lane_dots`),
    written to the edge's slot ``order[j]``."""
    seg, oth = _np(plan.sorted_seg), _np(plan.sorted_oth)
    pairs = [(p[seg], q[oth])] + ([] if u is None else [(u[oth], v[seg])])
    out = np.zeros(len(seg), np.float32)
    out[_np(plan.order)] = _lane_dots(pairs, la, elem)
    return out


def emulate_spmm(h, w, plan, la: tsp.RowLaunch):
    """``segment_rows_kernel`` weighted over one plan: each segment sums
    w[e] * h[o] over its edges (:func:`_segment_rows`)."""
    return _segment_rows(w[_np(plan.order), None] * h[_np(plan.sorted_oth)],
                         _np(plan.seg_ptr), set(_np(plan.long_seg)), la)


def emulate_gather_bwd(g, plans, la: tsp.RowLaunch):
    """``segment_rows_kernel`` unweighted: each plan's segments sum their
    edges' rows of g (:func:`_segment_rows`), long segments by a block:
    ``(dpa, dpb)``."""
    return tuple(_segment_rows(g[_np(p.order)], _np(p.seg_ptr),
                               set(_np(p.long_seg)), la)
                 for p in (plans.send, plans.recv))


def emulate_aggregate_pair(h, w, plans, la: tsp.RowLaunch):
    """``segment_rows_kernel`` weighted: each plan's segments sum w[e] *
    h[o] (the product rounded, then added) over their edges:
    ``(mi, mo)``."""
    return tuple(emulate_spmm(h, w, p, la) for p in (plans.recv, plans.send))


def emulate_aggregate_pair_bwd(h, w, g_mi, g_mo, plans, la: tsp.RowLaunch,
                               elem):
    """``agg_bwd_kernel``: node n's recv walk sums w g_mo[o], its send
    walk w g_mi[o] (:func:`_segment_rows`; a node with a long segment
    either way has a block, whose 8 warps take both walks), and dh[n] is
    the recv row plus the send row; each recv edge's dw is the group's
    dot product of (g_mi[n], h[o]) and (g_mo[o], h[n]) (:func:`_lane_dots`)
    in its EDGE-order slot."""
    r, s = plans.recv, plans.send
    long_nodes = set(_np(r.long_seg)) | set(_np(s.long_seg))
    dh = (_segment_rows(w[_np(r.order), None] * g_mo[_np(r.sorted_oth)],
                        _np(r.seg_ptr), long_nodes, la)
          + _segment_rows(w[_np(s.order), None] * g_mi[_np(s.sorted_oth)],
                          _np(s.seg_ptr), long_nodes, la))
    n, o = _np(r.sorted_seg), _np(r.sorted_oth)
    dw = np.zeros(len(n), np.float32)
    dw[_np(r.order)] = _lane_dots([(g_mi[n], h[o]), (g_mo[o], h[n])], la,
                                  elem)
    return dh, dw


def _emulated_launches(width, lane_elems=None):
    """(launch, element bytes) for every launch a call of this width
    takes in f32 (4) or bf16 (2)."""
    return [(la, elem) for la in _launches(width, lane_elems)
            for elem in (4, 2)
            if la.item_bytes >= elem and not width * elem % la.item_bytes]


# ---------------------------------------------------------------------------
# The emulations against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_emulated_sddmm_matches_jax(kind, width):
    s, r, v = _topology(1, kind)
    rng = np.random.default_rng(2)
    a, b = (rng.standard_normal((v, width)).astype(np.float32)
            for _ in range(2))
    plans_j = jsp.build_agg_plans(s, r, v, tile_e=32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jsp.sddmm(jnp.asarray(a), jnp.asarray(b),
                                    plans_j.recv))
    plan = tsp.build_agg_plans(s, r, v).recv
    for la, elem in _emulated_launches(width):
        np.testing.assert_allclose(
            emulate_sddmm(a, b, plan, la, elem), want, **F32_TOL,
            err_msg=f"{la}, {elem}-byte elements")


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_emulated_gather_pair_bwd_matches_jax_vjp(kind, width):
    s, r, v = _topology(3, kind)
    rng = np.random.default_rng(4)
    pa, pb = (rng.standard_normal((v, width)).astype(np.float32)
              for _ in range(2))
    g = rng.standard_normal((len(s), width)).astype(np.float32)
    plans_j = jsp.build_agg_plans(s, r, v, tile_e=32)
    sj, rj = jnp.asarray(s), jnp.asarray(r)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda x, y: jsp.gather_pair(x, y, sj, rj, plans_j),
                         jnp.asarray(pa), jnp.asarray(pb))
        want = vjp(jnp.asarray(g))
    plans = tsp.build_agg_plans(s, r, v)
    for la in _launches(width):
        got = emulate_gather_bwd(g, plans, la)
        for name, x, y in zip(("dpa", "dpb"), got, want):
            np.testing.assert_allclose(x, np.asarray(y), **VJP_TOL,
                                       err_msg=f"{name}, {la}")
        if kind == "degree_zero":       # nodes without edges: zero rows
            assert not got[0][v // 2:].any() and not got[1][v // 2:].any()


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_emulated_aggregate_pair_matches_jax(kind, width):
    s, r, v = _topology(6, kind)
    rng = np.random.default_rng(7)
    h = rng.standard_normal((v, width)).astype(np.float32)
    w = rng.random(len(s)).astype(np.float32)
    plans_j = jsp.build_agg_plans(s, r, v, tile_e=32)
    with pltpu.force_tpu_interpret_mode():
        want = jsp.aggregate_pair(jnp.asarray(h), jnp.asarray(w), plans_j)
    plans = tsp.build_agg_plans(s, r, v)
    for la in _launches(width):
        got = emulate_aggregate_pair(h, w, plans, la)
        for name, x, y in zip(("mi", "mo"), got, want):
            np.testing.assert_allclose(x, np.asarray(y), **F32_TOL,
                                       err_msg=f"{name}, {la}")
        if kind == "degree_zero":       # nodes without edges: zero rows
            assert not got[0][v // 2:].any() and not got[1][v // 2:].any()


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_emulated_aggregate_pair_bwd_matches_jax_vjp(kind, width):
    s, r, v = _topology(8, kind)
    rng = np.random.default_rng(9)
    h, g_mi, g_mo = (rng.standard_normal((v, width)).astype(np.float32)
                     for _ in range(3))
    w = rng.random(len(s)).astype(np.float32)
    plans_j = jsp.build_agg_plans(s, r, v, tile_e=32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda x, y: jsp.aggregate_pair(x, y, plans_j),
                         jnp.asarray(h), jnp.asarray(w))
        want = vjp((jnp.asarray(g_mi), jnp.asarray(g_mo)))
    plans = tsp.build_agg_plans(s, r, v)
    for la, elem in _emulated_launches(width, tsp.AGG_BWD_LANE_ELEMS):
        got = emulate_aggregate_pair_bwd(h, w, g_mi, g_mo, plans, la, elem)
        for name, x, y in zip(("dh", "dw"), got, want):
            np.testing.assert_allclose(x, np.asarray(y), **VJP_TOL,
                                       err_msg=f"{name}, {la}, {elem}")
        if kind == "degree_zero":
            assert not got[0][v // 2:].any()


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_emulated_sddmm_dual_matches_jax(kind, width):
    s, r, v = _topology(10, kind)
    rng = np.random.default_rng(11)
    tabs = [rng.standard_normal((v, width)).astype(np.float32)
            for _ in range(4)]
    plans_j = jsp.build_agg_plans(s, r, v, tile_e=32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jsp.sddmm_dual(*map(jnp.asarray, tabs),
                                         plans_j.recv))
    plan = tsp.build_agg_plans(s, r, v).recv
    for la, elem in _emulated_launches(width):
        np.testing.assert_allclose(
            emulate_sddmm_dual(*tabs, plan, la, elem), want, **F32_TOL,
            err_msg=f"{la}, {elem}-byte elements")


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_emulated_spmm_matches_jax(kind, width):
    s, r, v = _topology(12, kind)
    rng = np.random.default_rng(13)
    h = rng.standard_normal((v, width)).astype(np.float32)
    w = rng.random(len(s)).astype(np.float32)
    plans_j = jsp.build_agg_plans(s, r, v, tile_e=32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jsp.spmm(jnp.asarray(h), jnp.asarray(w),
                                   plans_j.recv, plans_j.send))
    plan = tsp.build_agg_plans(s, r, v).recv
    for la in _launches(width):
        got = emulate_spmm(h, w, plan, la)
        np.testing.assert_allclose(got, want, **F32_TOL, err_msg=f"{la}")
        if kind == "degree_zero":       # nodes without edges: zero rows
            assert not got[v // 2:].any()


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_emulated_spmm_vjp_matches_jax_vjp(kind, width):
    """``spmm``'s VJP on the card: ``dh`` is ``spmm_raw`` over the
    transpose plan, ``dw`` is ``sddmm`` over the plan."""
    s, r, v = _topology(14, kind)
    rng = np.random.default_rng(15)
    h, g = (rng.standard_normal((v, width)).astype(np.float32)
            for _ in range(2))
    w = rng.random(len(s)).astype(np.float32)
    plans_j = jsp.build_agg_plans(s, r, v, tile_e=32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(
            lambda x, y: jsp.spmm(x, y, plans_j.recv, plans_j.send),
            jnp.asarray(h), jnp.asarray(w))
        want = vjp(jnp.asarray(g))
    plans = tsp.build_agg_plans(s, r, v)
    for la, elem in _emulated_launches(width):
        got = (emulate_spmm(g, w, plans.send, la),
               emulate_sddmm(g, h, plans.recv, la, elem))
        for name, x, y in zip(("dh", "dw"), got, want):
            np.testing.assert_allclose(x, np.asarray(y), **VJP_TOL,
                                       err_msg=f"{name}, {la}, {elem}")


def test_emulated_kernels_on_a_graph_without_edges():
    """No edges: zero rows and no edge values, as the plain versions."""
    plans = tsp.build_agg_plans(np.zeros(0, np.int32), np.zeros(0, np.int32),
                                5)
    la = tsp.row_launch(12, torch.float32)
    dpa, dpb = emulate_gather_bwd(np.zeros((0, 12), np.float32), plans, la)
    assert dpa.shape == dpb.shape == (5, 12)
    assert not dpa.any() and not dpb.any()
    a = np.ones((5, 12), np.float32)
    assert emulate_sddmm(a, a, plans.recv, la, 4).shape == (0,)
    w = np.zeros(0, np.float32)
    mi, mo = emulate_aggregate_pair(a, w, plans, la)
    dh, dw = emulate_aggregate_pair_bwd(a, w, a, a, plans, la, 4)
    assert not mi.any() and not mo.any() and not dh.any()
    assert mi.shape == dh.shape == (5, 12) and dw.shape == (0,)
    out = emulate_spmm(a, w, plans.recv, la)
    assert out.shape == (5, 12) and not out.any()
    assert emulate_sddmm_dual(a, a, a, a, plans.recv, la, 4).shape == (0,)


# ---------------------------------------------------------------------------
# Launch arguments
# ---------------------------------------------------------------------------

def test_row_launch_at_the_fullevent_widths():
    """H = 64: one 16-byte item a lane, 8 lanes in bf16 (a warp reads 4
    whole 128-byte rows at once), 16 in f32.  D = 66: 132-byte bf16 rows
    at 4-byte alignment, 264-byte f32 rows at 8, so 33 items of 4 or 8
    bytes, 5 a lane on 8 lanes; the hit graph's odd D = 67 is 67 bf16
    elements, 5 a lane on 16 lanes."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert tsp.row_launch(64, bf16) == tsp.RowLaunch(16, 3)
    assert tsp.row_launch(64, f32) == tsp.RowLaunch(16, 4)
    assert tsp.row_launch(66, bf16) == tsp.RowLaunch(4, 3)
    assert tsp.row_launch(66, f32) == tsp.RowLaunch(8, 3)
    assert tsp.row_launch(67, bf16) == tsp.RowLaunch(2, 4)
    # a table off 16-byte alignment takes the narrow items
    assert tsp.row_launch(64, bf16, align=2) == tsp.RowLaunch(2, 3)
    assert tsp.row_launch(64, f32, align=4).item_bytes == 4
    # aggregate_pair_bwd: D = 66 as one-element items, 5 a lane on 16
    # lanes; rows of at most 32 items and D = 67 as for the other kernels
    k = tsp.AGG_BWD_LANE_ELEMS
    assert tsp.row_launch(66, bf16, lane_elems=k) == tsp.RowLaunch(2, 4)
    assert tsp.row_launch(66, f32, lane_elems=k) == tsp.RowLaunch(4, 4)
    for width, dt in ((64, bf16), (64, f32), (67, bf16), (12, f32)):
        assert tsp.row_launch(width, dt, lane_elems=k) == \
            tsp.row_launch(width, dt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lane_elems", [None, tsp.AGG_BWD_LANE_ELEMS])
def test_row_launch_fits_every_width(dtype, lane_elems):
    """For widths 1-256 and every alignment: at most 32 lanes and at most
    8 items a lane (csrc/rows.cuh checks these), items that divide the row
    and the alignment.  The widest item (at most 16 bytes) and the fewest
    lanes that hold a row one item a lane where 32 do, else 8 items a
    lane; with ``lane_elems``, a row of more than 32 items that would put
    more elements than that on a lane goes to one-element items on the
    fewest lanes that hold at most ``lane_elems`` each (32 at most)."""
    elem = dtype.itemsize
    for width in range(1, 257):
        for align in (16, 8, 4, 2):
            if align < elem:
                continue
            la = tsp.row_launch(width, dtype, align, lane_elems)
            item = la.item_bytes
            assert item in (2, 4, 8, 16) and item >= elem
            assert width * elem % item == 0 and align % item == 0
            assert 0 <= la.log_lanes <= 5
            lanes = 1 << la.log_lanes
            n_items = width * elem // item
            assert -(-n_items // lanes) <= 8
            plain = tsp.row_launch(width, dtype, align)
            if la != plain:
                p_items = width * elem // plain.item_bytes
                p_lane = -(-p_items // (1 << plain.log_lanes))
                assert lane_elems and p_items > 32
                assert p_lane * plain.item_bytes // elem > lane_elems
                assert item == elem
                assert lanes == 32 or -(-width // lanes) <= lane_elems
                assert lanes == 1 or -(-width // (lanes // 2)) > lane_elems
                continue
            if item < 16:
                assert width * elem % (2 * item) or align % (2 * item)
            if n_items <= 32:
                assert lanes >= n_items
                assert lanes == 1 or lanes // 2 < n_items
            else:
                assert -(-n_items // (lanes // 2)) > 8
                if lane_elems and lanes < 32:
                    assert -(-n_items // lanes) * item // elem <= lane_elems


@pytest.mark.parametrize("kind", KINDS)
def test_plans_list_their_long_segments(kind):
    """Each plan lists, ascending, the nodes whose segments have more than
    LONG_SEGMENT edges, which a block walks: the pad node's 48 edges each
    way, the hub's 1,120 (node 0 receiving, node 1 sending)."""
    s, r, v = _topology(5, kind)
    plans = tsp.build_agg_plans(s, r, v)
    for plan, seg in ((plans.recv, r), (plans.send, s)):
        deg = np.bincount(seg, minlength=v)
        np.testing.assert_array_equal(
            _np(plan.long_seg), np.flatnonzero(deg > tsp.LONG_SEGMENT))
        assert plan.long_seg.dtype == torch.int32
    expect = {"padded": ([v - 1], [v - 1]), "hub": ([0], [1])}.get(kind,
                                                                 ([], []))
    assert (plans.recv.long_seg.tolist(), plans.send.long_seg.tolist()) \
        == expect


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_launch_for_tables_of_mixed_alignment(dtype):
    """sddmm_dual's four tables at base addresses of different alignment
    (as allocated, a row in, one element in, two elements in): the launch
    takes the items the least aligned table allows, and the emulated
    kernel on that launch still computes the function."""
    v, width = 40, 66
    rng = np.random.default_rng(16)
    big = torch.from_numpy(
        rng.standard_normal(((v + 1) * width + 2,)).astype(np.float32)
    ).to(dtype)
    tabs = (big[:v * width].view(v, width),
            big[width:(v + 1) * width].view(v, width),
            big[1:v * width + 1].view(v, width),
            big[2:v * width + 2].view(v, width))
    aligns = [_build.alignment(t) for t in tabs]
    assert len(set(aligns)) > 1
    align = _build.alignment(*tabs)
    assert align == min(aligns) == dtype.itemsize
    la = tsp.row_launch(width, dtype, align)
    assert la == min((tsp.row_launch(width, dtype, a) for a in aligns),
                     key=lambda x: x.item_bytes)
    assert la.item_bytes == dtype.itemsize
    s, r, v = _topology(17, "padded", v=v, e=160)
    plan = tsp.build_agg_plans(s, r, v).recv
    p, q, u, w = (t.float().numpy() for t in tabs)
    want = tsp.sddmm_dual_reference(
        *(torch.from_numpy(t) for t in (p, q, u, w)),
        plan.sorted_seg.long(), plan.sorted_oth.long())
    np.testing.assert_allclose(
        emulate_sddmm_dual(p, q, u, w, plan, la, dtype.itemsize),
        want.index_select(0, plan.inv_order.long()).numpy(), **F32_TOL)


def test_alignment_of_table_views():
    """The largest power of two, at most 16, dividing every base address:
    a row slice of a 66-wide bf16 table starts 132 bytes in (4-byte
    aligned), a slice one element in 2 bytes in."""
    t = torch.zeros((10, 66), dtype=torch.bfloat16)
    assert _build.alignment(t) == 16
    assert _build.alignment(t, t[1:]) == 4
    assert _build.alignment(t.flatten()[1:]) == 2
    assert _build.alignment(torch.zeros((10, 64))[1:]) == 16
    assert _build.alignment(torch.zeros(0)) == 16


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_emulated_row_kernels_give_the_same_bits_on_padded_plans(kind,
                                                                  width):
    """Plans padded to a capacity list pad long segments (node -1) after
    the real ones, whose blocks return at once: every row kernel's
    emulation gives the unpadded plans' bits."""
    s, r, v = _topology(12, kind)
    plans = tsp.build_agg_plans(s, r, v)
    real = tsp.plan_counts(plans)
    padded = tsp.pad_plans(plans, dataclasses.replace(
        real, recv_items=real.recv_items + 9, send_items=real.send_items + 2,
        splits=real.splits + 1, slots=real.slots + 4,
        recv_long=real.recv_long + 3, send_long=real.send_long + 1))
    assert padded.recv.long_seg.tolist()[-3:] == [-1] * 3
    rng = np.random.default_rng(13)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    h, gm, go, q = f(v, width), f(v, width), f(v, width), f(v, width)
    w, g = f(len(s)), f(len(s), width)
    for la, elem in _emulated_launches(width):
        for run in (
                lambda p: emulate_sddmm(gm, h, p.recv, la, elem),
                lambda p: emulate_sddmm_dual(gm, h, go, q, p.recv, la, elem),
                lambda p: emulate_spmm(h, w, p.send, la),
                lambda p: emulate_gather_bwd(g, p, la),
                lambda p: emulate_aggregate_pair(h, w, p, la),
                lambda p: emulate_aggregate_pair_bwd(h, w, gm, go, p, la,
                                                     elem)):
            as_tuple = lambda x: x if isinstance(x, tuple) else (x,)
            for a, b in zip(as_tuple(run(padded)), as_tuple(run(plans))):
                np.testing.assert_array_equal(a, b)
