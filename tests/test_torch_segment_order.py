"""The segment-sum kernel's launch (``ops/cuda/segment_sum.py``:
``segment_launch``) and its summation order, on the CPU.

``sorted_segment_sum`` runs on the card as ``csrc/segment_sum.cu`` (held
against its plain version in ``tests/test_torch_cuda.py``).  Here a numpy
emulation of the kernel's two launches (tiles of sorted rows, each node's
rows in a tile added in row order in f32, the partials of nodes cut by
tile boundaries added in tile order, and which launch writes each node,
zeros included) is held against the JAX package's ``sorted_segment_sum``,
interpreted as ``tests/test_torch_ops.py`` runs it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from gnn_fpga_tpu.ops.pallas import segment_sum as jss
from gnn_fpga_tpu_torch.ops.cuda import segment_sum as tss

SEGSUM_TOL = dict(rtol=1e-5)              # tests/test_pallas_segment_sum.py
# A reordered f32 sum errs in proportion to its terms, not to its result:
# a sum that cancels to near zero can miss rtol alone, so the comparisons
# also take an atol of this factor times the largest absolute sum.
SUM_ATOL = 1e-6
JAX_TILE_E = 64                           # the JAX kernel's edge tile

KINDS = ["padded", "degree_zero", "dense", "hub", "boundaries", "all_pad",
         "empty"]
WIDTHS = [12, 64, 66]
PRECISIONS = ["highest", "default"]

# Segment lengths whose ends fall on the boundaries of tiles of 8, 32, 128
# and 256 rows, with empty nodes on boundaries: a node of exactly one tile, a
# node of two tiles from a boundary, nodes ending on one.
BOUNDARY_LENGTHS = [32, 16, 16, 64, 0, 0, 1, 31, 33, 31, 0, 32, 0, 256, 5,
                    251, 512, 3]


def _ids(kind, seed=0, v=72, e=192):
    """Segment ids and the node count: random ids with 48 rows on node
    v-1 and ~5% pad ids (``padded``); ids on the lower half of the nodes
    (``degree_zero``); on 24 nodes, ~8 rows each (``dense``); random ids
    and 1,120 more rows on node 0 (``hub``, 4-5 tiles of 256 rows); the
    lengths of ``BOUNDARY_LENGTHS`` in a shuffled order, three empty nodes
    after them and 8 pad ids (``boundaries``); every id the pad id
    (``all_pad``); no rows (``empty``)."""
    rng = np.random.default_rng(seed)
    if kind == "padded":
        ids = rng.integers(0, v - 1, e)
        ids[-48:] = v - 1
        ids[rng.random(e) < 0.05] = v
    elif kind == "degree_zero":
        ids = rng.integers(0, v // 2, e)
    elif kind == "dense":
        ids = rng.integers(0, 24, e)
    elif kind == "hub":
        ids = np.concatenate([rng.integers(0, v, e), np.zeros(1120, int)])
    elif kind == "boundaries":
        v = len(BOUNDARY_LENGTHS) + 3
        ids = np.concatenate([np.repeat(np.arange(len(BOUNDARY_LENGTHS)),
                                        BOUNDARY_LENGTHS), np.full(8, v)])
    elif kind == "all_pad":
        ids = np.full(64, v)
    else:
        ids = np.zeros(0, int)
    return rng.permutation(ids).astype(np.int32), v


def _messages(n, d, seed=1):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _bf16(x):
    return torch.from_numpy(x).bfloat16().float().numpy()


def emulate_segment_sum(sorted_msgs, sorted_ids, ptr, n_node, rows,
                        round_bf16=False):
    """``csrc/segment_sum.cu``'s f32 arithmetic, launch by launch, for
    tiles of ``rows`` sorted rows: ``segment_tile_kernel`` (block t owns
    rows [t rows, t rows + rows) of the kept rows; zero rows for the nodes
    before its first that no tile holds and, in the last tile, past its
    last; each node it touches summed in row order, written if its rows lie
    in the tile, else left as the tile's partial in slot 0 or 1), then
    ``segment_cut_kernel`` (each cut node's partials added in tile order at
    its last boundary).  The columns a thread takes change nothing: each
    column is its own sum.  Fails unless every node is written exactly
    once and every partial read was written."""
    m = _bf16(sorted_msgs) if round_bf16 else sorted_msgs
    n_rows, d = m.shape
    n_kept = int(ptr[n_node])
    n_tiles = max(1, -(-n_rows // rows))
    out = np.full((n_node, d), np.nan, np.float32)
    part = np.full((n_tiles, 2, d), np.nan, np.float32)
    writes = np.zeros(n_node, int)

    def write(n, row):
        out[n] = row
        writes[n] += 1

    for t in range(n_tiles):
        a = t * rows
        if t > 0 and a >= n_kept:
            continue
        b = min(a + rows, n_kept)
        first = sorted_ids[a] if a < n_kept else n_node
        before = -1 if t == 0 else sorted_ids[a - 1]
        for n in range(before + 1, first):
            write(n, 0.0)
        if b <= a:
            continue
        last = sorted_ids[b - 1]
        if b == n_kept:
            for n in range(last + 1, n_node):
                write(n, 0.0)
        for n in range(first, last + 1):
            beg, end = ptr[n], ptr[n + 1]
            s = np.zeros(d, np.float32)
            for j in range(max(beg, a), min(end, b)):
                s = s + m[j]
            if beg >= a and end <= b:
                write(n, s)
            else:
                part[t, 0 if beg < a else 1] = s
    for t in range(1, n_tiles):
        a = t * rows
        if a >= n_kept:
            continue
        n = sorted_ids[a]
        beg, end = ptr[n], ptr[n + 1]
        if beg >= a or (end - 1) // rows != t:
            continue
        t0 = beg // rows
        s = part[t0, 1]
        for u in range(t0 + 1, t + 1):
            s = s + part[u, 0]
        write(n, s)
    assert (writes == 1).all(), "a node written other than once"
    assert not np.isnan(out).any(), "an unwritten partial was read"
    return out


def _tile_rows_cases(width):
    """Tiles of 8 and 32 rows (many boundaries), and the rows the kernel
    takes at this width in either dtype."""
    return sorted({8, 32, tss.segment_tile_rows(width, torch.float32),
                   tss.segment_tile_rows(width, torch.bfloat16)})


def _jax_sum(messages, ids, n_node, precision):
    """The JAX package's sorted_segment_sum, interpreted, with pad ids
    appended up to its tile of JAX_TILE_E rows; with no rows at all (it
    takes none) its oracle ``segment_sum_reference``."""
    if len(ids) == 0:
        return np.asarray(jss.segment_sum_reference(
            jnp.asarray(messages), jnp.asarray(ids), n_node))
    pad = -len(ids) % JAX_TILE_E
    ids = np.concatenate([ids, np.full(pad, n_node, np.int32)])
    messages = np.concatenate([messages, _messages(pad, messages.shape[1],
                                                   seed=2)])
    jseg = jss.build_sorted_segments(ids, n_node)
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jss.sorted_segment_sum(
            jnp.asarray(messages)[jseg.order], jseg, n_node, JAX_TILE_E,
            precision))


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_tile_order_matches_jax(kind, width, precision):
    """For every tile the kernel or a test takes at this width, the
    emulated sum equals the JAX kernel's.  Under ``"default"`` the
    emulation rounds each message to bf16; the interpreted JAX kernel
    sums unrounded on the CPU, so it is given the rounded messages."""
    ids, v = _ids(kind)
    messages = _messages(len(ids), width)
    seg = tss.build_sorted_segments(ids, v)
    order, sorted_ids, ptr = (x.numpy().astype(np.int64)
                              for x in (seg.order, seg.sorted_ids, seg.ptr))
    want = _jax_sum(_bf16(messages) if precision == "default" else messages,
                    ids, v, precision)
    atol = SUM_ATOL * float(np.abs(want).max(initial=0.0))
    for rows in _tile_rows_cases(width):
        got = emulate_segment_sum(messages[order], sorted_ids, ptr, v, rows,
                                  precision == "default")
        np.testing.assert_allclose(got, want, atol=atol, **SEGSUM_TOL,
                                   err_msg=f"tiles of {rows} rows")


def test_tiles_cut_the_hub_and_meet_boundaries():
    """The cases do what their names say: at 256 rows the hub is cut by
    four boundaries and summed from its partials; on ``boundaries``
    segments start and end on tile boundaries of 8, 32, 128 and 256 rows,
    one node fills two tiles of 256, and empty nodes sit on
    boundaries."""
    ids, v = _ids("hub")
    ptr = tss.build_sorted_segments(ids, v).ptr.numpy()
    assert ptr[1] - ptr[0] >= 1120
    assert len(range(256, ptr[1], 256)) >= 4
    ids, v = _ids("boundaries")
    ptr = tss.build_sorted_segments(ids, v).ptr.numpy()
    for rows in (8, 32, 128, 256):
        bounds = np.arange(rows, ptr[-1], rows)
        assert np.isin(bounds, ptr).sum() >= 4, rows
    # node 16: exactly the two tiles [768, 1280) of 256 rows
    assert (ptr[16], ptr[17]) == (3 * 256, 5 * 256)
    empty = np.flatnonzero(np.diff(ptr) == 0)
    assert (ptr[empty] % 32 == 0).any()


@pytest.mark.parametrize("kind", KINDS)
def test_tile_order_matches_the_plain_version(kind):
    """The emulation at the kernel's f32 tile at D = 66, against the
    port's plain version (the CPU path of ``sorted_segment_sum``)."""
    ids, v = _ids(kind)
    messages = _messages(len(ids), 66)
    seg = tss.build_sorted_segments(ids, v)
    m_sorted = torch.from_numpy(messages)[seg.order.long()]
    want = tss.sorted_segment_sum(m_sorted, seg, v).numpy()
    got = emulate_segment_sum(m_sorted.numpy(), seg.sorted_ids.numpy(),
                              seg.ptr.numpy(), v,
                              tss.segment_tile_rows(66, torch.float32))
    np.testing.assert_allclose(got, want, atol=SUM_ATOL * float(
        np.abs(want).max(initial=0.0)), **SEGSUM_TOL)


# ---------------------------------------------------------------------------
# The launch the wrapper picks (pure Python)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_sorted_segments_count_the_kept_rows(kind):
    """``n_kept``, the kernel's grid, is ``ptr[n_node]``: the rows whose id
    is not the pad id, first in the sorted order; it survives ``.to``."""
    ids, v = _ids(kind)
    seg = tss.build_sorted_segments(ids, v)
    assert seg.n_kept == int(seg.ptr[-1]) == int((ids < v).sum())
    assert (seg.sorted_ids[:seg.n_kept] < v).all()
    assert (seg.sorted_ids[seg.n_kept:] == v).all()
    assert seg.to("cpu").n_kept == seg.n_kept


def test_launch_at_the_fullevent_widths():
    """D = 66 and D = 64: 128 rows a tile (36 KB of messages or less) and
    two columns a thread in either dtype."""
    for d in (66, 64):
        for dt in (torch.bfloat16, torch.float32):
            assert tss.segment_launch(d, dt) == tss.SegmentLaunch(
                tile_rows=128, unit=2)


def test_launch_takes_one_column_a_thread_where_pairs_are_unaligned():
    """An odd width, or a base off two-element alignment (a view one
    element in), reads one column a thread."""
    assert tss.segment_launch(67, torch.bfloat16).unit == 1
    assert tss.segment_launch(66, torch.bfloat16, align=2).unit == 1
    assert tss.segment_launch(66, torch.bfloat16, align=4).unit == 2
    assert tss.segment_launch(66, torch.float32, align=4).unit == 1
    assert tss.segment_launch(66, torch.float32, align=8).unit == 2


def test_tile_rows_shrink_for_wide_rows():
    """Rows of 256 columns (1 KB in f32) pass SEGSUM_TILE_BYTES at 128
    rows: 32 rows in f32, 64 in bf16; narrow rows keep 128."""
    assert tss.segment_tile_rows(256, torch.float32) == 32
    assert tss.segment_tile_rows(256, torch.bfloat16) == 64
    assert tss.segment_tile_rows(12, torch.float32) == 128


def test_tile_rows_fit_the_kernels_shared_memory():
    """Every width the kernel takes (1 to 256) in either dtype: at least
    one row, and a tile (with the 30 bytes of 16-byte copies around it,
    in whole 16-byte pieces) within the 227 KB of shared memory that
    ``csrc/segment_sum.cu`` accepts."""
    for dtype in (torch.float32, torch.bfloat16):
        for d in range(1, 257):
            rows = tss.segment_tile_rows(d, dtype)
            assert 1 <= rows <= tss.SEGSUM_TILE_ROWS
            assert rows * d * dtype.itemsize <= tss.SEGSUM_TILE_BYTES
            smem = (rows * d * dtype.itemsize + 45) // 16 * 16
            assert smem <= 227 * 1024


def test_tile_rows_follow_the_module_settings(monkeypatch):
    """The chip smoke's sweep varies the tile through these settings."""
    monkeypatch.setattr(tss, "SEGSUM_TILE_ROWS", 512)
    monkeypatch.setattr(tss, "SEGSUM_TILE_BYTES", 512 * 66 * 4)
    assert tss.segment_tile_rows(66, torch.float32) == 512
    monkeypatch.setattr(tss, "SEGSUM_TILE_BYTES", 1)
    assert tss.segment_tile_rows(66, torch.float32) == 1
