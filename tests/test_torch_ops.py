"""The port's single-direction sparse ops (``spmm``, ``sddmm``,
``sddmm_dual``, ``sorted_segment_sum``) and ``segment_mean`` against the
JAX package's, on the same numpy inputs.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do; on the CPU the port's wrappers run their plain PyTorch versions.  The
CUDA kernels are held against those versions in ``tests/test_torch_cuda.py``
and ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from gnn_fpga_tpu.ops import segment as jseg
from gnn_fpga_tpu.ops.pallas import segment_sum as jss
from gnn_fpga_tpu.ops.pallas import spmm as jsp
from gnn_fpga_tpu_torch.ops import segment as tseg
from gnn_fpga_tpu_torch.ops.cuda import segment_sum as tss
from gnn_fpga_tpu_torch.ops.cuda import spmm as tsp

SPMM_TOL = dict(rtol=1e-4, atol=1e-5)     # tests/test_pallas_spmm.py
SEGSUM_TOL = dict(rtol=1e-5)              # tests/test_pallas_segment_sum.py


def _graph(seed, v, e, d, kind="random"):
    """Random tables over a topology: random ids, a hot receiver holding
    half the edges and empty nodes, or a band (tracking-graph locality)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, v, e).astype(np.int32)
    r = rng.integers(0, v, e).astype(np.int32)
    if kind == "hot":
        r[: e // 2] = 7
        r[e // 2:] = rng.choice([0, v - 1], e - e // 2)
    elif kind == "band":
        s = rng.integers(0, v - 8, e).astype(np.int32)
        r = (s + rng.integers(1, 8, e)).astype(np.int32)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return dict(s=s, r=r, v=v, w=f(e), a=f(v, d), b=f(v, d), u=f(v, d),
                vv=f(v, d))


def _plans(c):
    """(JAX plans, port plans) of the same topology: seg = recv."""
    return (jsp.build_agg_plans(c["s"], c["r"], c["v"], tile_e=32),
            tsp.build_agg_plans(c["s"], c["r"], c["v"]))


def _t(a):
    return torch.from_numpy(np.array(a))


KINDS = ["random", "hot", "band"]


@pytest.mark.parametrize("kind", KINDS)
def test_spmm_raw_matches_jax(kind):
    c = _graph(0, 48, 128, 16, kind)
    jp, tp = _plans(c)
    for jplan, tplan, seg, oth in ((jp.recv, tp.recv, c["r"], c["s"]),
                                   (jp.send, tp.send, c["s"], c["r"])):
        with pltpu.force_tpu_interpret_mode():
            want = jsp._spmm_raw(jnp.asarray(c["a"]), jnp.asarray(c["w"]),
                                 jplan)
        got = tsp.spmm_raw(_t(c["a"]), _t(c["w"]), tplan)
        assert got.dtype == torch.float32 and got.shape == (48, 16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SPMM_TOL)
        ref = tsp.spmm_reference(_t(c["a"]), _t(c["w"]), _t(seg), _t(oth),
                                 48)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **SPMM_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_sddmm_matches_jax(kind):
    c = _graph(1, 64, 128, 16, kind)
    jp, tp = _plans(c)
    with pltpu.force_tpu_interpret_mode():
        want = jsp.sddmm(jnp.asarray(c["a"]), jnp.asarray(c["b"]), jp.recv)
    got = tsp.sddmm(_t(c["a"]), _t(c["b"]), tp.recv)
    assert got.dtype == torch.float32 and got.shape == (128,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SPMM_TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jsp.sddmm_reference(c["a"], c["b"], c["r"],
                                                    c["s"])), **SPMM_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_sddmm_dual_matches_jax(kind):
    c = _graph(2, 64, 128, 16, kind)
    jp, tp = _plans(c)
    tabs = (c["a"], c["b"], c["u"], c["vv"])
    with pltpu.force_tpu_interpret_mode():
        want = jsp.sddmm_dual(*map(jnp.asarray, tabs), jp.recv)
    got = tsp.sddmm_dual(*map(_t, tabs), tp.recv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SPMM_TOL)
    expect = (jsp.sddmm_reference(c["a"], c["b"], c["r"], c["s"])
              + jsp.sddmm_reference(c["u"], c["vv"], c["s"], c["r"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **SPMM_TOL)
    ref = tsp.sddmm_dual_reference(*map(_t, tabs), _t(c["r"]), _t(c["s"]))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **SPMM_TOL)


def test_sddmm_dual_is_the_dw_of_aggregate_pair():
    c = _graph(3, 40, 96, 8)
    _, tp = _plans(c)
    g_mi, g_mo = _t(c["u"]), _t(c["vv"])
    _, dw = tsp.aggregate_pair_bwd(_t(c["a"]), _t(c["w"]), g_mi, g_mo, tp)
    got = tsp.sddmm_dual(g_mi, _t(c["a"]), g_mo, _t(c["a"]), tp.recv)
    np.testing.assert_allclose(got.numpy(), dw.numpy(), **SPMM_TOL)


@pytest.mark.parametrize("transpose", [False, True])
def test_spmm_vjp_matches_jax(transpose):
    c = _graph(4, 30, 64, 8)
    jp, tp = _plans(c)
    jplans = (jp.send, jp.recv) if transpose else (jp.recv, jp.send)
    tplans = (tp.send, tp.recv) if transpose else (tp.recv, tp.send)
    g = np.random.default_rng(5).standard_normal((30, 8)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda h, w: jsp.spmm(h, w, *jplans),
                           jnp.asarray(c["a"]), jnp.asarray(c["w"]))
        want_dh, want_dw = vjp(jnp.asarray(g))
    h = _t(c["a"]).requires_grad_()
    w = _t(c["w"]).requires_grad_()
    got = tsp.spmm(h, w, *tplans)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               **SPMM_TOL)
    got.backward(_t(g))
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(want_dh),
                               **SPMM_TOL)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(want_dw),
                               **SPMM_TOL)


def test_spmm_rejects_a_plan_of_another_graph():
    c = _graph(6, 30, 64, 8)
    _, tp = _plans(c)
    other = tsp.build_edge_plan(c["s"][:32], c["r"][:32], 30)
    with pytest.raises(ValueError, match="transpose"):
        tsp.spmm(_t(c["a"]), _t(c["w"]), tp.recv, other)


# ---------------------------------------------------------------------------
# sorted_segment_sum
# ---------------------------------------------------------------------------

def _segment_sum_pair(messages, ids, n_node, precision="highest"):
    """(port, JAX interpret) sums of ``messages`` by ``ids``."""
    jseg_ = jss.build_sorted_segments(ids, n_node)
    with pltpu.force_tpu_interpret_mode():
        want = jss.sorted_segment_sum(jnp.asarray(messages)[jseg_.order],
                                      jseg_, n_node, 8, precision)
    seg = tss.build_sorted_segments(ids, n_node)
    np.testing.assert_array_equal(seg.order.numpy(), np.asarray(jseg_.order))
    got = tss.sorted_segment_sum(_t(messages)[seg.order.long()], seg, n_node,
                                 precision)
    return got, np.asarray(want)


@pytest.mark.parametrize("case", ["random", "hot_and_gaps", "padding",
                                  "one_segment"])
def test_sorted_segment_sum_matches_jax(case):
    rng = np.random.default_rng({"random": 0, "hot_and_gaps": 3,
                                 "padding": 4, "one_segment": 5}[case])
    n, e, d = {"random": (24, 64, 16), "hot_and_gaps": (1000, 64, 8),
               "padding": (10, 32, 8), "one_segment": (4, 16, 8)}[case]
    messages = rng.normal(size=(e, d)).astype(np.float32)
    if case == "random":
        ids = rng.integers(0, n, e)
    elif case == "hot_and_gaps":
        ids = np.concatenate([np.full(32, 7), np.full(16, 0),
                              np.full(16, 999)])
    elif case == "padding":          # ids == n_node are padding
        ids = rng.permutation(np.concatenate([np.arange(10),
                                              np.full(22, n)]))
    else:
        ids = np.zeros(e)
    ids = ids.astype(np.int32)
    got, want = _segment_sum_pair(messages, ids, n)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got.numpy(), want, **SEGSUM_TOL)
    oracle = np.asarray(jss.segment_sum_reference(
        jnp.asarray(messages), jnp.asarray(ids), n))
    np.testing.assert_allclose(got.numpy(), oracle, **SEGSUM_TOL)
    if case == "one_segment":
        np.testing.assert_allclose(got[0].numpy(), messages.sum(0),
                                   **SEGSUM_TOL)
        assert (got[1:] == 0).all()


def test_sorted_segment_sum_default_precision_rounds_to_bf16():
    """``"default"`` sums the messages rounded to bf16, as the one-pass
    bf16 MXU product does; on the CPU the JAX package's interpreted kernel
    sums them unrounded, so it is held to the rounded messages."""
    rng = np.random.default_rng(7)
    messages = rng.normal(size=(64, 16)).astype(np.float32)
    ids = rng.integers(0, 24, 64).astype(np.int32)
    rounded = np.asarray(jnp.asarray(messages).astype(jnp.bfloat16)
                         .astype(jnp.float32))
    got, _ = _segment_sum_pair(messages, ids, 24, "default")
    _, want = _segment_sum_pair(rounded, ids, 24, "default")
    np.testing.assert_allclose(got.numpy(), want, **SEGSUM_TOL)
    exact, _ = _segment_sum_pair(messages, ids, 24)
    assert not np.allclose(got.numpy(), exact.numpy(), rtol=1e-5, atol=0)
    with pytest.raises(ValueError, match="precision"):
        tss.sorted_segment_sum(_t(messages), tss.build_sorted_segments(
            ids, 24), 24, "high")


def test_sorted_segment_sum_gradient_matches_jax():
    rng = np.random.default_rng(6)
    e, d, n = 32, 8, 12
    messages = rng.normal(size=(e, d)).astype(np.float32)
    ids = rng.integers(0, n + 1, e).astype(np.int32)     # with pad ids
    w = rng.normal(size=(n, d)).astype(np.float32)
    jseg_ = jss.build_sorted_segments(ids, n)

    def loss(m):
        with pltpu.force_tpu_interpret_mode():
            out = jss.sorted_segment_sum(m[jseg_.order], jseg_, n, 8)
        return jnp.sum(out * w)

    want = np.asarray(jax.grad(loss)(jnp.asarray(messages)))
    seg = tss.build_sorted_segments(ids, n)
    m = _t(messages).requires_grad_()
    (tss.sorted_segment_sum(m[seg.order.long()], seg, n) * _t(w)).sum() \
        .backward()
    np.testing.assert_allclose(m.grad.numpy(), want, **SEGSUM_TOL)
    assert (m.grad[ids == n] == 0).all()


def test_build_sorted_segments_csr_offsets():
    ids = np.array([3, 0, 3, 5, 1, 3, 5, 0], np.int32)   # 5 is padding
    seg = tss.build_sorted_segments(torch.from_numpy(ids), 5)
    np.testing.assert_array_equal(seg.ptr.numpy(), [0, 2, 3, 3, 6, 6])
    np.testing.assert_array_equal(seg.sorted_ids.numpy(), np.sort(ids))
    with pytest.raises(ValueError):
        tss.build_sorted_segments(np.array([0, 6]), 5)


def test_cpu_calls_launch_no_kernel():
    c = _graph(8, 40, 96, 8)
    _, tp = _plans(c)
    before = tsp.launch_counts()
    assert set(before) >= {"spmm", "sddmm", "sddmm_dual",
                           "sorted_segment_sum"}
    tsp.spmm(_t(c["a"]), _t(c["w"]), tp.recv, tp.send)
    tsp.sddmm(_t(c["a"]), _t(c["b"]), tp.recv)
    tsp.sddmm_dual(_t(c["a"]), _t(c["b"]), _t(c["u"]), _t(c["vv"]), tp.recv)
    seg = tss.build_sorted_segments(c["r"], 40)
    tss.sorted_segment_sum(_t(c["u"][:96 // 8]).repeat(8, 1), seg, 40)
    assert tsp.launch_counts() == before


def test_meta_tensors_raise_not_fall_back():
    c = _graph(9, 40, 96, 8)
    _, tp = _plans(c)
    meta = lambda a: _t(a).to("meta")
    with pytest.raises(ValueError):
        tsp.spmm_raw(meta(c["a"]), meta(c["w"]), tp.recv)
    with pytest.raises(ValueError):
        tsp.sddmm(meta(c["a"]), meta(c["b"]), tp.recv)
    seg = tss.build_sorted_segments(c["r"], 40)
    with pytest.raises(ValueError):
        tss.sorted_segment_sum(torch.zeros(96, 8, device="meta"), seg, 40)


def test_segment_mean_matches_jax():
    rng = np.random.default_rng(10)
    msgs = rng.standard_normal((50, 6)).astype(np.float32)
    idx = rng.integers(-2, 14, 50).astype(np.int32)   # empty and dropped ids
    got = tseg.segment_mean(_t(msgs), _t(idx), 12)
    want = jseg.segment_mean(jnp.asarray(msgs), jnp.asarray(idx), 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
