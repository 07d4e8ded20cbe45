"""The port's probes (``gnn_fpga_tpu_torch/probes/``, ``ops/cuda/
probes.py``) against the TPU probes under ``benchmarks/`` and the JAX
package, on the CPU: the layered graph bit for bit, the backward from
stashed scores against ``benchmarks.probe_iter._stash_bwd`` (interpret
mode), the recompute form against the JAX production VJP, the SpMM
ablation's plain versions against numpy and JAX ``spmm``, the copy and
gather plain versions against ``x * 2.0`` and ``jnp.take``, ``timed``'s
chaining, and each probe's entry point at a small size.  The CUDA kernels
are held against these plain versions in ``tests/test_torch_cuda.py`` and
``chip_smoke.py --phase probes``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from benchmarks import probe_iter as jprobe_iter
from benchmarks import probe_spmm as jprobe_spmm
from gnn_fpga_tpu.ops.pallas import spmm as jsp
from gnn_fpga_tpu_torch.ops.cuda import probes, spmm as tsp
from gnn_fpga_tpu_torch.probes import bw, common, ops, spmm_ablate
from gnn_fpga_tpu_torch.probes import iter as iter_probe

# The port's plain backward against the TPU probe's kernel in interpret
# mode, f32: summation order only (the JAX package's kernel tolerance).
F32_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16: the TPU probe's own instrument tolerances (benchmarks/
# probe_iter.py:162-183): node tables elementwise, parameter sums by
# their cosine (the JAX kernel rounds its messages to bf16, the plain
# version sums in f32).
BF16_TABLE_TOL = dict(rtol=0.1, atol=0.5)
MIN_COSINE = 0.999


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("v,e,n_layers,phi_window,seed", [
    (16384, 131072, 8, 128, 0), (512, 2048, 8, 128, 0),
    (1000, 777, 5, 16, 3), (64, 300, 4, 8, 11), (15848, 180736, 8, 128, 1)])
def test_layered_graph_equals_the_tpu_probe(v, e, n_layers, phi_window,
                                            seed):
    got = common.layered_graph(v, e, n_layers, phi_window, seed)
    want = jprobe_spmm.layered_graph(v, e, n_layers, phi_window, seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _iter_case(dtype=np.float32, v=512, e=2048, d=16, hd=16):
    """The TPU probe's inputs at a small size (``benchmarks/
    probe_iter.py``'s seeds), its plans (tile 256, 8 boundaries) and the
    edge scores in edge order."""
    rng = np.random.default_rng(0)
    s, r = common.layered_graph(v, e)
    h = rng.standard_normal((v, d)).astype(np.float32)
    pa = rng.standard_normal((v, hd)).astype(np.float32)
    pb = rng.standard_normal((v, hd)).astype(np.float32)
    w2 = rng.standard_normal(hd).astype(np.float32)
    b1 = rng.standard_normal(hd).astype(np.float32)
    b2 = rng.standard_normal(1).astype(np.float32)
    rng = np.random.default_rng(1)
    gmi = rng.standard_normal((v, d)).astype(np.float32)
    gmo = rng.standard_normal((v, d)).astype(np.float32)
    if dtype != np.float32:   # the tables as the JAX probe casts them
        h, pa, pb, gmi, gmo = (np.asarray(jnp.asarray(a).astype(dtype)
                                          .astype(jnp.float32))
                               for a in (h, pa, pb, gmi, gmo))
    em = np.ones(e, np.float32)
    sig = tsp.edge_scores_reference(*map(_t, (pa, pb, em, w2, b1, b2, s,
                                                 r))).numpy()
    return dict(v=v, e=e, s=s, r=r, h=h, pa=pa, pb=pb, w2=w2, b1=b1, b2=b2,
                gmi=gmi, gmo=gmo, em=em, sig=sig)


def _stash_bwd_jax(c, sig, dtype):
    """``benchmarks.probe_iter._stash_bwd`` in interpret mode on ``c`` with
    the edge scores ``sig`` (edge order)."""
    plans = jsp.build_agg_plans(c["s"], c["r"], c["v"], tile_e=256,
                                boundaries=np.arange(0, c["v"] + 1,
                                                     c["v"] // 8))
    plan = plans.recv
    order = np.asarray(plan.order)
    real = order < c["e"]      # the plan's pad slots take no score
    sig_sorted = np.where(real, sig[np.minimum(order, c["e"] - 1)], 0)
    tab = lambda k: jnp.asarray(c[k]).astype(dtype)
    with pltpu.force_tpu_interpret_mode():
        out = jprobe_iter._stash_bwd(
            tab("pa"), tab("pb"), tab("h"),
            jsp.sort_edge_weights(jnp.asarray(c["em"]), plan),
            jnp.asarray(sig_sorted.astype(np.float32)), jnp.asarray(c["w2"]),
            jnp.asarray(c["b1"]), plan, tab("gmi"), tab("gmo"))
    return [np.asarray(o, np.float32) for o in out]


def _stashed_plain(c, sig):
    return [t.numpy() for t in tsp.iteration_pair_bwd_stashed_reference(
        *map(_t, (c["pa"], c["pb"], c["h"], c["em"], c["w2"], c["b1"], sig,
                  c["gmi"], c["gmo"], c["s"], c["r"])), c["v"])]


def _cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float((a * b).sum() / max(np.linalg.norm(a) * np.linalg.norm(b),
                                     1e-9))


def _assert_backwards_agree(got, want, bf16):
    for g, w in zip(got, want):
        g = np.reshape(g, np.shape(w))
        if not bf16:
            np.testing.assert_allclose(g, w, **F32_TOL)
        elif np.ndim(w) >= 2:
            np.testing.assert_allclose(g, w, **BF16_TABLE_TOL)
        else:
            assert _cosine(g, w) > MIN_COSINE


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_stashed_backward_matches_the_tpu_probe(dtype):
    c = _iter_case(dtype)
    want = _stash_bwd_jax(c, c["sig"], dtype)
    _assert_backwards_agree(_stashed_plain(c, c["sig"]), want,
                            dtype != np.float32)


def test_stashed_backward_reads_the_scores():
    """Scores other than the forward's, given to both sides, move both
    alike: the plain version reads them rather than recomputing them."""
    c = _iter_case()
    sig = np.random.default_rng(5).uniform(0.05, 0.95, c["e"]).astype(
        np.float32)
    got = _stashed_plain(c, sig)
    _assert_backwards_agree(got, _stash_bwd_jax(c, sig, np.float32), False)
    own = _stashed_plain(c, c["sig"])
    assert all(not np.allclose(a, b, **F32_TOL) for a, b in zip(got, own))
    # the production wrapper's CPU path reads the scores it is given
    plans = tsp.build_agg_plans(c["s"], c["r"], c["v"])
    em = tsp.sort_edge_weights(_t(c["em"]), plans.recv)
    wrapped = tsp.iteration_pair_bwd(
        *map(_t, (c["pa"], c["pb"], c["h"])), em,
        *map(_t, (c["w2"], c["b1"], c["b2"], c["gmi"], c["gmo"])), plans,
        tsp.sort_edge_weights(_t(sig), plans.recv))
    _assert_backwards_agree([t.numpy() for t in wrapped], got, False)


def test_recompute_backward_is_the_reference_and_the_jax_vjp():
    """The recompute variant's plain version is the production plain
    version, and both match the JAX production backward (which recomputes
    the scores) and the stashed form given the forward's scores."""
    c = _iter_case()
    plans = tsp.build_agg_plans(c["s"], c["r"], c["v"])
    recv = plans.recv
    em = tsp.sort_edge_weights(_t(c["em"]), recv)
    args = tuple(map(_t, (c["pa"], c["pb"], c["h"]))) + (em,) + tuple(
        map(_t, (c["w2"], c["b1"], c["b2"], c["gmi"], c["gmo"])))
    got = probes.iteration_pair_bwd_recompute(*args, plans)
    ref = tsp.iteration_pair_bwd_reference(*args, recv.sorted_oth,
                                           recv.sorted_seg, c["v"])
    for g, w in zip(got, ref):
        assert torch.equal(g, w.reshape(g.shape))
    jplans = jsp.build_agg_plans(c["s"], c["r"], c["v"], tile_e=256,
                                 boundaries=np.arange(0, c["v"] + 1,
                                                      c["v"] // 8))
    with pltpu.force_tpu_interpret_mode():
        want = jsp._iter_pair_bwd_call(
            *(jnp.asarray(c[k]) for k in ("pa", "pb", "h")),
            jsp.sort_edge_weights(jnp.asarray(c["em"]), jplans.recv),
            *(jnp.asarray(c[k]) for k in ("w2", "b1", "b2", "gmi", "gmo")),
            jplans.recv)
    _assert_backwards_agree([g.numpy() for g in got],
                            [np.asarray(w) for w in want], False)
    sig = tsp.edge_scores_reference(
        *args[:2], em, *args[4:7], recv.sorted_oth, recv.sorted_seg)
    stashed = tsp.iteration_pair_bwd(*args, plans, sig)
    for g, w in zip(stashed, got):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def _ablation_numpy(h, w, seg, oth, n_node, mode):
    """The ablation's modes in numpy float64, edge by edge in edge order
    (the sums' order does not matter at the tolerance)."""
    order = np.argsort(seg, kind="stable")
    w_s, oth_s, seg_s = w[order], oth[order], seg[order]
    e = len(seg)
    n_groups = -(-e // probes.ABLATE_GROUP)
    group = np.arange(e) // probes.ABLATE_GROUP
    if mode == "ids_only":
        out = np.zeros((n_groups, 2))
        np.add.at(out, group, np.stack([w_s, oth_s], 1))
        return out
    rows = h[np.arange(e) % probes.STATIC_ROWS] \
        if mode in ("no_gather", "compute") else h[oth_s]
    msgs = rows.astype(np.float64) * w_s[:, None]
    by_group = mode in ("no_scatter", "compute")
    out = np.zeros((n_groups if by_group else n_node, h.shape[1]))
    np.add.at(out, group if by_group else seg_s, msgs)
    return out


def _ablation_graph(kind, v=700, e=5000, d=10):
    rng = np.random.default_rng(7)
    if kind == "layered":
        s, r = common.layered_graph(v, e)
    else:   # a hub of 1,120 edges and nodes without edges
        s = rng.integers(0, v - 50, e).astype(np.int32)
        r = rng.integers(0, v - 50, e).astype(np.int32)
        r[:1120] = 3
    return (s, r, rng.standard_normal((v, d)).astype(np.float32),
            rng.standard_normal(e).astype(np.float32))


@pytest.mark.parametrize("kind", ["layered", "hub"])
@pytest.mark.parametrize("mode", probes.ABLATION_MODES)
def test_ablation_plain_versions_match_numpy(kind, mode):
    s, r, h, w = _ablation_graph(kind)
    v = h.shape[0]
    plan = tsp.build_edge_plan(r, s, v)   # seg = receivers, as the probe
    want = _ablation_numpy(h, w, r, s, v, "full" if mode == "aligned"
                           else mode)
    if mode == "aligned":
        table = probes.pad_rows(_t(h))
        assert table.shape[1] == 12 and torch.equal(table[:, :10], _t(h))
        assert (table[:, 10:] == 0).all()
        got = probes.ablate_rows(table, _t(w), plan, mode, width=10)
    else:
        got = probes.ablate_rows(_t(h), _t(w), plan, mode)
        ref = probes.ablate_rows_reference(_t(h), _t(w), plan, mode)
        assert torch.equal(got, ref)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kind", ["layered", "hub"])
def test_ablation_full_matches_jax_spmm(kind):
    s, r, h, w = _ablation_graph(kind, v=300, e=1536, d=16)
    v = h.shape[0]
    jplan = jsp.build_agg_plans(s, r, v, tile_e=32).recv
    with pltpu.force_tpu_interpret_mode():
        want = jsp._spmm_raw(jnp.asarray(h), jnp.asarray(w), jplan)
    plan = tsp.build_edge_plan(r, s, v)
    for mode, table, width in (("full", _t(h), None),
                               ("aligned", probes.pad_rows(_t(h)), 16)):
        got = probes.ablate_rows(table, _t(w), plan, mode, width=width)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
    assert torch.equal(probes.ablate_rows(_t(h), _t(w), plan, "full"),
                       tsp.spmm_raw(_t(h), _t(w), plan))


def test_ablation_refuses_what_it_does_not_take():
    s, r, h, w = _ablation_graph("layered", v=300, e=500, d=8)
    plan = tsp.build_edge_plan(r, s, 300)
    with pytest.raises(ValueError, match="unknown mode"):
        probes.ablate_rows(_t(h), _t(w), plan, "onehot")
    with pytest.raises(ValueError, match="width"):
        probes.ablate_rows(_t(h), _t(w), plan, "aligned")
    with pytest.raises(ValueError, match="width"):
        probes.ablate_rows(_t(h), _t(w), plan, "full", width=8)


def _bits(a) -> np.ndarray:
    """The bits of a JAX or torch array (bf16 as uint16)."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16).numpy().view(np.uint16)
                if a.dtype == torch.bfloat16 else a.numpy())
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_copy_and_gather_plain_versions_equal_jax_bit_for_bit(dtype):
    rng = np.random.default_rng(0)
    v, e, d = 300, 1000, 24
    h = rng.standard_normal((v, d)).astype(np.float32)
    x = rng.standard_normal((e, d)).astype(np.float32) * 1e3
    idx = rng.integers(0, v, e).astype(np.int32)
    tdt = getattr(torch, dtype)
    jh, jx = (jnp.asarray(a).astype(dtype) for a in (h, x))
    th, tx = _t(h).to(tdt), _t(x).to(tdt)
    for got, want in ((probes.passthrough(tx), jx * 2.0),
                      (probes.passthrough(tx, 1), jx * 2.0),
                      (probes.gather_rows(th, _t(idx)),
                       jnp.take(jh, jnp.asarray(idx), axis=0))):
        assert got.dtype == tdt
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_timed_chains_every_call_on_the_whole_output():
    """Each call sees the first argument perturbed by 1e-30 times the sum
    of the whole previous output: an output whose only nonzero element is
    its last still moves the next call's input, call after call."""
    seen = []

    def op(x, k):
        seen.append(float(x[0, 0]))
        out = torch.zeros(5, dtype=torch.float64)
        out[-1] = 1e30 * k
        return out

    x = torch.zeros((2, 3), dtype=torch.float64)
    t = common.timed(op, (x, 2.0), n_iters=4, n_reps=2)
    assert t > 0
    assert len(seen) == 4 * 3                  # a warm run and 2 reps
    # c = 2e30 after each call: the input grows by 2 every call
    assert seen == [2.0 * i for i in range(12)]
    assert float(x[0, 0]) == 0.0               # the caller's tensor is kept


def test_timed_sums_tuples_and_runs_a_plain_op():
    calls = []
    t = common.timed(lambda a, b: (calls.append(1) or a * 2, b),
                     (torch.ones(4), torch.ones(3)), n_iters=3, n_reps=1)
    assert t > 0 and len(calls) == 6


BW_ROWS = ["torch x*2 f32", "torch x*2 bf16", "cuda passthrough vectors=1",
           "cuda passthrough vectors=2", "cuda passthrough vectors=4",
           "matmul f32 32x32", "matmul bf16 32x32"]
OPS_ROWS = ["gather random idx", "gather sorted idx", "segment_sum random",
            "segment_sum sorted", "torch gather*w+segsum",
            "cuda sorted_segment_sum", "cuda passthrough vectors=1",
            "cuda passthrough vectors=2", "cuda passthrough vectors=4",
            "cuda gather_rows (correct=True)"]


def _labels(out):
    return [line for line in out.splitlines() if not line.startswith("#")]


def test_bw_probe_prints_its_rows(capsys, monkeypatch):
    monkeypatch.setattr(bw, "MATMUL_SIZES", (32,))
    monkeypatch.setattr(bw, "N_ITERS", 2)
    bw.main(["--e", "256", "--d", "16", "--device", "cpu"])
    lines = _labels(capsys.readouterr().out)
    assert len(lines) == len(BW_ROWS)
    for line, row in zip(lines, BW_ROWS):
        assert line.startswith(row) and " us " in line
    assert "(no card peak)" in lines[-1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_probe_prints_its_rows(capsys, monkeypatch, dtype):
    monkeypatch.setattr(ops, "N_ITERS", 2)
    ops.main(["--v", "200", "--e", "600", "--d", "8", "--dtype", dtype,
              "--device", "cpu"])
    lines = _labels(capsys.readouterr().out)
    assert len(lines) == len(OPS_ROWS)
    for line, row in zip(lines, OPS_ROWS):
        assert line.startswith(row) and "GB/s" in line


def test_spmm_ablate_probe_prints_every_mode(capsys, monkeypatch):
    for name, value in (("V", 512), ("E", 3000), ("N_ITERS", 2), (
            "CASES", ((8, torch.bfloat16), (66, torch.bfloat16),
                      (66, torch.float32)))):
        monkeypatch.setattr(spmm_ablate, name, value)
    spmm_ablate.main(["--device", "cpu"])
    out = capsys.readouterr().out
    heads = [line for line in out.splitlines() if line.startswith("#")]
    assert len(heads) == 3 and all(h.endswith("bit for bit: True")
                                   for h in heads)
    assert "D=66 (pitch 68 aligned) dtype=float32" in heads[-1]
    lines = _labels(out)
    want = ["spmm_raw (production)"] + list(spmm_ablate.ROWS.values())
    assert [line[:52].rstrip() for line in lines] == want * 3
    assert all("Medge/s" in line for line in lines)


def _small_iter_shapes(monkeypatch):
    monkeypatch.setattr(iter_probe, "SHAPES", {
        "probe": ((256, 1024, 8, 8),), "bench": ((300, 1500, 12, 8),)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_iter_probe_prints_its_rows(capsys, monkeypatch, dtype):
    _small_iter_shapes(monkeypatch)
    iter_probe.main(["--iters", "2", "--dtype", dtype, "--device", "cpu"])
    lines = _labels(capsys.readouterr().out)
    names = ["plain chain", "unfused cuda", "fused iteration",
             "fused pre:int8"]
    assert len(lines) == 4
    for line, name in zip(lines, names):
        assert line.startswith(f"V=   256 D=   8 {name}")
    assert "fwd+bwd" in lines[0] and "absent" in lines[-1]
    iter_probe.main(["--iters", "2", "--dtype", dtype, "--device", "cpu",
                     "--only", "fused iteration"])
    assert len(_labels(capsys.readouterr().out)) == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_iter_probe_ablates_the_stash(capsys, monkeypatch, dtype):
    _small_iter_shapes(monkeypatch)
    iter_probe.main(["--iters", "2", "--dtype", dtype, "--device", "cpu",
                     "--ablate-stash", "--shape", "bench"])
    lines = _labels(capsys.readouterr().out)
    assert len(lines) == 1 and lines[0].startswith("V=   300 D=  12")
    assert "bwd recompute" in lines[0] and "bwd stashed-scores" in lines[0]
    assert "% saved" in lines[0] and "parameter-sum cosine" in lines[0]


def test_iter_probe_instrument_check_fails_on_a_wrong_backward():
    ref = (torch.ones(4, 3), torch.ones(5))
    iter_probe.check_instrument(ref, ref, torch.float32)
    with pytest.raises(AssertionError):
        iter_probe.check_instrument(ref, (ref[0] * 1.1, ref[1]),
                                    torch.float32)
    with pytest.raises(AssertionError):
        iter_probe.check_instrument(ref, (ref[0], -ref[1]), torch.bfloat16)


@pytest.mark.parametrize("probe", [bw, ops, spmm_ablate, iter_probe])
def test_probes_raise_without_a_card(probe):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the card-less case")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main([])
