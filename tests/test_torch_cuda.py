"""CUDA kernels of the port against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from gnn_fpga_tpu_torch.core import graph as tg
from gnn_fpga_tpu_torch.models import mpnn as tm
from gnn_fpga_tpu_torch.ops.cuda import segment_sum as tss
from gnn_fpga_tpu_torch.ops.cuda import spmm as tsp

pytestmark = pytest.mark.cuda

# |kernel - plain| <= atol + rtol * |plain|; as in chip_smoke.py:
# f32: summation order only; bf16: one output rounding (2^-8), doubled.
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
       torch.bfloat16: dict(rtol=8e-3, atol=1e-4)}
# The parameter sums of the iteration backward (dw2, db1, db2) add a term
# per edge, and the terms cancel: a reordered f32 sum errs in proportion
# to the terms, not to the result, so their atol scales with the largest
# entry of the plain result.
PARAM_SUM_ATOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(seed, v, e, d, hdim, dev, dtype):
    """Random tables; the last 20 edges are masked pad edges on node v-1,
    and nodes above v*3//4 have no edges."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, v * 3 // 4, e).astype(np.int32)
    r = rng.integers(0, v * 3 // 4, e).astype(np.int32)
    s[-20:] = r[-20:] = v - 1
    em = np.ones(e, np.float32)
    em[-20:] = 0
    t = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
    plans = tsp.build_agg_plans(s, r, v).to(dev)
    em = torch.from_numpy(em).to(dev)
    return dict(pa=t(v, hdim), pb=t(v, hdim), h=t(v, d), w2=t(hdim),
                b1=t(hdim), b2=t(1), em=em,
                ems=tsp.sort_edge_weights(em, plans.recv),
                w=torch.rand(e, device=dev) * em, plans=plans, v=v,
                s=torch.from_numpy(s).to(dev), r=torch.from_numpy(r).to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,hdim", [(66, 64), (10, 12), (200, 40)])
def test_kernels_match_plain_versions(dev, dtype, d, hdim):
    c = _case(19, 300, 2048, d, hdim, dev, dtype)
    n_it, n_agg = tsp.iteration_pair.launches, tsp.aggregate_pair.launches
    got = tsp.iteration_pair(c["pa"], c["pb"], c["h"], c["ems"], c["w2"],
                             c["b1"], c["b2"], c["plans"])
    want = tsp.iteration_pair_reference(
        c["pa"], c["pb"], c["h"], c["em"], c["w2"], c["b1"], c["b2"],
        c["s"], c["r"], c["v"])
    got_a = tsp.aggregate_pair(c["h"], c["w"], c["plans"])
    want_a = tsp.aggregate_pair_reference(c["h"], c["w"], c["s"], c["r"],
                                          c["v"])
    torch.cuda.synchronize()
    assert tsp.iteration_pair.launches == n_it + 1
    assert tsp.aggregate_pair.launches == n_agg + 1
    for g, r in zip(got + got_a, want + want_a):
        assert g.dtype == dtype and g.shape == (c["v"], d)
        torch.testing.assert_close(g.float(), r.float(), **TOL[dtype])
    # nodes without edges get zero rows, not uninitialised memory
    assert (got[0][c["v"] * 3 // 4:-1] == 0).all()


def test_kernel_results_are_deterministic(dev):
    c = _case(20, 500, 4096, 66, 64, dev, torch.bfloat16)
    run = lambda: tsp.iteration_pair(c["pa"], c["pb"], c["h"], c["ems"],
                                     c["w2"], c["b1"], c["b2"], c["plans"])
    a, b = run(), run()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_forward_on_kernel_route_matches_sparse_route(dev):
    rng = np.random.default_rng(22)
    v, e = 200, 1024
    x = rng.normal(size=(v, 3)).astype(np.float32)
    s = rng.integers(0, v - 1, e).astype(np.int32)
    r = rng.integers(0, v - 1, e).astype(np.int32)
    g = tg.attach_plans(tg.pad_graph(
        tg.from_coo(x, s, r, np.zeros(e, np.float32)), v + 1, e + 64)).to(dev)
    cfg = tm.SegmentClassifierConfig(input_dim=3, hidden_dim=16, n_iters=3,
                                     aggregation="pallas")
    model = tm.init_segment_classifier(cfg, torch.Generator().manual_seed(0),
                                       device=dev)
    sparse = tm.SegmentClassifier(dataclasses.replace(cfg,
                                                      aggregation="sparse"),
                                  torch.Generator(), device=dev)
    sparse.load_state_dict(model.state_dict())
    n0 = tsp.iteration_pair.launches
    with torch.inference_mode():
        got, want = model(g), sparse(g)
    assert tsp.iteration_pair.launches == n0 + cfg.n_iters
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def _grads(c, dev, dtype, e):
    rng = np.random.default_rng(23)
    t = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
    v, d = c["h"].shape
    return t(v, d), t(v, d), t(e, c["pa"].shape[1])


def _bwd_runs(c, g_mi, g_mo, g):
    """The three backward kernels and their plain versions, as pairs of
    output tuples."""
    p = c["plans"]
    ip = tsp.iteration_pair_bwd(c["pa"], c["pb"], c["h"], c["ems"], c["w2"],
                                c["b1"], c["b2"], g_mi, g_mo, p)
    ip_ref = tsp.iteration_pair_bwd_reference(
        c["pa"], c["pb"], c["h"], c["em"], c["w2"], c["b1"], c["b2"], g_mi,
        g_mo, c["s"], c["r"], c["v"])
    ag = tsp.aggregate_pair_bwd(c["h"], c["w"], g_mi, g_mo, p)
    ag_ref = tsp.aggregate_pair_bwd_reference(c["h"], c["w"], g_mi, g_mo,
                                              c["s"], c["r"], c["v"])
    gp = tsp.gather_pair_bwd(g, p)
    gp_ref = tsp.gather_pair_bwd_reference(g, c["s"], c["r"], c["v"])
    return ((ip, ip_ref), (ag, ag_ref), (gp, gp_ref))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,hdim", [(66, 64), (10, 12), (200, 40)])
def test_backward_kernels_match_plain_versions(dev, dtype, d, hdim):
    c = _case(24, 300, 2048, d, hdim, dev, dtype)
    g_mi, g_mo, g = _grads(c, dev, dtype, 2048)
    n0 = tsp.launch_counts()
    runs = _bwd_runs(c, g_mi, g_mo, g)
    torch.cuda.synchronize()
    n1 = tsp.launch_counts()
    for name in ("iteration_pair_bwd", "aggregate_pair_bwd",
                 "gather_pair_bwd"):
        assert n1[name] == n0[name] + 1, name
    (ip, ip_ref), (ag, ag_ref), (gp, gp_ref) = runs
    for got, ref in zip(ip[:3] + ag[:1] + gp, ip_ref[:3] + ag_ref[:1] + gp_ref):
        assert got.dtype == dtype and got.shape == ref.shape
        torch.testing.assert_close(got.float(), ref, **TOL[dtype])
    for got, ref in zip(ip[3:], ip_ref[3:]):
        assert got.dtype == dtype
        torch.testing.assert_close(
            got.float().reshape(ref.shape), ref, rtol=TOL[dtype]["rtol"],
            atol=PARAM_SUM_ATOL[dtype] * ref.abs().max().item())
    assert ag[1].dtype == torch.float32
    torch.testing.assert_close(ag[1], ag_ref[1], **TOL[torch.float32])
    # nodes without edges get zero rows, not uninitialised memory
    assert (ip[0][c["v"] * 3 // 4:-1] == 0).all()
    assert (gp[0][c["v"] * 3 // 4:-1] == 0).all()


def test_backward_kernels_are_deterministic(dev):
    c = _case(25, 500, 4096, 66, 64, dev, torch.bfloat16)
    g_mi, g_mo, g = _grads(c, dev, torch.bfloat16, 4096)
    a, b = _bwd_runs(c, g_mi, g_mo, g), _bwd_runs(c, g_mi, g_mo, g)
    for (ka, _), (kb, _) in zip(a, b):
        for x, y in zip(ka, kb):
            assert torch.equal(x, y)


@pytest.mark.parametrize("fused", [True, False])
def test_model_gradients_on_kernel_route_match_sparse_route(dev, fused):
    from gnn_fpga_tpu_torch.train.trainer import masked_bce_with_logits

    rng = np.random.default_rng(26)
    v, e = 200, 1024
    x = rng.normal(size=(v, 3)).astype(np.float32)
    s = rng.integers(0, v - 1, e).astype(np.int32)
    r = rng.integers(0, v - 1, e).astype(np.int32)
    y = (rng.random(e) < 0.3).astype(np.float32)
    g = tg.attach_plans(tg.pad_graph(tg.from_coo(x, s, r, y),
                                     v + 1, e + 64)).to(dev)
    cfg = tm.SegmentClassifierConfig(input_dim=3, hidden_dim=16, n_iters=3,
                                     aggregation="pallas",
                                     fused_iteration=fused)
    model = tm.init_segment_classifier(cfg, torch.Generator().manual_seed(1),
                                       device=dev)
    sparse = tm.SegmentClassifier(dataclasses.replace(cfg,
                                                      aggregation="sparse"),
                                  torch.Generator(), device=dev)
    sparse.load_state_dict(model.state_dict())
    n0 = tsp.launch_counts()
    for m in (model, sparse):
        masked_bce_with_logits(m(g), g.y, g.edge_mask, 8.0).backward()
    n1 = tsp.launch_counts()
    bwd = "iteration_pair_bwd" if fused else "aggregate_pair_bwd"
    assert n1[bwd] == n0[bwd] + cfg.n_iters
    assert n1["gather_pair_bwd"] == (n0["gather_pair_bwd"] + 1
                                     + (0 if fused else cfg.n_iters))
    for (name, a), b in zip(model.named_parameters(), sparse.parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=2e-3, atol=1e-5,
                                   msg=name)


# ---------------------------------------------------------------------------
# The single-direction kernels (csrc/spmm_ops.cu)
# ---------------------------------------------------------------------------

def _ops_case(seed, width, dev, dtype, v=300, e=2048):
    """Tables of ``width`` columns over a topology whose nodes above
    v*3//4 have no edges, and ~5% pad ids (== v) for the segment sum."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, v * 3 // 4, e).astype(np.int32)
    r = rng.integers(0, v * 3 // 4, e).astype(np.int32)
    ids = r.copy()
    ids[rng.random(e) < 0.05] = v
    t = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
    return dict(plans=tsp.build_agg_plans(s, r, v).to(dev), v=v,
                seg=tss.build_sorted_segments(ids, v).to(dev),
                ids=torch.from_numpy(ids).to(dev),
                s=torch.from_numpy(s).to(dev), r=torch.from_numpy(r).to(dev),
                w=torch.rand(e, device=dev), a=t(v, width), b=t(v, width),
                u=t(v, width), vv=t(v, width), m=t(e, width))


def _ops_runs(c, precision="highest"):
    """(kernel outputs, plain outputs) of the four kernels."""
    p = c["plans"]
    m_sorted = c["m"].index_select(0, c["seg"].order.long())
    got = (tsp.spmm_raw(c["a"], c["w"], p.recv),
           tsp.sddmm(c["a"], c["b"], p.recv),
           tsp.sddmm_dual(c["a"], c["b"], c["u"], c["vv"], p.recv),
           tss.sorted_segment_sum(m_sorted, c["seg"], c["v"], precision))
    m_plain = c["m"] if precision == "highest" else c["m"].bfloat16()
    want = (tsp.spmm_reference(c["a"], c["w"], c["r"], c["s"], c["v"]),
            tsp.sddmm_reference(c["a"], c["b"], c["r"], c["s"]),
            tsp.sddmm_dual_reference(c["a"], c["b"], c["u"], c["vv"],
                                     c["r"], c["s"]),
            tss.segment_sum_reference(m_plain, c["ids"], c["v"]))
    return got, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [1, 33, 66, 256])
def test_ops_kernels_match_plain_versions(dev, dtype, width):
    c = _ops_case(30, width, dev, dtype)
    n0 = tsp.launch_counts()
    got, want = _ops_runs(c)
    torch.cuda.synchronize()
    n1 = tsp.launch_counts()
    for name in ("spmm", "sddmm", "sddmm_dual", "sorted_segment_sum"):
        assert n1[name] == n0[name] + 1, name
    (sp, sd, sdd, ss), (sp_r, sd_r, sdd_r, ss_r) = got, want
    for g, r in ((sp, sp_r), (ss, ss_r)):          # [V, width] in T
        assert g.dtype == dtype and g.shape == (c["v"], width)
        torch.testing.assert_close(g.float(), r, **TOL[dtype])
    for g, r in ((sd, sd_r), (sdd, sdd_r)):        # [E] f32 from T tables
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, r, **TOL[torch.float32])
    # nodes without edges get zero rows, not uninitialised memory
    assert (sp[c["v"] * 3 // 4:] == 0).all()
    assert (ss[c["v"] * 3 // 4:] == 0).all()


def test_segment_sum_default_precision_rounds_to_bf16(dev):
    c = _ops_case(31, 66, dev, torch.float32)
    got, want = _ops_runs(c, "default")
    torch.testing.assert_close(got[3], want[3], **TOL[torch.float32])
    exact = _ops_runs(c)[0][3]
    assert not torch.allclose(got[3], exact, rtol=1e-6, atol=0)


def test_ops_kernels_are_deterministic(dev):
    c = _ops_case(32, 66, dev, torch.bfloat16, v=500, e=4096)
    a, b = _ops_runs(c)[0], _ops_runs(c)[0]
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_vjp_matches_plain_autograd(dev, dtype):
    c = _ops_case(33, 66, dev, dtype)
    p = c["plans"]
    g = torch.randn(c["v"], 66, device=dev).to(dtype)
    h, w = c["a"].clone().requires_grad_(), c["w"].clone().requires_grad_()
    n0 = tsp.launch_counts()
    dh, dw = torch.autograd.grad(tsp.spmm(h, w, p.recv, p.send), (h, w), g)
    torch.cuda.synchronize()
    n1 = tsp.launch_counts()
    assert (n1["spmm"] - n0["spmm"], n1["sddmm"] - n0["sddmm"]) == (2, 1)
    h32 = c["a"].float().requires_grad_()
    w32 = c["w"].clone().requires_grad_()
    ref = tsp.spmm_reference(h32, w32, c["r"], c["s"], c["v"])
    dh_r, dw_r = torch.autograd.grad(ref, (h32, w32), g.float())
    assert dh.dtype == dtype and dw.dtype == torch.float32
    torch.testing.assert_close(dh.float(), dh_r, **TOL[dtype])
    torch.testing.assert_close(dw, dw_r, **TOL[torch.float32])
