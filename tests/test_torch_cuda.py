"""CUDA kernels of the port against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gnn_fpga_tpu_torch.core import graph as tg
from gnn_fpga_tpu_torch.models import mpnn as tm
from gnn_fpga_tpu_torch.ops.cuda import _build
from gnn_fpga_tpu_torch.ops.cuda import probes as tpr
from gnn_fpga_tpu_torch.ops.cuda import segment_sum as tss
from gnn_fpga_tpu_torch.ops.cuda import spmm as tsp
from gnn_fpga_tpu_torch.ops.segment import segment_sum

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
    n0 = _build.launch_counts()
    got = tsp.iteration_pair(c["pa"], c["pb"], c["h"], c["ems"], c["w2"],
                             c["b1"], c["b2"], c["plans"])
    want = tsp.iteration_pair_reference(
        c["pa"], c["pb"], c["h"], c["em"], c["w2"], c["b1"], c["b2"],
        c["s"], c["r"], c["v"])
    got_a = tsp.aggregate_pair(c["h"], c["w"], c["plans"])
    want_a = tsp.aggregate_pair_reference(c["h"], c["w"], c["s"], c["r"],
                                          c["v"])
    torch.cuda.synchronize()
    assert _build.launch_counts()["iteration_pair"] == n0["iteration_pair"] + 1
    assert _build.launch_counts()["aggregate_pair"] == n0["aggregate_pair"] + 1
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
    n0 = _build.launch_counts()["iteration_pair"]
    with torch.inference_mode():
        got, want = model(g), sparse(g)
    assert _build.launch_counts()["iteration_pair"] == n0 + cfg.n_iters
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
    args = (c["pa"], c["pb"], c["h"], c["ems"], c["w2"], c["b1"], c["b2"])
    sig = tsp.iteration_pair_fwd(*args, p)[2]
    ip = tsp.iteration_pair_bwd(*args, g_mi, g_mo, p, sig)
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
    for name in ("gather_pair", "gather_pair_bwd"):
        assert n1[name] == n0[name] + 1 + (0 if fused else cfg.n_iters), name
    for (name, a), b in zip(model.named_parameters(), sparse.parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=2e-3, atol=1e-5,
                                   msg=name)


# ---------------------------------------------------------------------------
# The fused iteration's kernels (csrc/iteration_fwd.cu, iteration_bwd.cu)
# ---------------------------------------------------------------------------

def _iter_case(seed, v, e, d, hdim, dev, dtype, hub=0, pad_only=False):
    """Random tables and output gradients over random edges on the first
    3/4 of the nodes, the last 20 edges masked pad edges on node v-1;
    ``hub`` more edges all received by node 0 and sent by node 1;
    ``pad_only``: every edge a masked pad edge on node v-1."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, max(v * 3 // 4, 1), e)
    r = rng.integers(0, max(v * 3 // 4, 1), e)
    em = np.ones(e, np.float32)
    pad = slice(0, e) if pad_only else slice(max(e - 20, 0), e)
    s[pad] = r[pad] = v - 1
    em[pad] = 0
    s = np.concatenate([s, np.full(hub, 1)]).astype(np.int32)
    r = np.concatenate([r, np.zeros(hub, np.int64)]).astype(np.int32)
    em = np.concatenate([em, np.ones(hub, np.float32)])
    t = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
    plans = tsp.build_agg_plans(s, r, v).to(dev)
    em = torch.from_numpy(em).to(dev)
    return dict(pa=t(v, hdim), pb=t(v, hdim), h=t(v, d), w2=t(hdim),
                b1=t(hdim), b2=t(1), g_mi=t(v, d), g_mo=t(v, d), em=em,
                ems=tsp.sort_edge_weights(em, plans.recv), plans=plans, v=v,
                s=torch.from_numpy(s).to(dev), r=torch.from_numpy(r).to(dev))


def _iter_runs(c):
    """((mi, mo), (dh, dpa, dpb, dw2, db1, db2)) of the kernels and of the
    plain versions."""
    args = [c[k] for k in ("pa", "pb", "h", "ems", "w2", "b1", "b2")]
    ref_args = [c["pa"], c["pb"], c["h"], c["em"]] + args[4:]
    ids = (c["s"], c["r"], c["v"])
    mi, mo, sig = tsp.iteration_pair_fwd(*args, c["plans"])
    return (((mi, mo),
             tsp.iteration_pair_bwd(*args, c["g_mi"], c["g_mo"], c["plans"],
                                    sig)),
            (tsp.iteration_pair_reference(*ref_args, *ids),
             tsp.iteration_pair_bwd_reference(*ref_args, c["g_mi"],
                                              c["g_mo"], *ids)))


def _check_iter(c, dtype):
    n0 = tsp.launch_counts()
    (fwd, bwd), (fwd_ref, bwd_ref) = _iter_runs(c)
    torch.cuda.synchronize()
    n1 = tsp.launch_counts()
    assert {k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]} == {
        "iteration_pair": 1, "iteration_pair_bwd": 1}
    for got, ref in zip(fwd + bwd[:3], fwd_ref + bwd_ref[:3]):
        assert got.dtype == dtype and got.shape == ref.shape
        torch.testing.assert_close(got.float(), ref, **TOL[dtype])
    for got, ref in zip(bwd[3:], bwd_ref[3:]):
        assert got.dtype == dtype
        torch.testing.assert_close(
            got.float().reshape(ref.shape), ref, rtol=TOL[dtype]["rtol"],
            atol=PARAM_SUM_ATOL[dtype] * ref.abs().max().item() + 1e-30)
    return fwd, bwd


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,hdim", [(1, 256), (8, 33), (33, 8), (66, 64),
                                    (64, 66), (256, 1)])
@pytest.mark.parametrize("hub", [0, 100])
def test_iteration_kernels_match_plain_versions(dev, dtype, d, hdim, hub):
    """Forward and backward against the plain versions at every width
    class (vector and scalar paths, 1 to 32 lanes an edge), without and
    with a hub of 100 edges (4 items on either side, the last partial)."""
    c = _iter_case(40, 300, 2048, d, hdim, dev, dtype, hub)
    assert (c["plans"].items.n_split > 0) == (hub > 0)
    fwd, bwd = _check_iter(c, dtype)
    # nodes without edges get zero rows, not uninitialised memory
    for t in fwd + bwd[:3]:
        assert (t[c["v"] * 3 // 4:-1] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["hub", "pad_only", "no_edges"])
def test_iteration_kernels_on_odd_graphs(dev, dtype, case):
    """A node that receives 1,500 edges from one node (47 items on either
    side), a graph of only masked pad edges, and a graph without edges."""
    kw = dict(hub=dict(hub=1500), pad_only=dict(pad_only=True),
              no_edges={})[case]
    c = _iter_case(41, 200, 0 if case == "no_edges" else 1024, 66, 64, dev,
                   dtype, **kw)
    fwd, bwd = _check_iter(c, dtype)
    if case != "hub":
        for t in fwd + bwd:
            assert not t.any()


def test_iteration_kernels_repeat_bit_for_bit(dev):
    """Two launches of each kernel give the same bits, split nodes and
    the f32 parameter sums included."""
    c = _iter_case(42, 500, 4096, 66, 64, dev, torch.bfloat16, hub=300)
    assert c["plans"].items.n_split > 0
    (fa, ba), _ = _iter_runs(c)
    (fb, bb), _ = _iter_runs(c)
    for x, y in zip(fa + ba, fb + bb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("hub", [0, 100])
def test_iteration_pair_autograd_matches_plain_autograd(dev, hub):
    """Gradients through torch.autograd of the kernel Function against
    autograd of the plain forward, in f32."""
    c = _iter_case(43, 300, 2048, 66, 64, dev, torch.float32, hub)
    names = ("pa", "pb", "h", "w2", "b1", "b2")
    outs = []
    for kernel in (True, False):
        a = {k: c[k].clone().requires_grad_() for k in names}
        if kernel:
            mi, mo = tsp.iteration_pair(a["pa"], a["pb"], a["h"], c["ems"],
                                        a["w2"], a["b1"], a["b2"],
                                        c["plans"])
        else:
            mi, mo = tsp.iteration_pair_reference(
                a["pa"], a["pb"], a["h"], c["em"], a["w2"], a["b1"],
                a["b2"], c["s"], c["r"], c["v"])
        outs.append(torch.autograd.grad((mi, mo), [a[k] for k in names],
                                        (c["g_mi"], c["g_mo"])))
    for name, got, want in zip(names, *outs):
        torch.testing.assert_close(
            got, want, rtol=1e-4,
            atol=1e-5 if name in ("pa", "pb", "h")
            else PARAM_SUM_ATOL[torch.float32] * want.abs().max().item(),
            msg=name)


# ---------------------------------------------------------------------------
# The gather forward (csrc/gather.cu) and the other heads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hdim", [1, 3, 16, 33, 64, 67, 256])
@pytest.mark.parametrize("aligned", [True, False])
def test_gather_pair_fwd_equals_plain_bit_for_bit(dev, dtype, hdim, aligned):
    """One rounding of the f32 sum, as the plain add: equal bit for bit.
    ``aligned=False`` offsets the tables by one element, which takes the
    scalar path whatever the width.  The widths give every lane-group size
    (1 to 32 lanes an edge) and rows longer than 32 items; 2001 edges leave
    a partial last block."""
    c = _case(27, 300, 2001, 8, hdim, dev, dtype)
    pa, pb = c["pa"], c["pb"]
    if not aligned:
        pa, pb = (torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)
                  for t in (pa, pb))
    n0 = _build.launch_counts()["gather_pair"]
    got = tsp.gather_pair_fwd(pa, pb, c["s"], c["r"])
    want = tsp.gather_pair_reference(pa, pb, c["s"], c["r"])
    torch.cuda.synchronize()
    assert _build.launch_counts()["gather_pair"] == n0 + 1
    assert got.dtype == dtype and got.shape == (2001, hdim)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", [-1, 300])
def test_gather_pair_fwd_stops_at_ids_outside_the_tables(dev, bad):
    """An id outside [0, V) stops the kernel at a device-side assert
    instead of reading past a table.  The assert loses the process's CUDA
    context, so the call runs in a child process."""
    code = (
        "import torch\n"
        "from gnn_fpga_tpu_torch.ops.cuda import spmm\n"
        "pa = torch.randn(300, 64, device='cuda')\n"
        "s = torch.zeros(2001, dtype=torch.int32, device='cuda')\n"
        f"s[1234] = {bad}\n"
        "spmm.gather_pair_fwd(pa, pa, s, s.flip(0).contiguous())\n"
        "torch.cuda.synchronize()\n"
        "print('no error')\n")
    root = Path(__file__).resolve().parents[1]
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0, p.stdout
    assert "device-side assert" in p.stderr, p.stderr[-2000:]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("head", ["unshared", "node"])
def test_heads_on_kernel_route_match_sparse_route(dev, head, fused):
    """Logits and parameter gradients of the other two heads on the kernel
    route against their sparse route, with the kernels each launches: the
    unshared head's output layer is one gather_pair, the node head has
    none; an unfused iteration is a gather_pair and an aggregate_pair."""
    from gnn_fpga_tpu_torch.train.trainer import masked_bce_with_logits

    rng = np.random.default_rng(28)
    v, e = 200, 1024
    x = rng.normal(size=(v, 3)).astype(np.float32)
    s = rng.integers(0, v - 1, e).astype(np.int32)
    r = rng.integers(0, v - 1, e).astype(np.int32)
    y = (rng.random(e) < 0.3).astype(np.float32)
    node_y = (rng.random(v) < 0.3).astype(np.float32)
    g = tg.attach_plans(tg.pad_graph(tg.from_coo(x, s, r, y, node_y),
                                     v + 1, e + 64)).to(dev)
    if head == "node":
        cfg = tm.NodeClassifierConfig(input_dim=3, hidden_dim=16, n_iters=3,
                                      aggregation="pallas",
                                      fused_iteration=fused)
        init, y, mask, n_out = (tm.init_node_classifier, g.node_y,
                                g.node_mask, 0)
    else:
        cfg = tm.SegmentClassifierConfig(input_dim=3, hidden_dim=16,
                                         n_iters=3, aggregation="pallas",
                                         fused_iteration=fused)
        init, y, mask, n_out = (tm.init_segment_classifier_unshared, g.y,
                                g.edge_mask, 1)
    model = init(cfg, torch.Generator().manual_seed(2), device=dev)
    sparse = type(model)(dataclasses.replace(cfg, aggregation="sparse"),
                         torch.Generator(), device=dev)
    sparse.load_state_dict(model.state_dict())
    n0 = tsp.launch_counts()
    logits = model(g)
    masked_bce_with_logits(logits, y, mask, 3.0).backward()
    torch.cuda.synchronize()
    n1 = tsp.launch_counts()
    want = sparse(g)
    masked_bce_with_logits(want, y, mask, 3.0).backward()
    n_iter = 0 if fused else cfg.n_iters
    it = cfg.n_iters - n_iter
    assert {k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]} == {
        k: n for k, n in dict(
            iteration_pair=it, iteration_pair_bwd=it,
            aggregate_pair=n_iter, aggregate_pair_bwd=n_iter,
            gather_pair=n_iter + n_out, gather_pair_bwd=n_iter + n_out,
        ).items() if n}
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-5)
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


# ---------------------------------------------------------------------------
# The lane-group row kernels: gather_pair_bwd (csrc/spmm_bwd.cu), spmm
# (csrc/spmm.cu), sddmm and sddmm_dual (csrc/spmm_ops.cu), rows read as in
# csrc/rows.cuh
# ---------------------------------------------------------------------------

ROW_WIDTHS = [1, 12, 40, 64, 66, 67, 256]


def _row_case(seed, v, e, width, dev, dtype, kind="random", order="recv",
              offset="none"):
    """Tables g [E, width] and a, b, u, w [V, width] over ``kind`` edges:
    ``random`` on the first 3/4 of the nodes (the rest have none) with 20
    pad edges on node v-1; ``dense`` the same on 24 nodes, ~e/24 edges a
    node each way; ``hub`` the same as ``random`` and 1,120 more that node 0
    receives from node 1; ``pad_only`` every edge on node v-1.  ``order``:
    edges receiver-major (the recv plan's order is the identity, so its
    side reads g in order) or ``shuffled`` (both sides read g scattered).
    ``offset``: the tables as allocated, as a row slice of a larger
    contiguous table (``row``), or one element into one (``element``:
    every base address off 16-byte alignment)."""
    rng = np.random.default_rng(seed)
    hi = 24 if kind == "dense" else v * 3 // 4
    s = rng.integers(0, hi, e)
    r = rng.integers(0, hi, e)
    pad = slice(0, e) if kind == "pad_only" else slice(e - 20, e)
    s[pad] = r[pad] = v - 1
    if kind == "hub":
        s = np.concatenate([s, np.full(1120, 1)])
        r = np.concatenate([r, np.zeros(1120, np.int64)])
    perm = (np.argsort(r, kind="stable") if order == "recv"
            else rng.permutation(len(s)))
    s, r = s[perm].astype(np.int32), r[perm].astype(np.int32)

    def table(rows):
        t = rng.standard_normal((rows + 1, width)).astype(np.float32)
        t = torch.from_numpy(t).to(dev, dtype)
        if offset == "row":
            return t[1:]
        if offset == "element":
            return t.flatten()[1:rows * width + 1].view(rows, width)
        return t[:rows].contiguous()

    return dict(plans=tsp.build_agg_plans(s, r, v).to(dev), v=v,
                s=torch.from_numpy(s).to(dev), r=torch.from_numpy(r).to(dev),
                g=table(len(s)), a=table(v), b=table(v), u=table(v),
                w=table(v))


def _row_runs(c):
    """(kernel, plain) outputs of gather_pair_bwd (dpa, dpb), spmm over
    the recv plan (h = a, edge weights in [0, 1)), sddmm and sddmm_dual
    (four distinct tables), with the launches each wrapper counted.
    gather_pair_bwd's and spmm's plain sums are taken in f64: the hub's
    1,120-term sums cancel, and in f32 the plain version's atomics on the
    card differ from one run to the next by more than TOL there."""
    p = c["plans"]
    rng = np.random.default_rng(len(c["s"]))
    w = torch.from_numpy(rng.random(len(c["s"])).astype(np.float32)).to(
        c["a"].device)
    n0 = tsp.launch_counts()
    got = (tsp.gather_pair_bwd(c["g"], p)
           + (tsp.spmm_raw(c["a"], w, p.recv),
              tsp.sddmm(c["a"], c["b"], p.recv),
              tsp.sddmm_dual(c["a"], c["b"], c["u"], c["w"], p.recv)))
    torch.cuda.synchronize()
    n1 = tsp.launch_counts()
    assert {k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]} == {
        "gather_pair_bwd": 1, "spmm": 1, "sddmm": 1, "sddmm_dual": 1}
    g64, a64 = c["g"].double(), c["a"].double()
    spmm64 = segment_sum(a64[c["s"].long()] * w.double()[:, None],
                         c["r"].long(), c["v"])
    want = (tuple(segment_sum(g64, ids, c["v"]).float()
                  for ids in (c["s"], c["r"]))
            + (spmm64.float(),
               tsp.sddmm_reference(c["a"], c["b"], c["r"], c["s"]),
               tsp.sddmm_dual_reference(c["a"], c["b"], c["u"], c["w"],
                                        c["r"], c["s"])))
    return got, want


def _check_rows(c, dtype):
    got, want = _row_runs(c)
    v, width = c["v"], c["g"].shape[1]
    for x, y in zip(got[:3], want[:3]):               # [V, width] in T
        assert x.dtype == dtype and x.shape == (v, width)
        torch.testing.assert_close(x.float(), y, **TOL[dtype])
    for x, y in zip(got[3:], want[3:]):               # [E] f32 from T
        assert x.dtype == torch.float32 and x.shape == (len(c["s"]),)
        torch.testing.assert_close(x, y, **TOL[torch.float32])
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", ROW_WIDTHS)
@pytest.mark.parametrize("order", ["recv", "shuffled"])
@pytest.mark.parametrize("offset", ["none", "row", "element"])
def test_row_kernels_match_plain_versions(dev, dtype, width, order, offset):
    """Every item width (16 bytes down to one element: offset tables take
    the narrow items) and lane-group size, edges receiver-major and
    shuffled; nodes without edges get zero rows."""
    c = _row_case(50, 300, 2048, width, dev, dtype, order=order,
                  offset=offset)
    la = tsp.row_launch(width, dtype, _build.alignment(
        c["g"], c["a"], c["b"], c["u"], c["w"]))
    if offset == "element":
        assert la.item_bytes == dtype.itemsize
    dpa, dpb, out = _check_rows(c, dtype)[:3]
    lo = c["v"] * 3 // 4
    assert not dpa[lo:-1].any() and not dpb[lo:-1].any()
    assert not out[lo:-1].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["hub", "pad_only", "no_edges", "dense"])
def test_row_kernels_on_odd_graphs(dev, dtype, kind):
    """A node that receives 1,120 edges from one node (35 chunks of 32 in
    either direction), a graph of pad edges only, a graph without edges,
    and ~43 edges a node each way on 24 nodes (long segments
    everywhere)."""
    c = _row_case(51, 200, 0 if kind == "no_edges" else 1024, 66, dev,
                  dtype, kind="pad_only" if kind == "no_edges" else kind)
    dpa, dpb, out = _check_rows(c, dtype)[:3]
    if kind in ("pad_only", "no_edges"):
        assert not dpa[:-1].any() and not dpb[:-1].any()
        assert not out[:-1].any()


def test_row_kernels_repeat_bit_for_bit(dev):
    """Two launches give the same bits: no atomics, fixed-order sums."""
    for dtype in (torch.float32, torch.bfloat16):
        c = _row_case(52, 500, 4096, 66, dev, dtype, kind="hub",
                      order="shuffled")
        c["g"] = c["g"][:, :64].contiguous()
        a, b = _row_runs(c)[0], _row_runs(c)[0]
        for x, y in zip(a, b):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The aggregation kernels: aggregate_pair (csrc/spmm.cu) and its backward
# (csrc/spmm_bwd.cu), rows read as in csrc/rows.cuh; spmm (the forward's
# kernel over one plan) on the same graphs
# ---------------------------------------------------------------------------

def _agg_runs(c):
    """(kernel, plain) outputs of aggregate_pair (mi, mo), its backward
    (dh, dw) and spmm over the recv plan, with h = a, g_mi = b, g_mo = u
    and edge weights in [0, 1); the plain sums taken in f64, as the hub's
    1,120-term sums may cancel."""
    p, v = c["plans"], c["v"]
    s, r = c["s"].long(), c["r"].long()
    rng = np.random.default_rng(len(c["s"]))
    w = torch.from_numpy(rng.random(len(s)).astype(np.float32)).to(
        c["a"].device)
    n0 = tsp.launch_counts()
    got = (tsp.aggregate_pair(c["a"], w, p)
           + tsp.aggregate_pair_bwd(c["a"], w, c["b"], c["u"], p)
           + (tsp.spmm_raw(c["a"], w, p.recv),))
    torch.cuda.synchronize()
    n1 = tsp.launch_counts()
    assert {k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]} == {
        "aggregate_pair": 1, "aggregate_pair_bwd": 1, "spmm": 1}
    h, g_mi, g_mo = (c[k].double() for k in ("a", "b", "u"))
    w64 = w.double()[:, None]
    mi = segment_sum(h[s] * w64, r, v)
    mo = segment_sum(h[r] * w64, s, v)
    dh = segment_sum(g_mi[r] * w64, s, v) + segment_sum(g_mo[s] * w64, r, v)
    dw = (g_mi[r] * h[s]).sum(1) + (g_mo[s] * h[r]).sum(1)
    return got, tuple(t.float() for t in (mi, mo, dh, dw, mi))


def _check_agg(c, dtype):
    got, want = _agg_runs(c)
    v, width = c["v"], c["a"].shape[1]
    for name, x, y in zip(("mi", "mo", "dh", "dw", "spmm"), got, want):
        if name == "dw":                              # [E] f32 from T
            assert x.dtype == torch.float32 and x.shape == (len(c["s"]),)
            torch.testing.assert_close(x, y, **TOL[torch.float32], msg=name)
        else:                                         # [V, width] in T
            assert x.dtype == dtype and x.shape == (v, width)
            torch.testing.assert_close(x.float(), y, **TOL[dtype], msg=name)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [12, 64, 66])
@pytest.mark.parametrize("kind", ["random", "dense", "hub", "pad_only"])
@pytest.mark.parametrize("offset", ["none", "element"])
def test_aggregation_kernels_match_plain_versions(dev, dtype, width, kind,
                                                  offset):
    """Random edges on 3/4 of the nodes (the rest have none, 20 pad edges
    on node v-1), the same on 24 nodes (~85 edges a node each way: long
    segments everywhere), a 1,120-edge hub (a long segment each way,
    on two nodes), and pad edges only (one node, long both ways); tables
    as allocated or one element in (narrow items)."""
    c = _row_case(53, 300, 2048, width, dev, dtype, kind=kind,
                  order="shuffled", offset=offset)
    la = tsp.row_launch(width, dtype,
                        _build.alignment(c["a"], c["b"], c["u"]))
    if offset == "element":
        assert la.item_bytes == dtype.itemsize
    mi, mo, dh = _check_agg(c, dtype)[:3]
    if kind == "random":            # nodes without edges get zero rows
        lo = c["v"] * 3 // 4
        assert not mi[lo:-1].any() and not mo[lo:-1].any()
        assert not dh[lo:-1].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_aggregation_kernels_on_a_graph_without_edges(dev, dtype):
    c = _row_case(54, 200, 0, 66, dev, dtype, kind="pad_only")
    mi, mo, dh, dw, out = _check_agg(c, dtype)
    assert not mi.any() and not mo.any() and not dh.any() and not out.any()
    assert dw.shape == (0,)


def test_aggregation_kernels_repeat_bit_for_bit(dev):
    """Two launches give the same bits: no atomics, fixed-order sums, the
    recv row before the send row."""
    for dtype in (torch.float32, torch.bfloat16):
        c = _row_case(55, 500, 4096, 66, dev, dtype, kind="hub",
                      order="shuffled")
        a, b = _agg_runs(c)[0], _agg_runs(c)[0]
        for x, y in zip(a, b):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The sorted segment sum (csrc/segment_sum.cu): tiles of sorted rows staged
# in shared memory, cut nodes finished by a second launch
# ---------------------------------------------------------------------------

SEG_KINDS = ["padded", "degree_zero", "dense", "hub", "boundaries", "all_pad",
             "empty"]
# Segment lengths whose ends fall on tile boundaries of 8, 32, 128 and
# 256 rows, with empty nodes on boundaries
# (tests/test_torch_segment_order.py).
BOUNDARY_LENGTHS = [32, 16, 16, 64, 0, 0, 1, 31, 33, 31, 0, 32, 0, 256, 5,
                    251, 512, 3]


def _segment_ids(kind, seed, v=300, e=2048):
    """Segment ids and node count: random ids on 3/4 of the nodes, 160 rows
    on node v-1 and ~1% pad ids (``padded``); ids on half the nodes
    (``degree_zero``); on 24 nodes (``dense``); random ids and 1,120 more
    on node 0 (``hub``); the lengths of BOUNDARY_LENGTHS and 8 pad ids
    (``boundaries``); pad ids only (``all_pad``); none (``empty``)."""
    rng = np.random.default_rng(seed)
    if kind == "padded":
        ids = rng.integers(0, v * 3 // 4, e)
        ids[-160:] = v - 1
        ids[rng.random(e) < 0.01] = v
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
        ids = np.full(e, v)
    else:
        ids = np.zeros(0, int)
    return rng.permutation(ids).astype(np.int32), v


def _segment_case(kind, seed, width, dev, dtype, offset=0):
    """ids, node count, sorted segments, messages in edge order and their
    sorted copy; with ``offset`` the sorted copy is a view that many
    elements into a larger buffer."""
    ids, v = _segment_ids(kind, seed)
    seg = tss.build_sorted_segments(ids, v).to(dev)
    rng = np.random.default_rng(seed + 1)
    m = torch.from_numpy(rng.standard_normal((len(ids), width)).astype(
        np.float32)).to(dev, dtype)
    buf = torch.zeros(len(ids) * width + offset, device=dev, dtype=dtype)
    m_sorted = buf[offset:].view(len(ids), width)
    m_sorted.copy_(m.index_select(0, seg.order.long()))
    return dict(ids=torch.from_numpy(ids).to(dev), v=v, seg=seg, m=m,
                m_sorted=m_sorted)


def _check_segment_sum(c, dtype, precision="highest"):
    """The kernel against the plain sum in f64 (of the bf16-rounded
    messages under "default"), one launch counted; the hub's 1,120-term
    sums cancel, so the atol takes PARAM_SUM_ATOL times the largest
    sum."""
    n0 = _build.launch_counts()["sorted_segment_sum"]
    got = tss.sorted_segment_sum(c["m_sorted"], c["seg"], c["v"], precision)
    torch.cuda.synchronize()
    assert _build.launch_counts()["sorted_segment_sum"] == n0 + 1
    assert got.dtype == dtype and got.shape == (c["v"], c["m"].shape[1])
    m = c["m"].bfloat16() if precision == "default" else c["m"]
    want = segment_sum(m.double(), c["ids"].long(), c["v"]).float()
    atol = max(TOL[dtype]["atol"],
               PARAM_SUM_ATOL[dtype] * want.abs().max().item())
    torch.testing.assert_close(got.float(), want, rtol=TOL[dtype]["rtol"],
                               atol=atol)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("kind", SEG_KINDS)
def test_segment_sum_matches_plain_version(dev, dtype, precision, kind):
    c = _segment_case(kind, 60, 66, dev, dtype)
    got = _check_segment_sum(c, dtype, precision)
    counts = torch.bincount(c["ids"].long(), minlength=c["v"] + 1)[:c["v"]]
    assert not got[counts == 0].any()      # nodes without rows: zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [1, 12, 64, 66, 67, 256])
@pytest.mark.parametrize("rows", [8, 32, None])
def test_segment_sum_tiles_of_any_size(dev, dtype, width, rows,
                                       monkeypatch):
    """Tiles of 8 and 32 rows cut most segments (the second launch adds
    the pieces) and of the wrapper's own size, at widths whose rows are
    2 to 1,024 bytes, one or two columns a unit (67 is odd), on the
    boundary-aligned and hub graphs."""
    if rows is not None:
        monkeypatch.setattr(tss, "SEGSUM_TILE_ROWS", rows)
    for kind in ("boundaries", "hub"):
        _check_segment_sum(_segment_case(kind, 61, width, dev, dtype), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", ["row", "3 rows", "element"])
def test_segment_sum_on_a_view_off_16_byte_alignment(dev, dtype, offset):
    """Messages one or three rows into their buffer (at D = 66 a bf16 base
    on a 4-byte boundary, an f32 one on 8: two columns a unit) or one
    element in (one column a unit); the kernel's own copies take them,
    never the plain version."""
    elems = {"row": 66, "3 rows": 3 * 66, "element": 1}[offset]
    c = _segment_case("padded", 62, 66, dev, dtype, elems)
    assert c["m_sorted"].data_ptr() % 16 != 0
    la = tss.segment_launch(66, dtype, _build.alignment(c["m_sorted"]))
    assert la.unit == (1 if offset == "element" else 2)
    _check_segment_sum(c, dtype)


def test_segment_sum_repeats_bit_for_bit(dev):
    """Two launches give the same bits: no atomics, fixed-order sums, the
    cut nodes' partials in tile order."""
    for dtype in (torch.float32, torch.bfloat16):
        for kind in ("hub", "padded"):
            c = _segment_case(kind, 63, 66, dev, dtype)
            a = tss.sorted_segment_sum(c["m_sorted"], c["seg"], c["v"])
            b = tss.sorted_segment_sum(c["m_sorted"], c["seg"], c["v"])
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# gather_pair's forward (csrc/gather.cu) at the main path's width, an odd
# one and off alignment
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hdim", [64, 67])
@pytest.mark.parametrize("aligned", [True, False])
def test_gather_pair_fwd_repeats_bit_for_bit(dev, dtype, hdim, aligned):
    """Equal to the plain add bit for bit, the same bits from two launches,
    one launch counted a call, over 40,001 edges (1,251 chunks of 32, the
    last partial).  ``aligned=False``: tables one element into their
    storage (the one-element path)."""
    c = _case(28, 300, 40_001, 8, hdim, dev, dtype)
    pa, pb = c["pa"], c["pb"]
    if not aligned:
        pa, pb = (torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)
                  for t in (pa, pb))
    n0 = _build.launch_counts()["gather_pair"]
    got = tsp.gather_pair_fwd(pa, pb, c["s"], c["r"])
    again = tsp.gather_pair_fwd(pa, pb, c["s"], c["r"])
    want = tsp.gather_pair_reference(pa, pb, c["s"], c["r"])
    torch.cuda.synchronize()
    assert _build.launch_counts()["gather_pair"] == n0 + 2
    assert got.dtype == dtype and got.shape == (40_001, hdim)
    assert torch.equal(got, want) and torch.equal(got, again)


# ---------------------------------------------------------------------------
# The host loop: pinned, prefetched batches and the train CLI on the card
# ---------------------------------------------------------------------------

def _planned_batches(seed=0):
    """An endless host generator of packed 4-sector batches with the
    kernels' plans attached, as the train CLI makes them."""
    from gnn_fpga_tpu_torch.core import batching
    from gnn_fpga_tpu_torch.data import toy2d

    cfg = toy2d.Toy2DConfig(n_layers=8, n_tracks=6, seed=seed)
    graphs = tg.unbatch_graphs(toy2d.make_knn_segment_graphs(cfg, 24, k=3))
    return batching.batch_generator(
        graphs, 4, seed=seed, packed=True,
        transform=lambda b, idx: tg.attach_plans(b))


def test_pin_memory_pins_every_tensor_and_copies_back_equal(dev):
    g = next(_planned_batches())
    pinned = g.pin_memory()
    # an empty tensor (a plan with no long segments) has no memory to pin
    assert all(t.is_pinned() or t.numel() == 0 for t in pinned.tensors())
    assert any(t.numel() == 0 for t in pinned.tensors())
    moved = pinned.to(dev, non_blocking=True)
    torch.cuda.synchronize()
    assert all(t.device.type == "cuda" for t in moved.tensors())
    assert moved.plans.items.n_recv == g.plans.items.n_recv
    for a, b in zip(moved.tensors(), g.tensors()):
        assert torch.equal(a.cpu(), b)


def test_prefetched_batches_equal_synchronous_copies(dev):
    """50 batches with plans attached, prefetched on a side stream, each
    used at once by the fused forward on the current stream while the next
    copies run: the same bits as the forward on batches copied one by one,
    and the same tensors; freed batches are not handed out early (a new
    allocation after each step overwrites whatever memory it is given)."""
    from gnn_fpga_tpu_torch.core.prefetch import prefetch_to_device

    model = tm.init_segment_classifier(
        tm.SegmentClassifierConfig(input_dim=2, hidden_dim=16, n_iters=2,
                                   aggregation="pallas"),
        torch.Generator().manual_seed(0), device=dev)
    gen = _planned_batches(1)
    want = []
    with torch.inference_mode():
        for _ in range(50):
            g = next(gen).to(dev)
            want.append((tm.segment_classifier(model, g).cpu(),
                         [t.cpu() for t in g.tensors()]))
        it = prefetch_to_device(_planned_batches(1), size=2, device=dev,
                                n_batches=50)
        n = 0
        for g, (probs, tensors) in zip(it, want):
            got = tm.segment_classifier(model, g)
            del g
            torch.full((1 << 20,), float("nan"), device=dev)
            assert torch.equal(got.cpu(), probs), n
            n += 1
        assert n == 50
    it = prefetch_to_device(_planned_batches(1), size=2, device=dev,
                            n_batches=50)
    for g, (_, tensors) in zip(it, want):
        for a, b in zip(g.tensors(), tensors):
            assert torch.equal(a.cpu(), b)


def _two_signature_batches(n, seed=1):
    """``n`` planned host batches alternating between two signatures (the
    plans padded to two capacities)."""
    gen = _planned_batches(seed)
    raw = [next(gen) for _ in range(n)]
    cap = tsp.PlanCapacity.covering(*(b.plans for b in raw))
    caps = [cap, dataclasses.replace(cap, recv_items=cap.recv_items + 8)]
    return [b.replace(plans=tsp.pad_plans(b.plans, caps[i % 2]))
            for i, b in enumerate(raw)]


@pytest.mark.parametrize("pinned", [True, False])
def test_staged_batches_of_two_signatures_equal_synchronous_copies(dev,
                                                                   pinned):
    """50 planned batches of two alternating signatures, staged in the
    prefetching ring (from pinned memory, or pageable through the slot's
    twin) and used at once by the fused forward: every tensor and the
    forward's output bit for bit as on batches copied one by one, one
    ring a signature, slots recycled."""
    from gnn_fpga_tpu_torch.core import staging
    from gnn_fpga_tpu_torch.core.prefetch import prefetch_to_device

    host = _two_signature_batches(50)
    if pinned:
        host = [b.pin_memory() for b in host]
    model = tm.init_segment_classifier(
        tm.SegmentClassifierConfig(input_dim=2, hidden_dim=16, n_iters=2,
                                   aggregation="pallas"),
        torch.Generator().manual_seed(0), device=dev)
    with torch.inference_mode():
        want = [tm.segment_classifier(model, b.to(dev)).cpu() for b in host]
        it = prefetch_to_device(iter(host), size=2, device=dev)
        n = 0
        for g, b, probs in zip(it, host, want):
            assert staging.staged_in(g) is not None
            got = tm.segment_classifier(model, g)
            for x, y in zip(g.tensors(), b.tensors()):
                assert torch.equal(x.cpu(), y), n
            del g
            torch.full((1 << 20,), float("nan"), device=dev)
            assert torch.equal(got.cpu(), probs), n
            n += 1
            slots = [s for r in it._rings.values() for s in r]
            assert slots and all((s.twin is None) == pinned for s in slots)
    assert n == 50
    assert it.stats["staged"] == 50 and it.stats["unstaged"] == 0
    assert it.stats["recycled"] >= 50 - 2 * (2 + 3)
    assert it._rings == {}            # freed at exhaustion


def test_a_consumer_that_keeps_every_staged_batch_reads_them_all(dev):
    """A consumer that keeps every batch in a list: after the ring would
    have cycled many times, every kept batch still holds its own values,
    and the ring grew instead of filling a kept slot."""
    from gnn_fpga_tpu_torch.core.prefetch import prefetch_to_device

    host = _two_signature_batches(30, seed=2)
    it = prefetch_to_device(iter(host), size=2, device=dev)
    kept = []
    for g in it:
        kept.append(g)
        torch.full((1 << 20,), float("nan"), device=dev)
    torch.cuda.synchronize()
    assert len(kept) == 30 and it.stats["grown"] > 0
    for g, b in zip(kept, host):
        for x, y in zip(g.tensors(), b.tensors()):
            assert torch.equal(x.cpu(), y)


def test_prefetching_a_batch_that_is_not_tensor_fields_raises(dev):
    """The card's prefetcher stages TensorFields only: a plain tensor
    raises ``TypeError`` naming its type."""
    from gnn_fpga_tpu_torch.core.prefetch import prefetch_to_device

    it = prefetch_to_device(iter([torch.ones(3)]), size=1, device=dev)
    with pytest.raises(TypeError, match="Tensor"):
        next(it)
    it.close()


@pytest.mark.parametrize("pinned", [True, False])
@pytest.mark.parametrize("size", [1, 2])
def test_a_slot_is_not_filled_while_queued_work_reads_it(dev, size, pinned):
    """Each batch read by a kernel queued behind a long sleep on the
    consumer's stream, the batch dropped at once: the worker may not fill
    its slot again until that read has run, so each read sees its own
    batch."""
    from gnn_fpga_tpu_torch.core.prefetch import prefetch_to_device

    n, v = 16, 1 << 18
    host = [tg.from_coo(np.full((v, 2), i, np.float32), [0], [1], [1.0])
            for i in range(n)]
    if pinned:
        host = [b.pin_memory() for b in host]
    it = prefetch_to_device(iter(host), size=size, device=dev)
    reads = []
    for g in it:
        torch.cuda._sleep(20_000_000)          # ~10 ms on the stream
        reads.append(g.x.sum(0))
        del g
    torch.cuda.synchronize()
    assert it.stats["recycled"] > 0
    for i, r in enumerate(reads):
        assert r.tolist() == [float(i * v)] * 2, i


def test_captured_forward_from_staged_batches_equals_from_host(dev):
    """A captured forward loaded from staged batches (one copy of the
    slot's buffer) gives the bits of one loaded from the same host batches
    (one batched copy of their tensors), and counts its loads so."""
    from gnn_fpga_tpu_torch.core.capture import CapturedCall
    from gnn_fpga_tpu_torch.core.prefetch import prefetch_to_device

    host = [b.pin_memory() for b in _two_signature_batches(12, seed=3)[::2]]
    model = tm.init_segment_classifier(
        tm.SegmentClassifierConfig(input_dim=2, hidden_dim=16, n_iters=2,
                                   aggregation="pallas",
                                   compute_dtype=torch.bfloat16),
        torch.Generator().manual_seed(1), device=dev)

    def forward(g):
        with torch.no_grad():
            return tm.segment_classifier(model, g)

    staged, plain = CapturedCall(forward, dev), CapturedCall(forward, dev)
    got = [staged(g).clone()
           for g in prefetch_to_device(iter(host), size=2, device=dev)]
    want = [plain(b).clone() for b in host]
    assert staged.captured and plain.captured
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert staged.load_counts == dict(one_copy=len(host), batched=0)
    assert plain.load_counts == dict(one_copy=0, batched=len(host))


def test_train_cli_epoch_on_the_pallas_route(dev, tmp_path):
    """One epoch of the train CLI on the fused route with prefetching:
    finite losses, and per step 2 launches each of ``iteration_pair``
    forward and backward and one of ``gather_pair`` and its backward
    (plus the validation forward)."""
    from gnn_fpga_tpu_torch.cli import train
    from gnn_fpga_tpu_torch.data import toy2d

    cfg = toy2d.Toy2DConfig(n_layers=8, n_tracks=6, seed=2)
    graphs = tg.unbatch_graphs(toy2d.make_knn_segment_graphs(cfg, 12, k=3))
    _, _, _, layers = toy2d.generate_events(cfg, 12)
    for i, g in enumerate(graphs):
        tg.save_npz(g, str(tmp_path / f"g{i:02d}.npz"), layer=layers[i])
    tsp.reset_launch_counts()
    trainer = train.main([
        "--input-dir", str(tmp_path), "--output-dir", str(tmp_path / "run"),
        "--aggregation", "pallas", "--bf16", "--batch-size", "4",
        "--n-epochs", "1", "--hidden-dim", "16", "--n-iters", "2",
        "--valid-frac", "0.34", "--test-frac", "0", "--prefetch", "2"])
    counts = tsp.launch_counts()
    assert next(trainer.model.parameters()).device.type == "cuda"
    assert np.isfinite(trainer.train_losses).all()
    assert np.isfinite(trainer.valid_losses).all()
    steps, valid = 2, 1
    assert counts["iteration_pair"] == 2 * (steps + valid)
    assert counts["iteration_pair_bwd"] == 2 * steps
    assert counts["gather_pair"] == steps + valid
    assert counts["gather_pair_bwd"] == steps
    assert (tmp_path / "run" / "model.npz").exists()


# ---------------------------------------------------------------------------
# Captured steps and forwards (core/capture.py); kernels on padded plans
# ---------------------------------------------------------------------------

def _composed_batches(dev, n, seed=3):
    """``n`` packed 4-sector batches on the card, their plans composed
    from per-graph plans and padded to the dataset's capacity, as the
    train CLI makes them: one static signature."""
    from gnn_fpga_tpu_torch.cli import train
    from gnn_fpga_tpu_torch.core import batching
    from gnn_fpga_tpu_torch.data import toy2d

    cfg = toy2d.Toy2DConfig(n_layers=8, n_tracks=6, seed=seed)
    graphs = tg.unbatch_graphs(toy2d.make_knn_segment_graphs(cfg, 24, k=3))
    bucket = batching.choose_bucket(graphs, edge_multiple=256)
    setup = train.PlanSetup(graphs, bucket, 4)
    gen = batching.batch_generator(
        graphs, 4, bucket, seed=seed, packed=True,
        transform=setup.transform_for(range(len(graphs))))
    return [next(gen).to(dev) for _ in range(n)]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_captured_steps_match_eager_steps(dev, fused, dtype):
    """Five steps from one init: the captured steps (one capture, then
    replays) against the eager ones, losses and weights at rtol 1e-5, and
    each replay counts its kernels' launches as the eager step does."""
    from gnn_fpga_tpu_torch.core.capture import signature
    from gnn_fpga_tpu_torch.train.trainer import TrainConfig, Trainer

    batches = _composed_batches(dev, 5)
    assert len({signature(b) for b in batches}) == 1
    base = tm.init_segment_classifier(
        tm.SegmentClassifierConfig(input_dim=2, hidden_dim=16, n_iters=2,
                                   aggregation="pallas",
                                   fused_iteration=fused,
                                   compute_dtype=dtype),
        torch.Generator().manual_seed(0), device=dev)
    cfg = TrainConfig(learning_rate=3e-3, pos_weight=8.0, l1=1e-4,
                      lr_schedule="cosine", decay_steps=5)
    runs = {}
    for capture in (True, False):
        model = tm.SegmentClassifier(base.cfg, torch.Generator(), device=dev)
        model.load_state_dict(base.state_dict())
        tr = Trainer(model, cfg, capture=capture)
        tsp.reset_launch_counts()
        # one step a call: the first eager and captured, then replays
        runs[capture] = (np.concatenate([tr.run_steps([b])
                                         for b in batches]),
                         tsp.launch_counts(),
                         [p.detach().clone() for p in model.parameters()])
        if capture:
            (call,) = tr._captured.values()
            assert call.captured
    (got, got_n, got_w), (want, want_n, want_w) = runs[True], runs[False]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got_n == want_n
    for a, b in zip(got_w, want_w):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_captured_forwards_match_eager_bit_for_bit(dev):
    """The served fused forward and infer's dense forward, replayed on new
    batches, give the eager forward's bits; a batch of another signature
    raises."""
    from gnn_fpga_tpu_torch.cli import infer
    from gnn_fpga_tpu_torch.core.capture import CapturedCall
    from gnn_fpga_tpu_torch.data import toy2d

    batches = _composed_batches(dev, 4, seed=4)
    model = tm.init_segment_classifier(
        tm.SegmentClassifierConfig(input_dim=2, hidden_dim=16, n_iters=2,
                                   aggregation="pallas",
                                   compute_dtype=torch.bfloat16),
        torch.Generator().manual_seed(1), device=dev)

    def forward(g):
        with torch.no_grad():
            return tm.segment_classifier(model, g)

    call = CapturedCall(forward, dev)
    for g in batches:
        got = call(g).clone()
        assert torch.equal(got, forward(g))
    assert call.captured
    with pytest.raises(ValueError, match="another static signature"):
        call(next(_planned_batches()).to(dev))
    dense = tm.init_segment_classifier(
        tm.SegmentClassifierConfig(input_dim=2, hidden_dim=16, n_iters=2),
        torch.Generator().manual_seed(2), device=dev)
    fwd = infer.captured_forward(dense, dev)
    sectors = tg.unbatch_graphs(toy2d.make_knn_segment_graphs(
        toy2d.Toy2DConfig(n_layers=8, n_tracks=6, seed=5), 3, k=3))
    graphs = [tg.pad_graph(g, 56, 256) for g in sectors]
    for g in graphs:
        got = fwd(g).clone()
        with torch.no_grad():
            assert torch.equal(got, tm.segment_classifier(dense, g.to(dev)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_on_padded_plans_match_unpadded_bit_for_bit(dev, dtype):
    """A graph of 4,000 nodes with a 1,120-edge hub and 300 pad edges (so
    the send pass's grid sits at its cap of two blocks an SM, as at the
    fullevent shapes): every plan-reading kernel on plans padded with pad
    items, splits and long segments gives the unpadded plans' bits."""
    rng = np.random.default_rng(21)
    v, e = 4000, 30_000
    s = rng.integers(0, v - 1, e)
    r = rng.integers(0, v - 1, e)
    s[:1120], r[:1120] = 1, 0
    s[-300:] = r[-300:] = v - 1
    plans = tsp.build_agg_plans(s.astype(np.int32), r.astype(np.int32), v)
    real = tsp.plan_counts(plans)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    assert tsp.walk_blocks(real.send_items, sm) == 2 * sm
    cap = tsp.PlanCapacity(
        recv_items=real.recv_items + 500, send_items=real.send_items + 700,
        splits=real.splits + 40, slots=real.slots + 90,
        recv_long=real.recv_long + 5, send_long=real.send_long + 9)
    padded = tsp.pad_plans(plans, cap).to(dev)
    plans = plans.to(dev)
    t = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
    pa, pb, h, g_mi, g_mo = t(v, 64), t(v, 64), t(v, 66), t(v, 66), t(v, 66)
    w2, b1, b2, g = t(64) * 0.25, t(64), t(1), t(e, 64)
    em = torch.ones(e, device=dev)
    em[-300:] = 0
    w = torch.rand(e, device=dev) * em
    ss, rr = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in (s, r))

    def run(p):
        ems = tsp.sort_edge_weights(em, p.recv)
        args = (pa, pb, h, ems, w2, b1, b2)
        mi, mo, sig = tsp.iteration_pair_fwd(*args, p)
        with torch.no_grad():
            return ((mi, mo, sig)
                    + tsp.iteration_pair_bwd(*args, g_mi, g_mo, p, sig)
                    + tsp.aggregate_pair(h, w, p)
                    + tsp.aggregate_pair_bwd(h, w, g_mi, g_mo, p)
                    + (tsp.gather_pair(pa, pb, ss, rr, p),)
                    + tsp.gather_pair_bwd(g, p)
                    + (tsp.spmm_raw(h, w, p.recv), tsp.spmm_raw(h, w, p.send),
                       tsp.sddmm(g_mi, h, p.recv),
                       tsp.sddmm_dual(g_mi, h, g_mo, h, p.recv)))

    want, got = run(plans), run(padded)
    torch.cuda.synchronize()
    assert len(got) == len(want) == 20
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b), i


def test_a_capture_that_fails_raises(dev):
    """A call that reads a value back to the host cannot be captured: the
    call raises after its eager run, and never serves eagerly."""
    from gnn_fpga_tpu_torch.core.capture import CapturedCall

    g = next(_planned_batches()).to(dev)
    call = CapturedCall(lambda b: b.x * float(b.x.sum()), dev)
    with pytest.raises(RuntimeError):
        call(g)
    assert not call.captured
    torch.cuda.synchronize()
    assert torch.isfinite(g.x.sum() + 1)        # the device still works


# ---------------------------------------------------------------------------
# The stacked epoch: K steps in one captured graph (Trainer.run_steps)
# ---------------------------------------------------------------------------

def _count_replays(run):
    """``(run(), the CUDA graph replays it made)``."""
    n = [0]
    replay = torch.cuda.CUDAGraph.replay

    def counted(graph):
        n[0] += 1
        return replay(graph)

    torch.cuda.CUDAGraph.replay = counted
    try:
        return run(), n[0]
    finally:
        torch.cuda.CUDAGraph.replay = replay


def _k_step_against_one_step(make_trainer, batches):
    """A K-step trainer runs the stack twice (eager and captured, then one
    replay), a one-step trainer the same 2K steps one batch a call; both
    from one init.  Returns their losses, weights, the K-step replay's
    graph replays and launches, and the one-step replays' launches."""
    from gnn_fpga_tpu_torch.train.trainer import stack_batches

    stacked, one = make_trainer(), make_trainer()
    stack = stack_batches(batches)
    first = stacked.run_steps(stack)
    tsp.reset_launch_counts()
    second, replays = _count_replays(lambda: stacked.run_steps(stack))
    k_launches = tsp.launch_counts()
    ones = [one.run_steps([batches[0]])]
    tsp.reset_launch_counts()
    ones += [one.run_steps([b]) for b in (batches + batches)[1:]]
    one_launches = tsp.launch_counts()
    params = lambda tr: torch.cat([p.detach().reshape(-1)
                                   for p in tr.model.parameters()])
    return dict(got=np.concatenate([first, second]),
                want=np.concatenate(ones), got_w=params(stacked),
                want_w=params(one), replays=replays, k_launches=k_launches,
                one_launches=one_launches, k=len(batches))


def _assert_k_step_matches(r):
    np.testing.assert_array_equal(r["got"], r["want"])
    assert torch.equal(r["got_w"], r["want_w"])
    assert r["replays"] == 1
    # the one-step trainer's 2K - 1 replays against the K steps of one
    per_step = {k: n / (2 * r["k"] - 1) for k, n in r["one_launches"].items()}
    assert any(per_step.values())
    assert r["k_launches"] == {k: n * r["k"] for k, n in per_step.items()}


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
@pytest.mark.parametrize("fused", [True, False])
def test_k_step_graph_equals_one_step_graphs_bit_for_bit(dev, fused,
                                                         schedule):
    """``run_steps`` on a stack of 5 composed batches is one replay of a
    5-step graph that launches 5 steps' kernels, and its losses and
    weights equal 10 one-step calls' from the same init bit for bit,
    under a constant and a cosine rate (the rate computed on the device
    inside both graphs)."""
    from gnn_fpga_tpu_torch.train.trainer import TrainConfig, Trainer

    batches = _composed_batches(dev, 5, seed=7)
    base = tm.init_segment_classifier(
        tm.SegmentClassifierConfig(input_dim=2, hidden_dim=16, n_iters=2,
                                   aggregation="pallas",
                                   fused_iteration=fused,
                                   compute_dtype=torch.bfloat16),
        torch.Generator().manual_seed(3), device=dev)
    kw = dict(lr_schedule="cosine", decay_steps=7) \
        if schedule == "cosine" else {}
    cfg = TrainConfig(learning_rate=3e-3, pos_weight=8.0, l1=1e-4, **kw)

    def make():
        model = tm.SegmentClassifier(base.cfg, torch.Generator(), device=dev)
        model.load_state_dict(base.state_dict())
        return Trainer(model, cfg)

    _assert_k_step_matches(_k_step_against_one_step(make, batches))


def test_k_step_capture_memory_does_not_grow_with_k(dev):
    """The first call of a 16-step graph (its eager run and capture)
    allocates at most twice the one-step graph's memory beyond its input
    buffers: the capture's pool reuses each step's blocks."""
    from gnn_fpga_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                                  stack_batches)

    batches = _composed_batches(dev, 4, seed=8)
    base = tm.init_segment_classifier(
        tm.SegmentClassifierConfig(input_dim=2, hidden_dim=16, n_iters=2,
                                   aggregation="pallas"),
        torch.Generator().manual_seed(4), device=dev)
    extra = {}
    for k in (1, 16):
        model = tm.SegmentClassifier(base.cfg, torch.Generator(), device=dev)
        model.load_state_dict(base.state_dict())
        tr = Trainer(model, TrainConfig())
        stack = stack_batches([batches[i % 4] for i in range(k)])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        tr.run_steps(stack)
        torch.cuda.synchronize()
        extra[k] = (torch.cuda.max_memory_allocated() - before
                    - sum(t.numel() * t.element_size()
                          for t in stack.tensors()))
    assert 0 < extra[16] <= 2 * extra[1], extra


def test_a_failing_k_step_capture_raises(dev):
    """A K-step body that reads a value back to the host cannot be
    captured: ``run_steps`` raises after its eager run, and raises again
    on the next call rather than stepping eagerly."""
    from gnn_fpga_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                                  stack_batches)

    batches = _composed_batches(dev, 2, seed=9)
    tr = Trainer(tm.init_segment_classifier(
        tm.SegmentClassifierConfig(input_dim=2, hidden_dim=16, n_iters=2,
                                   aggregation="pallas"),
        torch.Generator().manual_seed(5), device=dev), TrainConfig())
    tr._step_body = lambda g: g.x.sum() * float(g.x.sum())
    stack = stack_batches(batches)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            tr.run_steps(stack)
    assert not any(call.captured for call in tr._captured.values())
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The doublet cross-join (csrc/doublets.cu)
# ---------------------------------------------------------------------------

def _doublet_args(sizes, dev, seed=0, boundary=False):
    """Hits of layer pairs of ``sizes`` ((n1, n2) each) on ``dev``, their
    offsets and cuts; with ``boundary`` hits exactly on the cuts and one
    ulp inside them."""
    rng = np.random.default_rng(seed)
    cols = [[] for _ in range(6)]
    for n1, n2 in sizes:
        r1, r2 = rng.uniform(20, 40, n1), rng.uniform(50, 70, n2)
        p1 = rng.uniform(-np.pi, np.pi, n1)
        p2 = rng.uniform(-np.pi, np.pi, n2)
        z1, z2 = rng.uniform(-200, 200, n1), rng.uniform(-200, 200, n2)
        if boundary and n1 > 1 and n2 > 1:
            r2[0], p2[0], z2[0] = r1[0] + 32.0, p1[0] + 0.5, z1[0]
            r2[-1], z2[-1] = r1[-1] + 32.0, z1[-1]
            p2[-1] = np.nextafter(p1[-1] + 0.5, p1[-1])
            z1[1], z2[1], r2[1], p2[1] = 150.0, 150.0, r1[1] + 10.0, p1[1]
        for c, v in zip(cols, (r1, p1, z1, r2, p2, z2)):
            c.append(v)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    off = lambda k: t(np.concatenate([[0], np.cumsum(
        [s[k] for s in sizes])]).astype(np.int64))
    cuts = t(np.resize([0.015625, 0.05, 1e31], len(sizes)).astype(np.float64))
    return [t(np.concatenate(c) if c else np.zeros(0)) for c in cols] + [
        off(0), off(1), cuts]


@pytest.mark.parametrize("sizes,boundary", [
    ([(173, 211), (50, 60), (300, 17)], False),
    ([(0, 9), (13, 17), (5, 0), (0, 0), (40, 33)], False),   # empty pairs
    ([(64, 80), (33, 31)], True),                             # on the cuts
])
def test_doublet_kernel_matches_plain_exactly(dev, sizes, boundary):
    from gnn_fpga_tpu_torch.ops.cuda import doublets as dop

    args = _doublet_args(sizes, dev, boundary=boundary)
    n0 = tsp.launch_counts()["select_segments"]
    got = dop.select_segments(*args, 150.0)
    again = dop.select_segments(*args, 150.0)
    torch.cuda.synchronize()
    assert tsp.launch_counts()["select_segments"] == n0 + 2
    ref = dop.select_segments_reference(*args, 150.0)
    assert len(ref[0]) > 0
    for a, b, c in zip(got, ref, again):
        assert a.dtype == torch.int64
        assert torch.equal(a, b)
        assert torch.equal(c, a)


def test_doublet_kernel_on_one_large_pair(dev):
    """One pair of 10^4 x 10^4 hits."""
    from gnn_fpga_tpu_torch.ops.cuda import doublets as dop

    args = _doublet_args([(10_000, 10_000)], dev, seed=3)
    got = dop.select_segments(*args, 150.0)
    ref = dop.select_segments_reference(*args, 150.0)
    torch.cuda.synchronize()
    assert len(ref[0]) > 10_000
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_doublet_kernel_with_no_kept_pair_and_no_pairs(dev):
    from gnn_fpga_tpu_torch.ops.cuda import doublets as dop

    args = _doublet_args([(20, 30)], dev)
    got = dop.select_segments(*args[:8], torch.zeros(
        1, dtype=torch.float64, device=dev), 150.0)
    assert got[0].shape == (0,) and got[1].shape == (0,)
    none = _doublet_args([], dev)
    got = dop.select_segments(*none, 150.0)
    assert got[0].shape == (0,)


def test_construct_graph_on_the_card_equals_the_cpu(dev):
    """A whole graph: the card's one kernel call against the CPU's plain
    cross-join, field for field."""
    from gnn_fpga_tpu_torch.data import doublets as tdbl
    from gnn_fpga_tpu_torch.data.table import Table

    rng = np.random.default_rng(5)
    n = 4000
    hits = Table({"layer": rng.integers(0, 10, n),
                  "r": rng.uniform(30, 1000, n),
                  "phi": rng.uniform(-np.pi, np.pi, n),
                  "z": rng.uniform(-1000, 1000, n),
                  "particle_id": rng.integers(0, 300, n)})
    cuts = tdbl.SegmentCuts(phi_slope_max=0.01, phi_slope_outer_max=0.005,
                            z0_max=300.0)
    on_card = tdbl.construct_graph(hits, tdbl.adjacent_layer_pairs(10),
                                   cuts=cuts, sort_by_layer=True)
    on_cpu = tdbl.construct_graph(hits, tdbl.adjacent_layer_pairs(10),
                                  cuts=cuts, sort_by_layer=True, device="cpu")
    assert on_card.n_edge > 0
    for f in ("x", "senders", "receivers", "y"):
        assert torch.equal(getattr(on_card, f), getattr(on_cpu, f)), f


@pytest.fixture
def world_of_one(request):
    """A process group of this process alone (``request.param``'s backend)
    for the parallel paths, destroyed afterwards."""
    import torch.distributed as dist

    from gnn_fpga_tpu_torch.parallel import multihost

    multihost.initialize_single(request.param)
    try:
        yield request.param
    finally:
        dist.destroy_process_group()


def _partitioned_batches(dev, n):
    """``n`` Toy2D events, each one graph partitioned into one shard with
    plans, pinned to one signature, on the card."""
    from gnn_fpga_tpu_torch.data import toy2d
    from gnn_fpga_tpu_torch.parallel import partition as part

    gs = [tg.unbatch_graphs(toy2d.make_segment_graphs(
        toy2d.Toy2DConfig(n_layers=8, n_tracks=6, seed=s), 1))[0]
        for s in range(n)]
    e_cap = max(int(g.edge_mask.sum()) for g in gs)
    cap = tsp.PlanCapacity.covering(*(part.partition_graph(
        g, 1, plans=True, edge_capacity=e_cap).shard(0).plans for g in gs))
    return [part.partition_graph(g, 1, plans=True, edge_capacity=e_cap,
                                 capacity=cap).to(dev) for g in gs]


@pytest.mark.parametrize("world_of_one", ["nccl"], indirect=True)
@pytest.mark.parametrize("fused", [True, False])
def test_partitioned_captured_steps_match_eager(dev, world_of_one, fused):
    """Five partitioned steps at P = 1 over NCCL: captured (the step with
    its collectives, then the eval loss and predict) against eager, losses
    and weights at rtol 1e-5 and the same launches; the partitioned
    forward on the card against its plain versions on the CPU."""
    from gnn_fpga_tpu_torch.parallel import mesh as mesh_lib
    from gnn_fpga_tpu_torch.parallel import partition as part
    from gnn_fpga_tpu_torch.train.trainer import TrainConfig, Trainer

    batches = _partitioned_batches(dev, 5)
    mesh = mesh_lib.make_mesh(axis_names=(mesh_lib.GRAPH_AXIS,))
    base = tm.init_segment_classifier(
        tm.SegmentClassifierConfig(input_dim=2, hidden_dim=16, n_iters=2,
                                   fused_iteration=fused),
        torch.Generator().manual_seed(0), device=dev)
    cfg = TrainConfig(learning_rate=3e-3, pos_weight=8.0, l1=1e-4)
    runs = {}
    for capture in (True, False):
        model = tm.SegmentClassifier(base.cfg, torch.Generator(), device=dev)
        model.load_state_dict(base.state_dict())
        tr = Trainer(model, cfg, strategy="partitioned", mesh=mesh,
                     capture=capture)
        tsp.reset_launch_counts()
        # one step a call: the first eager and captured, then replays
        runs[capture] = (np.concatenate([tr.run_steps([b])
                                         for b in batches]),
                         tsp.launch_counts(),
                         [p.detach().clone() for p in model.parameters()],
                         tr._eval_loss(batches[0]))
        if capture:
            tr.predict(iter(batches[:1]), 1)
            assert sorted(k for k, _ in tr._captured) == [
                "eval", "predict", "train"]
    (got, got_n, got_w, got_v), (want, want_n, want_w, want_v) = \
        runs[True], runs[False]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-5)
    assert got_n == want_n
    for a, b in zip(got_w, want_w):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    import torch.distributed as dist

    from gnn_fpga_tpu_torch.parallel.collectives import Comm

    cpu_model = tm.SegmentClassifier(base.cfg, torch.Generator(),
                                     device="cpu")
    cpu_model.load_state_dict(base.state_dict())
    with torch.no_grad():
        card = part.sharded_logits(base, batches[0].shard(0),
                                   part.graph_comm(mesh))
        plain = part.sharded_logits(
            cpu_model, batches[0].shard(0).to("cpu"),
            Comm(dist.new_group(backend="gloo")))
    torch.testing.assert_close(card.cpu(), plain, **TOL[torch.float32])


@pytest.mark.parametrize("world_of_one", ["nccl"], indirect=True)
@pytest.mark.parametrize("strategy", ["partitioned", "dp"])
def test_parallel_k_step_graph_equals_one_step_graphs(dev, world_of_one,
                                                      strategy):
    """At P = 1 over NCCL, a stack of 5 partitioned graphs (the shard
    axis 1 taken) or of 5 batched graphs (dp, the batch axis 1 split) runs
    as one replay of a 5-step graph holding each step's collectives,
    equal bit for bit to 10 one-step calls, cosine rate and all."""
    from gnn_fpga_tpu_torch.data import toy2d
    from gnn_fpga_tpu_torch.parallel import mesh as mesh_lib
    from gnn_fpga_tpu_torch.train.trainer import TrainConfig, Trainer

    axis = mesh_lib.GRAPH_AXIS if strategy == "partitioned" \
        else mesh_lib.DATA_AXIS
    mesh = mesh_lib.make_mesh(axis_names=(axis,))
    if strategy == "partitioned":
        batches, kw = _partitioned_batches(dev, 5), {}
    else:
        batches = [toy2d.make_segment_graphs(toy2d.Toy2DConfig(
            n_layers=6, n_tracks=4, seed=s), 4).to(dev) for s in range(5)]
        # the dense route: the sparse route's atomic index_add_ sums in
        # no fixed order on the card
        kw = dict(aggregation="dense")
    base = tm.init_segment_classifier(
        tm.SegmentClassifierConfig(input_dim=2, hidden_dim=16, n_iters=2,
                                   **kw),
        torch.Generator().manual_seed(6), device=dev)
    cfg = TrainConfig(learning_rate=3e-3, pos_weight=8.0, l1=1e-4,
                      lr_schedule="cosine", decay_steps=7)

    def make():
        model = tm.SegmentClassifier(base.cfg, torch.Generator(), device=dev)
        model.load_state_dict(base.state_dict())
        return Trainer(model, cfg, strategy=strategy, mesh=mesh)

    r = _k_step_against_one_step(make, batches)
    if strategy == "partitioned":
        _assert_k_step_matches(r)
    else:                               # the dense route: no hand kernel
        np.testing.assert_array_equal(r["got"], r["want"])
        assert torch.equal(r["got_w"], r["want_w"])
        assert r["replays"] == 1


@pytest.mark.parametrize("world_of_one", ["gloo"], indirect=True)
def test_capture_under_gloo_on_the_card_raises(dev, world_of_one):
    """gloo's collectives cannot be captured: ``capture=True`` raises, and
    ``capture=False`` runs the step eagerly."""
    from gnn_fpga_tpu_torch.parallel import mesh as mesh_lib
    from gnn_fpga_tpu_torch.train.trainer import Trainer

    mesh = mesh_lib.make_mesh(axis_names=(mesh_lib.GRAPH_AXIS,))
    model = tm.init_segment_classifier(
        tm.SegmentClassifierConfig(input_dim=2, hidden_dim=16, n_iters=2),
        torch.Generator().manual_seed(0), device=dev)
    with pytest.raises(ValueError, match="NCCL"):
        Trainer(model, strategy="partitioned", mesh=mesh)
    tr = Trainer(model, strategy="partitioned", mesh=mesh, capture=False)
    assert np.isfinite(tr.run_steps(_partitioned_batches(dev, 1))).all()


# ---------------------------------------------------------------------------
# The probes' kernels (ops/cuda/probes.py), against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [5, 4096 * 3 + 7, 131072 * 128])
@pytest.mark.parametrize("vectors", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_passthrough_equals_x_times_two(dev, dtype, vectors, n):
    gen = torch.Generator().manual_seed(n % 1000)
    x = (torch.randn(n, generator=gen) * 100).to(dev, dtype)
    n0 = _build.launch_counts()["passthrough"]
    got, again = tpr.passthrough(x, vectors), tpr.passthrough(x, vectors)
    torch.cuda.synchronize()
    assert _build.launch_counts()["passthrough"] == n0 + 2
    assert got.dtype == dtype and torch.equal(got, x * 2)
    assert torch.equal(got, again)


@pytest.mark.parametrize("d", [128, 66, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_rows_equals_index_select(dev, dtype, d):
    gen = torch.Generator().manual_seed(d)
    v, e = 1000, 20000
    base = torch.randn(v + 1, d, generator=gen).to(dev, dtype)
    idx = torch.randint(0, v, (e,), generator=gen, dtype=torch.int32).to(dev)
    n0 = _build.launch_counts()["gather_rows"]
    for h in (base[:v], base[1:]):      # the second off 16-byte alignment
        got = tpr.gather_rows(h, idx)
        torch.cuda.synchronize()
        assert torch.equal(got, h.index_select(0, idx))
    assert _build.launch_counts()["gather_rows"] == n0 + 2


def _ablation_plan(dev, v=4096, e=40000):
    """The layered graph, with a hub of 1,120 edges on node 5 (a long
    segment, walked by a block); seg = receivers."""
    from gnn_fpga_tpu_torch.probes.common import layered_graph

    s, r = layered_graph(v, e)
    r = r.copy()
    r[:1120] = 5
    return tsp.build_edge_plan(r, s, v).to(dev)


@pytest.mark.parametrize("mode", tpr.ABLATION_MODES)
@pytest.mark.parametrize("d", [128, 66])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ablate_rows_match_their_plain_versions(dev, dtype, d, mode):
    plan = _ablation_plan(dev)
    gen = torch.Generator().manual_seed(3)
    h = torch.randn(plan.n_node, d, generator=gen).to(dev, dtype)
    w = torch.rand(plan.n_edge, generator=gen).to(dev)
    table, width = ((tpr.pad_rows(h), d) if mode == "aligned"
                    else (h, None))
    n0 = _build.launch_counts()["ablate_rows"]
    got = tpr.ablate_rows(table, w, plan, mode, width=width)
    again = tpr.ablate_rows(table, w, plan, mode, width=width)
    torch.cuda.synchronize()
    assert _build.launch_counts()["ablate_rows"] == n0 + 2
    assert torch.equal(got, again)
    if mode in ("full", "aligned"):
        assert torch.equal(got, tsp.spmm_raw(h, w, plan))
    ref = tpr.ablate_rows_reference(h, w, plan, "full" if mode == "aligned"
                                    else mode)
    kdt = torch.float32 if mode == "ids_only" else dtype
    tol = dict(TOL[kdt])
    if mode in ("no_scatter", "compute", "ids_only"):
        tol["atol"] = PARAM_SUM_ATOL[kdt] * ref.abs().max().item()
    assert got.dtype == kdt and got.shape == ref.shape
    torch.testing.assert_close(got.float(), ref, **tol)


def test_ablate_rows_refuses_a_width_it_was_not_built_for(dev):
    plan = _ablation_plan(dev)
    h = torch.randn(plan.n_node, 7, device=dev)  # 4-byte items: not built
    with pytest.raises(RuntimeError, match="gnn_ablate_rows"):
        tpr.ablate_rows(h, torch.rand(plan.n_edge, device=dev), plan, "full")


@pytest.mark.parametrize("d,hdim", [(66, 64), (128, 128), (64, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_iteration_bwd_recompute_matches_plain_and_stashed(dev, dtype, d,
                                                          hdim):
    c = _case(31, 700, 6000, d, hdim, dev, dtype)
    gen = torch.Generator().manual_seed(4)
    g_mi, g_mo = (torch.randn(c["v"], d, generator=gen).to(dev, dtype)
                  for _ in range(2))
    ip = (c["pa"], c["pb"], c["h"], c["ems"], c["w2"], c["b1"], c["b2"])
    recv = c["plans"].recv
    sig = tsp.iteration_pair_fwd(*ip, c["plans"])[2]
    n0 = _build.launch_counts()["iteration_pair_bwd_recompute"]
    got = tpr.iteration_pair_bwd_recompute(*ip, g_mi, g_mo, c["plans"])
    again = tpr.iteration_pair_bwd_recompute(*ip, g_mi, g_mo, c["plans"])
    stashed = tsp.iteration_pair_bwd(*ip, g_mi, g_mo, c["plans"], sig)
    ref = tsp.iteration_pair_bwd_reference(*ip, g_mi, g_mo, recv.sorted_oth,
                                           recv.sorted_seg, c["v"])
    stash_ref = tsp.iteration_pair_bwd_stashed_reference(
        *ip[:6], sig, g_mi, g_mo, recv.sorted_oth, recv.sorted_seg, c["v"])
    torch.cuda.synchronize()
    assert _build.launch_counts()["iteration_pair_bwd_recompute"] == n0 + 2
    names = ("dh", "dpa", "dpb", "dw2", "db1", "db2")
    for name, a, b, p, q, s in zip(names, got, again, stashed, ref,
                                   stash_ref):
        assert torch.equal(a, b), name
        tol = dict(TOL[dtype])
        # w2 ~ N(0, 1) saturates the scores at H = 128: a node's rows err
        # in proportion to its edges' terms (chip_smoke.py's
        # phase_probes), as the parameter sums do
        if name in ("dw2", "db1", "db2") or hdim == 128:
            tol["atol"] = PARAM_SUM_ATOL[dtype] * q.abs().max().item()
        torch.testing.assert_close(a.float(), q.reshape(a.shape), **tol)
        torch.testing.assert_close(a.float(), p.float(), **tol)
        torch.testing.assert_close(p.float(), s.reshape(p.shape), **tol)


# The tolerances at which the plain sparse route serves as the reference
# (chip_smoke.py, PERF.md section 2): in f32, logits and gradients
# elementwise (rtol, atol); for a bf16 route, the sparse route in f32 at
# the bf16 route's rounded weights and inputs, probabilities by their
# largest difference and gradients by one relative norm over all
# parameters.
SPARSE_REF_LOGIT_TOL = (1e-4, 1e-4)
SPARSE_REF_GRAD_TOL = (2e-3, 1e-5)
SPARSE_REF_BF16_PROB_MAX_ABS = 3e-2
SPARSE_REF_BF16_GRAD_REL = 1.5e-2
SPREAD_RUNS = 20


def _spread(runs, rtol: float, atol: float) -> dict:
    """How far ``runs`` (one tensor a run of the same computation on the
    same inputs) lie from each other: the largest pairwise ``max|a_i -
    a_j|`` (``max_abs``), ``||a_i - a_j|| / ||a_j||`` (``rel_norm``) and
    ``|a_i - a_j| / (atol + rtol |a_j|)`` of any element (``of_tol``: 1 is
    the tolerance itself)."""
    a = torch.stack([r.detach().reshape(-1).double() for r in runs])
    out = {"max_abs": float((a.max(0).values - a.min(0).values).max()),
           "rel_norm": 0.0, "of_tol": 0.0}
    for j in range(len(a)):
        diff = (a - a[j]).abs()
        out["rel_norm"] = max(out["rel_norm"], float(
            diff.norm(dim=1).max() / a[j].norm()))
        out["of_tol"] = max(out["of_tol"], float(
            (diff / (atol + rtol * a[j].abs())).max()))
    return out


def _fullevent_packed(dev, seed=0):
    """The fullevent graph: 36 Toy2D kNN sectors packed into one graph of
    15,848 nodes and 180,736 edges (no plans)."""
    from gnn_fpga_tpu_torch.data import toy2d

    gs = toy2d.make_knn_segment_graphs(
        toy2d.Toy2DConfig(n_layers=20, n_tracks=22, seed=seed), 36, k=12)
    return tg.pack_graphs(tg.unbatch_graphs(gs), n_node=15_848,
                          n_edge=180_736).to(dev)


@pytest.mark.parametrize("case", ["f32", "bf16 reference", "bf16 route"])
def test_sparse_route_spread_is_a_tenth_of_its_reference_tolerances(
        dev, case):
    """The sparse route sums with an atomic ``index_add_`` (and so does
    ``index_select``'s backward), so two runs on the same inputs may
    differ.  20 forwards and backwards of the fullevent SegmentClassifier
    (hidden 64, 6 iterations, ``pos_weight=8``) on the packed graph with
    one set of weights; the largest pairwise difference of the logits (or
    probabilities) and of the parameter gradients, printed, must stay
    under a tenth of the tolerance at which the route serves as a
    reference:

    - ``f32``: the f32 route, elementwise at the f32 tolerances;
    - ``bf16 reference``: the reference of every bf16 check, the f32
      route at bf16-rounded weights and inputs, probabilities by their
      largest difference and gradients by their relative norm;
    - ``bf16 route``: the route computing (and summing) in bf16, which is
      a timing baseline and no reference: its spread is recorded and held
      under the bf16 gradient tolerance itself."""
    from gnn_fpga_tpu_torch.train.trainer import masked_bce_with_logits

    g = _fullevent_packed(dev)
    dtype = torch.bfloat16 if case == "bf16 route" else None
    model = tm.init_segment_classifier(
        tm.SegmentClassifierConfig(input_dim=2, hidden_dim=64, n_iters=6,
                                   compute_dtype=dtype,
                                   aggregation="sparse"),
        torch.Generator().manual_seed(13), device=dev)
    if case == "bf16 reference":
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(p.to(torch.bfloat16).float())
        g = g.replace(x=g.x.to(torch.bfloat16).float())
    outs, grads = [], []
    for _ in range(SPREAD_RUNS):
        model.zero_grad(set_to_none=True)
        out = model(g)
        masked_bce_with_logits(out, g.y, g.edge_mask, 8.0).backward()
        outs.append(out.detach().clone() if case == "f32"
                    else torch.sigmoid(out.detach()))
        grads.append(torch.cat([p.grad.reshape(-1)
                                for p in model.parameters()]))
    torch.cuda.synchronize()
    lo = _spread(outs, *SPARSE_REF_LOGIT_TOL)
    gr = _spread(grads, *SPARSE_REF_GRAD_TOL)
    print(f"\nF1 spread, sparse route, {case}, {SPREAD_RUNS} runs on "
          f"{torch.cuda.get_device_name(0)}: "
          f"{'logits' if case == 'f32' else 'probabilities'} max|d| "
          f"{lo['max_abs']:.3e} ({lo['of_tol']:.3e} of the f32 logit "
          f"tolerance), ||d|| / ||.|| {lo['rel_norm']:.3e}; gradients "
          f"max|d| {gr['max_abs']:.3e} ({gr['of_tol']:.3e} of the f32 "
          f"gradient tolerance), ||d|| / ||g|| {gr['rel_norm']:.3e}")
    if case == "f32":
        assert lo["of_tol"] <= 0.1
        assert gr["of_tol"] <= 0.1
    elif case == "bf16 reference":
        assert lo["max_abs"] <= 0.1 * SPARSE_REF_BF16_PROB_MAX_ABS
        assert gr["rel_norm"] <= 0.1 * SPARSE_REF_BF16_GRAD_REL
    else:
        assert gr["rel_norm"] <= SPARSE_REF_BF16_GRAD_REL


def test_windowcut_256_step_stack_equals_one_step_calls_bit_for_bit(dev):
    """``probes.windowcut``'s epoch, a stack of 256 steps, on a small
    window-cut set (512 events, batches of 2): the 256-step graph (its
    first call eager and captured, the second one replay) gives the
    losses and weights of 512 one-step calls from the same init bit for
    bit, at the probe's cosine rate."""
    from gnn_fpga_tpu_torch.data import toy2d
    from gnn_fpga_tpu_torch.probes import windowcut
    from gnn_fpga_tpu_torch.train.trainer import stack_batches

    g = toy2d.make_window_segment_graphs(
        toy2d.Toy2DConfig(n_layers=10, n_tracks=4, seed=0), 512)
    batches = [b.to(dev) for b in windowcut.split_epoch(g, 256)]
    stacked, one = (windowcut.make_trainer(2, 256, dev) for _ in range(2))
    one.model.load_state_dict(stacked.model.state_dict())
    stack = stack_batches(batches)
    first = stacked.run_steps(stack)
    second, replays = _count_replays(lambda: stacked.run_steps(stack))
    ones = [one.run_steps([b]) for b in batches + batches]
    np.testing.assert_array_equal(np.concatenate([first, second]),
                                  np.concatenate(ones))
    for a, b in zip(stacked.model.parameters(), one.model.parameters()):
        assert torch.equal(a, b)
    assert replays == 1


def test_timed_counts_the_replays_it_launches_and_not_the_capture(dev):
    """``probes.common.timed`` on ``aggregate_pair``: ``n_iters`` eager
    launches, none for the capture, ``n_iters`` for each replay (one warm,
    ``n_reps`` timed), as ``core/capture.py`` counts a captured call."""
    from gnn_fpga_tpu_torch.probes.common import layered_graph, timed

    s, r = layered_graph(1024, 4096)
    plans = tsp.build_agg_plans(s, r, 1024).to(dev)
    h = torch.randn(1024, 64, device=dev)
    w = torch.rand(4096, device=dev)
    tsp.reset_launch_counts()
    timed(lambda h, w: tsp.aggregate_pair(h, w, plans), (h, w), n_iters=3,
          n_reps=2)
    counts = tsp.launch_counts()
    assert counts["aggregate_pair"] == 3 + (1 + 2) * 3
    assert sum(counts.values()) == counts["aggregate_pair"]


# ---------------------------------------------------------------------------
# The Interaction Network's sum onto both ends (edge_sum) and its training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hdim", [16, 67, 128])
def test_edge_sum_matches_plain_on_the_card(dev, dtype, hdim):
    """``edge_sum`` forward (``gather_pair_bwd``'s kernel, its halves
    added) against the f64 ``index_add``, and its backward (one
    ``gather_pair`` launch) against the plain gather bit for bit.  In
    bf16 each half is rounded and then their sum, and the halves may
    cancel: atol relative to the largest entry."""
    c = _case(43, 300, 2001, 8, hdim, dev, dtype)
    rng = np.random.default_rng(hdim)
    e = torch.from_numpy(rng.standard_normal((2001, hdim)).astype(
        np.float32)).to(dev, dtype).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((300, hdim)).astype(
        np.float32)).to(dev, dtype)
    n0 = tsp.launch_counts()
    m = tsp.edge_sum(e, c["s"], c["r"], c["plans"])
    (de,) = torch.autograd.grad(m, e, g)
    torch.cuda.synchronize()
    n1 = tsp.launch_counts()
    assert {k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]} == {
        "edge_sum": 1, "gather_pair": 1}
    want = tsp.edge_sum_reference(e.detach().double(), c["s"].long(),
                                  c["r"].long(), 300)
    assert m.dtype == dtype and m.shape == (300, hdim)
    tol = TOL[dtype]
    torch.testing.assert_close(
        m.double(), want, rtol=tol["rtol"],
        atol=max(tol["atol"], tol["rtol"] * float(want.abs().max())))
    assert torch.equal(de, tsp.gather_pair_reference(g, g, c["s"], c["r"]))


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_interaction_gnn_captured_run_steps_match_eager(dev, dtype):
    """Two ``run_steps`` calls on a stack of 3 composed batches, the
    first eager and captured and the second one replay, against the same
    calls dispatched op by op (``capture=False``): losses and weights at
    rtol 1e-5, the same launches, ``n_iters`` sums a step."""
    from gnn_fpga_tpu_torch.models import interaction_gnn as ign
    from gnn_fpga_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                                  stack_batches)

    batches = _composed_batches(dev, 3, seed=9)
    base = ign.init_interaction_gnn(
        ign.InteractionGNNConfig(hidden_dim=128, n_iters=2, mlp_layers=3,
                                 compute_dtype=dtype),
        torch.Generator().manual_seed(5), dev)
    cfg = TrainConfig(learning_rate=3e-3, pos_weight=8.0,
                      lr_schedule="cosine", decay_steps=6)
    stack = stack_batches(batches)
    runs = {}
    for capture in (True, False):
        model = ign.InteractionGNN(base.cfg, torch.Generator(), dev)
        model.load_state_dict(base.state_dict())
        tr = Trainer(model, cfg, capture=capture)
        first = tr.run_steps(stack)
        tsp.reset_launch_counts()
        second, replays = _count_replays(lambda: tr.run_steps(stack))
        runs[capture] = (np.concatenate([first, second]),
                         tsp.launch_counts(),
                         [p.detach().clone() for p in model.parameters()])
        assert replays == capture
    (got, got_n, got_w), (want, want_n, want_w) = runs[True], runs[False]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got_n == want_n
    k, n, layers = 3, 2, 3
    # every hidden layer of the five MLPs is one layer_norm_relu a way
    hidden = layers * (2 * n + 3)
    assert {key: v for key, v in got_n.items() if v} == {
        "edge_sum": k * n, "gather_pair": k * (2 * n + 2),
        "gather_pair_bwd": k * (n + 2), "layer_norm_relu": k * hidden,
        "layer_norm_relu_bwd": k * hidden}
    for a, b in zip(got_w, want_w):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# An MLP's hidden layer after its bias-free Linear: bias, LayerNorm and ReLU
# in one kernel a direction (ops/cuda/layer_norm.py)
# ---------------------------------------------------------------------------

LN_EPS = 1e-5
# the Interaction Network's packed fullevent rows: edges and nodes
LN_ROWS = (180_736, 15_848)


def _ln_case(dev, rows, dtype, bias=True, h=128, seed=0, dead=False):
    """Rows ``y`` ~ N(0, 1), a bias ~ N(0, 1) / 4, a scale and a shift
    U(-1, 1) as the Interaction Network draws them, and an output
    gradient ``dz`` ~ N(0, 1), made on the card.  ``dead``: a scale in
    [0, 1/4] and a shift of -3, so that every output is <= 0 (a
    normalised row of ``h`` values lies within sqrt(h - 1), 11.3 at 128)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    u = lambda *shape: torch.rand(*shape, generator=gen, device=dev) * 2 - 1
    c = dict(y=n(rows, h), b=n(h) / 4 if bias else None, g=u(h),
             beta=u(h), dz=n(rows, h))
    if dead:
        c["g"], c["beta"] = c["g"].abs() / 4, torch.full_like(c["beta"], -3)
    return {k: None if v is None else v.to(dtype) for k, v in c.items()}


def _ln_run(c):
    """The layer through autograd on the card: the output and the
    gradients of ``y``, ``b`` (None without one), the scale and the
    shift."""
    from gnn_fpga_tpu_torch.ops.cuda import layer_norm as ln

    leaves = [c["y"].clone().requires_grad_(True),
              None if c["b"] is None else c["b"].clone().requires_grad_(True),
              c["g"].clone().requires_grad_(True),
              c["beta"].clone().requires_grad_(True)]
    out = ln.layer_norm_relu(*leaves, LN_EPS)
    grads = torch.autograd.grad(out, [t for t in leaves if t is not None],
                                c["dz"])
    if c["b"] is None:
        grads = (grads[0], None) + grads[1:]
    return (out,) + tuple(grads)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", LN_ROWS)
def test_layer_norm_relu_matches_plain_on_the_card(dev, rows, dtype, bias):
    """The fused pair at the Interaction Network's shapes (H = 128) against
    ``layer_norm_relu_reference`` and its autograd in f64, with the
    kernels' ReLU mask (a value within f32 rounding of 0 before the ReLU
    cannot flip one element of ``dy``; the output compared on its own
    shows the mask sound): the output and ``dy`` at TOL, one rounding of
    an f32 result each; the column sums (``db``, the scale's, the
    shift's) sum 10^4-10^5 terms that cancel, so their atol is
    PARAM_SUM_ATOL of the largest entry.  One launch a way."""
    from gnn_fpga_tpu_torch.ops.cuda import layer_norm as ln

    c = _ln_case(dev, rows, dtype, bias)
    n0 = tsp.launch_counts()
    out, dy, db, dg, dbeta = _ln_run(c)
    torch.cuda.synchronize()
    n1 = tsp.launch_counts()
    assert {k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]} == {
        "layer_norm_relu": 1, "layer_norm_relu_bwd": 1}
    f64 = lambda t: None if t is None else t.double()
    want = ln.layer_norm_relu_reference(f64(c["y"]), f64(c["b"]),
                                        f64(c["g"]), f64(c["beta"]), LN_EPS)
    assert out.dtype == dtype and out.shape == (rows, 128)
    torch.testing.assert_close(out.double(), want, **TOL[dtype])
    ref = ln.layer_norm_relu_bwd_reference(c["dz"], c["y"], c["b"], c["g"],
                                           c["beta"], LN_EPS, live=out > 0)
    for name, got, w in zip(("dy", "db", "dg", "dbeta"), (dy, db, dg, dbeta),
                            ref):
        if w is None:
            assert got is None and not bias
            continue
        assert got.dtype == dtype, name
        atol = TOL[dtype]["atol"] if name == "dy" else \
            PARAM_SUM_ATOL[dtype] * float(w.abs().max())
        torch.testing.assert_close(got.double(), w, rtol=TOL[dtype]["rtol"],
                                   atol=atol, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_relu_repeats_and_its_mask_is_the_forwards(dev, dtype):
    """Two calls are bit-equal (forward, statistics and every gradient:
    no atomics, a grid fixed by the rows); with ``dz`` all ones the
    shift's gradient counts each column's live outputs, so the
    backward's recomputed mask is the forward's ``out > 0`` exactly
    (integer sums in f32, rounded once)."""
    from gnn_fpga_tpu_torch.ops.cuda import layer_norm as ln

    c = _ln_case(dev, LN_ROWS[0], dtype, seed=1)
    a, b = _ln_run(c), _ln_run(c)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    args = (c["y"], c["b"], c["g"], c["beta"])
    out, mean, rstd = ln.layer_norm_relu_fwd(*args, LN_EPS)
    assert torch.equal(out, a[0])
    _, _, _, dbeta = ln.layer_norm_relu_bwd(torch.ones_like(out), *args,
                                            mean, rstd)
    live = (out > 0).sum(0)
    assert 0 < int(live.sum()) < out.numel()
    assert torch.equal(dbeta, live.float().to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_relu_dead_rows_pass_no_gradient(dev, dtype):
    """Every output <= 0: the output, ``dy`` and every column sum are
    zeros."""
    for t in _ln_run(_ln_case(dev, LN_ROWS[1], dtype, dead=True, seed=2)):
        assert not t.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [8, 72, 136, 256])
def test_layer_norm_relu_widths_on_the_card(dev, dtype, h):
    """Every instantiation (1-4 16-byte items a lane in f32, 1-2 in bf16)
    against the reference, on 1,000 rows (rows past a block's last group
    too) and on a view 8 bytes off 16-byte alignment, which the wrapper
    copies first."""
    from gnn_fpga_tpu_torch.ops.cuda import layer_norm as ln

    c = _ln_case(dev, 1000, dtype, h=h, seed=h)
    base = torch.empty(1000 * h + 8, dtype=dtype, device=dev)
    off = 8 // dtype.itemsize
    view = base[off:off + 1000 * h].view(1000, h)
    view.copy_(c["y"])
    assert view.data_ptr() % 16 == 8
    out, dy, db, dg, dbeta = _ln_run(c)
    got = ln.layer_norm_relu(view, c["b"], c["g"], c["beta"], LN_EPS)
    assert torch.equal(got, out)
    f64 = lambda t: t.double()
    want = ln.layer_norm_relu_reference(*(f64(c[k]) for k in
                                          ("y", "b", "g", "beta")), LN_EPS)
    torch.testing.assert_close(out.double(), want, **TOL[dtype])
    ref = ln.layer_norm_relu_bwd_reference(c["dz"], c["y"], c["b"], c["g"],
                                           c["beta"], LN_EPS, live=out > 0)
    torch.testing.assert_close(dy.double(), ref[0], **TOL[dtype])
    for got_sum, w in zip((db, dg, dbeta), ref[1:]):
        torch.testing.assert_close(
            got_sum.double(), w, rtol=TOL[dtype]["rtol"],
            atol=PARAM_SUM_ATOL[dtype] * float(w.abs().max()))


def test_interaction_gnn_on_the_card_matches_the_cpu(dev):
    """One forward and backward of the Interaction Network (H = 128, 2
    iterations, 3 layers an MLP) in f32 on a packed 4-sector graph, on
    the card (the kernels) and on the CPU (their plain versions) from the
    same weights: the logits and every leaf's gradient.  Both sides
    compute the same f32 sums in another order (GEMMs, segment sums,
    statistics): the largest gap measured on an H100 was 3.7e-7 of a
    leaf's largest gradient entry, so IGN_TOL's 1e-5 leaves 27x room."""
    from gnn_fpga_tpu_torch.models import interaction_gnn as ign
    from gnn_fpga_tpu_torch.train.trainer import masked_bce_with_logits

    g = _composed_batches(dev, 1, seed=11)[0]
    cfg = ign.InteractionGNNConfig(hidden_dim=128, n_iters=2, mlp_layers=3)
    card = ign.init_interaction_gnn(cfg, torch.Generator().manual_seed(7),
                                    dev)
    cpu = ign.InteractionGNN(cfg, torch.Generator(), "cpu")
    with torch.no_grad():
        # LayerNorm scales and shifts U(-1, 1), as the benchmark draws them
        gen = torch.Generator().manual_seed(8)
        for m in card.modules():
            if isinstance(m, torch.nn.LayerNorm):
                for p in (m.weight, m.bias):
                    p.copy_(torch.rand(p.shape, generator=gen) * 2 - 1)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    runs = []
    for model, graph in ((card, g), (cpu, g.to("cpu"))):
        logits = model(graph)
        masked_bce_with_logits(logits, graph.y, graph.edge_mask,
                               8.0).backward()
        runs.append((logits.detach().cpu(),
                     {k: p.grad.cpu() for k, p in model.named_parameters()}))
    (got, got_g), (want, want_g) = runs
    gaps = {"logits": float((got - want).abs().max())}
    torch.testing.assert_close(got, want, **IGN_TOL["logits"])
    for name, w in want_g.items():
        gaps[name] = float((got_g[name] - w).abs().max() / w.abs().max())
        torch.testing.assert_close(
            got_g[name], w, rtol=IGN_TOL["grads"]["rtol"],
            atol=IGN_TOL["grads"]["atol"] * float(w.abs().max()), msg=name)
    print("largest gaps (logits absolute, gradients over their largest "
          "entry):", max(gaps.items(), key=lambda kv: kv[1]))


# rtol, atol (the gradients' atol a share of the leaf's largest entry)
IGN_TOL = {"logits": dict(rtol=1e-5, atol=1e-5),
           "grads": dict(rtol=1e-4, atol=1e-5)}
