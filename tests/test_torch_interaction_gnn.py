"""The Interaction Network (``models/interaction_gnn.py``) and its sum onto
both ends (``ops/cuda/spmm.py::edge_sum``) on the CPU.

The oracle is the benchmark's plain reference of the model
(``port_bench/families/interaction_gnn.py``: float32, the published
concatenated first layers, ``index_add``), which shares no code with the
port; the JAX package has no Interaction Network.  Weights are drawn from
a seed in the reference's leaves and copied into the port's module by
name.  On the CPU the model's route runs the kernels' plain versions over
the plans; the kernels themselves are held to the plain versions on the
card (``tests/test_torch_cuda.py``).
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gnn_fpga_tpu_torch.core import graph as tg
from gnn_fpga_tpu_torch.data import toy2d
from gnn_fpga_tpu_torch.models import interaction_gnn as ign
from gnn_fpga_tpu_torch.ops.cuda import spmm as tsp
from gnn_fpga_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                              masked_bce_with_logits,
                                              stack_batches)
from port_bench.families import interaction_gnn as ref

H, ITERS, LAYERS = 16, 2, 3
CFG = dict(input_dim=2, hidden_dim=H, n_iters=ITERS, mlp_layers=LAYERS)


def _sectors(seed=0, n=2):
    """``n`` Toy2D kNN sector graphs, every edge real."""
    cfg = toy2d.Toy2DConfig(n_layers=6, n_tracks=4, seed=seed)
    return tg.unbatch_graphs(toy2d.make_knn_segment_graphs(cfg, n, k=3))


def _packed(graphs, pad_nodes=5, pad_edges=7, plans=True):
    """The graphs packed into one, with ``pad_nodes`` pad nodes and
    ``pad_edges`` pad edges (on the first pad node, or on node 0 when
    there is no pad node), plans attached."""
    n = sum(g.n_node for g in graphs) + pad_nodes
    e = sum(g.n_edge for g in graphs) + pad_edges
    g = tg.pack_graphs(graphs, n_node=n, n_edge=e)
    return tg.attach_plans(g) if plans else g


def _weights(seed=0):
    """The reference's leaves drawn from ``seed``, each U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) (LayerNorm's fan-in 1)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, fan_in in ref.leaves(CFG):
        bound = 1.0 / math.sqrt(fan_in)
        out[name] = (torch.rand(shape, generator=gen) * 2 - 1) * bound
    return out


def _model(w, compute_dtype=None):
    model = ign.init_interaction_gnn(
        ign.InteractionGNNConfig(**CFG, compute_dtype=compute_dtype),
        torch.Generator().manual_seed(1), "cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(w[name])
    return model


def _ref_graph(graphs):
    """The real graph as the reference takes it: the sectors' nodes and
    edges concatenated, ids offset, no padding."""
    off = np.cumsum([0] + [g.n_node for g in graphs])
    cat = lambda k: torch.cat([getattr(g, k) for g in graphs])
    ids = lambda k: torch.cat([getattr(g, k).long() + int(o)
                               for g, o in zip(graphs, off)])
    return dict(x=cat("x"), senders=ids("senders"),
                receivers=ids("receivers"), y=cat("y"))


def test_parameters_are_the_references_leaves():
    model = _model(_weights())
    assert [(n, tuple(p.shape)) for n, p in model.named_parameters()] == [
        (n, s) for n, s, _ in ref.leaves(CFG)]
    # the published initialisation of the LayerNorms: scale 1, shift 0
    fresh = ign.init_interaction_gnn(ign.InteractionGNNConfig(**CFG),
                                     torch.Generator().manual_seed(0), "cpu")
    for name, p in fresh.named_parameters():
        if name.endswith(".1.weight") or name.endswith(".4.weight"):
            assert torch.equal(p, torch.ones_like(p)), name
    assert sum(p.numel() for p in fresh.parameters()) == sum(
        math.prod(s) for _, s, _ in ref.leaves(CFG))


def test_logits_and_gradients_match_the_reference_in_f32():
    """Real edges only.  Both sides compute in float32 the same sums in
    another order (projection form against the concatenated Linear,
    sorted segment sums against ``index_add``): round-off of a few ulps
    (9e-8 on logits up to 0.26 here), grown by two iterations and the
    LayerNorms' division, so 1e-6."""
    graphs = _sectors()
    g = _packed(graphs)
    n_real = sum(x.n_edge for x in graphs)
    w = _weights()
    model = _model(w)
    got = model(g)
    loss = masked_bce_with_logits(got, g.y, g.edge_mask, 8.0)
    loss.backward()

    leaf = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    rg = _ref_graph(graphs)
    want = ref.logits(leaf, rg, CFG, lambda t: t)
    per = F.binary_cross_entropy_with_logits(want, rg["y"],
                                             reduction="none")
    want_loss = (per * torch.where(rg["y"] > 0.5, 8.0, 1.0)).mean()
    grads = torch.autograd.grad(want_loss, list(leaf.values()))
    torch.testing.assert_close(got[:n_real], want.detach(), rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(loss, want_loss.detach(), rtol=2e-6,
                               atol=2e-6)
    params = dict(model.named_parameters())
    for (name, _), gr in zip(leaf.items(), grads):
        # a gradient is a sum over every edge or node: atol relative to
        # the leaf's largest entry
        torch.testing.assert_close(params[name].grad, gr, rtol=1e-4,
                                   atol=1e-5 * float(gr.abs().max()),
                                   msg=name)


def test_bf16_stays_within_its_bound():
    """bf16 compute over f32 weights against the f32 reference: each
    rounding is 2^-9 relative; ~30 roundings in a row through two
    iterations, with the LayerNorms renormalising, moved a logit by 1.05%
    of the largest here, so 3%."""
    graphs = _sectors(seed=4)
    g = _packed(graphs)
    n_real = sum(x.n_edge for x in graphs)
    w = _weights(seed=4)
    with torch.no_grad():
        got = _model(w, compute_dtype=torch.bfloat16)(g)[:n_real]
        want = ref.logits(w, _ref_graph(graphs), CFG, lambda t: t)
    assert got.dtype == torch.float32
    gap = float((got - want).abs().max())
    assert gap <= 0.03 * float(want.abs().max()), gap
    # and bf16 does differ: the bound is not met by f32 alone
    assert gap > 0


def _sum_case(seed, v=30, e=90, h=12, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, v - 1, e).astype(np.int32)
    r = rng.integers(0, v - 1, e).astype(np.int32)
    s[:5] = r[:5] = 3          # a hub
    plans = tsp.build_agg_plans(s, r, v)
    rows = torch.from_numpy(rng.standard_normal((e, h))).to(dtype)
    return rows, torch.from_numpy(s), torch.from_numpy(r), plans, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_edge_sum_is_index_add_onto_both_ends(dtype):
    e, s, r, plans, v = _sum_case(1, dtype=dtype)
    got = tsp.edge_sum(e, s, r, plans)
    acc = e.double()
    want = (torch.zeros(v, e.shape[1], dtype=torch.float64)
            .index_add_(0, r.long(), acc).index_add_(0, s.long(), acc))
    assert got.dtype == dtype and got.shape == (v, e.shape[1])
    # f32 and f64: summation order; bf16: one rounding of the f32 sum
    tol = {torch.float32: 1e-6, torch.float64: 1e-12,
           torch.bfloat16: 2 ** -8}[dtype]
    torch.testing.assert_close(got.double(), want, rtol=tol, atol=tol)
    # a node with no edge gets a zero row
    assert torch.equal(got[v - 1], torch.zeros_like(got[v - 1]))


def test_edge_sum_gradient_passes_gradcheck_in_f64():
    e, s, r, plans, _ = _sum_case(2, v=12, e=30, h=3, dtype=torch.float64)
    e.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda t: tsp.edge_sum(t, s, r, plans), (e,))
    # the gradient is g[s] + g[r]
    g = torch.randn(12, 3, dtype=torch.float64)
    (de,) = torch.autograd.grad(tsp.edge_sum(e, s, r, plans), e, g)
    torch.testing.assert_close(de, g[s.long()] + g[r.long()])


@pytest.mark.parametrize("with_edges", [True, False])
def test_projection_form_equals_the_concatenated_linear(with_edges):
    rng = np.random.default_rng(3)
    v, n_edge, hd = 20, 50, 8
    h = torch.from_numpy(rng.standard_normal((v, hd)))
    e = torch.from_numpy(rng.standard_normal((n_edge, hd)))
    s = torch.from_numpy(rng.integers(0, v, n_edge))
    r = torch.from_numpy(rng.integers(0, v, n_edge))
    k = 3 if with_edges else 2
    w = torch.from_numpy(rng.standard_normal((hd, k * hd)))
    b = torch.from_numpy(rng.standard_normal(hd))
    parts = [h[s], h[r]] + ([e] if with_edges else [])
    want = F.linear(torch.cat(parts, dim=1), w, b)
    got = ign.pair_first_layer(w, b, h, e if with_edges else None,
                               lambda pa, pb: pa[s] + pb[r])
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("pad_nodes", [5, 1])
def test_pad_rows_are_finite_and_change_no_real_logit(pad_nodes):
    """Pad edges on the first pad node (5 pad nodes, or the one): the
    real edges' logits equal the unpadded graph's, every logit is finite,
    and junk in the pad nodes' features moves no real logit.  No mask is
    applied: the padding convention keeps pad rows off real nodes."""
    graphs = _sectors(seed=2)
    n_real = sum(x.n_edge for x in graphs)
    model = _model(_weights(seed=2))
    with torch.no_grad():
        bare = model(_packed(graphs, pad_nodes=0, pad_edges=0))
        g = _packed(graphs, pad_nodes=pad_nodes, pad_edges=9)
        padded = model(g)
        assert torch.isfinite(padded).all()
        torch.testing.assert_close(padded[:n_real], bare, rtol=1e-6,
                                   atol=1e-6)
        x = g.x.clone()
        x[-pad_nodes:] = 1e3
        junk = model(g.replace(x=x))
        assert torch.isfinite(junk).all()
        torch.testing.assert_close(junk[:n_real], bare, rtol=1e-6,
                                   atol=1e-6)


def test_pad_edges_without_a_pad_node_raise():
    """With no pad node the pad edges sit on the real node 0, where the
    unmasked sum would add their rows: the forward refuses the graph."""
    graphs = _sectors(seed=2)
    model = _model(_weights(seed=2))
    with pytest.raises(ValueError, match="pad node"):
        model(_packed(graphs, pad_nodes=0, pad_edges=9))


def test_wrong_uses_raise():
    graphs = _sectors()
    model = _model(_weights())
    with pytest.raises(ValueError, match="plans"):
        model(_packed(graphs, plans=False))
    with pytest.raises(ValueError, match="pack"):
        model(tg.batch_graphs(graphs))
    with pytest.raises(ValueError, match="masks"):
        model(_packed(graphs), {"edge": {}})


def test_run_steps_trains_it_as_one_step_at_a_time_does():
    """``Trainer.run_steps`` takes the model unchanged: a stack of three
    packed batches in one call equals three one-batch calls, and the loss
    falls over a few calls."""
    batches = [_packed(_sectors(seed=k)) for k in range(3)]
    cap = tsp.PlanCapacity.covering(*(b.plans for b in batches))
    batches = [b.replace(plans=tsp.pad_plans(b.plans, cap)) for b in batches]
    cfg = TrainConfig(learning_rate=3e-3, pos_weight=8.0)
    w = _weights(seed=6)
    stacked = Trainer(_model(w, compute_dtype=torch.bfloat16), cfg)
    one = Trainer(_model(w, compute_dtype=torch.bfloat16), cfg)
    got = stacked.run_steps(stack_batches(batches))
    want = np.concatenate([one.run_steps([b]) for b in batches])
    np.testing.assert_array_equal(got, want)
    losses = [stacked.run_steps(batches).mean() for _ in range(6)]
    assert all(np.isfinite(losses)) and losses[-1] < got.mean()
