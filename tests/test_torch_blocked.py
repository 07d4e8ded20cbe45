"""The port's dense and blocked SegmentClassifier routes, the blocked plan
and the graph helpers they use, against the JAX package, with the same
inputs and weights (``load_jax_params``).

Layered graphs (every real edge from layer ``l`` to ``l+1``) are the
blocked route's domain; the cases follow ``tests/test_blocked.py``: ragged
layers, grouped blocks, a padded graph, a batch, gradients, the Trainer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_fpga_tpu.core import graph as jg
from gnn_fpga_tpu.models import mpnn as jm
from gnn_fpga_tpu.ops import blocked as jblk
from gnn_fpga_tpu.train import trainer as jtrainer
from gnn_fpga_tpu_torch.core import graph as tg
from gnn_fpga_tpu_torch.data import toy2d
from gnn_fpga_tpu_torch.models import mpnn as tm
from gnn_fpga_tpu_torch.ops import blocked as tblk
from gnn_fpga_tpu_torch.train import trainer as ttrainer
from gnn_fpga_tpu_torch.utils import serialization as tser

TOL = dict(rtol=2e-5, atol=2e-6)           # tests/test_blocked.py
GRAD_TOL = dict(rtol=5e-5, atol=5e-6)      # tests/test_blocked.py
FIELDS = ("x", "senders", "receivers", "y", "node_mask", "edge_mask")


def _layered(seed, nodes_per_layer, k=3, n_feat=3):
    """Random layered graph with ragged layers, as (port, JAX) graphs and
    the layer offsets: each node on layer l+1 draws k senders on layer l."""
    rng = np.random.default_rng(seed)
    off = np.concatenate([[0], np.cumsum(nodes_per_layer)])
    senders, receivers = [], []
    for layer in range(len(nodes_per_layer) - 1):
        for r in range(off[layer + 1], off[layer + 2]):
            kk = min(k, nodes_per_layer[layer])
            senders.append(rng.choice(np.arange(off[layer], off[layer + 1]),
                                      size=kk, replace=False))
            receivers.append(np.full(kk, r))
    s, r = np.concatenate(senders), np.concatenate(receivers)
    x = rng.normal(size=(int(off[-1]), n_feat)).astype(np.float32)
    y = rng.integers(0, 2, size=len(s)).astype(np.float32)
    return tg.from_coo(x, s, r, y), jg.from_coo(x, s, r, y), off


def _to_jax(g: tg.Graph) -> jg.Graph:
    return jg.Graph(**{k: getattr(g, k).numpy() for k in FIELDS})


def _toy_batch(seed, n_events=4, n_layers=6, n_tracks=5, k=3):
    cfg = toy2d.Toy2DConfig(n_layers=n_layers, n_tracks=n_tracks, seed=seed)
    g = toy2d.make_knn_segment_graphs(cfg, n_events, k=k)
    return g, _to_jax(g), toy2d.layer_offsets(cfg)


def _assert_same_blocking(tb: tg.Graph, jb: jg.Graph):
    for f in ("senders", "receivers", "y", "edge_mask"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    for f in ("block_nodes", "src_local", "dst_local"):
        got, want = getattr(tb.blocks, f), np.asarray(getattr(jb.blocks, f))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)


def _models(seed, aggregation, input_dim=3, hidden=8, n_iters=3):
    cfg_j = jm.SegmentClassifierConfig(input_dim=input_dim, hidden_dim=hidden,
                                       n_iters=n_iters,
                                       aggregation=aggregation)
    params = jm.init_segment_classifier(jax.random.PRNGKey(seed), cfg_j)
    model = tm.init_segment_classifier(
        tm.SegmentClassifierConfig(input_dim=input_dim, hidden_dim=hidden,
                                   n_iters=n_iters, aggregation=aggregation),
        torch.Generator().manual_seed(seed), device="cpu")
    tser.load_jax_params(model, jax.tree.map(np.asarray, params))
    return cfg_j, params, model


# ---------------------------------------------------------------------------
# The blocked plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group", [1, 2, 3])
def test_attach_blocks_matches_jax_ragged_layers(group):
    tgr, jgr, off = _layered(0, [5, 9, 4, 7, 6])
    tb = tblk.attach_blocks_layered(tgr, off, group=group)
    jb = jblk.attach_blocks_layered(jgr, off, group=group)
    _assert_same_blocking(tb, jb)
    assert tb.blocks.n_blocks == -(-4 // group)
    assert int(tb.edge_mask.sum()) == tgr.n_edge


def test_attach_blocks_matches_jax_padded_graph_and_pins():
    tgr, jgr, off = _layered(1, [4, 6, 5], k=2)
    off_p = np.concatenate([off[:-1], [24]])  # pad nodes join the top layer
    tb = tblk.attach_blocks_layered(tg.pad_graph(tgr, 24, 40), off_p,
                                    block_e=40, block_n=24)
    jb = jblk.attach_blocks_layered(jg.pad_graph(jgr, 24, 40), off_p,
                                    block_e=40, block_n=24)
    _assert_same_blocking(tb, jb)
    assert (tb.blocks.block_e, tb.blocks.block_n) == (40, 24)
    with pytest.raises(ValueError, match="block_e"):
        tblk.attach_blocks_layered(tgr, off, block_e=8)


def test_attach_blocks_matches_jax_batched_toy_knn():
    tgr, jgr, off = _toy_batch(3)
    offs = np.broadcast_to(off, (4, len(off)))   # one offset row per graph
    tb = tblk.attach_blocks_layered(tgr, offs, group=2)
    jb = jblk.attach_blocks_layered(jgr, offs, group=2)
    _assert_same_blocking(tb, jb)
    assert tb.blocks.block_nodes.shape == (4, 3, 16)
    assert float(tb.y.sum()) == float(tgr.y.sum())


def test_blocked_rejects_non_layered_and_missing_plan():
    tgr, _, off = _layered(7, [4, 4, 4], k=2)
    with pytest.raises(ValueError, match="layered"):
        tblk.attach_blocks_layered(tgr.replace(receivers=tgr.senders), off)
    with pytest.raises(ValueError, match="2 layers"):
        tblk.attach_blocks_layered(tgr, off[:2])
    _, _, model = _models(6, "blocked", n_iters=1)
    with torch.no_grad(), pytest.raises(ValueError, match="blocked"):
        model(tgr)


def test_blocked_plan_follows_the_graph_to_a_device():
    tgr, _, off = _layered(8, [3, 4, 3], k=2)
    tb = tblk.attach_blocks_layered(tgr, off).to("meta")
    assert tb.blocks.src_local.device.type == "meta"


# ---------------------------------------------------------------------------
# Forward and gradients against the JAX package
# ---------------------------------------------------------------------------

def _jax_logits(params, jgraph, cfg_j):
    fn = lambda g: jm.segment_classifier_logits(params, g, cfg_j)
    if np.asarray(jgraph.x).ndim == 3:
        fn = jax.vmap(fn)
    return np.asarray(fn(jax.tree.map(jnp.asarray, jgraph)))


@pytest.mark.parametrize("route,group", [("blocked", 1), ("blocked", 2),
                                         ("blocked", 3), ("dense", 1)])
def test_forward_matches_jax_ragged_layers(route, group):
    tgr, jgr, off = _layered(10 + group, [5, 9, 4, 7, 6])
    tb = tblk.attach_blocks_layered(tgr, off, group=group)
    jb = jblk.attach_blocks_layered(jgr, off, group=group)
    if route == "dense":
        tb, jb = tb.replace(blocks=None), jb.replace(blocks=None)
    cfg_j, params, model = _models(1, route)
    with torch.no_grad():
        got = model(tb)
    assert got.dtype == torch.float32 and got.shape == tb.senders.shape
    np.testing.assert_allclose(got.numpy(), _jax_logits(params, jb, cfg_j),
                               **TOL)
    # the sparse route agrees on the real (permuted) edges
    _, _, sparse = _models(1, "sparse")
    m = tb.edge_mask > 0
    with torch.no_grad():
        np.testing.assert_allclose(got[m].numpy(), sparse(tb)[m].numpy(),
                                   **TOL)


@pytest.mark.parametrize("route", ["blocked", "dense"])
def test_forward_matches_jax_padded_graph(route):
    tgr, jgr, off = _layered(2, [4, 6, 5], k=2)
    off_p = np.concatenate([off[:-1], [24]])
    tb = tblk.attach_blocks_layered(tg.pad_graph(tgr, 24, 40), off_p)
    jb = jblk.attach_blocks_layered(jg.pad_graph(jgr, 24, 40), off_p)
    if route == "dense":
        tb, jb = tb.replace(blocks=None), jb.replace(blocks=None)
    cfg_j, params, model = _models(2, route, n_iters=2)
    with torch.no_grad():
        got = model(tb).numpy()
    m = tb.edge_mask.numpy() > 0
    np.testing.assert_allclose(got[m], _jax_logits(params, jb, cfg_j)[m],
                               **TOL)


@pytest.mark.parametrize("route", ["blocked", "dense"])
def test_forward_matches_jax_batched_toy_knn(route):
    """A batch runs whole ([B, E] logits) and equals the JAX package's
    vmap over its graphs."""
    tgr, jgr, off = _toy_batch(4)
    tb = tblk.attach_blocks_layered(tgr, off, group=2)
    jb = jblk.attach_blocks_layered(jgr, off, group=2)
    if route == "dense":
        tb, jb = tb.replace(blocks=None), jb.replace(blocks=None)
    cfg_j, params, model = _models(3, route, input_dim=2)
    with torch.no_grad():
        got = model(tb)
    assert got.shape == (4, tb.n_edge)
    np.testing.assert_allclose(got.numpy(), _jax_logits(params, jb, cfg_j),
                               **TOL)


@pytest.mark.parametrize("route", ["blocked", "dense"])
def test_gradients_match_jax(route):
    tgr, jgr, off = _toy_batch(5, n_events=3)
    tb = tblk.attach_blocks_layered(tgr, off, group=2)
    jb = jax.tree.map(jnp.asarray, jblk.attach_blocks_layered(jgr, off,
                                                              group=2))
    if route == "dense":
        tb, jb = tb.replace(blocks=None), jb.replace(blocks=None)
    cfg_j, params, model = _models(5, route, input_dim=2, n_iters=2)

    def loss_j(p):
        logits = jax.vmap(lambda g: jm.segment_classifier_logits(
            p, g, cfg_j))(jb)
        return jtrainer.masked_bce_with_logits(logits, jb.y, jb.edge_mask,
                                               8.0)

    want_loss, want = jax.value_and_grad(loss_j)(params)
    loss = ttrainer.masked_bce_with_logits(model(tb), tb.y, tb.edge_mask, 8.0)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    with torch.no_grad():             # the gradients, as a parameter tree
        for p in model.parameters():
            p.copy_(p.grad)
    got = tser.to_jax_params(model)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_routing_follows_jax(monkeypatch):
    """auto takes blocked when blocks are attached, dense on a small batch
    with neither blocks nor plans, and the fused kernels with plans."""
    tgr, _, off = _toy_batch(6)
    tb = tblk.attach_blocks_layered(tgr, off, group=2)
    _, _, auto = _models(7, "auto", input_dim=2)
    calls = []
    for name in ("_blocked_mp_logits", "_dense_mp_logits"):
        monkeypatch.setattr(tm, name, lambda *a, real=getattr(tm, name),
                            name=name: calls.append(name) or real(*a))
    with torch.no_grad():
        blocked = auto(tb)
        dense = auto(tb.replace(blocks=None))
        auto(tg.attach_plans(tg.unbatch_graphs(tb)[0]))
    assert calls == ["_blocked_mp_logits", "_dense_mp_logits"]
    m = tb.edge_mask > 0
    np.testing.assert_allclose(blocked[m].numpy(), dense[m].numpy(), **TOL)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def test_trainer_on_batched_blocked_graphs_matches_jax():
    """Five Adam steps, each on a distinct batch of 3 blocked Toy2D kNN
    graphs taken whole: the per-step losses match the JAX Trainer's."""
    pins = dict(group=2, block_e=40, block_n=16)
    tbatches, jbatches = [], []
    for seed in range(5):
        tgr, jgr, off = _toy_batch(20 + seed, n_events=3)
        tbatches.append(tblk.attach_blocks_layered(tgr, off, **pins))
        jbatches.append(jax.tree.map(
            jnp.asarray, jblk.attach_blocks_layered(jgr, off, **pins)))
    cfg_j, params, model = _models(8, "blocked", input_dim=2, n_iters=2)
    tcfg = dict(learning_rate=3e-3, pos_weight=8.0)
    tr_j = jtrainer.Trainer(
        lambda p, g, m: jm.segment_classifier_logits(p, g, cfg_j, m),
        params, jtrainer.TrainConfig(**tcfg))
    tr_j.fit(iter(jbatches), n_batches=1, n_epochs=5)
    tr_t = ttrainer.Trainer(model, ttrainer.TrainConfig(**tcfg))
    losses = tr_t.run_steps(tbatches)
    np.testing.assert_allclose(losses, tr_j.train_losses, rtol=1e-5)
    p, t, m = tr_t.predict(iter(tbatches[:1]), 1)
    assert p.shape == t.shape == m.shape == (tbatches[0].y.numel(),)


# ---------------------------------------------------------------------------
# Graph helpers and intermediates
# ---------------------------------------------------------------------------

def test_layer_offsets_from_layers_matches_jax():
    layers = np.array([0, 0, 1, 1, 1, 3, 3, 4])      # layer 2 is empty
    for n_layers in (None, 7):
        np.testing.assert_array_equal(
            tg.layer_offsets_from_layers(torch.from_numpy(layers), n_layers),
            jg.layer_offsets_from_layers(layers, n_layers))
    with pytest.raises(ValueError, match="sorted"):
        tg.layer_offsets_from_layers(layers[::-1].copy())


def test_dense_incidence_round_trip_matches_jax():
    tgr, jgr, _ = _layered(9, [3, 4, 3], k=2)
    em = np.ones(tgr.n_edge, np.float32)
    em[::5] = 0
    tgr = tgr.replace(edge_mask=torch.from_numpy(em))
    jgr = jgr.replace(edge_mask=em)
    for a, b in zip(tg.to_dense_incidence(tgr), jg.to_dense_incidence(jgr)):
        np.testing.assert_array_equal(a, b)
    back = tg.from_dense_incidence(*tg.to_dense_incidence(tgr))
    want = jg.from_dense_incidence(*jg.to_dense_incidence(jgr))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


def test_segment_classifier_intermediates_match_jax():
    tgr, jgr, _ = _layered(11, [4, 5, 4], k=2)
    cfg_j, params, model = _models(9, "sparse", n_iters=2)
    p_j, es_j, hs_j = jm.segment_classifier_intermediates(params, jgr, cfg_j)
    with torch.no_grad():
        p_t, es_t, hs_t = tm.segment_classifier_intermediates(model, tgr)
    assert len(es_t) == 2 and len(hs_t) == 3
    for a, b in zip([p_t, *es_t, *hs_t], [p_j, *es_j, *hs_j]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
