"""The port's other message-passing heads, SegmentClassifierUnshared and
NodeClassifier, against the JAX package's, with the same parameters carried
across by ``load_jax_params``, on the same Toy2D hit-classification graphs
(``make_seeded_node_graphs``).

Every route is held against the same route of the JAX package: ``sparse``,
``dense``, ``blocked`` and ``pallas`` (fused and unfused; the JAX side runs
its Pallas kernels in interpret mode, the port the plain versions of its
kernels).  "Batched" is a batch ``[B, V, F]`` on the first three routes and
several events packed into one graph on ``pallas``, the pallas route's own
batching."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from gnn_fpga_tpu.compress import pruning as jpruning
from gnn_fpga_tpu.core import graph as jg
from gnn_fpga_tpu.data import toy2d as jtoy2d
from gnn_fpga_tpu.models import mpnn as jm
from gnn_fpga_tpu.ops import blocked as jblk
from gnn_fpga_tpu.train import trainer as jtrainer
from gnn_fpga_tpu.utils import serialization as jser
from gnn_fpga_tpu_torch.compress import pruning as tpruning
from gnn_fpga_tpu_torch.core import graph as tg
from gnn_fpga_tpu_torch.data import toy2d
from gnn_fpga_tpu_torch.models import mpnn as tm
from gnn_fpga_tpu_torch.ops import blocked as tblk
from gnn_fpga_tpu_torch.ops.cuda import spmm as tsp
from gnn_fpga_tpu_torch.train import trainer as ttrainer
from gnn_fpga_tpu_torch.utils import serialization as tser

F32_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16 compute: both packages round activations to bf16 after every
# layer, at different points inside the aggregation (tests/test_torch_mpnn.py)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
# the JAX package's model-gradient tolerance (tests/test_pallas_spmm.py)
MODEL_GRAD_TOL = dict(rtol=2e-3, atol=1e-5)

N_LAYERS, N_TRACKS, F, HID, ITERS = 4, 3, 3, 8, 2
V1 = N_LAYERS * N_TRACKS                       # nodes of one event
E1 = (N_LAYERS - 1) * N_TRACKS * N_TRACKS      # edges of one event
FIELDS = ("x", "senders", "receivers", "y", "node_mask", "edge_mask",
          "node_y")

HEADS = {
    "unshared": dict(
        jcfg=jm.SegmentClassifierConfig,
        jinit=jm.init_segment_classifier_unshared,
        jlogits=jm.segment_classifier_unshared_logits,
        tcfg=tm.SegmentClassifierConfig,
        tinit=tm.init_segment_classifier_unshared,
        tlogits=tm.segment_classifier_unshared_logits),
    "node": dict(
        jcfg=jm.NodeClassifierConfig, jinit=jm.init_node_classifier,
        jlogits=jm.node_classifier_logits, tcfg=tm.NodeClassifierConfig,
        tinit=tm.init_node_classifier, tlogits=tm.node_classifier_logits),
}
ROUTES = {
    "sparse": dict(aggregation="sparse"),
    "dense": dict(aggregation="dense"),
    "blocked": dict(aggregation="blocked"),
    "pallas_fused": dict(aggregation="pallas", fused_iteration=True),
    "pallas_unfused": dict(aggregation="pallas", fused_iteration=False),
}


def _to_jax(g: tg.Graph) -> jg.Graph:
    return jg.Graph(**{k: getattr(g, k).numpy() for k in FIELDS})


def _events(seed, n_events=3):
    cfg = toy2d.Toy2DConfig(n_layers=N_LAYERS, n_tracks=N_TRACKS, seed=seed)
    return toy2d.make_seeded_node_graphs(cfg, n_events), toy2d.layer_offsets(
        cfg)


def _graphs(route, batched, seed=0):
    """The same graph for both packages on ``route``: one padded event
    (masked pad edges on its pad node) or a batch of 3 events, packed on
    the pallas route with its edges padded to the JAX plans' tile (32)."""
    tb, off = _events(seed)
    events = tg.unbatch_graphs(tb)
    if route.startswith("pallas"):
        events = events if batched else events[:1]
        n_edge = -(-(len(events) * E1 + 1) // 32) * 32
        t = tg.pack_graphs(events, n_node=len(events) * V1 + 1, n_edge=n_edge)
        return tg.attach_plans(t), jg.attach_plans(_to_jax(t), tile_e=32)
    if batched:
        t, offs = tb, np.broadcast_to(off, (tb.x.shape[0], len(off)))
    else:
        t = tg.pad_graph(events[0], V1 + 1, E1 + 8)
        offs = np.concatenate([off[:-1], [V1 + 1]])   # pad node: top layer
    j = _to_jax(t)
    if route == "blocked":
        t = tblk.attach_blocks_layered(t, offs)
        j = jblk.attach_blocks_layered(j, offs)
    return t, jax.tree.map(jnp.asarray, j)


def _models(head, seed=0, **kw):
    """JAX params of ``head`` and a port model holding the same weights;
    ``kw`` are config fields (``compute_dtype`` as a torch dtype; ``remat``
    only on the port's side)."""
    h = HEADS[head]
    jkw = {k: v for k, v in kw.items() if k not in ("compute_dtype", "remat")}
    if "compute_dtype" in kw:
        jkw["compute_dtype"] = jnp.bfloat16
    cfg_j = h["jcfg"](input_dim=F, hidden_dim=HID, n_iters=ITERS, **jkw)
    params = h["jinit"](jax.random.PRNGKey(seed), cfg_j)
    model = h["tinit"](h["tcfg"](input_dim=F, hidden_dim=HID, n_iters=ITERS,
                                 **kw),
                       torch.Generator().manual_seed(seed))
    tser.load_jax_params(model, jax.tree.map(np.asarray, params))
    return cfg_j, params, model


def _variant(model, **kw):
    m = type(model)(dataclasses.replace(model.cfg, **kw), torch.Generator())
    m.load_state_dict(model.state_dict())
    return m


def _jax_logits(head, params, g, cfg_j, masks=None):
    fn = lambda gg: HEADS[head]["jlogits"](params, gg, cfg_j, masks)
    if np.asarray(g.x).ndim == 3:
        fn = jax.vmap(fn)
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(g))


def _target(head, g):
    """(targets, mask) of the head's loss."""
    if head == "node":
        return g.node_y, g.node_mask
    return g.y, g.edge_mask


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers,n_tracks,seed,seed_layers",
                         [(4, 3, 0, 3), (7, 5, 11, 2)])
def test_make_seeded_node_graphs_matches_jax(n_layers, n_tracks, seed,
                                             seed_layers):
    got = toy2d.make_seeded_node_graphs(
        toy2d.Toy2DConfig(n_layers=n_layers, n_tracks=n_tracks, seed=seed), 6,
        seed_layers=seed_layers)
    want = jtoy2d.make_seeded_node_graphs(
        jtoy2d.Toy2DConfig(n_layers=n_layers, n_tracks=n_tracks, seed=seed),
        6, seed_layers=seed_layers)
    for f in FIELDS:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == (torch.int32 if f in ("senders", "receivers")
                           else torch.float32), f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    assert got.x.shape == (6, n_layers * n_tracks, 3)


# ---------------------------------------------------------------------------
# Forward on every route, against the same route of the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("head", list(HEADS))
def test_logits_match_jax(head, route, batched):
    tgraph, jgraph = _graphs(route, batched, seed=1)
    cfg_j, params, model = _models(head, seed=2, **ROUTES[route])
    want = _jax_logits(head, params, jgraph, cfg_j)
    with torch.no_grad():
        got = model(tgraph)
    n = tgraph.n_node if head == "node" else tgraph.n_edge
    lead = (tgraph.x.shape[0],) if tgraph.x.ndim == 3 else ()
    assert got.dtype == torch.float32 and got.shape == lead + (n,)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("route", ["pallas_fused", "dense"])
@pytest.mark.parametrize("head", list(HEADS))
def test_bf16_logits_match_jax(head, route):
    """compute_dtype reaches every parameter of the new heads (the stacked
    iterations and the output layers) on the kernel and dense preludes."""
    tgraph, jgraph = _graphs(route, True, seed=3)
    cfg_j, params, model = _models(head, seed=3, compute_dtype=torch.bfloat16,
                                   **ROUTES[route])
    want = _jax_logits(head, params, jgraph, cfg_j)
    with torch.no_grad():
        got = model(tgraph)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **BF16_TOL)
    with torch.no_grad():
        f32 = _variant(model, compute_dtype=None)(tgraph)
    assert not torch.equal(got, f32)


@pytest.mark.parametrize("route,masked,remat", [
    ("pallas_fused", True, False), ("pallas_unfused", True, True),
    ("sparse", True, True), ("dense", True, False), ("pallas_fused", False,
                                                     True)])
def test_node_classifier_masks_and_remat_match_jax(route, masked, remat):
    """Masks on the edge and node networks (the output layer unmasked, as
    in the JAX package) and remat; remat only on the port's side: it
    changes no value, and jax.checkpoint does not trace the Pallas
    interpreter's callbacks."""
    tgraph, jgraph = _graphs(route, True, seed=4)
    cfg_j, params, model = _models("node", seed=4, remat=remat,
                                   **ROUTES[route])
    masks_j = jpruning.magnitude_masks(params, 0.15) if masked else None
    want = _jax_logits("node", params, jgraph, cfg_j, masks_j)
    masks = (tser.load_jax_masks(jax.tree.map(np.asarray, masks_j), F, HID)
             if masked else None)
    model.train()
    got = model(tgraph, masks)
    got.sum().backward()                 # remat's recompute runs too
    np.testing.assert_allclose(got.detach().numpy(), want, **F32_TOL)
    if masked:
        with torch.no_grad():
            assert not np.allclose(model(tgraph).numpy(), want, **F32_TOL)


# ---------------------------------------------------------------------------
# Gradients on the kernel route, against jax.grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("head", list(HEADS))
def test_gradients_match_jax(head, fused):
    route = "pallas_fused" if fused else "pallas_unfused"
    tgraph, jgraph = _graphs(route, True, seed=5)
    cfg_j, params, model = _models(head, seed=5, **ROUTES[route])
    yj, mj = _target(head, jgraph)

    def loss_j(p):
        logits = HEADS[head]["jlogits"](p, jgraph, cfg_j)
        return jtrainer.masked_bce_with_logits(logits, yj, mj, 3.0)

    with pltpu.force_tpu_interpret_mode():
        want_loss, want = jax.value_and_grad(loss_j)(params)
    n0 = dict(tsp.launch_counts())
    loss = ttrainer.masked_bce_with_logits(model(tgraph), *_target(head,
                                                                   tgraph),
                                           3.0)
    loss.backward()
    assert tsp.launch_counts() == n0         # CPU: the plain versions
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    with torch.no_grad():             # the gradients, as a parameter tree
        for p in model.parameters():
            p.copy_(p.grad)
    got = tser.to_jax_params(model)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, want))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), **MODEL_GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("head", list(HEADS))
def test_kernel_route_calls(head, monkeypatch):
    """Which kernel wrappers each head's pallas route calls, forward and
    backward: the unshared head's output layer is one gather_pair, the
    node head has none; the unfused iterations are gather_pair plus
    aggregate_pair."""
    tgraph, _ = _graphs("pallas_fused", True, seed=6)
    calls = {}
    for name in ("iteration_pair", "aggregate_pair", "gather_pair"):
        real = getattr(tsp, name)
        monkeypatch.setattr(tsp, name, lambda *a, real=real, name=name: (
            calls.__setitem__(name, calls.get(name, 0) + 1) or real(*a)))
    edge_out = head == "unshared"
    for fused, want in (
            (True, dict(iteration_pair=ITERS, gather_pair=int(edge_out)))
            , (False, dict(aggregate_pair=ITERS,
                           gather_pair=ITERS + edge_out))):
        calls.clear()
        _, _, model = _models(head, seed=6, aggregation="auto",
                              fused_iteration=fused)
        model(tgraph).sum().backward()
        assert calls == {k: n for k, n in want.items() if n}, fused


# ---------------------------------------------------------------------------
# Training, pruning, weights
# ---------------------------------------------------------------------------

def test_trainer_node_target_matches_jax():
    """Five Adam steps of a NodeClassifier on the fused pallas route with
    target="node" (node_y, node_mask, L1 on the edge and node networks):
    the per-step losses match the JAX Trainer's; predict and evaluate read
    node probabilities, for a packed graph and for a batch."""
    tbatches, jbatches = [], []
    for seed in range(5):
        t, j = _graphs("pallas_fused", True, seed=10 + seed)
        tbatches.append(t)
        jbatches.append(j)
    cfg_j, params, model = _models("node", seed=7, **ROUTES["pallas_fused"])
    tcfg = dict(learning_rate=3e-3, target="node", pos_weight=2.0, l1=1e-4)
    tr_j = jtrainer.Trainer(
        lambda p, g, m: jm.node_classifier_logits(p, g, cfg_j, m), params,
        jtrainer.TrainConfig(**tcfg))
    with pltpu.force_tpu_interpret_mode():
        tr_j.fit(iter(jbatches), n_batches=1, n_epochs=5)
    tr_t = ttrainer.Trainer(model, ttrainer.TrainConfig(**tcfg))
    losses = tr_t.run_steps(tbatches)
    np.testing.assert_allclose(losses, tr_j.train_losses, rtol=1e-5)

    p, t, m = tr_t.predict(iter(tbatches[:1]), 1)
    assert p.shape == t.shape == m.shape == (tbatches[0].n_node,)
    np.testing.assert_array_equal(t, tbatches[0].node_y.numpy())
    np.testing.assert_array_equal(m, tbatches[0].node_mask.numpy())
    batch, _ = _events(20, n_events=4)
    tr_t.model = _variant(tr_t.model, aggregation="dense")
    p, t, m = tr_t.predict(iter([batch]), 1)
    assert p.shape == t.shape == (4 * V1,)
    assert set(tr_t.evaluate(iter([batch]), 1)) == {
        "accuracy", "precision", "recall", "f1", "auc"}


def test_node_classifier_pruning_matches_jax():
    """magnitude_masks covers the edge and node networks of a
    NodeClassifier (not its output layer) as the JAX package's does, and
    masked training keeps the pruned weights at 0."""
    _, params, model = _models("node", seed=8, aggregation="sparse")
    want = tser.load_jax_masks(
        jax.tree.map(np.asarray, jpruning.magnitude_masks(params, 0.12)),
        F, HID)
    got = tpruning.magnitude_masks(model, 0.12)
    assert {k: set(v) for k, v in got.items()} == \
        {"edge": {"pa", "pb", "l2"}, "node": {"l1", "l2"}}
    for mod in want:
        for name in want[mod]:
            torch.testing.assert_close(got[mod][name], want[mod][name])
    model, masks = tpruning.prune_round(model, 0.12)
    batch, _ = _events(21, n_events=4)
    tr = ttrainer.Trainer(model, ttrainer.TrainConfig(target="node", l1=1e-4),
                          masks=masks)
    tr.run_steps([batch] * 3)
    for mod, names in (("edge", ("pa", "pb", "l2")), ("node", ("l1", "l2"))):
        for name in names:
            w = getattr(getattr(tr.model, mod), name).weight
            assert (w[masks[mod][name] == 0] == 0).all(), (mod, name)


def test_unshared_refuses_masks():
    """The JAX package's unshared head takes masks and drops them, so
    pruned weights would go on training; the port raises."""
    tgraph, _ = _graphs("sparse", False)
    _, _, model = _models("unshared", aggregation="sparse")
    masks = {"edge": {"l2": torch.zeros(1, HID)}}
    with pytest.raises(ValueError, match="masks"):
        model(tgraph, masks)
    tr = ttrainer.Trainer(model, ttrainer.TrainConfig(), masks=masks)
    with pytest.raises(ValueError, match="masks"):
        tr.run_steps([tgraph])
    # the head has no "edge"/"node" networks, so pruning finds nothing to
    # mask, as in the JAX package, and an empty mask dict is no mask
    assert tpruning.magnitude_masks(model, 0.1) == {}
    with torch.no_grad():
        assert torch.equal(model(tgraph, {}), model(tgraph))


def test_masked_bf16_gap_to_jax():
    """A deliberate difference, measured.  Under bf16 compute the port
    casts the {0, 1} mask to bf16, so a masked layer runs in bf16 and
    equals the same weights pruned beforehand.  The JAX package multiplies
    the bf16 weight by the f32 mask the pruning writes, which promotes the
    layer to f32, and its iteration scan then refuses the f32 carry: a
    masked bf16 forward raises there, on every route.  With the masks cast
    to bf16 it runs in bf16, and the port matches it within the bf16
    tolerance; the f32 forward a promotion would tend to is as close."""
    tgraph, jgraph = _graphs("sparse", True, seed=9)
    cfg_j, params, model = _models("node", seed=9, aggregation="sparse",
                                   compute_dtype=torch.bfloat16)
    masks_j = jpruning.magnitude_masks(params, 0.15)
    masks = tser.load_jax_masks(jax.tree.map(np.asarray, masks_j), F, HID)
    pruned = tpruning.apply_masks_to_params(_variant(model), masks)
    with torch.no_grad():
        got, got_pruned = model(tgraph, masks), pruned(tgraph)
        got_f32 = _variant(model, compute_dtype=None)(tgraph, masks)
    assert torch.equal(got, got_pruned)           # masked layers in bf16
    with pytest.raises(TypeError, match="carry"):
        _jax_logits("node", params, jgraph, cfg_j, masks_j)
    masks_bf16 = jax.tree.map(lambda m: m.astype(jnp.bfloat16), masks_j)
    want = _jax_logits("node", params, jgraph, cfg_j, masks_bf16)
    np.testing.assert_allclose(got.numpy(), want, **BF16_TOL)
    gap_jax = np.abs(got.numpy() - want).max()
    gap_f32 = np.abs(got.numpy() - got_f32.numpy()).max()
    assert 0 < gap_jax < BF16_TOL["atol"] and 0 < gap_f32 < BF16_TOL["atol"]


@pytest.mark.parametrize("head", list(HEADS))
def test_weights_round_trip_through_jax_npz(head, tmp_path):
    """A tree written by either package loads in the other."""
    _, params, model = _models(head, seed=12)
    jser.save_params_npz(tmp_path / "jax.npz", params)
    fresh = HEADS[head]["tinit"](model.cfg, torch.Generator().manual_seed(0))
    tser.load_jax_params(fresh, tser.load_params_npz(tmp_path / "jax.npz"))
    for (n, a), b in zip(fresh.named_parameters(), model.parameters()):
        assert torch.equal(a, b), n
    tree = tser.to_jax_params(fresh)
    tser.save_params_npz(tmp_path / "port.npz", tree)
    loaded = jser.load_params_npz(tmp_path / "port.npz")
    assert jax.tree.structure(loaded) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tm.count_params(model) == jm.count_params(params)
    other = "node" if head == "unshared" else "unshared"
    with pytest.raises((ValueError, KeyError)):
        tser.load_jax_params(fresh, jax.tree.map(np.asarray,
                                                 _models(other)[1]))


def test_unshared_weights_need_the_same_depth():
    _, params, _ = _models("unshared")
    deeper = tm.init_segment_classifier_unshared(
        tm.SegmentClassifierConfig(input_dim=F, hidden_dim=HID,
                                   n_iters=ITERS + 1),
        torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="iterations"):
        tser.load_jax_params(deeper, jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("head", list(HEADS))
def test_init_bounds_and_seeding(head):
    h = HEADS[head]
    cfg = h["tcfg"](input_dim=2, hidden_dim=16, n_iters=3)
    a = h["tinit"](cfg, torch.Generator().manual_seed(5))
    b = h["tinit"](cfg, torch.Generator().manual_seed(5))
    d = 2 + 16
    edge = "edge" if head == "node" else "edge_stack.2"
    fan_in = {"input.weight": 2, f"{edge}.pa.weight": 2 * d,
              f"{edge}.b1": 2 * d, f"{edge}.l2.bias": 16,
              "output.weight": d if head == "node" else None}
    if head == "unshared":
        fan_in.update({"node_stack.0.l1.weight": 3 * d,
                       "output.pb.weight": 2 * d, "output.l2.weight": 16})
        del fan_in["output.weight"]
    params = dict(a.named_parameters())
    for name, fi in fan_in.items():
        bound = 1 / np.sqrt(fi)
        assert params[name].abs().max() <= bound, name
        if params[name].numel() >= 16:
            assert params[name].abs().max() > bound / 2, name
    for (n1, p1), (_, p2) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p1, p2), n1
    assert tm.count_params(a) == jm.count_params(h["jinit"](
        jax.random.PRNGKey(0), h["jcfg"](input_dim=2, hidden_dim=16,
                                         n_iters=3)))
