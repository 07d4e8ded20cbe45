"""The port's training engine, metrics, pruning and weight carrying against
the JAX package's, on the same inputs and initial weights; and the
engine's own semantics (checkpoint resume, best-model retention, masked
training, weight transplant), as ``tests/test_train.py`` holds them for the
JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from gnn_fpga_tpu.compress import pruning as jpruning
from gnn_fpga_tpu.core import graph as jg
from gnn_fpga_tpu.models import mpnn as jm
from gnn_fpga_tpu.train import metrics as jmetrics
from gnn_fpga_tpu.train import trainer as jtrainer
from gnn_fpga_tpu.utils import serialization as jser
from gnn_fpga_tpu_torch.compress import pruning as tpruning
from gnn_fpga_tpu_torch.core import graph as tg
from gnn_fpga_tpu_torch.data import toy2d
from gnn_fpga_tpu_torch.models import mpnn as tm
from gnn_fpga_tpu_torch.train import metrics as tmetrics
from gnn_fpga_tpu_torch.train import trainer as ttrainer
from gnn_fpga_tpu_torch.utils import serialization as tser

F32_TOL = dict(rtol=1e-4, atol=1e-5)
V, E, F, HID, ITERS = 60, 128, 3, 8, 2


def _model_pair(seed, **cfg_kw):
    """A JAX parameter tree and a port model holding the same weights."""
    cfg_j = jm.SegmentClassifierConfig(input_dim=F, hidden_dim=HID,
                                       n_iters=ITERS, **cfg_kw)
    params = jm.init_segment_classifier(jax.random.PRNGKey(seed), cfg_j)
    model = tm.init_segment_classifier(
        tm.SegmentClassifierConfig(input_dim=F, hidden_dim=HID,
                                   n_iters=ITERS, **cfg_kw),
        torch.Generator().manual_seed(seed), device="cpu")
    tser.load_jax_params(model, jax.tree.map(np.asarray, params))
    return cfg_j, params, model


def _batches(n, seed=0):
    """``n`` packed, plan-attached batches over one topology (so the JAX
    side compiles once), with their own features and labels."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, V - 1, E).astype(np.int32)
    r = rng.integers(0, V - 1, E).astype(np.int32)
    s[-16:] = r[-16:] = V - 1
    em = np.ones(E, np.float32)
    em[-16:] = 0
    plans_j = tplans = None
    out_t, out_j = [], []
    for _ in range(n):
        x = rng.normal(size=(V, F)).astype(np.float32)
        x[-1] = 0
        y = (rng.random(E) < 0.3).astype(np.float32)
        j = jg.from_coo(x, s, r, y).replace(edge_mask=em)
        t = tg.from_coo(x, s, r, y).replace(edge_mask=torch.from_numpy(em))
        if plans_j is None:
            plans_j = jg.attach_plans(j, tile_e=32).plans
            tplans = tg.attach_plans(t).plans
        out_j.append(j.replace(plans=plans_j))
        out_t.append(t.replace(plans=tplans))
    return out_t, out_j


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_loss_curve_matches_jax_trainer(optimizer):
    """Five steps on the pallas route, fused, f32, same weights and
    batches: the per-step losses agree; under SGD the trained weights do
    too.  (Under Adam a gradient component of ~1e-9 moves its weight by
    ~lr whatever its sign, so trained weights are not compared there.)"""
    cfg = dict(learning_rate=3e-3, optimizer=optimizer, pos_weight=8.0,
               l1=1e-4)
    cfg_j, params, model = _model_pair(11, aggregation="pallas")
    tbatches, jbatches = _batches(5, seed=1)

    tr_j = jtrainer.Trainer(
        lambda p, g, m: jm.segment_classifier_logits(p, g, cfg_j, m),
        params, jtrainer.TrainConfig(**cfg))
    with pltpu.force_tpu_interpret_mode():
        tr_j.fit(iter(jbatches), n_batches=1, n_epochs=5)
    tr_t = ttrainer.Trainer(model, ttrainer.TrainConfig(**cfg))
    losses = tr_t.run_steps(tbatches)
    assert losses.shape == (5,) and losses.dtype == np.float32
    np.testing.assert_allclose(losses, tr_j.train_losses, rtol=1e-5)
    if optimizer == "sgd":
        got = tser.to_jax_params(model)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tr_j.params)):
            np.testing.assert_allclose(a, np.asarray(b), **F32_TOL)


def test_batched_graph_loss_matches_jax_vmap():
    """A batched graph (leading axis) is scored graph by graph and the
    logits stacked, as the JAX trainer vmaps its logits_fn."""
    g_t = toy2d.make_segment_graphs(
        toy2d.Toy2DConfig(n_layers=4, n_tracks=3, seed=3), 4)
    g_j = jax.tree.map(jnp.asarray, jg.Graph(
        **{k: getattr(g_t, k).numpy() for k in
           ("x", "senders", "receivers", "y", "node_mask", "edge_mask")}))
    model = tm.init_segment_classifier(
        tm.SegmentClassifierConfig(input_dim=2, hidden_dim=HID, n_iters=ITERS,
                                   aggregation="sparse"),
        torch.Generator().manual_seed(0), device="cpu")
    cfg_j = jm.SegmentClassifierConfig(input_dim=2, hidden_dim=HID,
                                       n_iters=ITERS, aggregation="sparse")
    params = jax.tree.map(jnp.asarray, tser.to_jax_params(model))
    tcfg = dict(pos_weight=3.0)
    tr_j = jtrainer.Trainer(
        lambda p, g, m: jm.segment_classifier_logits(p, g, cfg_j, m),
        params, jtrainer.TrainConfig(**tcfg))
    tr_t = ttrainer.Trainer(model, ttrainer.TrainConfig(**tcfg))
    np.testing.assert_allclose(tr_t._eval_loss(g_t),
                               float(tr_j._eval_loss(tr_j.params, g_j)),
                               rtol=1e-5)
    p_t, _, _ = tr_t.predict(iter([g_t]), 1)
    p_j, _, _ = tr_j.predict(iter([g_j]), 1)
    np.testing.assert_allclose(p_t, p_j, **F32_TOL)


def test_masked_bce_matches_jax():
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal(50) * 3).astype(np.float32)
    targets = (rng.random(50) < 0.4).astype(np.float32)
    targets[:5] = 0.7                       # soft targets: the where form
    mask = (rng.random(50) < 0.8).astype(np.float32)
    for pw in (1.0, 8.0):
        for m in (mask, None):
            got = ttrainer.masked_bce_with_logits(
                torch.from_numpy(logits), torch.from_numpy(targets),
                None if m is None else torch.from_numpy(m), pw)
            want = jtrainer.masked_bce_with_logits(
                jnp.asarray(logits), jnp.asarray(targets),
                None if m is None else jnp.asarray(m), pw)
            np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_l1_penalty_with_masks_matches_jax():
    _, params, model = _model_pair(13)
    masks_j = jpruning.magnitude_masks(params, 0.1)
    masks_t = tser.load_jax_masks(jax.tree.map(np.asarray, masks_j), F, HID,
                                  device="cpu")
    for mj, mt in ((None, None), (masks_j, masks_t)):
        np.testing.assert_allclose(
            ttrainer.l1_penalty(model, masks=mt).item(),
            float(jtrainer.l1_penalty(params, masks=mj)), rtol=1e-6)
    # input layer and biases excluded
    total = sum(p.abs().sum().item() for p in model.parameters())
    assert ttrainer.l1_penalty(model).item() < total


def test_cosine_schedule_matches_optax():
    cfg = ttrainer.TrainConfig(learning_rate=2e-2, lr_schedule="cosine",
                               decay_steps=7, lr_min_fraction=0.1)
    opt, sched = ttrainer.make_optimizer(cfg, [torch.nn.Parameter(
        torch.zeros(1))])
    lrs = []
    for _ in range(12):            # past decay_steps: optax clamps
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    want = optax.cosine_decay_schedule(2e-2, 7, alpha=0.1)
    np.testing.assert_allclose(lrs, [float(want(t)) for t in range(12)],
                               rtol=1e-6)
    with pytest.raises(ValueError):
        ttrainer.make_optimizer(ttrainer.TrainConfig(lr_schedule="cosine"),
                                [torch.nn.Parameter(torch.zeros(1))])


def test_metrics_match_jax():
    rng = np.random.default_rng(6)
    pred = np.round(rng.random(300), 2)     # many ties
    target = (rng.random(300) < 0.3).astype(np.float32)
    mask = (rng.random(300) < 0.9).astype(np.float32)
    for m in (None, mask):
        got = tmetrics.binary_metrics(pred, target, m, 0.4)
        want = jmetrics.binary_metrics(pred, target, m, 0.4)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
    np.testing.assert_allclose(tmetrics.roc_auc(pred, target, mask),
                               jmetrics.roc_auc(pred, target, mask),
                               rtol=1e-12)
    for a, b in zip(tmetrics.roc_curve(pred, target, mask),
                    jmetrics.roc_curve(pred, target, mask)):
        np.testing.assert_array_equal(a, b)
    assert np.isnan(tmetrics.roc_auc(pred, np.zeros_like(target)))


def test_magnitude_masks_match_jax():
    _, params, model = _model_pair(14)
    want = tser.load_jax_masks(
        jax.tree.map(np.asarray, jpruning.magnitude_masks(params, 0.12)),
        F, HID, device="cpu")
    got = tpruning.magnitude_masks(model, 0.12)
    assert {k: set(v) for k, v in got.items()} == \
        {"edge": {"pa", "pb", "l2"}, "node": {"l1", "l2"}}
    for mod in want:
        for name in want[mod]:
            torch.testing.assert_close(got[mod][name], want[mod][name])
    assert tpruning.sparsity(got) == pytest.approx(
        jpruning.sparsity(jpruning.magnitude_masks(params, 0.12)))
    summary = tpruning.mask_summary(got)
    assert set(summary) == {"edge.pa", "edge.pb", "edge.l2", "node.l1",
                            "node.l2"}
    model, masks = tpruning.prune_round(model, 0.12)
    w = model.edge.pa.weight
    assert (w[masks["edge"]["pa"] == 0] == 0).all()


def test_to_jax_params_and_npz_round_trip_through_jax(tmp_path):
    _, params, model = _model_pair(15)
    tree = tser.to_jax_params(model)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    path = tmp_path / "port.npz"
    tser.save_params_npz(path, tree)
    loaded = jser.load_params_npz(path)
    assert jax.tree.structure(loaded) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # and lists, as the JAX writer's path table encodes them
    tser.save_params_npz(tmp_path / "seq.npz", {"a": [np.ones(2), np.zeros(3)]})
    seq = jser.load_params_npz(tmp_path / "seq.npz")
    np.testing.assert_array_equal(seq["a"][1], np.zeros(3))


# ---------------------------------------------------------------------------
# The engine's own semantics (tests/test_train.py on the port alone)
# ---------------------------------------------------------------------------

def _toy_gen(n_events=64, batch=16, n_layers=4, n_tracks=3, seed=0):
    g = toy2d.make_segment_graphs(
        toy2d.Toy2DConfig(n_layers=n_layers, n_tracks=n_tracks, seed=seed),
        n_events)

    def gen():
        rng = np.random.default_rng(seed)
        while True:
            order = rng.permutation(n_events)
            for b in range(n_events // batch):
                sel = torch.from_numpy(order[b * batch:(b + 1) * batch])
                yield g.replace(**{k: getattr(g, k).index_select(0, sel)
                                   for k in ("x", "senders", "receivers", "y",
                                             "node_mask", "edge_mask")})
    return gen


def _toy_model(seed, n_iters=2):
    return tm.init_segment_classifier(
        tm.SegmentClassifierConfig(input_dim=2, hidden_dim=8, n_iters=n_iters,
                                   aggregation="sparse"),
        torch.Generator().manual_seed(seed), device="cpu")


def test_checkpoint_resume(tmp_path):
    gen = _toy_gen()
    metrics = tmp_path / "m" / "metrics.jsonl"
    tr = ttrainer.Trainer(_toy_model(1), ttrainer.TrainConfig(),
                          checkpoint_dir=str(tmp_path), metrics_path=str(metrics))
    tr.fit(gen(), n_batches=4, n_epochs=3, valid_generator=gen(),
           n_valid_batches=2)
    assert tr.epoch == 3
    assert len(metrics.read_text().splitlines()) == 3

    tr2 = ttrainer.Trainer(_toy_model(2), ttrainer.TrainConfig(),
                           checkpoint_dir=str(tmp_path))
    assert tr2.load_checkpoint()
    assert tr2.epoch == 3
    torch.testing.assert_close(tr2.model.input.weight, tr.model.input.weight)
    # the optimizer state came back too: one more step agrees
    g = next(gen())
    np.testing.assert_allclose(tr2.run_steps([g]), tr.run_steps([g]),
                               rtol=1e-6)
    for a, b in zip(tr2.model.parameters(), tr.model.parameters()):
        torch.testing.assert_close(a, b)
    tr2.fit(gen(), n_batches=4, n_epochs=1, valid_generator=gen(),
            n_valid_batches=2)
    assert tr2.epoch == 4
    assert len(tr2.valid_losses) == 4


def test_best_checkpoint_retained_and_cosine_state_restored(tmp_path):
    gen = _toy_gen()
    cfg = ttrainer.TrainConfig(lr_schedule="cosine", decay_steps=20)
    tr = ttrainer.Trainer(_toy_model(3, n_iters=1), cfg,
                          checkpoint_dir=str(tmp_path))
    tr.fit(gen(), n_batches=4, n_epochs=2, valid_generator=gen(),
           n_valid_batches=2)
    assert tr.ckpt.exists(best=True)
    tr2 = ttrainer.Trainer(_toy_model(4, n_iters=1), cfg,
                           checkpoint_dir=str(tmp_path))
    assert tr2.load_checkpoint(best=True)
    assert tr2.scheduler.last_epoch == 8
    assert tr2.optimizer.param_groups[0]["lr"] == pytest.approx(
        tr.optimizer.param_groups[0]["lr"])


def test_fit_stacked_runs_epochs_of_fixed_batches(tmp_path):
    gen = _toy_gen()()
    epoch = [next(gen) for _ in range(3)]
    tr = ttrainer.Trainer(_toy_model(5, n_iters=1),
                          ttrainer.TrainConfig(learning_rate=5e-3),
                          checkpoint_dir=str(tmp_path))
    tr.fit_stacked(epoch, n_epochs=3, valid_batch=epoch[0])
    assert tr.epoch == 3 and len(tr.valid_losses) == 3
    assert tr.ckpt.exists() and tr.ckpt.exists(best=True)
    m = tr.evaluate(iter(epoch), 3)
    assert set(m) == {"accuracy", "precision", "recall", "f1", "auc"}


def test_masked_training_keeps_zeros():
    gen = _toy_gen()
    model = _toy_model(6)
    model, masks = tpruning.prune_round(model, threshold=0.1)
    tr = ttrainer.Trainer(model, ttrainer.TrainConfig(l1=1e-4), masks=masks)
    tr.fit(gen(), n_batches=4, n_epochs=2)
    for mod, names in (("edge", ("pa", "pb", "l2")), ("node", ("l1", "l2"))):
        for name in names:
            w = getattr(getattr(tr.model, mod), name).weight
            assert (w[masks[mod][name] == 0] == 0).all(), (mod, name)
            assert (w[masks[mod][name] == 1] != 0).any(), (mod, name)


def test_load_weights_transplant():
    dense = _toy_model(7, n_iters=1)
    masks = tpruning.magnitude_masks(dense, 0.1)
    tr = ttrainer.Trainer(_toy_model(8, n_iters=1), ttrainer.TrainConfig(),
                          masks=masks)
    tr.load_weights(dense.state_dict())
    w, m = tr.model.edge.pa.weight, masks["edge"]["pa"]
    assert (w[m == 0] == 0).all()
    torch.testing.assert_close(w[m == 1], dense.edge.pa.weight[m == 1])
    assert not tr.optimizer.state          # a fresh optimizer


def test_strategies_not_ported_raise():
    """The parallel strategies are ported (tests/test_torch_parallel*.py);
    without a mesh they raise, as an unknown strategy does."""
    for strategy in ("dp", "partitioned"):
        with pytest.raises(ValueError, match="needs a mesh"):
            ttrainer.Trainer(_toy_model(9, n_iters=1), strategy=strategy)
    with pytest.raises(ValueError):
        ttrainer.Trainer(_toy_model(9, n_iters=1), strategy="nope")
