"""The port's baselines against the JAX package's: the grid and window
Toy2D generators numpy-identical, logits at the same weights (carried
across both ways), the track-axis conv at even and odd widths, the LSTM,
and the JAX tests' convergence gates run on the port
(``tests/test_baselines.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gnn_fpga_tpu.data import toy2d as jtoy
from gnn_fpga_tpu.models import baselines as jbl
from gnn_fpga_tpu_torch.data import toy2d as ttoy
from gnn_fpga_tpu_torch.models import baselines as tbl
from gnn_fpga_tpu_torch.utils import serialization as tser

# f32 logits of the same layers at the same weights: summation order only
LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)
CFG = dict(n_layers=5, n_tracks=3, seed=7)


@pytest.mark.parametrize("gen,kw", [
    ("make_hit_grids", {}), ("make_segmenter_data", {}),
    ("make_seeded_grid_data", dict(seed_size=2, track=1)),
])
@pytest.mark.parametrize("n_tracks", [3, 4])
def test_grid_generators_are_numpy_identical(gen, kw, n_tracks):
    cfg = dict(CFG, n_tracks=n_tracks)
    want = getattr(jtoy, gen)(jtoy.Toy2DConfig(**cfg), 9, **kw)
    got = getattr(ttoy, gen)(ttoy.Toy2DConfig(**cfg), 9, **kw)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("window", [None, 0.05])
def test_window_segment_graphs_equal_jax(window):
    want = jtoy.make_window_segment_graphs(jtoy.Toy2DConfig(**CFG), 6,
                                           window=window)
    got = ttoy.make_window_segment_graphs(ttoy.Toy2DConfig(**CFG), 6,
                                          window=window)
    for name in ("x", "senders", "receivers", "y", "node_mask",
                 "edge_mask"):
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got.node_y is None


def test_softmax_xent_and_accuracy_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(7, 5)).astype(np.float32)
    targets = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 7)]
    np.testing.assert_allclose(
        float(tbl.softmax_xent(torch.from_numpy(logits),
                               torch.from_numpy(targets))),
        float(jbl.softmax_xent(jnp.asarray(logits), jnp.asarray(targets))),
        rtol=1e-6)
    assert float(tbl.row_accuracy(torch.from_numpy(logits),
                                  torch.from_numpy(targets))) == \
        float(jbl.row_accuracy(jnp.asarray(logits), jnp.asarray(targets)))


def _inputs(kind, n_tracks):
    """(JAX config kwargs, model inputs as numpy) of one baseline."""
    cfg = jtoy.Toy2DConfig(**dict(CFG, n_tracks=n_tracks))
    nl = cfg.n_layers
    if kind == "fc_segment_classifier":
        g = jtoy.make_segment_graphs(cfg, 6)
        return (dict(n_hits=nl * n_tracks, n_segments=g.senders.shape[1],
                     input_dim=2, hidden_dim=16), (np.asarray(g.x),))
    if kind in ("fc_segmenter", "conv_segmenter"):
        grids, _ = jtoy.make_segmenter_data(cfg, 6)
        kw = (dict(hidden_dim=16) if kind == "fc_segmenter"
              else dict(adj_filters=(8, 6), lay_filters=(5, 4)))
        return dict(n_layers=nl, n_tracks=n_tracks, **kw), (grids,)
    grids, seeds, _ = jtoy.make_seeded_grid_data(cfg, 6, seed_size=2)
    kw = {"seeded_fc": dict(hidden_dim=16),
          "seeded_cnn": dict(n_conv=3, n_filters=4),
          "seeded_lstm": dict(hidden_dim=6)}[kind]
    return (dict(n_layers=nl, n_tracks=n_tracks, seed_size=2, **kw),
            (grids, seeds))


# kind -> (JAX config, JAX init, JAX logits, port config, port module)
KINDS = {
    "fc_segment_classifier": (
        jbl.FCSegmentClassifierConfig, jbl.init_fc_segment_classifier,
        jbl.fc_segment_classifier_logits, tbl.FCSegmentClassifierConfig,
        tbl.FCSegmentClassifier),
    "fc_segmenter": (jbl.SegmenterConfig, jbl.init_fc_segmenter,
                     jbl.fc_segmenter_logits, tbl.SegmenterConfig,
                     tbl.FCSegmenter),
    "conv_segmenter": (jbl.ConvSegmenterConfig, jbl.init_conv_segmenter,
                       jbl.conv_segmenter_logits, tbl.ConvSegmenterConfig,
                       tbl.ConvSegmenter),
    "seeded_fc": (jbl.SeededConfig, jbl.init_seeded_fc, jbl.seeded_fc_logits,
                  tbl.SeededConfig, tbl.SeededFC),
    "seeded_cnn": (jbl.SeededCNNConfig, jbl.init_seeded_cnn,
                   jbl.seeded_cnn_logits, tbl.SeededCNNConfig,
                   tbl.SeededCNN),
    "seeded_lstm": (jbl.SeededLSTMConfig, jbl.init_seeded_lstm,
                    jbl.seeded_lstm_logits, tbl.SeededLSTMConfig,
                    tbl.SeededLSTM),
}


def _pair(kind, n_tracks, seed=3, **cfg_over):
    """JAX logits function over its params, the JAX params, the port
    model holding them, and the inputs."""
    jcfg_cls, jinit, jlogits, tcfg_cls, tmodel = KINDS[kind]
    cfg_kw, inputs = _inputs(kind, n_tracks)
    cfg_kw.update(cfg_over)
    jcfg = jcfg_cls(**cfg_kw)
    params = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(seed), jcfg))
    model = tmodel(tcfg_cls(**cfg_kw), torch.Generator().manual_seed(seed),
                   device="cpu")
    tser.load_jax_params(model, params)
    return (lambda p: jlogits(p, *map(jnp.asarray, inputs), jcfg)), params, \
        model, inputs


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("n_tracks", [3, 4])
def test_logits_match_jax(kind, n_tracks):
    """At an odd and an even track count: the conv segmenter's track-axis
    conv (kernel n_tracks wide) pads asymmetrically at an even width."""
    logits, params, model, inputs = _pair(kind, n_tracks)
    got = model(*map(torch.from_numpy, inputs)).detach().numpy()
    want = np.asarray(logits(params))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    assert tbl.count_params(model) == sum(
        int(np.size(p)) for p in jax.tree.leaves(params))


@pytest.mark.parametrize("kernel", [4, 5])
def test_seeded_cnn_matches_jax_at_even_and_odd_kernels(kernel):
    logits, params, model, inputs = _pair("seeded_cnn", 4, kernel=kernel)
    np.testing.assert_allclose(
        model(*map(torch.from_numpy, inputs)).detach().numpy(),
        np.asarray(logits(params)), **LOGIT_TOL)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_weights_carry_both_ways(kind):
    _, params, model, _ = _pair(kind, 3)
    back = tser.to_jax_params(model)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_lstm_gradients_match_jax():
    logits, params, model, inputs = _pair("seeded_lstm", 3)
    targets = jtoy.make_seeded_grid_data(
        jtoy.Toy2DConfig(**CFG), 6, seed_size=2)[2]
    want = jax.grad(lambda p: jbl.softmax_xent(logits(p),
                                               jnp.asarray(targets)))(params)
    loss = tbl.softmax_xent(model(*map(torch.from_numpy, inputs)),
                            torch.from_numpy(targets))
    loss.backward()
    np.testing.assert_allclose(model.wx.grad.numpy(), want["wx"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(model.b.grad.numpy(), want["b"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(model.out.weight.grad.numpy(),
                               want["out"]["w"].T, rtol=1e-4, atol=1e-6)


def test_stack_adjacent_features_matches_jax():
    x = np.arange(2 * 3 * 4 * 2, dtype=np.float32).reshape(2, 3, 4, 2)
    np.testing.assert_array_equal(
        tbl.stack_adjacent_features(torch.from_numpy(x)).numpy(),
        np.asarray(jbl.stack_adjacent_features(jnp.asarray(x))))


def _fit(loss_fn, model, steps, lr=3e-3):
    """The JAX tests' full-batch Adam loop; returns the first and the last
    loss."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    first = None
    for _ in range(steps):
        loss = loss_fn()
        opt.zero_grad()
        loss.backward()
        opt.step()
        first = float(loss.detach()) if first is None else first
    return first, float(loss_fn().detach())


def _convergence_case(kind, cfg_kw, n, seed):
    """The JAX test's model at its config and init (``PRNGKey(seed)``),
    carried to the port, and its data."""
    jcfg_cls, jinit, _, tcfg_cls, tmodel = KINDS[kind]
    params = jax.tree.map(np.asarray,
                          jinit(jax.random.PRNGKey(seed), jcfg_cls(**cfg_kw)))
    model = tmodel(tcfg_cls(**cfg_kw), torch.Generator(), device="cpu")
    tser.load_jax_params(model, params)
    return model


def test_fc_segment_classifier_trains_on_toy_segments():
    g = ttoy.make_segment_graphs(ttoy.Toy2DConfig(**CFG), 512)
    n_node = CFG["n_layers"] * CFG["n_tracks"]
    model = _convergence_case("fc_segment_classifier", dict(
        n_hits=n_node, n_segments=g.senders.shape[1], input_dim=2,
        hidden_dim=64), 512, 0)
    _fit(lambda: F.binary_cross_entropy_with_logits(model(g.x), g.y),
         model, 400)
    with torch.no_grad():
        acc = float(((torch.sigmoid(model(g.x)) > 0.5) == (g.y > 0.5))
                    .float().mean())
    assert acc > 0.8, acc


def test_fc_segmenter_converges():
    grids, targets = map(torch.from_numpy, ttoy.make_segmenter_data(
        ttoy.Toy2DConfig(**CFG), 1024))
    model = _convergence_case("fc_segmenter", dict(
        n_layers=CFG["n_layers"], n_tracks=CFG["n_tracks"], hidden_dim=64),
        1024, 1)
    _fit(lambda: tbl.softmax_xent(model(grids), targets), model, 400)
    acc = float(tbl.row_accuracy(model(grids), targets))
    assert acc > 0.85, acc


def test_conv_segmenter_learns():
    grids, targets = map(torch.from_numpy, ttoy.make_segmenter_data(
        ttoy.Toy2DConfig(**CFG), 256))
    model = _convergence_case("conv_segmenter", dict(
        n_layers=CFG["n_layers"], n_tracks=CFG["n_tracks"],
        adj_filters=(16, 16), lay_filters=(8,)), 256, 2)
    probs = torch.softmax(model(grids), dim=-1)
    np.testing.assert_allclose(probs.sum(-1).detach().numpy(), 1.0,
                               rtol=1e-5)
    loss0, loss1 = _fit(lambda: tbl.softmax_xent(model(grids), targets),
                        model, 120)
    assert loss1 < loss0


@pytest.mark.parametrize("kind,cfg_kw,steps", [
    ("seeded_fc", dict(hidden_dim=64), 400),
    ("seeded_cnn", dict(n_conv=3, n_filters=8), 120),
    ("seeded_lstm", dict(hidden_dim=16), 150),
])
def test_seeded_models_learn(kind, cfg_kw, steps):
    grids, seeds, targets = map(torch.from_numpy, ttoy.make_seeded_grid_data(
        ttoy.Toy2DConfig(**CFG), 512, seed_size=2))
    model = _convergence_case(kind, dict(
        n_layers=CFG["n_layers"], n_tracks=CFG["n_tracks"], seed_size=2,
        **cfg_kw), 512, 3)
    loss0, loss1 = _fit(
        lambda: tbl.softmax_xent(model(grids, seeds), targets), model, steps)
    assert loss1 < loss0
    if kind == "seeded_fc":
        acc = float(tbl.row_accuracy(model(grids, seeds), targets))
        assert acc > 0.85, acc
