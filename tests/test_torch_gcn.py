"""The port's GCN family against the JAX package's: the adjacency builders
and the GCN data generators numpy-identical, logits at the same weights
(carried across both ways), and the JAX tests' convergence gates run on
the port (``tests/test_gcn.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gnn_fpga_tpu.data import toy2d as jtoy
from gnn_fpga_tpu.models import gcn as jgcn
from gnn_fpga_tpu_torch.data import toy2d as ttoy
from gnn_fpga_tpu_torch.models import gcn as tgcn
from gnn_fpga_tpu_torch.utils import serialization as tser

# f32 logits of the same layers at the same weights: matmul order only
LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)


def _events(seed=0, n_layers=5, n_tracks=3, n=4):
    cfg = jtoy.Toy2DConfig(n_layers=n_layers, n_tracks=n_tracks, seed=seed)
    return jtoy.generate_events(cfg, n)


def _builder_cases():
    x, y, r, l = _events()
    adj = jgcn.layer_adjacency(l)
    seg = jgcn.segment_indices(adj)
    rng = np.random.default_rng(0)
    a = (rng.uniform(size=(3, 6, 6)) > 0.5).astype(np.float32)
    slopes = jgcn.segment_slopes(x, r, seg)
    return {
        "layer_adjacency": (l,),
        "toy_adjacency": (x, r, l, y),
        "row_norm_adjacency": (a,),
        "kipf_welling_adjacency": (np.maximum(a, a.transpose(0, 2, 1)),),
        "segment_indices": (adj,),
        "segment_adjacency": (seg,),
        "segment_labels": (y, seg),
        "segment_slopes": (x, r, seg),
        "gaussian_slope_kernel": (slopes, 0.05),
    }


@pytest.mark.parametrize("name", sorted(_builder_cases()))
def test_adjacency_builders_are_numpy_identical(name):
    args = _builder_cases()[name]
    want = getattr(jgcn, name)(*args)
    got = getattr(tgcn, name)(*args)
    for w, g in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("gen,kw", [
    ("make_gcn_data", dict(seed_layers=2)),
    ("make_gcn_data", dict(norm="kw")),
    ("make_segment_gcn_data", dict(sigma=0.02)),
])
def test_gcn_generators_are_numpy_identical(gen, kw):
    want = getattr(jtoy, gen)(jtoy.Toy2DConfig(n_layers=5, n_tracks=3,
                                               seed=4), 6, **kw)
    got = getattr(ttoy, gen)(ttoy.Toy2DConfig(n_layers=5, n_tracks=3,
                                              seed=4), 6, **kw)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_gcn_generator_rejects_an_unknown_norm():
    with pytest.raises(ValueError, match="norm"):
        ttoy.make_gcn_data(ttoy.Toy2DConfig(n_layers=3, n_tracks=2), 2,
                           norm="sym")


def _pair(cfg_kw, seed=2):
    """A JAX parameter tree and a port model holding it."""
    cfg_j = jgcn.GCNConfig(**cfg_kw)
    params = jax.tree.map(np.asarray,
                          jgcn.init_gcn_classifier(jax.random.PRNGKey(seed),
                                                   cfg_j))
    model = tgcn.init_gcn_classifier(tgcn.GCNConfig(**cfg_kw),
                                     torch.Generator().manual_seed(seed),
                                     device="cpu")
    tser.load_jax_params(model, params)
    return cfg_j, params, model


@pytest.mark.parametrize("gc_kind", ["conv", "self_int"])
@pytest.mark.parametrize("residual", [False, True])
def test_gcn_logits_match_jax(gc_kind, residual):
    feats, a, _ = jtoy.make_gcn_data(
        jtoy.Toy2DConfig(n_layers=6, n_tracks=3, seed=1), 8, norm="kw")
    cfg_j, params, model = _pair(dict(input_dim=3, hidden_dims=(8, 6, 8, 8),
                                      gc_kind=gc_kind, residual=residual))
    want = np.asarray(jgcn.gcn_classifier_logits(
        params, jnp.asarray(feats), jnp.asarray(a), cfg_j))
    got = model(torch.from_numpy(feats), torch.from_numpy(a))
    np.testing.assert_allclose(got.detach().numpy(), want, **LOGIT_TOL)
    np.testing.assert_allclose(
        tgcn.gcn_classifier(model, torch.from_numpy(feats),
                            torch.from_numpy(a)).detach().numpy(),
        np.asarray(jgcn.gcn_classifier(params, jnp.asarray(feats),
                                       jnp.asarray(a), cfg_j)), **LOGIT_TOL)
    assert tgcn.count_params(model) == jgcn.count_params(params)


@pytest.mark.parametrize("gc_kind", ["conv", "self_int"])
def test_gcn_weights_carry_both_ways(gc_kind):
    _, params, model = _pair(dict(input_dim=3, hidden_dims=(8, 8, 8),
                                  gc_kind=gc_kind, residual=True))
    back = tser.to_jax_params(model)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(got, want)
    other = tgcn.init_gcn_classifier(model.cfg, torch.Generator(),
                                     device="cpu")
    tser.load_jax_params(other, back)
    for (n, p), (_, q) in zip(model.named_parameters(),
                              other.named_parameters()):
        assert torch.equal(p, q), n


def test_gcn_carry_rejects_a_tree_of_another_shape():
    _, params, model = _pair(dict(input_dim=3, hidden_dims=(8, 8, 8)))
    params["gc"] = params["gc"][:1]
    with pytest.raises(ValueError, match="list"):
        tser.load_jax_params(model, params)
    _, params, model = _pair(dict(input_dim=3, hidden_dims=(8, 8),
                                  gc_kind="conv"))
    with pytest.raises(ValueError, match="holds"):
        tser.load_jax_params(
            tgcn.init_gcn_classifier(
                tgcn.GCNConfig(input_dim=3, hidden_dims=(8, 8)),
                torch.Generator(), device="cpu"), params)


def _fit_gcn(feats, a, y, cfg_kw, n_steps=150, lr=5e-3, batch=64):
    """The JAX test's loop on the port: its initial weights
    (``PRNGKey(0)``) carried across, Adam, minibatches drawn with
    ``default_rng(0).integers``."""
    _, _, model = _pair(cfg_kw, seed=0)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    feats, a, y = map(torch.from_numpy, (feats, a, y))
    rng = np.random.default_rng(0)
    for _ in range(n_steps):
        sel = torch.from_numpy(rng.integers(0, feats.shape[0], batch))
        loss = F.binary_cross_entropy_with_logits(
            model(feats[sel], a[sel]), y[sel])
        opt.zero_grad()
        loss.backward()
        opt.step()
    with torch.no_grad():
        return tgcn.gcn_classifier(model, feats, a).numpy()


def test_gcrn_converges_on_seeded_task():
    feats, a, y0 = ttoy.make_gcn_data(
        ttoy.Toy2DConfig(n_layers=6, n_tracks=3, seed=0), 512, seed_layers=2)
    cfg = dict(input_dim=3, hidden_dims=(8, 8, 8, 8), residual=True)
    acc = ((_fit_gcn(feats, a, y0, cfg) > 0.5) == y0).mean()
    naive = (feats[..., 2] == y0).mean()
    assert acc > 0.8, (acc, naive)
    assert acc > naive - 0.05


def test_segment_gcn_dual_graph_trains():
    feats, a, seg_y = ttoy.make_segment_gcn_data(
        ttoy.Toy2DConfig(n_layers=4, n_tracks=2, seed=3), 256)
    cfg = dict(input_dim=2, hidden_dims=(8, 8, 8), residual=True)
    acc = ((_fit_gcn(feats, a, seg_y, cfg, n_steps=200) > 0.5)
           == seg_y).mean()
    assert acc > 0.75, acc


def test_gcn_plain_runs_on_a_batch_of_identities():
    cfg = tgcn.GCNConfig(input_dim=3, hidden_dims=(8, 8), gc_kind="conv")
    model = tgcn.init_gcn_classifier(cfg, torch.Generator().manual_seed(2),
                                     device="cpu")
    out = tgcn.gcn_classifier(model, torch.zeros(4, 10, 3),
                              torch.eye(10).expand(4, 10, 10))
    assert out.shape == (4, 10)
    assert tgcn.count_params(model) > 0
