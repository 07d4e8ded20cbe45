"""The port's SegmentClassifier forward against the JAX package's, with the
same parameters carried across by ``load_jax_params``.

The JAX side runs the ``pallas`` route (Pallas kernels in interpret mode);
the port runs its ``pallas`` route (plain versions of the kernels on the
CPU) and its ``sparse`` route."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from gnn_fpga_tpu.compress import pruning
from gnn_fpga_tpu.core import graph as jg
from gnn_fpga_tpu.models import mpnn as jm
from gnn_fpga_tpu.utils import serialization as jser
from gnn_fpga_tpu_torch.core import graph as tg
from gnn_fpga_tpu_torch.models import mpnn as tm
from gnn_fpga_tpu_torch.ops.cuda import spmm as tsp
from gnn_fpga_tpu_torch.utils import serialization as tser

F32_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16 compute: both packages round activations to bf16 after every
# layer, but at different points inside the aggregation (JAX rounds each
# message before its scatter matmul, the port rounds the f32 sum once).
# Measured gap: one bf16 ulp of the logits (2^-9 at |logit| < 0.5); the
# tolerance allows about five.
BF16_TOL = dict(rtol=1e-2, atol=1e-2)

V, E, F, HID, ITERS = 60, 128, 3, 8, 2


def _graphs(seed=0):
    """The same packed graph for both packages: 16 masked pad edges on the
    pad node (id V-1), plans attached."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(V, F)).astype(np.float32)
    x[-1] = 0
    s = rng.integers(0, V - 1, E).astype(np.int32)
    r = rng.integers(0, V - 1, E).astype(np.int32)
    s[-16:] = r[-16:] = V - 1
    y = rng.integers(0, 2, E).astype(np.float32)
    em = np.ones(E, np.float32)
    em[-16:] = 0
    j = jg.attach_plans(jg.from_coo(x, s, r, y).replace(edge_mask=em),
                        tile_e=32)
    t = tg.from_coo(x, s, r, y).replace(edge_mask=torch.from_numpy(em))
    return tg.attach_plans(t), j


def _models(seed=0, **cfg_kw):
    cfg_j = jm.SegmentClassifierConfig(input_dim=F, hidden_dim=HID,
                                       n_iters=ITERS, aggregation="pallas",
                                       **{k: v for k, v in cfg_kw.items()
                                          if k != "compute_dtype"})
    if "compute_dtype" in cfg_kw:
        cfg_j = dataclasses.replace(cfg_j, compute_dtype=jnp.bfloat16)
    params = jm.init_segment_classifier(jax.random.PRNGKey(seed), cfg_j)
    np_params = jax.tree.map(np.asarray, params)
    cfg_t = tm.SegmentClassifierConfig(input_dim=F, hidden_dim=HID,
                                       n_iters=ITERS, aggregation="pallas",
                                       **cfg_kw)
    model = tm.init_segment_classifier(cfg_t, torch.Generator().manual_seed(9),
                                       device="cpu")
    tser.load_jax_params(model, np_params)
    return cfg_j, params, model


def _variant(model, **kw):
    m = tm.SegmentClassifier(dataclasses.replace(model.cfg, **kw),
                             torch.Generator(), device="cpu")
    m.load_state_dict(model.state_dict())
    return m


def _jax_logits(params, g, cfg, masks=None):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jm.segment_classifier_logits(params, g, cfg, masks))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("route", ["pallas", "sparse"])
def test_forward_matches_jax_f32(fused, route):
    tgraph, jgraph = _graphs()
    cfg_j, params, model = _models(fused_iteration=fused)
    want = _jax_logits(params, jgraph, cfg_j)
    with torch.no_grad():
        got = tm.segment_classifier_logits(_variant(model, aggregation=route),
                                           tgraph)
    assert got.dtype == torch.float32 and got.shape == (E,)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("route", ["pallas", "sparse"])
def test_forward_with_mask_tree_matches_jax(route):
    tgraph, jgraph = _graphs(1)
    cfg_j, params, model = _models(seed=1)
    masks = pruning.magnitude_masks(params, 0.15)
    want = _jax_logits(params, jgraph, cfg_j, masks)
    tmasks = tser.load_jax_masks(jax.tree.map(np.asarray, masks), F, HID,
                                 device="cpu")
    assert tmasks["edge"]["pa"].shape == (HID, F + HID)
    with torch.no_grad():
        got = tm.segment_classifier_logits(
            _variant(model, aggregation=route), tgraph, tmasks)
        unmasked = tm.segment_classifier_logits(model, tgraph)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    assert not np.allclose(unmasked.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("fused", [True, False])
def test_forward_matches_jax_bf16(fused):
    tgraph, jgraph = _graphs(2)
    cfg_j, params, model = _models(seed=2, fused_iteration=fused,
                                   compute_dtype=torch.bfloat16)
    want = _jax_logits(params, jgraph, cfg_j)
    with torch.no_grad():
        got = model(tgraph)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **BF16_TOL)


def test_probabilities_are_sigmoid_of_logits():
    tgraph, _ = _graphs(3)
    _, _, model = _models(seed=3)
    with torch.no_grad():
        p = tm.segment_classifier(model, tgraph)
        torch.testing.assert_close(p, torch.sigmoid(model(tgraph)))


def test_load_params_npz_from_jax_writer(tmp_path):
    tgraph, jgraph = _graphs(4)
    cfg_j, params, _ = _models(seed=4)
    path = tmp_path / "model.npz"
    jser.save_params_npz(path, params)
    loaded = tser.load_params_npz(path)
    for a, b in zip(jax.tree.leaves(loaded),
                    jax.tree.leaves(jser.load_params_npz(path))):
        np.testing.assert_array_equal(a, np.asarray(b))
    model = tm.init_segment_classifier(
        tm.SegmentClassifierConfig(input_dim=F, hidden_dim=HID,
                                   n_iters=ITERS),
        torch.Generator().manual_seed(0), device="cpu")
    tser.load_jax_params(model, loaded)
    with torch.no_grad():
        got = model(tgraph)
    np.testing.assert_allclose(got.numpy(), _jax_logits(params, jgraph, cfg_j),
                               **F32_TOL)


def test_load_params_npz_reads_the_older_keystr_format(tmp_path):
    _, params, _ = _models(seed=7)
    flat = {jax.tree_util.keystr(kp): np.asarray(leaf) for kp, leaf
            in jax.tree_util.tree_flatten_with_path(params)[0]}
    path = tmp_path / "old.npz"
    np.savez(path, **flat)
    loaded = tser.load_params_npz(path)
    np.testing.assert_array_equal(loaded["edge"]["l1"]["w"],
                                  np.asarray(params["edge"]["l1"]["w"]))
    for a, b in zip(jax.tree.leaves(loaded),
                    jax.tree.leaves(jser.load_params_npz(path))):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_load_jax_params_rejects_wrong_width():
    _, params, _ = _models()
    model = tm.init_segment_classifier(
        tm.SegmentClassifierConfig(input_dim=F, hidden_dim=HID + 1),
        torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError):
        tser.load_jax_params(model, jax.tree.map(np.asarray, params))


def test_init_bounds_and_seeding():
    cfg = tm.SegmentClassifierConfig(input_dim=2, hidden_dim=16)
    a, b = (tm.init_segment_classifier(cfg, torch.Generator().manual_seed(5),
                                       device="cpu") for _ in range(2))
    d = 2 + 16
    fan_in = {"input.weight": 2, "edge.pa.weight": 2 * d, "edge.b1": 2 * d,
              "edge.l2.bias": 16, "node.l1.weight": 3 * d,
              "node.l2.weight": 16}
    params = dict(a.named_parameters())
    for name, fi in fan_in.items():
        assert params[name].abs().max() <= 1 / np.sqrt(fi)
    for (n1, p1), (_, p2) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p1, p2), n1


def test_auto_with_plans_takes_the_fused_kernel_route(monkeypatch):
    tgraph, _ = _graphs(5)
    _, _, model = _models(seed=5)
    calls = []
    real = tsp.iteration_pair

    def counting(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(tsp, "iteration_pair", counting)
    with torch.no_grad():
        auto = _variant(model, aggregation="auto")(tgraph)
        sparse = _variant(model, aggregation="sparse")(tgraph)
    assert len(calls) == ITERS
    np.testing.assert_allclose(auto.numpy(), sparse.numpy(), **F32_TOL)


def test_routes_not_ported_raise():
    """Every route the JAX package selects is ported now: auto on a small
    graph without plans takes the dense route, and what still raises is a
    route that needs a plan the graph lacks."""
    tgraph, _ = _graphs(6)
    _, _, model = _models(seed=6)
    plain = tgraph.replace(plans=None)
    with torch.no_grad():
        sparse = _variant(model, aggregation="sparse")(plain)
        m = plain.edge_mask > 0
        for route, g in (("auto", plain), ("dense", tgraph)):
            got = _variant(model, aggregation=route)(g)
            np.testing.assert_allclose(got[m].numpy(), sparse[m].numpy(),
                                       **F32_TOL)
        with pytest.raises(ValueError, match="blocked"):
            _variant(model, aggregation="blocked")(tgraph)
        with pytest.raises(ValueError, match="plans"):
            _variant(model, aggregation="pallas")(plain)


@pytest.mark.parametrize("init", [tm.init_segment_classifier,
                                  tm.init_segment_classifier_unshared,
                                  tm.init_node_classifier])
def test_default_device_is_the_card(init, monkeypatch):
    """``device=None`` means the CUDA device: with a card the parameters
    land there, and without one the constructors and the mask loader
    raise instead of quietly running on the CPU."""
    cfg = (tm.NodeClassifierConfig if init is tm.init_node_classifier
           else tm.SegmentClassifierConfig)(input_dim=2, hidden_dim=8)
    masks = {"node": {"l1": np.ones((3 * 10, 8), np.float32)}}
    if torch.cuda.is_available():
        model = init(cfg, torch.Generator().manual_seed(0))
        assert {p.device.type for p in model.parameters()} == {"cuda"}
        assert tser.load_jax_masks(masks, 2, 8)["node"]["l1"].is_cuda
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tser.load_jax_masks(masks, 2, 8)
    model = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
