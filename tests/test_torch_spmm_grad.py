"""Gradients of the port's kernel Functions and model against the JAX
package's custom VJPs (Pallas kernels in interpret mode), on the same
numpy inputs and cotangents.

On the CPU each Function runs its plain forward and plain backward through
the same ``torch.autograd.Function`` the card uses; the CUDA backward
kernels are checked against the plain backwards in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from gnn_fpga_tpu.compress import pruning as jpruning
from gnn_fpga_tpu.core import graph as jg
from gnn_fpga_tpu.models import mpnn as jm
from gnn_fpga_tpu.ops.pallas import spmm as jsp
from gnn_fpga_tpu.train import trainer as jtrainer
from gnn_fpga_tpu_torch.core import graph as tg
from gnn_fpga_tpu_torch.models import mpnn as tm
from gnn_fpga_tpu_torch.ops.cuda import spmm as tsp
from gnn_fpga_tpu_torch.train import trainer as ttrainer
from gnn_fpga_tpu_torch.utils import serialization as tser

# the JAX package's kernel-gradient tolerance (tests/test_pallas_spmm.py)
KERNEL_GRAD_TOL = dict(rtol=2e-3, atol=1e-4)
# the JAX package's model-gradient tolerance (tests/test_pallas_spmm.py)
MODEL_GRAD_TOL = dict(rtol=2e-3, atol=1e-5)
# plain backward vs autograd of the plain forward: same f32 math, other
# summation order
PLAIN_TOL = dict(rtol=1e-5, atol=1e-6)

KINDS = ["padded", "degree_zero", "repeated"]


def _case(seed, v, e, d, hdim, kind):
    """Random tables and cotangents over a topology with masked pad edges,
    nodes of degree zero, or repeated edges."""
    rng = np.random.default_rng(seed)
    hi = v if kind != "degree_zero" else v // 2 + 8
    s = rng.integers(0, hi, e).astype(np.int32)
    r = rng.integers(0, hi, e).astype(np.int32)
    em = np.ones(e, np.float32)
    if kind == "padded":
        em[-20:] = 0
        s[-20:] = r[-20:] = v - 1
    if kind == "repeated":
        s[e // 2:] = s[: e - e // 2]
        r[e // 2:] = r[: e - e // 2]
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return dict(s=s, r=r, em=em, h=f(v, d), pa=f(v, hdim), pb=f(v, hdim),
                w2=f(hdim), b1=f(hdim), b2=f(1), w=f(e) * em, v=v,
                g_mi=f(v, d), g_mo=f(v, d), g=f(e, hdim))


def _t(a, grad=True):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want, tol):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, np.float32), **tol,
                                   err_msg=f"output {i}")


@pytest.mark.parametrize("kind", KINDS)
def test_iteration_pair_vjp_matches_jax(kind):
    c = _case(31, 72, 192, 10, 12, kind)
    plans_j = jsp.build_agg_plans(c["s"], c["r"], c["v"], tile_e=32)
    ems_j = jsp.sort_edge_weights(jnp.asarray(c["em"]), plans_j.recv)
    names = ("pa", "pb", "h", "w2", "b1", "b2")
    f = lambda pa, pb, h, w2, b1, b2: jsp.iteration_pair(
        pa, pb, h, ems_j, w2, b1, b2, plans_j)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, *(jnp.asarray(c[k]) for k in names))
        want = vjp((jnp.asarray(c["g_mi"]), jnp.asarray(c["g_mo"])))

    plans = tsp.build_agg_plans(c["s"], c["r"], c["v"])
    ems = tsp.sort_edge_weights(torch.from_numpy(c["em"]), plans.recv)
    args = {k: _t(c[k]) for k in names}
    mi, mo = tsp.iteration_pair(args["pa"], args["pb"], args["h"], ems,
                                args["w2"], args["b1"], args["b2"], plans)
    got = torch.autograd.grad((mi, mo), [args[k] for k in names],
                              (_t(c["g_mi"], False), _t(c["g_mo"], False)))
    for a, k in zip(got, names):
        assert a.shape == args[k].shape, k
    _close(got, want, KERNEL_GRAD_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_aggregate_pair_vjp_matches_jax(kind):
    c = _case(32, 64, 160, 8, 8, kind)
    plans_j = jsp.build_agg_plans(c["s"], c["r"], c["v"], tile_e=32)
    f = lambda h, w: jsp.aggregate_pair(h, w, plans_j)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, jnp.asarray(c["h"]), jnp.asarray(c["w"]))
        want = vjp((jnp.asarray(c["g_mi"]), jnp.asarray(c["g_mo"])))

    plans = tsp.build_agg_plans(c["s"], c["r"], c["v"])
    h, w = _t(c["h"]), _t(c["w"])
    mi, mo = tsp.aggregate_pair(h, w, plans)
    got = torch.autograd.grad((mi, mo), (h, w),
                              (_t(c["g_mi"], False), _t(c["g_mo"], False)))
    _close(got, want, KERNEL_GRAD_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_gather_pair_vjp_matches_jax(kind):
    c = _case(33, 64, 160, 8, 12, kind)
    plans_j = jsp.build_agg_plans(c["s"], c["r"], c["v"], tile_e=32)
    sj, rj = jnp.asarray(c["s"]), jnp.asarray(c["r"])
    f = lambda pa, pb: jsp.gather_pair(pa, pb, sj, rj, plans_j)
    with pltpu.force_tpu_interpret_mode():
        out_j, vjp = jax.vjp(f, jnp.asarray(c["pa"]), jnp.asarray(c["pb"]))
        want = vjp(jnp.asarray(c["g"]))

    plans = tsp.build_agg_plans(c["s"], c["r"], c["v"])
    pa, pb = _t(c["pa"]), _t(c["pb"])
    out = tsp.gather_pair(pa, pb, torch.from_numpy(c["s"]),
                          torch.from_numpy(c["r"]), plans)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
    got = torch.autograd.grad(out, (pa, pb), _t(c["g"], False))
    _close(got, want, KERNEL_GRAD_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_gather_pair_fwd_matches_jax_kernel(kind, dtype):
    """The port's gather forward on the CPU against the TPU kernel itself
    (``_gather_pair_raw``, interpreted), which sums in f32: the port
    rounds that sum once to the tables' dtype."""
    c = _case(36, 64, 160, 8, 12, kind)
    plans_j = jsp.build_agg_plans(c["s"], c["r"], c["v"], tile_e=32)
    pa, pb = (jnp.asarray(c[k], dtype) for k in ("pa", "pb"))
    with pltpu.force_tpu_interpret_mode():
        want = jsp._gather_pair_raw(pa, pb, plans_j.recv)
    tdt = getattr(torch, dtype)
    got = tsp.gather_pair_fwd(
        torch.from_numpy(c["pa"]).to(tdt), torch.from_numpy(c["pb"]).to(tdt),
        torch.from_numpy(c["s"]), torch.from_numpy(c["r"]))
    assert got.dtype == tdt and got.shape == (160, 12)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(dtype), np.float32))


@pytest.mark.parametrize("side", ["senders", "receivers"])
@pytest.mark.parametrize("bad", [-1, 64])
def test_gather_pair_fwd_rejects_ids_outside_the_tables(side, bad):
    """An id outside [0, V) raises rather than reading past a table (on
    the card: a device-side assert, ``tests/test_torch_cuda.py``)."""
    c = _case(37, 64, 160, 8, 12, "padded")
    ids = {k: torch.from_numpy(c[k[0]].copy()) for k in ("senders",
                                                         "receivers")}
    ids[side][5] = bad
    with pytest.raises(IndexError):
        tsp.gather_pair_fwd(torch.from_numpy(c["pa"]),
                            torch.from_numpy(c["pb"]), ids["senders"],
                            ids["receivers"])


def test_plain_backwards_match_autograd_of_plain_forwards():
    c = _case(34, 48, 128, 9, 7, "padded")
    s, r, v = torch.from_numpy(c["s"]), torch.from_numpy(c["r"]), c["v"]
    g_mi, g_mo = _t(c["g_mi"], False), _t(c["g_mo"], False)
    em = torch.from_numpy(c["em"])

    names = ("h", "pa", "pb", "w2", "b1", "b2")
    a = {k: _t(c[k]) for k in names}
    out = tsp.iteration_pair_reference(a["pa"], a["pb"], a["h"], em, a["w2"],
                                       a["b1"], a["b2"], s, r, v)
    want = torch.autograd.grad(out, [a[k] for k in names], (g_mi, g_mo))
    got = tsp.iteration_pair_bwd_reference(a["pa"], a["pb"], a["h"], em,
                                           a["w2"], a["b1"], a["b2"], g_mi,
                                           g_mo, s, r, v)
    _close(got, want, PLAIN_TOL)

    h, w = _t(c["h"]), _t(c["w"])
    out = tsp.aggregate_pair_reference(h, w, s, r, v)
    want = torch.autograd.grad(out, (h, w), (g_mi, g_mo))
    _close(tsp.aggregate_pair_bwd_reference(h, w, g_mi, g_mo, s, r, v),
           want, PLAIN_TOL)

    pa, pb, g = _t(c["pa"]), _t(c["pb"]), _t(c["g"], False)
    out = tsp.gather_pair_reference(pa, pb, s, r)
    want = torch.autograd.grad(out, (pa, pb), g)
    _close(tsp.gather_pair_bwd_reference(g, s, r, v), want, PLAIN_TOL)


def test_bwd_wrappers_do_not_count_on_cpu():
    # the probes' and the LayerNorm's wrappers count here once their
    # modules are imported
    from gnn_fpga_tpu_torch.ops.cuda import layer_norm  # noqa: F401
    from gnn_fpga_tpu_torch.ops.cuda import probes  # noqa: F401

    c = _case(35, 40, 96, 6, 5, "padded")
    before = tsp.launch_counts()
    plans = tsp.build_agg_plans(c["s"], c["r"], c["v"])
    ems = tsp.sort_edge_weights(torch.from_numpy(c["em"]), plans.recv)
    a = {k: _t(c[k]) for k in ("pa", "pb", "h", "w2", "b1", "b2")}
    mi, mo = tsp.iteration_pair(a["pa"], a["pb"], a["h"], ems, a["w2"],
                                a["b1"], a["b2"], plans)
    (mi.sum() + mo.sum()).backward()
    out = tsp.gather_pair(a["pa"], a["pb"], torch.from_numpy(c["s"]),
                          torch.from_numpy(c["r"]), plans)
    out.sum().backward()
    m = tsp.edge_sum(out.detach().requires_grad_(), torch.from_numpy(c["s"]),
                     torch.from_numpy(c["r"]), plans)
    m.sum().backward()
    assert tsp.launch_counts() == before
    assert set(before) == {"iteration_pair", "aggregate_pair", "gather_pair",
                           "iteration_pair_bwd", "aggregate_pair_bwd",
                           "gather_pair_bwd", "edge_sum", "spmm", "sddmm",
                           "sddmm_dual",
                           "sorted_segment_sum", "select_segments",
                           "passthrough", "gather_rows", "ablate_rows",
                           "iteration_pair_bwd_recompute", "layer_norm_relu",
                           "layer_norm_relu_bwd"}


# ---------------------------------------------------------------------------
# Whole-model gradients: the port's pallas route against jax.grad of the
# JAX package's pallas route, same weights, same masked BCE
# ---------------------------------------------------------------------------

V, E, F, HID, ITERS = 60, 128, 3, 8, 2


def _graphs(seed):
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


@pytest.mark.parametrize("fused,masked,remat", [
    (True, False, False), (False, False, False), (True, True, False),
    (True, False, True), (False, True, True)])
def test_model_gradients_match_jax(fused, masked, remat):
    tgraph, jgraph = _graphs(40 + 2 * fused + masked)
    # remat only on the port's side: it changes no value, and jax.checkpoint
    # does not trace the Pallas interpreter's callbacks
    cfg_j = jm.SegmentClassifierConfig(input_dim=F, hidden_dim=HID,
                                       n_iters=ITERS, aggregation="pallas",
                                       fused_iteration=fused)
    params = jm.init_segment_classifier(jax.random.PRNGKey(3), cfg_j)
    masks_j = jpruning.magnitude_masks(params, 0.15) if masked else None

    def loss_j(p):
        logits = jm.segment_classifier_logits(p, jgraph, cfg_j, masks_j)
        return jtrainer.masked_bce_with_logits(logits, jgraph.y,
                                               jgraph.edge_mask, 8.0)

    with pltpu.force_tpu_interpret_mode():
        want_loss, want = jax.value_and_grad(loss_j)(params)

    model = tm.init_segment_classifier(
        tm.SegmentClassifierConfig(input_dim=F, hidden_dim=HID,
                                   n_iters=ITERS, aggregation="pallas",
                                   fused_iteration=fused, remat=remat),
        torch.Generator().manual_seed(0), device="cpu")
    tser.load_jax_params(model, jax.tree.map(np.asarray, params))
    masks = (tser.load_jax_masks(jax.tree.map(np.asarray, masks_j), F, HID,
                                 device="cpu")
             if masked else None)
    n0 = dict(tsp.launch_counts())
    loss = ttrainer.masked_bce_with_logits(model(tgraph, masks), tgraph.y,
                                           tgraph.edge_mask, 8.0)
    loss.backward()
    assert tsp.launch_counts() == n0
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    with torch.no_grad():             # the gradients, as a parameter tree
        for p in model.parameters():
            p.copy_(p.grad)
    got = tser.to_jax_params(model)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), **MODEL_GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_final_edge_layer_goes_through_gather_pair(monkeypatch):
    """With plans attached, both routes' last edge layer (and, unfused,
    every iteration's) is a gather_pair call, as in the JAX package."""
    tgraph, _ = _graphs(46)
    calls = []
    real = tsp.gather_pair
    monkeypatch.setattr(tsp, "gather_pair",
                        lambda *a: calls.append(1) or real(*a))
    for fused, expect in ((True, 1), (False, ITERS + 1)):
        calls.clear()
        cfg = tm.SegmentClassifierConfig(input_dim=F, hidden_dim=HID,
                                         n_iters=ITERS, aggregation="pallas",
                                         fused_iteration=fused)
        model = tm.init_segment_classifier(cfg,
                                           torch.Generator().manual_seed(1),
                                           device="cpu")
        model(tgraph).sum().backward()
        assert len(calls) == expect, fused


def test_remat_gives_the_same_gradients():
    tgraph, _ = _graphs(47)
    cfg = tm.SegmentClassifierConfig(input_dim=F, hidden_dim=HID,
                                     n_iters=ITERS, aggregation="pallas")
    grads = []
    for remat in (False, True):
        model = tm.init_segment_classifier(dataclasses.replace(cfg,
                                                               remat=remat),
                                           torch.Generator().manual_seed(2),
                                           device="cpu")
        model(tgraph).square().sum().backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
