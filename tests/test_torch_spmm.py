"""The port's fused aggregation wrappers against the JAX package's Pallas
kernels (interpret mode) and jnp oracles, on the same numpy inputs.

On the CPU the wrappers run their plain PyTorch versions; the CUDA kernels
are checked against those versions in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from gnn_fpga_tpu.ops import segment as jseg
from gnn_fpga_tpu.ops.pallas import spmm as jsp
from gnn_fpga_tpu_torch.ops import segment as tseg
from gnn_fpga_tpu_torch.ops.cuda import spmm as tsp

F32_TOL = dict(rtol=1e-4, atol=1e-5)      # the JAX kernel tests' tolerance
# bf16 tables: the JAX kernel rounds each message to bf16 before its
# one-hot scatter matmul and the score's z to bf16 before the w2 dot; the
# port accumulates in f32 and rounds once on output.  Measured gap: one
# bf16 ulp of the output (2^-8 relative); the absolute term covers sums
# of ~6 rounded messages of magnitude ~1 that cancel.
BF16_TOL = dict(rtol=1e-2, atol=3e-2)


def _case(seed, v, e, d, hdim, kind):
    """Random tables and a topology with masked pad edges, nodes of degree
    zero (ids >= v // 2 + 8 never used) or repeated edges."""
    rng = np.random.default_rng(seed)
    hi = v if kind != "degree_zero" else v // 2 + 8
    s = rng.integers(0, hi, e).astype(np.int32)
    r = rng.integers(0, hi, e).astype(np.int32)
    em = np.ones(e, np.float32)
    if kind == "padded":
        em[-20:] = 0
        s[-20:] = r[-20:] = v - 1            # pad edges on the pad node
    if kind == "repeated":
        s[e // 2:] = s[: e - e // 2]
        r[e // 2:] = r[: e - e // 2]
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return dict(s=s, r=r, em=em, h=f(v, d), pa=f(v, hdim), pb=f(v, hdim),
                w2=f(hdim), b1=f(hdim), b2=f(1), w=f(e) * em, v=v)


KINDS = ["padded", "degree_zero", "repeated"]


def _jax_iteration(c, dtype):
    plans = jsp.build_agg_plans(c["s"], c["r"], c["v"], tile_e=32)
    ems = jsp.sort_edge_weights(jnp.asarray(c["em"]), plans.recv)
    a = {k: jnp.asarray(c[k]).astype(dtype)
         for k in ("pa", "pb", "h", "w2", "b1", "b2")}
    with pltpu.force_tpu_interpret_mode():
        return jsp.iteration_pair(a["pa"], a["pb"], a["h"], ems, a["w2"],
                                  a["b1"], a["b2"], plans)


def _torch_iteration(c, dtype):
    plans = tsp.build_agg_plans(c["s"], c["r"], c["v"])
    ems = tsp.sort_edge_weights(torch.from_numpy(c["em"]), plans.recv)
    a = {k: torch.from_numpy(c[k]).to(dtype)
         for k in ("pa", "pb", "h", "w2", "b1", "b2")}
    return tsp.iteration_pair(a["pa"], a["pb"], a["h"], ems, a["w2"],
                              a["b1"], a["b2"], plans)


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **tol)


@pytest.mark.parametrize("kind", KINDS)
def test_iteration_pair_matches_jax_f32(kind):
    c = _case(11, 72, 192, 10, 12, kind)
    out = _torch_iteration(c, torch.float32)
    assert out[0].dtype == torch.float32 and out[0].shape == (72, 10)
    _close(out, _jax_iteration(c, jnp.float32), F32_TOL)
    ref = jsp.iteration_pair_reference(c["pa"], c["pb"], c["h"], c["em"],
                                       c["w2"], c["b1"], c["b2"], c["s"],
                                       c["r"], c["v"])
    _close(out, ref, F32_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_aggregate_pair_matches_jax_f32(kind):
    c = _case(12, 64, 160, 8, 8, kind)
    plans_j = jsp.build_agg_plans(c["s"], c["r"], c["v"], tile_e=32)
    with pltpu.force_tpu_interpret_mode():
        want = jsp.aggregate_pair(jnp.asarray(c["h"]), jnp.asarray(c["w"]),
                                  plans_j)
    plans_t = tsp.build_agg_plans(c["s"], c["r"], c["v"])
    got = tsp.aggregate_pair(torch.from_numpy(c["h"]),
                             torch.from_numpy(c["w"]), plans_t)
    _close(got, want, F32_TOL)
    ref = tsp.aggregate_pair_reference(
        torch.from_numpy(c["h"]), torch.from_numpy(c["w"]),
        torch.from_numpy(c["s"]), torch.from_numpy(c["r"]), c["v"])
    _close(got, ref, F32_TOL)


def test_degree_zero_rows_are_zero():
    c = _case(13, 72, 192, 10, 12, "degree_zero")
    mi, mo = _torch_iteration(c, torch.float32)
    unused = np.setdiff1d(np.arange(72), np.concatenate([c["s"], c["r"]]))
    assert len(unused) > 0
    assert (mi[unused] == 0).all() and (mo[unused] == 0).all()


@pytest.mark.parametrize("kind", KINDS)
def test_iteration_pair_matches_jax_bf16(kind):
    c = _case(14, 72, 192, 10, 12, kind)
    out = _torch_iteration(c, torch.bfloat16)
    assert out[0].dtype == torch.bfloat16
    _close(out, _jax_iteration(c, jnp.bfloat16), BF16_TOL)


def test_wrappers_do_not_count_on_cpu():
    c = _case(15, 64, 128, 8, 8, "padded")
    counts = lambda: tuple(tsp.launch_counts()[k]
                           for k in ("iteration_pair", "aggregate_pair"))
    before = counts()
    _torch_iteration(c, torch.float32)
    plans = tsp.build_agg_plans(c["s"], c["r"], c["v"])
    tsp.aggregate_pair(torch.from_numpy(c["h"]), torch.from_numpy(c["w"]),
                       plans)
    assert counts() == before


def test_non_cpu_non_cuda_tensor_raises_not_falls_back():
    """Only a CPU tensor takes the plain version; anything else must reach
    the kernel or raise."""
    c = _case(16, 64, 128, 8, 8, "padded")
    plans = tsp.build_agg_plans(c["s"], c["r"], c["v"])
    h = torch.from_numpy(c["h"]).to("meta")
    with pytest.raises(ValueError):
        tsp.aggregate_pair(h, torch.from_numpy(c["w"]).to("meta"), plans)


def test_segment_sum_drops_out_of_range_ids_like_jax():
    rng = np.random.default_rng(17)
    msgs = rng.standard_normal((40, 5)).astype(np.float32)
    idx = rng.integers(-3, 12, 40).astype(np.int32)
    got = tseg.segment_sum(torch.from_numpy(msgs), torch.from_numpy(idx), 9)
    want = jseg.segment_sum(jnp.asarray(msgs), jnp.asarray(idx), 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    w = rng.standard_normal(40).astype(np.float32)
    got = tseg.weighted_segment_sum(torch.from_numpy(msgs),
                                    torch.from_numpy(w),
                                    torch.from_numpy(idx), 9)
    want = jseg.weighted_segment_sum(jnp.asarray(msgs), jnp.asarray(w),
                                     jnp.asarray(idx), 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_edge_concat_matches_jax():
    rng = np.random.default_rng(18)
    x = rng.standard_normal((20, 4)).astype(np.float32)
    s = rng.integers(0, 20, 30).astype(np.int32)
    r = rng.integers(0, 20, 30).astype(np.int32)
    em = (rng.random(30) > 0.2).astype(np.float32)
    got = tseg.edge_concat(*(torch.from_numpy(a) for a in (x, s, r, em)))
    want = jseg.edge_concat(*(jnp.asarray(a) for a in (x, s, r, em)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

