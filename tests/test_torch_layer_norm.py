"""An MLP's hidden layer after its bias-free Linear, ``layer_norm_relu``
(``ops/cuda/layer_norm.py``), on the CPU.

On CPU tensors ``layer_norm_relu`` is its plain version,
``layer_norm_relu_reference`` (the layer as PyTorch's own ``F.layer_norm``
and ``F.relu`` compose it), and ``linear_layer_norm_relu`` the unfused
layer.  The kernel wrappers ``layer_norm_relu_fwd`` and
``layer_norm_relu_bwd`` run the kernels' arithmetic in plain PyTorch there
(the bias added, the statistics, the normalisation and the sums in f32,
or f64 for f64 rows): held here against the reference and its autograd,
and by ``gradcheck`` through the autograd Function the card runs.  The
CUDA kernels are held to the reference in ``tests/test_torch_cuda.py``
and ``chip_smoke.py --phase ign``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gnn_fpga_tpu_torch.ops.cuda import layer_norm as ln
from gnn_fpga_tpu_torch.ops.cuda import spmm as tsp

EPS = 1e-5
# the same f32 arithmetic in another order (F.layer_norm's Welford
# statistics and its own expression of the gradient): a few ulps, grown
# by the row's normalisation and the sums over 64 rows
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 outputs: one rounding each (2^-8), doubled
BF16_TOL = dict(rtol=8e-3, atol=1e-4)


def _inputs(seed, n=64, h=32, dtype=torch.float32, bias=True):
    """Rows ``y`` with a bias, scale and shift drawn as the Interaction
    Network draws them (U(-1, 1)), and an output gradient ``dz``."""
    rng = np.random.default_rng(seed)
    t = lambda *shape, scale=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)
    u = lambda *shape: torch.from_numpy(
        rng.uniform(-1, 1, shape).astype(np.float32)).to(dtype)
    return dict(y=t(n, h), b=u(h) if bias else None, g=u(h), beta=u(h),
                dz=t(n, h))


def _leaves(c):
    return {k: (None if v is None else v.clone().requires_grad_(True))
            for k, v in c.items() if k != "dz"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
def test_reference_equals_the_unfused_layer(dtype, bias):
    """On the CPU the whole layer is ``F.relu(F.layer_norm(F.linear(x, w,
    b)))``, the unfused composition, bit for bit, and so is the reference
    on the bias-free product without a bias; with one, the reference adds
    it apart, the same in f32 but for the order of the sum (in bf16 the
    product is rounded before the add, an ulp of rows of 40 products)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((50, 40)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((32, 40)).astype(
        np.float32)).to(dtype)
    c = _inputs(4, h=32, dtype=dtype, bias=bias)
    unfused = F.relu(F.layer_norm(F.linear(x, w, c["b"]), (32,), c["g"],
                                  c["beta"], EPS))
    got = ln.linear_layer_norm_relu(x, w, c["b"], c["g"], c["beta"], EPS)
    assert torch.equal(got, unfused)
    if dtype == torch.float32:
        ref = ln.layer_norm_relu_reference(F.linear(x, w), c["b"], c["g"],
                                           c["beta"], EPS)
        torch.testing.assert_close(ref, unfused, **F32_TOL)
    if bias is False:
        assert torch.equal(ln.layer_norm_relu(F.linear(x, w), None, c["g"],
                                              c["beta"], EPS), unfused)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
def test_kernel_arithmetic_matches_the_reference(dtype, bias):
    """The kernel wrappers on CPU tensors (the kernels' arithmetic in
    plain PyTorch, f32) against the reference in f64 and its autograd:
    the output and the gradients of ``y``, ``b``, the scale and the
    shift, with the kernels' ReLU mask (a value within f32 rounding of 0
    cannot flip one element)."""
    c = _inputs(5, dtype=dtype, bias=bias)
    args = (c["y"], c["b"], c["g"], c["beta"])
    out, mean, rstd = ln.layer_norm_relu_fwd(*args, EPS)
    f64 = lambda t: None if t is None else t.double()
    want = ln.layer_norm_relu_reference(*map(f64, args), EPS)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert out.dtype == dtype
    torch.testing.assert_close(out.double(), want, **tol)
    grads = ln.layer_norm_relu_bwd(c["dz"], *args, mean, rstd)
    ref = ln.layer_norm_relu_bwd_reference(c["dz"], *args, EPS,
                                           live=out > 0)
    for name, got, want_grad in zip(("y", "b", "g", "beta"), grads, ref):
        if want_grad is None:
            assert got is None and not bias
            continue
        assert got.dtype == dtype, name
        # the column sums cancel: atol relative to the largest
        atol = tol["atol"] if name == "y" else tol["rtol"] * float(
            want_grad.abs().max())
        torch.testing.assert_close(got.double(), want_grad,
                                   rtol=tol["rtol"], atol=atol, msg=name)


@pytest.mark.parametrize("bias", [True, False])
def test_gradcheck_in_f64(bias):
    """The autograd Function the card runs, on CPU tensors in f64: the
    kernels' backward arithmetic against finite differences."""
    c = _inputs(6, n=12, h=16, dtype=torch.float64, bias=bias)
    leaves = _leaves(c)
    fn = lambda y, b, g, beta: ln._LayerNormReLU.apply(y, b, g, beta, EPS)
    assert torch.autograd.gradcheck(fn, tuple(leaves.values()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_recomputed_mask_is_the_forwards(dtype):
    """With ``dz`` all ones the shift's gradient counts each column's live
    outputs: the backward's mask, recomputed from ``y``, is the forward's
    ``out > 0``, exactly (integer sums in f32, rounded once)."""
    c = _inputs(7, n=300, dtype=dtype)
    out, mean, rstd = ln.layer_norm_relu_fwd(c["y"], c["b"], c["g"],
                                             c["beta"], EPS)
    assert 0 < int((out > 0).sum()) < out.numel()
    _, _, _, dbeta = ln.layer_norm_relu_bwd(torch.ones_like(out), c["y"],
                                            c["b"], c["g"], c["beta"], mean,
                                            rstd)
    assert torch.equal(dbeta, (out > 0).sum(0).float().to(dtype))


@pytest.mark.parametrize("path", ["layer_norm_relu", "kernel arithmetic"])
def test_dead_rows_pass_no_gradient(path):
    """A scale in [0, 1/4] and a shift of -3 keep every output <= 0 (a
    normalised row of 32 values lies within sqrt(31)): the output, ``dy``
    and every column sum are zeros."""
    c = _inputs(8)
    c["g"] = c["g"].abs() / 4
    c["beta"] = torch.full_like(c["beta"], -3.0)
    a = _leaves(c)
    run = ln.layer_norm_relu if path == "layer_norm_relu" else (
        lambda *t: ln._LayerNormReLU.apply(*t))
    out = run(a["y"], a["b"], a["g"], a["beta"], EPS)
    (out * c["dz"]).sum().backward()
    assert not out.any()
    for name in ("y", "b", "g", "beta"):
        assert not a[name].grad.any(), name


@pytest.mark.parametrize("case", ["width 12", "width 264", "f16", "int32",
                                  "non-contiguous", "1-D", "bias shape",
                                  "scale dtype"])
def test_wrapper_refuses_what_the_kernels_do_not_take(case):
    c = _inputs(9, h=32)
    y, b, g, beta = c["y"], c["b"], c["g"], c["beta"]
    if case.startswith("width"):
        h = int(case.split()[1])
        y, b, g, beta = (torch.zeros(4, h), torch.zeros(h), torch.ones(h),
                         torch.zeros(h))
    elif case in ("f16", "int32"):
        dt = torch.float16 if case == "f16" else torch.int32
        y, b, g, beta = (t.to(dt) for t in (y, b, g, beta))
    elif case == "non-contiguous":
        y = torch.zeros(64, 64)[:, ::2]
    elif case == "1-D":
        y = y[0]
    elif case == "bias shape":
        b = b[:16]
    else:
        g = g.double()
    with pytest.raises(ValueError):
        ln.layer_norm_relu(y, b, g, beta, EPS)
    with pytest.raises(ValueError):
        ln.layer_norm_relu_fwd(y, b, g, beta, EPS)
    if case in ("width 12", "width 264", "f16", "int32", "bias shape",
                "scale dtype"):
        # the whole layer refuses them on the CPU too
        w = torch.zeros(y.shape[-1], 8, dtype=y.dtype)
        x = torch.zeros(4, 8, dtype=y.dtype)
        with pytest.raises((ValueError, RuntimeError)):
            ln.linear_layer_norm_relu(x, w, b, g, beta, EPS)


@pytest.mark.parametrize("h", [8, 128, 256])
def test_wrapper_takes_every_multiple_of_8_up_to_256(h):
    c = _inputs(10, n=5, h=h)
    out = ln.layer_norm_relu(c["y"], c["b"], c["g"], c["beta"], EPS)
    torch.testing.assert_close(
        out, ln.layer_norm_relu_reference(c["y"], c["b"], c["g"], c["beta"],
                                          EPS), **F32_TOL)


def test_wrappers_do_not_count_on_the_cpu():
    c = _inputs(11)
    before = tsp.launch_counts()
    for run in (ln.layer_norm_relu, ln._LayerNormReLU.apply):
        a = _leaves(c)
        (run(a["y"], a["b"], a["g"], a["beta"], EPS)
         * c["dz"]).sum().backward()
    after = tsp.launch_counts()
    assert after == before
    assert {"layer_norm_relu", "layer_norm_relu_bwd"} <= set(after)
