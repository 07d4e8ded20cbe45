"""One hidden layer of an MLP after its bias-free Linear: the bias, LayerNorm
and ReLU in one kernel a direction.

    out = relu(layer_norm(y + b) * g + beta),   y = F.linear(x, w)  [N, H]

The Interaction Network's MLPs (``models/interaction_gnn.py``) run every
Linear-LayerNorm-ReLU layer through :func:`layer_norm_relu`, on node rows
and on edge rows alike.  On the card it is two hand-written CUDA kernels
(``csrc/layer_norm.cu``): the forward reads ``y`` once and writes the
activation and each row's f32 ``mean`` and ``rstd``; the backward reads
the output's gradient and ``y`` once, recomputes the ReLU mask with the
forward's own arithmetic, writes ``dy`` and sums the bias's, the scale's
and the shift's gradients over the rows in the same pass (per-block f32
partials, added in a fixed order by a second small launch: no atomics, so
a call repeats bit for bit).  The statistics and every sum are f32; the
output is rounded to the compute dtype once, then ReLU.

On CPU tensors :func:`layer_norm_relu` is its plain version,
:func:`layer_norm_relu_reference` (the layer as PyTorch's own ops compose
it), and :func:`linear_layer_norm_relu`, the whole layer with its
Linear, is ``F.linear``, ``F.layer_norm`` and ``F.relu``; the kernel
wrappers :func:`layer_norm_relu_fwd` and :func:`layer_norm_relu_bwd` run
the kernels' arithmetic in plain PyTorch there (f64 too, for gradient
checks).  The wrappers count their calls under their names in
``_build.launch_counts``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gnn_fpga_tpu_torch.ops.cuda._build import (DTYPE_CODES, MAX_WIDTH,
                                                alignment, grad_as,
                                                kernel_device, launch)

# The backward's blocks at most (``csrc/layer_norm.cu``'s kMaxBlocks): its
# scratch holds a row of 3 x H f32 partial sums a block.
BWD_MAX_BLOCKS = 1024
# Widths the kernels take: multiples of 8 (16-byte rows in bf16) up to 256.
WIDTH_MULTIPLE = 8
# dtypes a CPU call takes besides the kernels' (f64 for gradient checks)
_CPU_ONLY_DTYPES = (torch.float64,)


def _acc(dtype):
    """The dtype the arithmetic runs in: f32, f64 for f64 rows."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def layer_norm_relu_reference(y, b, g, beta, eps):
    """``relu(layer_norm(y + b) * g + beta)`` by PyTorch's own ops in the
    tensors' dtype (``b`` may be None): the plain version, which
    :func:`layer_norm_relu` runs on CPU tensors."""
    z = y if b is None else y + b
    return F.relu(F.layer_norm(z, z.shape[-1:], g, beta, eps))


def layer_norm_relu_bwd_reference(dz, y, b, g, beta, eps, live=None):
    """``(dy, db, dg, dbeta)`` of :func:`layer_norm_relu_reference` by
    autograd in f64 (``db`` None without a bias).  With ``live`` [N, H]
    given, it is the ReLU's mask in place of the reference's own: a
    kernel's mask, so that a value within rounding of 0 before the ReLU
    does not flip one element of the comparison."""
    f64 = lambda t: None if t is None else t.detach().double()
    z = f64(y) if b is None else f64(y) + f64(b)
    z, g, beta = (t.requires_grad_(True) for t in (z, f64(g), f64(beta)))
    pre = F.layer_norm(z, z.shape[-1:], g, beta, eps)
    if live is None:
        live = pre.detach().to(y.dtype) > 0
    dy, dg, dbeta = torch.autograd.grad(pre, (z, g, beta),
                                        f64(dz) * live.double())
    return dy, None if b is None else dy.sum(0), dg, dbeta


def _normalised(y, b, mean, rstd):
    acc = mean.dtype
    z = y.to(acc) if b is None else y.to(acc) + b.to(acc)
    return (z - mean[:, None]) * rstd[:, None]


def _pre_relu(xhat, g, beta, dtype):
    return (xhat * g.to(xhat.dtype) + beta.to(xhat.dtype)).to(dtype)


def _check(name, y, b, g, beta):
    """The shapes, dtypes, devices and layout the kernels take; the same
    checks on the CPU, so that a CPU run refuses what the card would."""
    if y.ndim != 2:
        raise ValueError(f"{name}: y must be [N, H]")
    h = y.shape[1]
    if h % WIDTH_MULTIPLE or not 0 < h <= MAX_WIDTH:
        raise ValueError(f"{name}: width {h} is not a multiple of "
                         f"{WIDTH_MULTIPLE} up to {MAX_WIDTH}")
    ok = tuple(DTYPE_CODES) + (_CPU_ONLY_DTYPES if y.device.type == "cpu"
                               else ())
    if y.dtype not in ok:
        raise ValueError(f"{name}: unsupported dtype {y.dtype}")
    for pname, p in (("b", b), ("g", g), ("beta", beta)):
        if p is None and pname == "b":
            continue
        if p.shape != (h,) or p.dtype != y.dtype or p.device != y.device:
            raise ValueError(f"{name}: {pname} must be [{h}] of {y.dtype} "
                             f"on {y.device}")
    if not y.is_contiguous():
        raise ValueError(f"{name}: y must be contiguous")


def _aligned(t):
    """``t``, or a copy of it where its data is not 16-byte aligned (a
    view into a larger tensor): the kernels load 16 bytes at a time."""
    return t if t is None or alignment(t) == 16 else t.clone()


def layer_norm_relu_fwd(y, b, g, beta, eps):
    """:func:`layer_norm_relu`'s forward, no VJP attached: ``(out, mean,
    rstd)``, ``out`` [N, H] in ``y.dtype`` and each row's mean and
    ``1 / sqrt(var + eps)`` [N] (f32; f64 for f64 rows).  One kernel
    launch on CUDA tensors, counted as ``layer_norm_relu``."""
    _check("layer_norm_relu", y, b, g, beta)
    return _fwd(y, b, g, beta, eps)


def _fwd(y, b, g, beta, eps):
    dev = kernel_device(y, "layer_norm_relu")
    n, h = y.shape
    if dev is None:
        acc = _acc(y.dtype)
        z = y.to(acc) if b is None else y.to(acc) + b.to(acc)
        mean = z.mean(-1)
        rstd = torch.rsqrt(((z - mean[:, None]) ** 2).mean(-1) + eps)
        out = _pre_relu(_normalised(y, b, mean, rstd), g, beta, y.dtype)
        return out.masked_fill(out <= 0, 0), mean, rstd
    y, b, g, beta = (_aligned(t) for t in (y, b, g, beta))
    out = torch.empty_like(y)
    mean = torch.empty(n, dtype=torch.float32, device=dev)
    rstd = torch.empty_like(mean)
    launch("gnn_layer_norm_relu_fwd", y.dtype, n, h, float(eps), y, b, g,
           beta, out, mean, rstd, count="layer_norm_relu")
    return out, mean, rstd


def layer_norm_relu_bwd(dz, y, b, g, beta, mean, rstd):
    """VJP of :func:`layer_norm_relu` from the output's gradient ``dz``
    and the forward's ``mean`` and ``rstd``: ``(dy, db, dg, dbeta)``,
    ``db`` None without a bias, each in ``y.dtype``.  The ReLU mask is
    recomputed from ``y``.  On CUDA tensors a pass over the rows and a
    launch that adds the blocks' column sums, counted as one
    ``layer_norm_relu_bwd``."""
    _check("layer_norm_relu_bwd", y, b, g, beta)
    if dz.shape != y.shape or dz.dtype != y.dtype:
        raise ValueError("layer_norm_relu_bwd: dz must be like y")
    return _bwd(dz, y, b, g, beta, mean, rstd)


def _bwd(dz, y, b, g, beta, mean, rstd):
    dev = kernel_device(y, "layer_norm_relu_bwd")
    n, h = y.shape
    if dev is None:
        xhat = _normalised(y, b, mean, rstd)
        out = _pre_relu(xhat, g, beta, y.dtype)
        gz = dz.to(xhat.dtype).masked_fill(out <= 0, 0)
        gx = gz * g.to(xhat.dtype)
        dy = (rstd[:, None] * (gx - gx.mean(-1, keepdim=True) - xhat * (
            gx * xhat).mean(-1, keepdim=True))).to(y.dtype)
        total = lambda t: t.sum(0).to(y.dtype)
        return (dy, None if b is None else total(dy.to(xhat.dtype)),
                total(gz * xhat), total(gz))
    dz = _aligned(dz.contiguous())
    y, b, g, beta = (_aligned(t) for t in (y, b, g, beta))
    if mean.dtype != torch.float32 or rstd.dtype != torch.float32 or (
            mean.shape != (n,) or rstd.shape != (n,)):
        raise ValueError("layer_norm_relu_bwd: mean and rstd must be [N] "
                         "f32, from layer_norm_relu_fwd")
    dy = torch.empty_like(y)
    part = torch.empty((BWD_MAX_BLOCKS, 3, h), dtype=torch.float32,
                       device=dev)
    dg, dbeta = torch.empty_like(g), torch.empty_like(beta)
    db = None if b is None else torch.empty_like(b)
    launch("gnn_layer_norm_relu_bwd", y.dtype, n, h, dz, y, b, g, beta, mean,
           rstd, dy, part, dg, dbeta, db, count="layer_norm_relu_bwd")
    return dy, db, dg, dbeta


class _LayerNormReLU(torch.autograd.Function):
    """The kernels forward and backward (on CPU tensors their arithmetic
    in plain PyTorch)."""

    @staticmethod
    def forward(ctx, y, b, g, beta, eps):
        out, mean, rstd = _fwd(y, b, g, beta, eps)
        ctx.save_for_backward(y, b, g, beta, mean, rstd)
        return out

    @staticmethod
    def backward(ctx, dz):
        y, b, g, beta, mean, rstd = ctx.saved_tensors
        dy, db, dg, dbeta = _bwd(grad_as(dz, y.dtype), y, b, g, beta, mean,
                                 rstd)
        return dy, db, dg, dbeta, None


def layer_norm_relu(y, b, g, beta, eps):
    """``relu(layer_norm(y + b) * g + beta)`` over the last dimension of
    ``y`` [N, H] (``b`` [H] or None; scale ``g`` and shift ``beta`` [H]),
    in ``y.dtype``: a hidden layer of an MLP after ``y = F.linear(x, w)``
    without its bias.  On CUDA tensors one kernel launch forward
    (:func:`layer_norm_relu_fwd`) and one call of two launches backward
    (:func:`layer_norm_relu_bwd`), which returns the bias's, the scale's
    and the shift's gradients too; on CPU tensors
    :func:`layer_norm_relu_reference`.  ``H`` is a multiple of 8 up to
    256; f32 or bf16 on the card; anything else raises."""
    _check("layer_norm_relu", y, b, g, beta)
    if kernel_device(y, "layer_norm_relu") is None:
        return layer_norm_relu_reference(y, b, g, beta, eps)
    return _LayerNormReLU.apply(y, b, g, beta, eps)


def linear_layer_norm_relu(x, w, b, g, beta, eps):
    """A whole hidden layer, ``relu(layer_norm(x w^T + b) * g + beta)``:
    on the card the bias-free product (``F.linear(x, w)``) and
    :func:`layer_norm_relu`, whose kernels add the bias and sum its
    gradient; on CPU tensors the layer as PyTorch composes it,
    ``F.linear`` with its bias, ``F.layer_norm``, ``F.relu``."""
    if kernel_device(x, "linear_layer_norm_relu") is not None:
        return layer_norm_relu(F.linear(x, w), b, g, beta, eps)
    y = F.linear(x, w, b)
    _check("linear_layer_norm_relu", y, b, g, beta)
    return F.relu(F.layer_norm(y, y.shape[-1:], g, beta, eps))
