"""The plain reference: a model family's forward, the loss and Adam in
plain PyTorch, in float32 with TF32 off.

The forward is the family's (``families/<model>.py``, found by the
configuration's ``model``: :func:`port_bench.manifest.family`), on one
graph given as plain arrays (sector graphs concatenated,
:meth:`port_bench.gen.Event.packed`).  The loss is the masked mean of the
BCE on logits, positives weighted by ``pos_weight``; Adam is written out,
with the cosine rate of a step count.

``rounding`` computes the same in a lower precision, to serve as the
control of the check: every parameter, input, intermediate and gradient
rounded to bfloat16, or to float8 e4m3 with one scale a tensor (its
largest magnitude at 448).  It imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from port_bench import manifest

E4M3_MAX = 448.0


def _round_fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


_ROUNDERS = {
    "float32": None,
    "bfloat16": lambda t: t.to(torch.bfloat16).to(t.dtype),
    "float8_e4m3": _round_fp8,
}


class _Round(torch.autograd.Function):
    """Rounds the value on the way forward and its gradient on the way
    back."""

    @staticmethod
    def forward(ctx, t, fn):
        ctx.fn = fn
        return fn(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def rounder(rounding: str) -> Callable:
    fn = _ROUNDERS[rounding]
    if fn is None:
        return lambda t: t
    return lambda t: _Round.apply(t, fn)


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Every parameter of the family's ``leaves`` from ``seed``, drawn on
    ``device`` in one call: each U(-1/sqrt(fan_in), 1/sqrt(fan_in)), in
    the leaves' order."""
    spec = manifest.family(cfg["model"]).leaves(cfg)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(sizes), generator=gen, device=device,
                   dtype=torch.float32)
    out = {}
    for (name, shape, fan_in), part in zip(spec, u.split(sizes)):
        bound = 1.0 / math.sqrt(fan_in)
        out[name] = (part * (2 * bound) - bound).reshape(shape)
    return out


def graph_tensors(packed: dict, device) -> dict:
    """A packed event's arrays as tensors on ``device`` (ids as int64)."""
    out = {k: torch.as_tensor(v, device=device) for k, v in packed.items()}
    for k in ("senders", "receivers"):
        out[k] = out[k].long()
    return out


def logits(w: dict, g: dict, cfg: dict, r: Callable = lambda t: t):
    """The family's logits (one an edge or a node, float32); ``r`` rounds
    what a lower precision would."""
    return manifest.family(cfg["model"]).logits(w, g, cfg, r)


def loss(w: dict, g: dict, cfg: dict, r: Callable = lambda t: t):
    """Mean BCE on logits over every real edge (or node), positives
    weighted by ``pos_weight``."""
    z = logits(w, g, cfg, r)
    t = g["node_y"] if cfg["target"] == "node" else g["y"]
    per = torch.nn.functional.binary_cross_entropy_with_logits(
        z, t, reduction="none")
    per = per * torch.where(t > 0.5, cfg["pos_weight"], 1.0)
    return per.mean()


def rate(cfg: dict, count: int) -> float:
    """The learning rate of the update made after ``count`` updates: the
    cosine schedule falls from ``learning_rate`` to ``lr_min_fraction``
    of it over ``decay_steps`` and stays there."""
    if cfg.get("lr_schedule", "constant") == "constant":
        return cfg["learning_rate"]
    t = min(count, cfg["decay_steps"]) / cfg["decay_steps"]
    a = cfg["lr_min_fraction"]
    return cfg["learning_rate"] * (a + (1 - a) * 0.5 * (1 + math.cos(math.pi * t)))


def follow(w: dict, events: list, cfg: dict, adam: Optional[dict] = None,
           rounding: str = "float32") -> dict:
    """Adam steps from weights ``w`` and Adam state ``adam`` (``step``,
    ``exp_avg``, ``exp_avg_sq`` by name; None: a fresh optimizer), one a
    graph of ``events`` (tensors, :func:`graph_tensors`), in order.
    Returns the losses, and after the last step the weights and the
    moments by name."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    r = rounder(rounding)
    p = {k: v.detach().clone() for k, v in w.items()}
    if adam is None:
        step = 0
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    else:
        step = int(adam["step"])
        m = {k: t.clone() for k, t in adam["exp_avg"].items()}
        v2 = {k: t.clone() for k, t in adam["exp_avg_sq"].items()}
    losses = []
    for g in events:
        leaf = {k: t.requires_grad_(True) for k, t in p.items()}
        value = loss(leaf, g, cfg, r)
        grads = dict(zip(leaf, torch.autograd.grad(value, list(leaf.values()))))
        losses.append(float(value.detach()))
        lr = rate(cfg, step)
        step += 1
        with torch.no_grad():
            for k in p:
                m[k] = b1 * m[k] + (1 - b1) * grads[k]
                v2[k] = b2 * v2[k] + (1 - b2) * grads[k] * grads[k]
                m_hat = m[k] / (1 - b1 ** step)
                v_hat = v2[k] / (1 - b2 ** step)
                p[k] = (p[k] - lr * m_hat / (v_hat.sqrt() + eps)).detach()
    return dict(losses=losses, params=p, exp_avg=m, exp_avg_sq=v2,
                step=step)


def probabilities(w: dict, g: dict, cfg: dict, rounding: str = "float32"):
    """Sigmoid of the logits, without gradients."""
    with torch.no_grad():
        return torch.sigmoid(logits(w, g, cfg, rounder(rounding)))


def strict_float32() -> None:
    """Float32 matmuls without TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
