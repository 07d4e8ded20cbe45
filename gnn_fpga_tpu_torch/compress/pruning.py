"""Iterative magnitude pruning for FPGA-sized models.

The counterpart of ``gnn_fpga_tpu/compress/pruning.py``: threshold the
trained weights at magnitude tau -> binary masks -> zero the masked
weights -> retrain with the masks applied inside every matmul (and an L1
penalty) -> next round.

Masks are a dict shaped like the model's submodules,
``{"edge": {"pa", "pb", "l2"}, "node": {"l1", "l2"}}``, each a 0/1 tensor
of the weight's ``[out, in]`` shape (the layout of
:func:`~gnn_fpga_tpu_torch.utils.serialization.load_jax_masks`).  The
model applies ``w * mask`` inside each matmul, so masked weights get zero
gradient; the trainer re-projects after every step so they stay exactly 0.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch
from torch import nn


def weight_matrices(model: nn.Module, modules: Iterable[str] = ("edge", "node")):
    """``(module, layer, weight)`` for each weight matrix of the given
    sub-networks (biases and the input layer excluded)."""
    for mod in modules:
        sub = getattr(model, mod, None)
        if sub is None:
            continue
        for name, child in sub.named_children():
            w = getattr(child, "weight", None)
            if isinstance(w, torch.Tensor):
                yield mod, name, w


def magnitude_masks(model: nn.Module, threshold: float,
                    modules: Iterable[str] = ("edge", "node")) -> Dict:
    """Binary masks ``|W| > threshold`` for each weight matrix of the
    given sub-networks, in the weights' dtype and device."""
    masks: Dict[str, Dict[str, torch.Tensor]] = {}
    with torch.no_grad():
        for mod, name, w in weight_matrices(model, modules):
            masks.setdefault(mod, {})[name] = (w.abs() > threshold).to(w.dtype)
    return masks


@torch.no_grad()
def apply_masks_to_params(model: nn.Module, masks: Optional[Dict]) -> nn.Module:
    """Zero the masked weights of ``model`` in place (``w.mul_(mask)``);
    returns ``model``."""
    if masks is None:
        return model
    for mod, layer_masks in masks.items():
        sub = getattr(model, mod)
        for name, m in layer_masks.items():
            if m is not None:
                w = getattr(sub, name).weight
                w.mul_(m.to(w.device, w.dtype))
    return model


def mask_summary(masks: Dict) -> Dict[str, str]:
    """Per-layer ``"nonzero/total"`` counts."""
    return {f"{mod}.{name}": f"{int(m.sum())}/{m.numel()}"
            for mod, layer_masks in masks.items()
            for name, m in layer_masks.items()}


def sparsity(masks: Dict) -> float:
    """Fraction of pruned weights across all masked layers."""
    total = nz = 0
    for layer_masks in masks.values():
        for m in layer_masks.values():
            total += m.numel()
            nz += int(m.sum())
    return 1.0 - nz / max(total, 1)


def prune_round(model: nn.Module, threshold: float,
                modules: Iterable[str] = ("edge", "node")):
    """One pruning round: derive masks at ``threshold``, zero the masked
    weights in place, and return ``(model, masks)`` ready for masked
    retraining."""
    masks = magnitude_masks(model, threshold, modules)
    return apply_masks_to_params(model, masks), masks
