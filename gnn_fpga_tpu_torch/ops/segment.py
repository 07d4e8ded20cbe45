"""Sparse message-passing primitives on COO edges: gather and segment-sum.

The counterpart of ``gnn_fpga_tpu/ops/segment.py``, on ``index_select`` and
``index_add_``.  Every function works on one graph.  Padded edges must be
masked by the caller.
"""

from __future__ import annotations

from typing import Optional

import torch


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[e] = x[idx[e]]``: the edge-endpoint feature gather."""
    return x.index_select(0, idx)


def segment_sum(messages: torch.Tensor, idx: torch.Tensor,
                n_node: int) -> torch.Tensor:
    """``out[n] = sum_{e: idx[e]==n} messages[e]``.

    Ids outside ``[0, n_node)`` are dropped, as ``jax.ops.segment_sum``
    drops them: they are routed to one spare row that is cut off, so no
    host synchronisation is needed.
    """
    keep = (idx >= 0) & (idx < n_node)
    idx = torch.where(keep, idx, torch.full_like(idx, n_node))
    out = messages.new_zeros((n_node + 1,) + tuple(messages.shape[1:]))
    return out.index_add_(0, idx, messages)[:n_node]


def weighted_segment_sum(messages: torch.Tensor, weights: torch.Tensor,
                         idx: torch.Tensor, n_node: int) -> torch.Tensor:
    """``out[n] = sum_{e: idx[e]==n} weights[e] * messages[e]``."""
    return segment_sum(messages * weights[:, None], idx, n_node)


def segment_mean(messages: torch.Tensor, idx: torch.Tensor, n_node: int,
                 eps: float = 1e-9) -> torch.Tensor:
    """Mean of each segment's messages (zero for an empty segment)."""
    totals = segment_sum(messages, idx, n_node)
    counts = segment_sum(messages.new_ones((messages.shape[0], 1)), idx,
                         n_node)
    return totals / counts.clamp_min(eps)


def edge_concat(x: torch.Tensor, senders: torch.Tensor,
                receivers: torch.Tensor,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-edge ``[x[senders], x[receivers]]``; with ``edge_mask`` the
    masked edges' rows are zero."""
    b = torch.cat([gather(x, senders), gather(x, receivers)], dim=-1)
    if edge_mask is not None:
        b = b * edge_mask.to(b.dtype)[:, None]
    return b
