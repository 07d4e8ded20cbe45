"""Blocked (layered) incidence aggregation: per-layer-pair one-hot matmuls.

The counterpart of ``gnn_fpga_tpu/ops/blocked.py``.  Tracking graphs are
layered: every real edge goes from a hit on layer ``l`` to one on layer
``l+1``, so grouping edges by layer pair makes the global incidence
block-diagonal.  :func:`attach_blocks_layered` permutes a graph's edges
into ``[nB, be]`` blocks of consecutive layer pairs and attaches a
:class:`BlockedPlan`; the route then gathers and scatters per block with
``[be, bn]`` one-hots, ~n_layers times smaller than the dense route's
``[V, E]`` incidence, and moves between the global node table and the
block slots with the one-hot broadcast matrix ``G`` ``[nB*bn, V]``.

Plan construction is host-side numpy, vectorised over the batch.  The
device functions take one graph or a batch (leading axes): a batch runs as
one batched matmul over ``B * nB`` blocks.  They are plain products that
the JAX package leaves to XLA, so the port leaves them to
``torch.matmul``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gnn_fpga_tpu_torch.core.graph import Graph, TensorFields, _np


@dataclasses.dataclass(frozen=True)
class BlockedPlan(TensorFields):
    """Per-graph block structure (leading batch axes allowed), int32:

      block_nodes: [..., nB, bn]  global node id of each block slot
                                  (pad slots hold ``n_node``)
      src_local:   [..., nB, be]  block-local slot of each edge's sender
                                  (pad edges hold ``bn``)
      dst_local:   [..., nB, be]  the same for the receiver

    The graph's edge arrays are permuted so that edge ``b * be + j`` is
    edge ``j`` of block ``b``.
    """

    block_nodes: torch.Tensor
    src_local: torch.Tensor
    dst_local: torch.Tensor

    @property
    def n_blocks(self) -> int:
        return self.block_nodes.shape[-2]

    @property
    def block_n(self) -> int:
        return self.block_nodes.shape[-1]

    @property
    def block_e(self) -> int:
        return self.src_local.shape[-1]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def attach_blocks_layered(graph: Graph, layer_offsets, group: int = 1,
                          block_e: Optional[int] = None,
                          block_n: Optional[int] = None) -> Graph:
    """Permute a layered graph's edges into per-layer-pair blocks and
    attach a :class:`BlockedPlan` for ``aggregation="blocked"``.

    ``graph``: batched ``[B, ...]`` or single, nodes sorted by layer, every
    real edge from layer ``l`` to ``l+1``.  ``layer_offsets``: ``[n_layers
    + 1]`` node-id boundaries of the layers, or ``[B, n_layers + 1]``.
    ``group``: layer pairs merged per block.  ``block_e``/``block_n``: pin
    the per-block edge and node capacities (default: the largest over the
    batch, rounded up to a multiple of 8).

    Returns a Graph whose edge arrays (senders, receivers, y, edge_mask)
    are reordered and padded to ``nB * block_e`` and whose ``blocks`` is
    set; node arrays are unchanged.
    """
    off = np.asarray(layer_offsets, dtype=np.int64)
    n_layers = off.shape[-1] - 1
    n_pairs = n_layers - 1
    if n_pairs < 1:
        raise ValueError("need at least 2 layers")
    g = int(group)
    n_blocks = -(-n_pairs // g)

    batched = graph.senders.ndim > 1
    senders = _np(graph.senders).astype(np.int64)
    receivers = _np(graph.receivers).astype(np.int64)
    y = _np(graph.y)
    emask = _np(graph.edge_mask)
    if not batched:
        senders, receivers = senders[None], receivers[None]
        y, emask = y[None], emask[None]
    B, E = senders.shape
    if off.ndim == 1:
        off = np.broadcast_to(off, (B, n_layers + 1))
    elif off.shape[0] != B:
        raise ValueError(
            f"layer_offsets batch dim {off.shape[0]} != graph batch {B}")
    n_node = graph.n_node
    real = emask > 0

    # --- layer of each sender -> pair index -> block
    pair = (senders[:, :, None] >= off[:, None, :]).sum(-1) - 1
    if np.any(pair[real] >= n_pairs) or np.any(pair[real] < 0):
        raise ValueError("sender layers out of range for layer_offsets")
    recv_layer = (receivers[:, :, None] >= off[:, None, :]).sum(-1) - 1
    if np.any(recv_layer[real] != pair[real] + 1):
        raise ValueError(
            "graph is not layered: every real edge must go from layer l "
            "to layer l+1 (nodes sorted by layer)")
    blk = np.where(real, pair // g, n_blocks)   # pad edges -> virtual block

    # --- stable bucketing of the edges into [nB, be] slots
    order = np.argsort(blk, axis=-1, kind="stable")
    blk_s = np.take_along_axis(blk, order, axis=-1)
    rows = np.repeat(np.arange(B), E)
    counts = np.bincount(
        (rows * (n_blocks + 1) + blk_s.ravel()).astype(np.int64),
        minlength=B * (n_blocks + 1)).reshape(B, n_blocks + 1)
    starts = np.concatenate(
        [np.zeros((B, 1), np.int64), np.cumsum(counts, axis=-1)[:, :-1]],
        axis=-1)
    slot = np.arange(E)[None] - np.take_along_axis(starts, blk_s, axis=-1)
    max_be = int(slot[blk_s < n_blocks].max()) + 1 if real.any() else 0
    be = _round_up(max_be, 8) if block_e is None else int(block_e)
    if max_be > be:
        raise ValueError(f"block_e={be} < max real block size {max_be}")

    valid = blk_s < n_blocks
    dest = (blk_s * be + slot)[valid]
    brow = np.broadcast_to(np.arange(B)[:, None], (B, E))[valid]

    def scatter(src, fill, dtype):
        out = np.full((B, n_blocks * be), fill, dtype=dtype)
        out[brow, dest] = np.take_along_axis(src, order, axis=-1)[valid]
        return out

    new_s = scatter(senders, 0, np.int32)
    new_r = scatter(receivers, 0, np.int32)
    new_y = scatter(y, 0.0, y.dtype)
    new_m = scatter(emask, 0.0, emask.dtype)

    # --- block node slots: contiguous layer ranges (per graph)
    lo_idx = np.arange(n_blocks) * g
    hi_idx = np.minimum(lo_idx + g + 1, n_layers)
    lo = off[:, lo_idx]                                       # [B, nB]
    hi = off[:, hi_idx]
    bn = _round_up(int((hi - lo).max()), 8)
    if block_n is not None:
        if bn > block_n:
            raise ValueError(f"block_n={block_n} < max layer-range span {bn}")
        bn = int(block_n)
    slot_ids = lo[:, :, None] + np.arange(bn)[None, None, :]  # [B, nB, bn]
    block_nodes = np.where(slot_ids < hi[:, :, None], slot_ids, n_node)

    # --- block-local endpoint slots (pad -> bn: a zero one-hot column)
    base_of_slot = np.repeat(lo, be, axis=-1)                 # [B, nB*be]
    m = new_m > 0
    src_local = np.where(m, new_s - base_of_slot, bn)
    dst_local = np.where(m, new_r - base_of_slot, bn)
    if np.any((src_local[m] < 0) | (src_local[m] >= bn)) or np.any(
            (dst_local[m] < 0) | (dst_local[m] >= bn)):
        raise ValueError("edge endpoints escape their block node range")

    lead = (B,) if batched else ()
    as_t = lambda a, shape=None: torch.from_numpy(np.ascontiguousarray(
        a.reshape(lead + (shape or a.shape[1:])))).to(graph.x.device)
    plan = BlockedPlan(
        block_nodes=as_t(block_nodes.astype(np.int32)),
        src_local=as_t(src_local.astype(np.int32), (n_blocks, be)),
        dst_local=as_t(dst_local.astype(np.int32), (n_blocks, be)))
    return graph.replace(senders=as_t(new_s), receivers=as_t(new_r),
                         y=as_t(new_y), edge_mask=as_t(new_m), blocks=plan)


# ---------------------------------------------------------------------------
# Device-side blocked primitives (one graph, or a batch on leading axes)
# ---------------------------------------------------------------------------

def broadcast_matrix(plan: BlockedPlan, n_node: int, dtype) -> torch.Tensor:
    """``G[..., s, v] = 1`` iff block slot ``s`` (flattened ``[nB*bn]``)
    holds node ``v``; pad slots are zero rows.  ``G @ h`` broadcasts the
    node table into the blocks, ``G^T @ m`` sums block partials back."""
    slots = plan.block_nodes.flatten(-2)
    nodes = torch.arange(n_node, device=slots.device)
    return (slots.unsqueeze(-1) == nodes).to(dtype)


def local_incidence(plan: BlockedPlan, edge_mask: torch.Tensor, dtype):
    """Block-local one-hots ``(Ri, Ro)`` ``[..., nB, be, bn]``: ``Ro[b, e,
    n] = 1`` iff edge ``e`` of block ``b`` starts at slot ``n`` (``Ri`` for
    its end); masked edges are zero rows."""
    em = edge_mask.reshape(plan.src_local.shape).to(dtype).unsqueeze(-1)
    slots = torch.arange(plan.block_n, device=em.device)
    ro = (plan.src_local.unsqueeze(-1) == slots).to(dtype) * em
    ri = (plan.dst_local.unsqueeze(-1) == slots).to(dtype) * em
    return ri, ro


def gather_blocks(g: torch.Tensor, h: torch.Tensor,
                  n_blocks: int) -> torch.Tensor:
    """The node table in block layout, ``[..., nB, bn, D]``."""
    hb = g @ h.to(g.dtype)
    return hb.reshape(*hb.shape[:-2], n_blocks, -1, hb.shape[-1])


def gather_bmm(r: torch.Tensor, hb: torch.Tensor) -> torch.Tensor:
    """``bo[b, e] = hb[b, src_local[b, e]]`` as a per-block matmul."""
    return r @ hb


def scatter_bmm(r: torch.Tensor, messages: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-block scatter-add of (optionally edge-weighted) messages:
    ``[..., nB, bn, D]``."""
    if weights is not None:
        messages = messages * weights.unsqueeze(-1).to(messages.dtype)
    return r.transpose(-1, -2) @ messages


def reduce_blocks(g: torch.Tensor, mb: torch.Tensor) -> torch.Tensor:
    """Block-local node partials ``[..., nB, bn, D]`` summed into the global
    node table ``[..., V, D]`` (the transpose of :func:`broadcast_matrix`)."""
    return g.transpose(-1, -2) @ mb.flatten(-3, -2)
