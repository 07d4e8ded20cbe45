"""Segment sum over edges already sorted by segment id.

The counterpart of ``gnn_fpga_tpu/ops/pallas/segment_sum.py``:

    out[n] = sum_{e: sorted_ids[e]==n} sorted_messages[e]

with the messages already in the sorted order of a reusable
:class:`SortedSegments`.  On the card the sum is a hand-written CUDA
kernel (``csrc/segment_sum.cu``): each block stages a tile of
:func:`segment_tile_rows` sorted rows in shared memory and sums the rows
of the nodes the tile touches, one or two columns a thread
(:func:`segment_launch`); a second small launch adds the partials of the
nodes that tile boundaries cut.  Ids equal to ``n_node`` are padding
and are dropped.

Deliberate differences from the JAX package: the TPU kernel's rank
compaction (``ranks``, ``node_of_rank``) is replaced by CSR offsets
``ptr``, and ``tile_e`` and ``pad_edges_to_tile`` are gone; they exist only
for Mosaic's tile divisibility.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gnn_fpga_tpu_torch.core.graph import TensorFields
from gnn_fpga_tpu_torch.ops.cuda._build import (DTYPE_CODES, alignment,
                                                check_cuda, check_widths,
                                                kernel_device, launch)
from gnn_fpga_tpu_torch.ops.segment import segment_sum

# "highest" sums the f32 messages exactly; "default" rounds each message to
# bf16 first and sums in f32, as the JAX package's one-pass MXU product does
_PRECISIONS = ("highest", "default")

# Sorted rows a block of the kernel stages in shared memory (a tile) at
# most, and the bytes of messages a tile takes at most (PERF.md, PR 9:
# 128 rows ran fastest at the fullevent D = 66 in both dtypes).
SEGSUM_TILE_ROWS = 128
SEGSUM_TILE_BYTES = 36 * 1024


def segment_tile_rows(d: int, dtype) -> int:
    """Rows a tile of the segment-sum kernel holds for messages of ``d``
    columns of ``dtype``: :data:`SEGSUM_TILE_ROWS`, fewer (a multiple of
    32 where that leaves any) where they would pass
    :data:`SEGSUM_TILE_BYTES`: 128 at the fullevent D = 66, 32 for f32
    rows of 256 columns."""
    rows = min(SEGSUM_TILE_ROWS,
               SEGSUM_TILE_BYTES // (max(d, 1) * dtype.itemsize))
    return max(1, rows // 32 * 32 if rows >= 32 else rows)


@dataclasses.dataclass(frozen=True)
class SegmentLaunch:
    """How ``csrc/segment_sum.cu`` takes one call: ``tile_rows`` sorted
    rows a block, and ``unit`` columns a thread (2 where the messages'
    base and width allow two-element loads, else 1)."""

    tile_rows: int
    unit: int


def segment_launch(d: int, dtype, align: int = 16) -> SegmentLaunch:
    """The :class:`SegmentLaunch` for messages of ``d`` columns of
    ``dtype`` whose base address is a multiple of ``align`` bytes: two
    columns a unit for an even width on a base aligned to two elements
    (the fullevent D = 66: 33 units)."""
    two = d % 2 == 0 and align % (2 * dtype.itemsize) == 0
    return SegmentLaunch(tile_rows=segment_tile_rows(d, dtype),
                         unit=2 if two else 1)


@dataclasses.dataclass(frozen=True)
class SortedSegments(TensorFields):
    """Reusable sorted structure of one topology's segment ids (int32):

      order:      [E]          stable permutation sorting the ids
      sorted_ids: [E]          ids[order]
      ptr:        [n_node + 1] CSR offsets: segment n is the sorted rows
                               ``ptr[n]:ptr[n+1]``; pad ids (``n_node``)
                               lie past ``ptr[n_node]``
      n_kept:     ``ptr[n_node]``, the rows whose id is not padding, on
                  the host (the kernel's grid)
    """

    order: torch.Tensor
    sorted_ids: torch.Tensor
    ptr: torch.Tensor
    n_node: int
    n_kept: int


def build_sorted_segments(ids, n_node: int) -> SortedSegments:
    """Host-side (numpy) sort of ``ids`` (in ``[0, n_node]``, ``n_node``
    being padding), stable as ``jnp.argsort``."""
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    ids = np.asarray(ids, np.int64)
    if len(ids) >= 2 ** 31 or n_node >= 2 ** 31:
        raise ValueError("segments index edges and nodes with int32")
    if len(ids) and (ids.min() < 0 or ids.max() > n_node):
        raise ValueError("segment ids must be in [0, n_node]")
    order = np.argsort(ids, kind="stable")
    ptr = np.zeros(n_node + 1, np.int64)
    np.cumsum(np.bincount(ids, minlength=n_node + 1)[:n_node], out=ptr[1:])
    as_t = lambda a: torch.from_numpy(a.astype(np.int32))
    return SortedSegments(order=as_t(order), sorted_ids=as_t(ids[order]),
                          ptr=as_t(ptr), n_node=int(n_node),
                          n_kept=int(ptr[-1]))


def segment_sum_reference(messages, ids, n_node):
    """``out[n] = sum_{ids[e]==n} messages[e]`` in f32, any order; ids
    outside ``[0, n_node)`` are dropped."""
    return segment_sum(messages.float(), ids, n_node)


def _segment_sum_fwd(sorted_messages, seg: SortedSegments, precision):
    n_node = seg.n_node
    dev = kernel_device(sorted_messages, "sorted_segment_sum")
    if dev is None:
        m = sorted_messages
        if precision == "default":
            m = m.to(torch.bfloat16)
        return segment_sum_reference(m, seg.sorted_ids, n_node).to(
            sorted_messages.dtype)
    d, dtype = sorted_messages.shape[1], sorted_messages.dtype
    if dtype not in DTYPE_CODES:
        raise ValueError(f"sorted_segment_sum: unsupported dtype {dtype}")
    check_widths("sorted_segment_sum", d)
    check_cuda(dev, dtype, sorted_messages=sorted_messages)
    check_cuda(dev, torch.int32, sorted_ids=seg.sorted_ids, ptr=seg.ptr)
    out = torch.empty((n_node, d), dtype=dtype, device=dev)
    if d == 0:
        return out
    la = segment_launch(d, dtype, alignment(sorted_messages))
    part = torch.empty((max(1, -(-seg.n_kept // la.tile_rows)), 2, d),
                       dtype=torch.float32, device=dev)
    launch("gnn_sorted_segment_sum", dtype, seg.n_kept, n_node, d,
           la.tile_rows, la.unit, sorted_messages, seg.sorted_ids, seg.ptr,
           int(precision == "default"), part, out, count="sorted_segment_sum")
    return out


class _SortedSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sorted_messages, seg, precision):
        ctx.seg = seg
        return _segment_sum_fwd(sorted_messages, seg, precision)

    @staticmethod
    def backward(ctx, g):
        # d messages[e] = g[sorted_ids[e]], zero for the pad id n_node
        g_pad = torch.cat([g, g.new_zeros((1, g.shape[1]))])
        return g_pad.index_select(0, ctx.seg.sorted_ids), None, None


def sorted_segment_sum(sorted_messages, seg: SortedSegments, n_node: int,
                       precision: str = "highest"):
    """``out[n] = sum_e sorted_messages[e] * (seg.sorted_ids[e] == n)`` in
    one call of the kernel (two CUDA launches, counted as one
    ``sorted_segment_sum``).  ``sorted_messages`` [E, D] must already be in
    ``seg.order``; ids equal to ``n_node`` are dropped.  Returns [n_node,
    D] in the messages' dtype, summed in f32.  The backward is a row
    gather (``index_select``), as in the JAX package."""
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}")
    if seg.n_node != n_node:
        raise ValueError(f"segments are for {seg.n_node} nodes, not {n_node}")
    if sorted_messages.ndim != 2 or (sorted_messages.shape[0]
                                     != seg.sorted_ids.shape[0]):
        raise ValueError("sorted_messages must be [E, D] over the segments")
    return _SortedSegmentSum.apply(sorted_messages, seg, precision)
