"""Sorted-edge plans and the message-passing kernels, forward and backward.

The counterpart of ``gnn_fpga_tpu/ops/pallas/spmm.py``.  The iteration's two
edge-weighted aggregations

    mi[n] = sum_{e: recv[e]==n} w[e] * h[send[e]]
    mo[n] = sum_{e: send[e]==n} w[e] * h[recv[e]]

run on the card as hand-written CUDA kernels:

- :func:`iteration_pair` (``csrc/iteration_fwd.cu``) computes the edge
  weights itself from the edge MLP (``w = sigmoid(tanh((pa[s] + pb[r]) *
  em + b1) . w2 + b2) * em``), once per edge, so no ``[E, H]``
  intermediate exists;
- :func:`aggregate_pair` (``csrc/spmm.cu``) takes the weights as given;
- :func:`gather_pair` is the edge MLP's first layer in projection form,
  ``pa[s] + pb[r]`` (the final edge layer, and every unfused iteration);
  its forward is :func:`gather_pair_fwd` (``csrc/gather.cu``), a row
  gather in edge order that needs no plan.

Each is a ``torch.autograd.Function`` whose backward is a kernel too:
:func:`iteration_pair_bwd` (``csrc/iteration_bwd.cu``),
:func:`aggregate_pair_bwd` and :func:`gather_pair_bwd`
(``csrc/spmm_bwd.cu``).  The backwards
save only the V-sized inputs and recompute per-edge values, as the JAX
package's VJPs do.

The single-direction API: :func:`spmm_raw` (one direction of the
aggregation over one plan, on ``csrc/spmm.cu``'s kernel), :func:`spmm`
(with its VJP, ``dh`` through the transpose plan and ``dw`` through
:func:`sddmm`), and on ``csrc/spmm_ops.cu`` :func:`sddmm` (``out[e] =
<a[seg], b[oth]>``) and :func:`sddmm_dual`.

The plans keep the JAX package's receiver-sorted and sender-sorted edge
orders, from a stable argsort, and add CSR row pointers, so each node's
row is reduced by one warp without atomics; the fused iteration's kernels
walk work items of at most :data:`ITEM_EDGES` edges instead
(:class:`IterItems`), and the lane-group row kernels (:func:`aggregate_pair`
and its backward, :func:`gather_pair_bwd`, :func:`spmm_raw`,
:func:`sddmm` and :func:`sddmm_dual`) give each segment of more than
:data:`LONG_SEGMENT` edges a block of warps
(``EdgePlan.long_seg``), so that no long segment sets a tail.  The TPU's
gather windows, prebuilt one-hots and tile padding are not needed: Hopper
gathers rows natively.

Each kernel wrapper runs its kernel on CUDA tensors and its plain PyTorch
version (``*_reference``) on CPU tensors, and counts its kernel launches
in ``<wrapper>.launches`` (:func:`launch_counts`).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from gnn_fpga_tpu_torch.core.graph import TensorFields
from gnn_fpga_tpu_torch.ops.segment import segment_sum

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_WIDTH = 256   # 8 row chunks of 32 lanes in csrc/


@dataclasses.dataclass(frozen=True)
class EdgePlan(TensorFields):
    """Sorted-edge plan for one aggregation direction.

    ``seg`` is the endpoint the edges are grouped by, ``oth`` the gathered
    endpoint.  All arrays int32:

      order:      [E]   sorted position -> edge index (seg ascending, stable)
      inv_order:  [E]   edge index -> sorted position
      sorted_seg: [E]   seg ids in sorted order
      sorted_oth: [E]   oth ids in sorted order
      seg_ptr:    [V+1] CSR offsets: node n's edges are
                        ``sorted_*[seg_ptr[n]:seg_ptr[n+1]]``
      long_seg:   [S]   the nodes with more than :data:`LONG_SEGMENT`
                        edges, ascending; the lane-group row kernels
                        walk each with a block
    """

    order: torch.Tensor
    inv_order: torch.Tensor
    sorted_seg: torch.Tensor
    sorted_oth: torch.Tensor
    seg_ptr: torch.Tensor
    long_seg: torch.Tensor
    n_node: int
    n_edge: int


@dataclasses.dataclass(frozen=True)
class IterItems(TensorFields):
    """Work items of the fused iteration kernels (:func:`iteration_pair`
    and :func:`iteration_pair_bwd`), built once per topology.

    Each direction's CSR segments are cut into items of at most
    :data:`ITEM_EDGES` consecutive sorted edges; a node without edges in a
    direction still has one empty item there, so that its row is written.
    A node is *split* when it has more than one item in either direction.
    All arrays int32:

      items:  [I, 4]  (beg, end, node, slot): item i sums sorted positions
                      [beg, end) of its direction; items [0, n_recv) are
                      the recv plan's (``mi``), the rest the send plan's
                      (``mo``).  In each direction the split nodes' items
                      come first, so that the longest walks start first,
                      then the other nodes', each part in node order and
                      a node's items in edge order.  ``slot`` is -1 when
                      the item writes its node's output row itself, else
                      the f32 partial row it writes for a split node.
      splits: [S, 4]  (node, slot_beg, slot_mid, slot_end) of each split
                      node: its recv items' partial rows are slots
                      [slot_beg, slot_mid), its send items' [slot_mid,
                      slot_end), each in item order; a combine pass sums
                      them in that order.

    Plans padded to a :class:`PlanCapacity` (:func:`pad_plans`) carry
    no-op entries after each direction's real items and after the real
    splits: node -1, which every kernel skips.  ``n_recv`` and ``n_slot``
    are then the capacity's, so a batch's launches do not depend on its
    topology.
    """

    items: torch.Tensor
    splits: torch.Tensor
    n_recv: int
    n_slot: int

    @property
    def n_item(self) -> int:
        return self.items.shape[0]

    @property
    def n_split(self) -> int:
        return self.splits.shape[0]


@dataclasses.dataclass(frozen=True)
class AggPlans(TensorFields):
    """The (receiver-sorted, sender-sorted) plan pair of a graph.

    ``recv`` groups edges by receiver and gathers senders (``mi``); ``send``
    is its transpose (``mo``).  ``send_in_recv[j]`` is the position in the
    recv order of the ``j``-th send-sorted edge: it lets the send side read
    weights that arrive in recv order (:func:`sort_edge_weights`).
    ``items`` are the fused iteration kernels' work items.
    """

    recv: EdgePlan
    send: EdgePlan
    send_in_recv: torch.Tensor
    items: IterItems


# Segments longer than this are walked by the eight warps of a block in
# the lane-group row kernels (csrc/rows.cuh kLongSegment), other segments
# by one warp: the packed fullevent graph's pad node has 160 edges in each
# direction, and one warp walking them set the first designs' tails
# (PERF.md).
LONG_SEGMENT = 32


def build_edge_plan(seg_ids, oth_ids, n_node: int) -> EdgePlan:
    """Host-side (numpy) plan for one aggregation direction."""
    seg_ids = np.asarray(seg_ids, np.int64)
    oth_ids = np.asarray(oth_ids, np.int64)
    e = len(seg_ids)
    if e >= 2 ** 31 or n_node >= 2 ** 31:
        raise ValueError("plans index edges and nodes with int32")
    if e and (min(seg_ids.min(), oth_ids.min()) < 0
              or max(seg_ids.max(), oth_ids.max()) >= n_node):
        raise ValueError("edge ids must be in [0, n_node)")
    order = np.argsort(seg_ids, kind="stable")
    inv_order = np.argsort(order, kind="stable")
    deg = np.bincount(seg_ids, minlength=n_node)
    seg_ptr = np.zeros(n_node + 1, np.int64)
    np.cumsum(deg, out=seg_ptr[1:])
    as_t = lambda a: torch.from_numpy(a.astype(np.int32))
    return EdgePlan(order=as_t(order), inv_order=as_t(inv_order),
                    sorted_seg=as_t(seg_ids[order]),
                    sorted_oth=as_t(oth_ids[order]), seg_ptr=as_t(seg_ptr),
                    long_seg=as_t(np.flatnonzero(deg > LONG_SEGMENT)),
                    n_node=int(n_node), n_edge=e)


# Edges an item of IterItems holds at most.  The packed fullevent graph
# has ~11 edges a node and direction and one pad node with 160 (208 on the
# hit graphs): 32 leaves nearly every real node in one item and cuts the
# pad node into 5-7 items, each about as long as a dense real node's walk.
ITEM_EDGES = 32


def _direction_items(ptr: np.ndarray):
    """One direction's items, in node order: ``(node, beg, end, rank)``
    (``rank``: the item's place among its node's items) and each node's
    first item and item count."""
    deg = np.diff(ptr)
    count = np.maximum(1, -(-deg // ITEM_EDGES))
    first = np.cumsum(count) - count
    node = np.repeat(np.arange(len(deg)), count)
    rank = np.arange(len(node)) - first[node]
    beg = ptr[node] + rank * ITEM_EDGES
    end = np.minimum(beg + ITEM_EDGES, ptr[node + 1])
    return node, beg, end, rank, first, count


def build_iter_items(recv_ptr, send_ptr) -> IterItems:
    """Host-side (numpy) :class:`IterItems` from the two directions' CSR
    offsets ``[V + 1]``."""
    rn, rb, re, r_rank, _, rc = _direction_items(
        np.asarray(recv_ptr, np.int64))
    sn, sb, se, s_rank, _, sc = _direction_items(
        np.asarray(send_ptr, np.int64))
    n_recv = len(rn)
    is_split = (rc > 1) | (sc > 1)
    split = np.flatnonzero(is_split)
    # a split node's partial rows: its recv items', then its send items'
    per = rc[split] + sc[split]
    slot_beg = np.cumsum(per) - per
    slot_mid = slot_beg + rc[split]
    first_slot_r = np.full(len(rc), -1, np.int64)
    first_slot_s = np.full(len(sc), -1, np.int64)
    first_slot_r[split], first_slot_s[split] = slot_beg, slot_mid
    slot_r = np.where(is_split[rn], first_slot_r[rn] + r_rank, -1)
    slot_s = np.where(is_split[sn], first_slot_s[sn] + s_rank, -1)
    split_first = lambda node: np.argsort(~is_split[node], kind="stable")
    r_ord, s_ord = split_first(rn), split_first(sn)
    items = np.stack([np.concatenate([rb[r_ord], sb[s_ord]]),
                      np.concatenate([re[r_ord], se[s_ord]]),
                      np.concatenate([rn[r_ord], sn[s_ord]]),
                      np.concatenate([slot_r[r_ord], slot_s[s_ord]])], 1)
    as_t = lambda a, w: torch.from_numpy(
        np.asarray(a, np.int64).reshape(-1, w).astype(np.int32))
    return IterItems(
        items=as_t(items, 4),
        splits=as_t(np.stack([split, slot_beg, slot_mid, slot_beg + per], 1),
                    4),
        n_recv=n_recv, n_slot=int(per.sum()))


def build_agg_plans(senders, receivers, n_node: int) -> AggPlans:
    """Both aggregation directions of a graph topology (host-side), with
    the fused iteration kernels' work items (:class:`IterItems`)."""
    recv = build_edge_plan(receivers, senders, n_node)
    send = build_edge_plan(senders, receivers, n_node)
    send_in_recv = recv.inv_order.index_select(0, send.order.long())
    return AggPlans(recv=recv, send=send, send_in_recv=send_in_recv,
                    items=build_iter_items(recv.seg_ptr.numpy(),
                                           send.seg_ptr.numpy()))


# ---------------------------------------------------------------------------
# Plans composed per batch and padded to static capacities
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlanCapacity:
    """The sizes a plan's variable-length lists are padded to
    (:func:`pad_plans`): work items in each direction, split nodes, f32
    partial-row slots and long segments in each direction.  With the node
    and edge counts, which a bucket fixes, they set every launch of the
    kernels, so one CUDA graph serves every batch of a bucket."""

    recv_items: int
    send_items: int
    splits: int
    slots: int
    recv_long: int
    send_long: int

    def covers(self, other: "PlanCapacity") -> bool:
        return all(getattr(self, f.name) >= getattr(other, f.name)
                   for f in dataclasses.fields(self))

    @staticmethod
    def covering(*plans: AggPlans) -> "PlanCapacity":
        """The least capacity that holds each of ``plans``."""
        counts = [plan_counts(p) for p in plans]
        return PlanCapacity(**{f.name: max(getattr(c, f.name)
                                           for c in counts)
                               for f in dataclasses.fields(PlanCapacity)})

    def with_headroom(self, factor: float) -> "PlanCapacity":
        """Each count times ``factor``, rounded up, and room for one more
        split node (its two partial-row slots) and one more long segment a
        direction: those counts are 0 on many plans and not on others."""
        floor = dict(splits=1, slots=2, recv_long=1, send_long=1)
        return PlanCapacity(**{
            f.name: math.ceil(getattr(self, f.name) * factor)
            + floor.get(f.name, 0) for f in dataclasses.fields(self)})


def _host(t) -> np.ndarray:
    if t.device.type == "cpu" and not t.requires_grad:
        return t.numpy()
    return t.detach().cpu().numpy()


def plan_counts(plans: AggPlans) -> PlanCapacity:
    """The entries a plan uses: its real items, splits, slots and long
    segments (pad entries, node -1, not counted)."""
    it = plans.items
    node = _host(it.items[:, 2])
    splits = _host(it.splits)
    real = splits[splits[:, 0] >= 0]
    return PlanCapacity(
        recv_items=int((node[:it.n_recv] >= 0).sum()),
        send_items=int((node[it.n_recv:] >= 0).sum()),
        splits=len(real), slots=int(real[:, 3].max()) if len(real) else 0,
        recv_long=int((_host(plans.recv.long_seg) >= 0).sum()),
        send_long=int((_host(plans.send.long_seg) >= 0).sum()))


def worst_case_capacity(n_node: int, n_edge: int) -> PlanCapacity:
    """A capacity that holds the plans of every graph of ``n_node`` nodes
    and ``n_edge`` edges: a node has ``max(1, ceil(deg / ITEM_EDGES))``
    items a direction, so a direction at most ``V + ceil(E / ITEM_EDGES)``;
    a split node has more than ``ITEM_EDGES`` edges one way, so there are
    at most ``min(V, 2E / (ITEM_EDGES + 1))``, with at most two slots each
    beyond one per ``ITEM_EDGES`` edges a direction; a long segment holds
    more than ``LONG_SEGMENT`` edges."""
    per_edges = -(-n_edge // ITEM_EDGES)
    splits = min(n_node, 2 * n_edge // (ITEM_EDGES + 1))
    n_long = min(n_node, n_edge // (LONG_SEGMENT + 1))
    return PlanCapacity(recv_items=n_node + per_edges,
                        send_items=n_node + per_edges, splits=splits,
                        slots=2 * splits + 2 * per_edges,
                        recv_long=n_long, send_long=n_long)


def batch_capacity(per_graph_plans, batch_size: int, n_node: int,
                   n_edge: int) -> PlanCapacity:
    """A capacity that holds the plans of every batch of ``batch_size`` of
    the graphs whose plans are ``per_graph_plans``, packed into ``n_node``
    nodes and ``n_edge`` edges (the pad edges on the one pad node after
    the real nodes, as :func:`~gnn_fpga_tpu_torch.core.graph.pack_graphs`
    puts them).

    A batch's items in a direction are ``n_node - 1 + sum(items - nodes)
    + max(1, ceil(pad / ITEM_EDGES))`` over its graphs, with ``pad =
    n_edge - sum(edges)``; since a graph's items beyond one a node are at
    most ``edges / ITEM_EDGES``, the bound takes the larger of the case
    without pad edges (the ``batch_size`` largest ``items - nodes``, one
    pad item) and the case with them (the largest ``items - nodes -
    edges / ITEM_EDGES``, plus ``(n_edge + ITEM_EDGES - 1) / ITEM_EDGES``);
    the slots likewise, the pad node's two a pad item when it is split.
    Splits and long segments: the ``batch_size`` largest counts, plus the
    pad node's at the most pad edges a batch can have."""
    rows = np.array([[p.recv.n_node, p.recv.n_edge,
                      *dataclasses.astuple(plan_counts(p))]
                     for p in per_graph_plans], np.int64)
    if len(rows) < batch_size:
        raise ValueError("fewer graphs than batch_size")
    top = lambda col: int(np.sort(col)[::-1][:batch_size].sum())
    nodes, edges = rows[:, 0], rows[:, 1]
    if top(nodes) >= n_node or top(edges) > n_edge:
        raise ValueError(f"a batch of {batch_size} graphs does not fit "
                         f"{n_node} nodes (one pad node) and {n_edge} edges")
    max_pad = n_edge - int(np.sort(edges)[:batch_size].sum())
    k = ITEM_EDGES

    def items(col):
        extra = col - nodes
        return n_node - 1 + max(top(extra) + 1,
                                (top(k * extra - edges) + n_edge + k - 1)
                                // k)

    slots = top(rows[:, 5])
    if max_pad > k:
        slots = max(slots, (top(k * rows[:, 5] - 2 * edges)
                            + 2 * (n_edge + k - 1)) // k)
    return PlanCapacity(
        recv_items=items(rows[:, 2]), send_items=items(rows[:, 3]),
        splits=top(rows[:, 4]) + int(max_pad > k), slots=slots,
        recv_long=top(rows[:, 6]) + int(max_pad > LONG_SEGMENT),
        send_long=top(rows[:, 7]) + int(max_pad > LONG_SEGMENT))


# No-op entries of padded plans: an item of node -1 and no edges, a split
# of node -1 and no slots, a long segment of node -1.
_PAD_ITEM = (0, 0, -1, -1)
_PAD_SPLIT = (-1, 0, 0, 0)


def _padded(rows: np.ndarray, node: np.ndarray, n: int, fill,
            what: str) -> np.ndarray:
    """The real entries of ``rows`` (those whose ``node`` is not negative)
    followed by entries ``fill`` to ``n`` rows."""
    k = int(np.count_nonzero(node >= 0))
    if k > n:
        raise ValueError(f"plans exceed their capacity: {k} {what}, "
                         f"capacity {n}")
    out = np.empty((n,) + rows.shape[1:], np.int32)
    out[:k] = rows[node >= 0]
    out[k:] = fill
    return out


def pad_plans(plans: AggPlans, capacity: PlanCapacity) -> AggPlans:
    """``plans`` with each variable-length list padded to ``capacity`` by
    no-op entries after its real ones (node -1; :class:`IterItems`): the
    recv items to ``capacity.recv_items``, the send items after them to
    ``capacity.send_items``, the splits, and each direction's long
    segments.  ``n_recv`` and ``n_slot`` become the capacity's.  Real
    entries keep their order and slots, so every kernel sums as on the
    unpadded plans.  Plans that do not fit raise ``ValueError``; nothing is
    ever dropped.  The padding is done on the host; the result lies where
    ``plans`` lie."""
    it = plans.items
    if not capacity.covers(plan_counts(plans)):
        raise ValueError(f"plans exceed their capacity: they need "
                         f"{plan_counts(plans)}, capacity {capacity}")
    dev = it.items.device
    as_t = lambda a: torch.from_numpy(a).to(dev)
    items = _host(it.items)
    recv, send = items[:it.n_recv], items[it.n_recv:]
    splits = _host(it.splits)
    items = np.concatenate([
        _padded(recv, recv[:, 2], capacity.recv_items, _PAD_ITEM,
                "recv items"),
        _padded(send, send[:, 2], capacity.send_items, _PAD_ITEM,
                "send items")])
    splits = _padded(splits, splits[:, 0], capacity.splits, _PAD_SPLIT,
                     "splits")

    def long_seg(p, n, what):
        nodes = _host(p.long_seg)
        return dataclasses.replace(
            p, long_seg=as_t(_padded(nodes, nodes, n, -1, what)))

    return dataclasses.replace(
        plans, recv=long_seg(plans.recv, capacity.recv_long,
                             "recv long segments"),
        send=long_seg(plans.send, capacity.send_long, "send long segments"),
        items=IterItems(items=as_t(items), splits=as_t(splits),
                        n_recv=capacity.recv_items, n_slot=capacity.slots))


def _offset_cat(arrays, offsets, tail) -> np.ndarray:
    """``concat(arrays) + offsets ++ tail`` as int32: ``offsets`` holds
    each entry's offset (its graph's, repeated)."""
    n = len(offsets)
    out = np.empty(n + len(tail), np.int32)
    np.concatenate(arrays, out=out[:n])
    out[:n] += offsets
    out[n:] = tail
    return out


def compose_agg_plans(per_graph_plans, node_offsets, edge_offsets,
                      n_node: int, n_edge: int) -> AggPlans:
    """The plans of a packed batch from its graphs' plans, built once per
    graph: equal, field for field, to :func:`build_agg_plans` on the graph
    :func:`~gnn_fpga_tpu_torch.core.graph.pack_graphs` makes of them.

    Graph ``k``'s nodes start at ``node_offsets[k]`` and its edges at
    ``edge_offsets[k]``, one after the other from 0; the ``n_edge`` -
    (real edges) pad edges join the one pad node after the real nodes to
    itself, and the nodes after it have no edges.  So each edge array is
    the graphs' arrays offset and concatenated, then the pad node's
    segment; the work items keep :func:`build_iter_items`' order in each
    direction (every split node's items across the batch, then the
    others', each part in node order), and split nodes' slots are
    renumbered in node order.  Host-side (numpy); the plans are CPU
    tensors."""
    plans = list(per_graph_plans)
    noff = np.asarray(node_offsets, np.int64)
    eoff = np.asarray(edge_offsets, np.int64)
    nn = np.array([p.recv.n_node for p in plans], np.int64)
    ne = np.array([p.recv.n_edge for p in plans], np.int64)
    if (len(noff) != len(plans) or len(eoff) != len(plans)
            or np.any(noff != np.cumsum(nn) - nn)
            or np.any(eoff != np.cumsum(ne) - ne)):
        raise ValueError("the graphs must lie one after the other from "
                         "node 0 and edge 0, in the order of their plans")
    real_n, real_e = int(nn.sum()), int(ne.sum())
    n_pad = n_edge - real_e
    if real_n > n_node or n_pad < 0 or (n_pad and real_n == n_node):
        raise ValueError(f"{real_n} nodes and {real_e} edges do not fit "
                         f"{n_node} nodes (a pad node for the pad edges) "
                         f"and {n_edge} edges")
    if max(n_node, n_edge) >= 2 ** 31:
        raise ValueError("plans index edges and nodes with int32")
    tail_ptr = np.concatenate([[0], np.full(n_node - real_n, n_pad)])
    pad_ids = np.full(n_pad, real_n, np.int32)
    pad_pos = np.arange(real_e, n_edge, dtype=np.int32)
    as_t = torch.from_numpy

    # each entry's offset: its graph's first edge or node, by edge or node
    e_by_edge = np.repeat(eoff.astype(np.int32), ne)
    n_by_edge = np.repeat(noff.astype(np.int32), ne)
    e_by_node = np.repeat(eoff.astype(np.int32), nn)

    def direction(get):
        sides = [get(p) for p in plans]
        field = lambda name: [_host(getattr(q, name)) for q in sides]
        longs = field("long_seg")
        return EdgePlan(
            order=as_t(_offset_cat(field("order"), e_by_edge, pad_pos)),
            inv_order=as_t(_offset_cat(field("inv_order"), e_by_edge,
                                       pad_pos)),
            sorted_seg=as_t(_offset_cat(field("sorted_seg"), n_by_edge,
                                        pad_ids)),
            sorted_oth=as_t(_offset_cat(field("sorted_oth"), n_by_edge,
                                        pad_ids)),
            seg_ptr=as_t(_offset_cat([a[:-1] for a in field("seg_ptr")],
                                     e_by_node, tail_ptr + real_e)),
            long_seg=as_t(_offset_cat(
                longs, np.repeat(noff.astype(np.int32),
                                 [len(a) for a in longs]),
                [real_n] * (n_pad > LONG_SEGMENT))),
            n_node=n_node, n_edge=n_edge)

    # the tail: the pad node and the empty nodes after it, planned alone
    tail = build_iter_items(tail_ptr, tail_ptr)
    its = [p.items for p in plans] + [tail]
    n_slot = np.array([it.n_slot for it in its], np.int64)
    soff = np.cumsum(n_slot) - n_slot
    shift = np.stack([np.append(eoff, real_e), np.append(eoff, real_e),
                      np.append(noff, real_n), soff], 1).astype(np.int32)
    parts = {(d, split): [] for d in (0, 1) for split in (True, False)}
    for it, off in zip(its, shift):
        items = _host(it.items) + off
        items[items[:, 3] < off[3], 3] = -1          # slot -1 stays -1
        for d, rows in ((0, items[:it.n_recv]), (1, items[it.n_recv:])):
            n_split = int(np.count_nonzero(rows[:, 3] >= 0))   # they lead
            parts[(d, True)].append(rows[:n_split])
            parts[(d, False)].append(rows[n_split:])
    cat_rows = lambda d: np.concatenate(parts[(d, True)]
                                        + parts[(d, False)]).reshape(-1, 4)
    recv_items, send_items = cat_rows(0), cat_rows(1)
    splits = np.concatenate(
        [_host(it.splits) + off[[2, 3, 3, 3]] for it, off in zip(its, shift)]
    ).reshape(-1, 4)
    return AggPlans(
        recv=direction(lambda p: p.recv), send=direction(lambda p: p.send),
        send_in_recv=as_t(_offset_cat([_host(p.send_in_recv) for p in plans],
                                      e_by_edge, pad_pos)),
        items=IterItems(
            items=as_t(np.ascontiguousarray(
                np.concatenate([recv_items, send_items]), np.int32)),
            splits=as_t(np.ascontiguousarray(splits, np.int32)),
            n_recv=len(recv_items), n_slot=int(n_slot.sum())))


_THREADS = 256       # threads a block (csrc/common.cuh kThreads)
_EDGE_UNROLL = 4     # edges a lane keeps in flight (csrc/iteration.cuh)
# Shared memory a warp of the backward's walks stages its chunk's rows in:
# eight warps a block take 48 KB, the most a block gets without opting in.
_STAGE_BYTES = 6 * 1024


@dataclasses.dataclass(frozen=True)
class IterLaunch:
    """Launch arguments of the fused iteration kernels
    (``csrc/iteration_fwd.cu``, ``csrc/iteration_bwd.cu``) for one call.

    ``vec_h``: H rows (``pa``, ``pb``, ``w2``, ``b1``) read as 16-byte
    items, at most 32 a row; ``vec_d``: D rows (``h``, ``g_mi``,
    ``g_mo``) as element pairs; else one element an item.  In the
    forward's score pass H rows lie across groups of ``2 ** log_lanes``
    lanes, as many as the row has items (at most 32); a group takes an
    edge, each lane keeping ``_EDGE_UNROLL`` edges in flight, in
    ``edge_blocks`` blocks of ``_THREADS`` threads.  In the backward's
    passes a group of ``2 ** bwd_log_lanes`` lanes takes an edge with both
    its H rows, as items of ``bwd_h_bytes`` (16 or 8; 0: one element an
    item), one a lane, and its D rows, at most 8 items a lane; a warp's
    groups take an item's edges in turn, in
    chunks of ``recv_chunk`` (recv pass: an H and two D rows an edge) and
    ``send_chunk`` edges (send pass: an H and a D row), whose rows it
    stages in shared memory, each H row in a slot of ``slot_h`` bytes and
    each D row in one of ``slot_d``.
    """

    vec_h: bool
    vec_d: bool
    log_lanes: int
    edge_blocks: int
    bwd_h_bytes: int
    bwd_log_lanes: int
    recv_chunk: int
    send_chunk: int
    slot_h: int
    slot_d: int


@functools.lru_cache(maxsize=256)
def iteration_launch(n_edge: int, d: int, hdim: int, dtype,
                     aligned_h: bool = True,
                     aligned_d: bool = True) -> IterLaunch:
    """The :class:`IterLaunch` of a call with ``n_edge`` edges, ``[V, d]``
    node tables and ``[V, hdim]`` projections in ``dtype``; ``aligned_h``
    / ``aligned_d``: the H tables start on 16 bytes, the D tables on two
    elements.  At the fullevent widths (H = 64, D = 66): 8 lanes an edge
    in bf16, one 16-byte item each (and in the backward 5 of the D row's
    33 pairs); 16 in f32.  The backward takes the widest H items that
    still fill the lanes its D rows need: the hit graph's odd D = 67 needs
    16 lanes in bf16, so 8-byte items."""
    per = 16 // dtype.itemsize
    vec_h = bool(aligned_h and hdim % per == 0 and hdim // per <= 32)
    vec_d = bool(aligned_d and d % 2 == 0)
    row_h = hdim // per if vec_h else hdim
    row_d = d // 2 if vec_d else d
    log_lanes = min(5, (row_h - 1).bit_length())
    per_block = (_THREADS >> log_lanes) * _EDGE_UNROLL
    # a staged row takes its bytes and the 2 it may start into its first
    # 4-byte word, rounded up to 16 bytes
    slot = lambda width: -(-(width * dtype.itemsize + 4) // 16) * 16
    slot_h, slot_d = slot(hdim), slot(d)
    need_d = (-(-row_d // 8) - 1).bit_length()   # log2 lanes a D row needs
    bwd_h_bytes, row_hb = 0, hdim
    for nbytes in (16, 8):
        per_b = nbytes // dtype.itemsize
        if aligned_h and hdim % per_b == 0 and hdim // per_b <= 32:
            bwd_h_bytes, row_hb = nbytes, hdim // per_b
            if (row_hb - 1).bit_length() >= need_d:
                break
    bwd_log_lanes = max(min(5, (row_hb - 1).bit_length()), need_d)
    groups = 32 >> bwd_log_lanes

    def chunk(edge_bytes):
        """Edges a chunk: as many as fit, a multiple of the groups."""
        c = max(1, min(32, _STAGE_BYTES // edge_bytes))
        return c - c % groups if c >= groups else c

    return IterLaunch(vec_h=vec_h, vec_d=vec_d, log_lanes=log_lanes,
                      edge_blocks=-(-n_edge // per_block),
                      bwd_h_bytes=bwd_h_bytes, bwd_log_lanes=bwd_log_lanes,
                      recv_chunk=chunk(slot_h + 2 * slot_d),
                      send_chunk=chunk(slot_h + slot_d),
                      slot_h=slot_h, slot_d=slot_d)


# Elements a lane of aggregate_pair_bwd holds of each row: its recv walk
# keeps two rows an edge in flight beside the node's own two, and with
# more than 5 elements a lane (the fullevent D = 66 on 8 lanes: 10) its
# registers allow two or three blocks an SM instead of four (PERF.md).
AGG_BWD_LANE_ELEMS = 5


@dataclasses.dataclass(frozen=True)
class RowLaunch:
    """How the kernels of ``csrc/rows.cuh`` (:func:`aggregate_pair` and
    :func:`aggregate_pair_bwd`, :func:`gather_pair_bwd`, :func:`spmm_raw`,
    :func:`sddmm` and :func:`sddmm_dual`) read one call's rows: as items of
    ``item_bytes`` (16, 8, 4 or, in bf16, 2 bytes), in groups of ``2 **
    log_lanes`` lanes, one edge a group, lane ``c`` holding items ``c, c +
    lanes, ...`` (at most 8)."""

    item_bytes: int
    log_lanes: int


@functools.lru_cache(maxsize=256)
def row_launch(width: int, dtype, align: int = 16,
               lane_elems: int | None = None) -> RowLaunch:
    """The :class:`RowLaunch` for rows of ``width`` elements of ``dtype``
    in tables whose base addresses are multiples of ``align`` bytes
    (:func:`_alignment`): the widest item, at most 16 bytes, that divides
    the row and ``align``; the fewest lanes that hold a row in one item a
    lane, or, for rows of more than 32 items, in at most 8.  H = 64 is one
    16-byte item on each of 8 lanes in bf16, of 16 lanes in f32; the
    fullevent D = 66 (132-byte rows in bf16, 264 in f32) is 33 items of 4
    or 8 bytes, 5 a lane on 8 lanes, which ran faster than 3 on 16 or 2 on
    32 (PERF.md).

    ``lane_elems``: a row of more than 32 items that would put more than
    this many elements on a lane is read instead as one-element items, on
    the fewest lanes (at most 32) that hold at most ``lane_elems`` each.
    :func:`aggregate_pair_bwd` takes 5, which holds its registers to four
    blocks an SM: D = 66 is then 5 elements a lane on 16 lanes."""
    elem = dtype.itemsize
    item = 16
    while item > elem and (width * elem % item or align % item):
        item //= 2
    n_items = width * elem // item
    per_lane = 1 if n_items <= 32 else 8
    log = (max(-(-n_items // per_lane), 1) - 1).bit_length()
    if (lane_elems and n_items > 32
            and -(-n_items >> log) * (item // elem) > lane_elems):
        item = elem
        log = (min(32, -(-width // lane_elems)) - 1).bit_length()
    return RowLaunch(item_bytes=item, log_lanes=log)


def _alignment(*tensors) -> int:
    """The largest power of two, at most 16, that divides the base address
    of every tensor (an empty tensor's null address divides by all)."""
    align = 16
    for t in tensors:
        ptr = t.data_ptr()
        if ptr:
            align = min(align, ptr & -ptr)
    return align


def walk_blocks(n_item: int, sm_count: int) -> int:
    """Blocks of eight warps for the backward's send pass, whose warps
    stride over ``n_item`` items: two blocks an SM (the pass's register
    budget), fewer when there are fewer items, none without items.  Each
    warp writes one row of parameter partials, so fewer warps mean fewer
    partials to sum."""
    return min(-(-n_item // 8), 2 * sm_count)


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def sort_edge_weights(w: torch.Tensor, plan: EdgePlan) -> torch.Tensor:
    """[E] edge weights (or mask) permuted into the plan's order, in f32."""
    return w.float().index_select(0, plan.order)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' check on the card).
# They work in any edge order, given senders/receivers in that order, and
# return f32.
# ---------------------------------------------------------------------------

def aggregate_pair_reference(h, w, senders, receivers, n_node):
    """``(mi, mo)`` in f32; ``w`` includes the mask."""
    hf, w = h.float(), w.float()[:, None]
    mi = segment_sum(hf.index_select(0, senders) * w, receivers, n_node)
    mo = segment_sum(hf.index_select(0, receivers) * w, senders, n_node)
    return mi, mo


def iteration_pair_reference(pa, pb, h, em, w2, b1, b2, senders, receivers,
                             n_node, activation=torch.tanh):
    """:func:`iteration_pair` in plain PyTorch, in f32."""
    em = em.float()
    pre = (pa.float().index_select(0, senders)
           + pb.float().index_select(0, receivers)) * em[:, None]
    z = activation(pre + b1.float())
    e = torch.sigmoid(z @ w2.float().reshape(-1)
                      + b2.float().reshape(())) * em
    return aggregate_pair_reference(h, e, senders, receivers, n_node)


def gather_pair_reference(pa, pb, senders, receivers):
    """``out[e] = pa[senders[e]] + pb[receivers[e]]`` in the input dtype."""
    return pa.index_select(0, senders) + pb.index_select(0, receivers)


def aggregate_pair_bwd_reference(h, w, g_mi, g_mo, senders, receivers,
                                 n_node):
    """VJP of :func:`aggregate_pair_reference`, in closed form (the JAX
    kernel's ``_agg_bwd_kernel``): ``(dh, dw)``, with ``dw`` in the given
    edge order."""
    hf, w = h.float(), w.float()[:, None]
    gmi_r = g_mi.float().index_select(0, receivers)
    gmo_s = g_mo.float().index_select(0, senders)
    dw = ((gmi_r * hf.index_select(0, senders)).sum(1)
          + (gmo_s * hf.index_select(0, receivers)).sum(1))
    dh = (segment_sum(w * gmi_r, senders, n_node)
          + segment_sum(w * gmo_s, receivers, n_node))
    return dh, dw


def edge_scores_reference(pa, pb, em, w2, b1, b2, senders, receivers):
    """The fused iteration's [E] f32 edge scores ``sigmoid(tanh((pa[s] +
    pb[r]) * em + b1) . w2 + b2)`` in the given edge order."""
    pre = (pa.float().index_select(0, senders)
           + pb.float().index_select(0, receivers)) * em.float()[:, None]
    z = torch.tanh(pre + b1.float())
    return torch.sigmoid(z @ w2.float().reshape(-1)
                         + b2.float().reshape(()))


def iteration_pair_bwd_reference(pa, pb, h, em, w2, b1, b2, g_mi, g_mo,
                                 senders, receivers, n_node):
    """VJP of :func:`iteration_pair_reference` (tanh), in closed form (the
    JAX kernel's ``_iter_pair_bwd_kernel``, recomputing z and the edge
    score): ``(dh, dpa, dpb, dw2, db1, db2)``, ``db2`` of shape [1]."""
    sig = edge_scores_reference(pa, pb, em, w2, b1, b2, senders, receivers)
    return iteration_pair_bwd_stashed_reference(
        pa, pb, h, em, w2, b1, sig, g_mi, g_mo, senders, receivers, n_node)


def iteration_pair_bwd_stashed_reference(pa, pb, h, em, w2, b1, sig, g_mi,
                                         g_mo, senders, receivers, n_node):
    """The same VJP from STASHED edge scores ``sig`` [E] (the forward's, in
    the given edge order; ``benchmarks/probe_iter.py::_stash_bwd``'s
    function), in f32: ``z`` is recomputed (``dpre`` needs it), the scores
    are read, so ``b2`` is not needed."""
    em = em.float()
    w2 = w2.float().reshape(-1)
    hf = h.float()
    sig = sig.float()
    pre = (pa.float().index_select(0, senders)
           + pb.float().index_select(0, receivers)) * em[:, None]
    z = torch.tanh(pre + b1.float())
    e = (sig * em)[:, None]
    gmi_r = g_mi.float().index_select(0, receivers)
    gmo_s = g_mo.float().index_select(0, senders)
    de = ((gmi_r * hf.index_select(0, senders)).sum(1)
          + (gmo_s * hf.index_select(0, receivers)).sum(1))
    dlogit = de * em * sig * (1 - sig)
    dz1 = dlogit[:, None] * w2 * (1 - z * z)      # dz * (1 - z^2), no em
    dpre = dz1 * em[:, None]
    dh = (segment_sum(e * gmi_r, senders, n_node)
          + segment_sum(e * gmo_s, receivers, n_node))
    return (dh, segment_sum(dpre, senders, n_node),
            segment_sum(dpre, receivers, n_node),
            (z * dlogit[:, None]).sum(0), dz1.sum(0), dlogit.sum().reshape(1))


def gather_pair_bwd_reference(g, senders, receivers, n_node):
    """VJP of :func:`gather_pair_reference` (the JAX kernel's
    ``_gather_bwd_kernel``): ``(dpa, dpb)`` in f32."""
    g = g.float()
    return segment_sum(g, senders, n_node), segment_sum(g, receivers, n_node)


def spmm_reference(h, w, seg_ids, oth_ids, n_node):
    """``out[n] = sum_{seg[e]==n} w[e] * h[oth[e]]`` in f32."""
    return segment_sum(h.float().index_select(0, oth_ids) * w.float()[:, None],
                       seg_ids, n_node)


def sddmm_reference(a, b, seg_ids, oth_ids):
    """``out[e] = <a[seg[e]], b[oth[e]]>`` in f32."""
    return (a.float().index_select(0, seg_ids)
            * b.float().index_select(0, oth_ids)).sum(1)


def sddmm_dual_reference(p, q, u, v, seg_ids, oth_ids):
    """``out[e] = <p[seg[e]], q[oth[e]]> + <u[oth[e]], v[seg[e]]>`` in f32."""
    return (sddmm_reference(p, q, seg_ids, oth_ids)
            + sddmm_reference(v, u, seg_ids, oth_ids))


# ---------------------------------------------------------------------------
# Checks and launch plumbing
# ---------------------------------------------------------------------------

def _check_cuda(device, dtype, **tensors):
    """Device, dtype and contiguity checks before passing raw pointers."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_plan(name, plan: EdgePlan, device, n_node: int):
    if plan.n_node != n_node:
        raise ValueError(f"{name}: plan is for {plan.n_node} nodes, tables "
                         f"for {n_node}")
    _check_cuda(device, torch.int32, seg_ptr=plan.seg_ptr,
                sorted_oth=plan.sorted_oth, order=plan.order,
                long_seg=plan.long_seg)


def _check_plans(plans: AggPlans, device, n_node: int):
    if plans.send.n_edge != plans.recv.n_edge:
        raise ValueError("recv and send plans differ in their edge count")
    _check_plan("recv plan", plans.recv, device, n_node)
    _check_plan("send plan", plans.send, device, n_node)
    _check_cuda(device, torch.int32, send_in_recv=plans.send_in_recv)


def _kernel_device(h, name):
    """Tables on the CPU take the plain version (None); anything other
    than a CUDA device is refused rather than falling back."""
    if h.device.type == "cpu":
        return None
    if h.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {h.device}, expected CPU or CUDA")
    if h.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {h.dtype}")
    return h.device


def _check_widths(name, *widths):
    if max(widths) > _MAX_WIDTH:
        raise ValueError(f"{name}: widths above {_MAX_WIDTH}")


def _check_iteration(name, pa, pb, h, em_sorted, w2, b1, b2, plans, **grads):
    """Shapes, dtypes and devices of :func:`iteration_pair`'s arguments
    (and its output gradients) before a kernel launch."""
    dev = h.device
    v, d = h.shape
    hdim = pa.shape[-1]
    if (pa.shape != (v, hdim) or pb.shape != (v, hdim)
            or w2.shape != (hdim,) or b1.shape != (hdim,) or b2.numel() != 1
            or em_sorted.shape != (plans.recv.n_edge,)
            or any(g.shape != (v, d) for g in grads.values())):
        raise ValueError(f"{name}: inconsistent shapes")
    _check_widths(name, d, hdim)
    _check_cuda(dev, h.dtype, pa=pa, pb=pb, h=h, w2=w2, b1=b1, b2=b2,
                **grads)
    _check_cuda(dev, torch.float32, em_sorted=em_sorted)
    _check_plans(plans, dev, v)
    it = plans.items
    _check_cuda(dev, torch.int32, sorted_seg=plans.recv.sorted_seg,
                items=it.items, splits=it.splits)


def _raise_on_error(code: int, name: str):
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError_t {code})")


def _ptr(t):
    return t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _lib():
    from gnn_fpga_tpu_torch.ops.cuda._build import load_library
    return load_library()


def _plan_args(plans: AggPlans) -> tuple:
    """The aggregation kernels' arguments for each plan, recv then send:
    CSR offsets, other endpoints, edge order, long segments and their
    count."""
    return tuple(x for p in (plans.recv, plans.send)
                 for x in (_ptr(p.seg_ptr), _ptr(p.sorted_oth), _ptr(p.order),
                           _ptr(p.long_seg), len(p.long_seg)))


# ---------------------------------------------------------------------------
# Kernel wrappers: CPU tensors take the plain version, CUDA tensors launch
# ---------------------------------------------------------------------------

def iteration_pair_fwd(pa, pb, h, em_sorted, w2, b1, b2, plans: AggPlans):
    """:func:`iteration_pair`'s forward, no VJP attached: ``(mi, mo,
    sig)``, ``sig`` the [E] f32 edge scores ``sigmoid(z . w2 + b2)`` in the
    recv plan's order, which :func:`iteration_pair_bwd` takes on the card
    (None on the CPU, whose backward recomputes them).  On CUDA tensors a
    score pass over the edges, a walk over the work items and, when a node
    is split, a combine pass: 2-3 CUDA launches, counted as one in
    ``iteration_pair.launches``."""
    if _kernel_device(h, "iteration_pair") is None:
        r = plans.recv
        mi, mo = iteration_pair_reference(pa, pb, h, em_sorted, w2, b1, b2,
                                          r.sorted_oth, r.sorted_seg,
                                          h.shape[0])
        return mi.to(h.dtype), mo.to(h.dtype), None
    _check_iteration("iteration_pair", pa, pb, h, em_sorted, w2, b1, b2,
                     plans)
    v, d = h.shape
    hdim = pa.shape[1]
    n_edge = plans.recv.n_edge
    it = plans.items
    la = iteration_launch(n_edge, d, hdim, h.dtype,
                          _alignment(pa, pb, w2, b1) >= 16,
                          _alignment(h) >= 2 * h.element_size())
    f32 = dict(dtype=torch.float32, device=h.device)
    e_sorted, sig = torch.empty(n_edge, **f32), torch.empty(n_edge, **f32)
    partial = torch.empty((max(it.n_slot, 1), d), **f32)
    mi = torch.empty_like(h)
    mo = torch.empty_like(h)
    code = _lib().gnn_iteration_pair_fwd(
        _DTYPE_CODES[h.dtype], n_edge, d, hdim, int(la.vec_h),
        int(la.vec_d), la.log_lanes, la.edge_blocks, _ptr(pa), _ptr(pb),
        _ptr(h), _ptr(em_sorted), _ptr(plans.send_in_recv), _ptr(w2),
        _ptr(b1), _ptr(b2), _ptr(plans.recv.sorted_oth),
        _ptr(plans.recv.sorted_seg), _ptr(plans.send.sorted_oth),
        _ptr(it.items), it.n_item, it.n_recv,
        _ptr(it.splits), it.n_split, _ptr(e_sorted), _ptr(sig), _ptr(partial),
        _ptr(mi), _ptr(mo), _stream(h))
    _raise_on_error(code, "gnn_iteration_pair_fwd")
    iteration_pair.launches += 1
    return mi, mo, sig


def _aggregate_pair_fwd(h, w, plans):
    if h.device.type == "cpu":
        r = plans.recv
        mi, mo = aggregate_pair_reference(h, sort_edge_weights(w, r),
                                          r.sorted_oth, r.sorted_seg,
                                          h.shape[0])
        return mi.to(h.dtype), mo.to(h.dtype)
    v, d = h.shape
    mi = torch.empty_like(h)
    mo = torch.empty_like(h)
    la = row_launch(d, h.dtype, _alignment(h, mi, mo))
    code = _lib().gnn_aggregate_pair_fwd(
        _DTYPE_CODES[h.dtype], v, d, la.item_bytes, la.log_lanes, _ptr(h),
        _ptr(w), *_plan_args(plans), _ptr(mi), _ptr(mo), _stream(h))
    _raise_on_error(code, "gnn_aggregate_pair_fwd")
    aggregate_pair.launches += 1
    return mi, mo


def iteration_pair_bwd(pa, pb, h, em_sorted, w2, b1, b2, g_mi, g_mo,
                       plans: AggPlans, sig_sorted=None):
    """VJP of :func:`iteration_pair`: ``(dh, dpa, dpb, dw2, db1, db2)`` in
    ``h.dtype``, ``db2`` shaped like ``b2``.  ``g_mi`` and ``g_mo`` are
    [V, D] in ``h.dtype``.  ``sig_sorted``: the forward's [E] f32 edge
    scores (:func:`iteration_pair_fwd`), required on CUDA tensors; the CPU
    path reads them where given (:func:`iteration_pair_bwd_stashed_
    reference`) and recomputes them where not.  On CUDA tensors: a
    pass over the recv items (each edge's ``dlogit``, ``dpb``, the recv
    part of ``dh``), a pass over the send items (``dpa``, ``dh``, the
    parameter sums) and one that finishes the parameter sums and the split
    nodes' rows (3 CUDA launches, counted as one in
    ``iteration_pair_bwd.launches``); z is recomputed from the V-sized
    inputs on both passes."""
    dev = _kernel_device(h, "iteration_pair_bwd")
    if dev is None:
        r = plans.recv
        ids = (r.sorted_oth, r.sorted_seg, h.shape[0])
        if sig_sorted is None:
            out = iteration_pair_bwd_reference(pa, pb, h, em_sorted, w2, b1,
                                               b2, g_mi, g_mo, *ids)
        else:
            out = iteration_pair_bwd_stashed_reference(
                pa, pb, h, em_sorted, w2, b1, sig_sorted, g_mi, g_mo, *ids)
        out = out[:-1] + (out[-1].reshape(b2.shape),)
        return tuple(t.to(h.dtype) for t in out)
    _check_iteration("iteration_pair_bwd", pa, pb, h, em_sorted, w2, b1, b2,
                     plans, g_mi=g_mi, g_mo=g_mo)
    if sig_sorted is None or sig_sorted.shape != em_sorted.shape:
        raise ValueError("iteration_pair_bwd: sig_sorted, the forward's [E] "
                         "edge scores, is required on the card")
    _check_cuda(dev, torch.float32, sig_sorted=sig_sorted)
    out = _launch_iteration_bwd("gnn_iteration_pair_bwd", sig_sorted, pa, pb,
                                h, em_sorted, w2, b1, b2, g_mi, g_mo, plans)
    iteration_pair_bwd.launches += 1
    return out


def _launch_iteration_bwd(entry, scores, pa, pb, h, em_sorted, w2, b1, b2,
                          g_mi, g_mo, plans: AggPlans) -> tuple:
    """One launch of ``csrc/iteration_bwd.cu``'s C ``entry`` on checked
    CUDA tensors: ``gnn_iteration_pair_bwd`` with ``scores`` the
    forward's [E] f32 edge scores, or the probes' variant
    ``gnn_iteration_pair_bwd_recompute`` with ``scores`` = ``b2``, which
    forms them itself.  Returns ``(dh, dpa, dpb, dw2, db1, db2)``."""
    dev = h.device
    v, d = h.shape
    hdim = pa.shape[1]
    n_edge = plans.recv.n_edge
    it = plans.items
    la = iteration_launch(n_edge, d, hdim, h.dtype,
                          _alignment(pa, pb, w2, b1) >= 16,
                          _alignment(h, g_mi, g_mo) >= 2 * h.element_size())
    f32 = dict(dtype=torch.float32, device=dev)
    n_slot = max(it.n_slot, 1)
    e_sorted, dl = (torch.empty(n_edge, **f32),
                    torch.empty((n_edge, 2), **f32))
    dh_recv = torch.empty((v, d), **f32)
    send_blocks = walk_blocks(it.n_item - it.n_recv, _sm_count(dev))
    # one partial a column and a warp of the send pass
    param = torch.empty((2 * hdim + 1) * max(8 * send_blocks, 1), **f32)
    hpart, dpart = (torch.empty((n_slot, hdim), **f32),
                    torch.empty((n_slot, d), **f32))
    dh, dpa, dpb = (torch.empty_like(h), torch.empty_like(pa),
                    torch.empty_like(pb))
    dw2, db1, db2 = (torch.empty_like(w2), torch.empty_like(b1),
                     torch.empty_like(b2))
    code = getattr(_lib(), entry)(
        _DTYPE_CODES[h.dtype], n_edge, d, hdim, la.bwd_h_bytes,
        int(la.vec_d), la.bwd_log_lanes, send_blocks, la.recv_chunk,
        la.send_chunk, la.slot_h, la.slot_d, _ptr(pa), _ptr(pb),
        _ptr(h), _ptr(em_sorted), _ptr(scores),
        _ptr(plans.send_in_recv), _ptr(w2), _ptr(b1), _ptr(g_mi), _ptr(g_mo),
        _ptr(plans.recv.sorted_oth),
        _ptr(plans.send.sorted_oth), _ptr(it.items), it.n_item, it.n_recv,
        _ptr(it.splits), it.n_split, _ptr(e_sorted), _ptr(dl),
        _ptr(dh_recv), _ptr(param), _ptr(hpart), _ptr(dpart), _ptr(dh),
        _ptr(dpa), _ptr(dpb), _ptr(dw2), _ptr(db1), _ptr(db2), _stream(h))
    _raise_on_error(code, entry)
    return dh, dpa, dpb, dw2, db1, db2


def aggregate_pair_bwd(h, w, g_mi, g_mo, plans: AggPlans):
    """VJP of :func:`aggregate_pair` in one kernel launch: ``(dh, dw)``,
    ``dh`` in ``h.dtype``, ``dw`` [E] f32 in EDGE order.  ``w`` is [E] f32
    in edge order; ``g_mi``/``g_mo`` are [V, D] in ``h.dtype``."""
    dev = _kernel_device(h, "aggregate_pair_bwd")
    if dev is None:
        r = plans.recv
        dh, dw = aggregate_pair_bwd_reference(
            h, sort_edge_weights(w, r), g_mi, g_mo, r.sorted_oth,
            r.sorted_seg, h.shape[0])
        return dh.to(h.dtype), dw.index_select(0, r.inv_order)
    v, d = h.shape
    if (w.shape != (plans.recv.n_edge,) or g_mi.shape != (v, d)
            or g_mo.shape != (v, d)):
        raise ValueError("aggregate_pair_bwd: inconsistent shapes")
    _check_widths("aggregate_pair_bwd", d)
    _check_cuda(dev, h.dtype, h=h, g_mi=g_mi, g_mo=g_mo)
    _check_cuda(dev, torch.float32, w=w)
    _check_plans(plans, dev, v)
    dh = torch.empty_like(h)
    dw = torch.empty_like(w)
    la = row_launch(d, h.dtype, _alignment(h, g_mi, g_mo, dh),
                    lane_elems=AGG_BWD_LANE_ELEMS)
    code = _lib().gnn_aggregate_pair_bwd(
        _DTYPE_CODES[h.dtype], v, d, la.item_bytes, la.log_lanes, _ptr(h),
        _ptr(w), _ptr(g_mi), _ptr(g_mo), *_plan_args(plans), _ptr(dh),
        _ptr(dw), _stream(h))
    _raise_on_error(code, "gnn_aggregate_pair_bwd")
    aggregate_pair_bwd.launches += 1
    return dh, dw


def gather_pair_fwd(pa, pb, senders, receivers):
    """``out[e] = pa[senders[e]] + pb[receivers[e]]`` [E, H] in the
    tables' dtype, EDGE order, in one kernel launch, no VJP attached
    (:func:`gather_pair` adds it); counted in ``gather_pair.launches``.
    Each element is rounded once from the f32 sum, as the plain version's
    add rounds it, so the two agree bit for bit.  ``pa``/``pb``: [V, H];
    ``senders``/``receivers``: [E] int32 ids in [0, V).  An id outside
    [0, V) raises ``IndexError`` on the CPU; on the card it stops the
    kernel at a device-side assert, as ``index_select`` does there, and
    the error surfaces at the next synchronisation."""
    dev = _kernel_device(pa, "gather_pair")
    if dev is None:
        return gather_pair_reference(pa, pb, senders, receivers)
    if (pa.ndim != 2 or pb.shape != pa.shape or senders.ndim != 1
            or receivers.shape != senders.shape):
        raise ValueError("gather_pair: pa and pb must be [V, H] alike, "
                         "senders and receivers [E]")
    n_node, hdim = pa.shape
    _check_widths("gather_pair", hdim)
    _check_cuda(dev, pa.dtype, pa=pa, pb=pb)
    _check_cuda(dev, torch.int32, senders=senders, receivers=receivers)
    out = torch.empty((senders.shape[0], hdim), dtype=pa.dtype, device=dev)
    code = _lib().gnn_gather_pair_fwd(
        _DTYPE_CODES[pa.dtype], senders.shape[0], n_node, hdim, _ptr(pa),
        _ptr(pb), _ptr(senders), _ptr(receivers), _ptr(out), _stream(pa))
    _raise_on_error(code, "gnn_gather_pair_fwd")
    gather_pair.launches += 1
    return out


def gather_pair_bwd(g, plans: AggPlans):
    """VJP of :func:`gather_pair` in one kernel launch: ``(dpa, dpb)``
    [V, H] in ``g.dtype``, from ``g`` [E, H] in EDGE order."""
    n_node = plans.recv.n_node
    dev = _kernel_device(g, "gather_pair_bwd")
    if dev is None:
        r = plans.recv
        dpa, dpb = gather_pair_bwd_reference(g.index_select(0, r.order),
                                             r.sorted_oth, r.sorted_seg,
                                             n_node)
        return dpa.to(g.dtype), dpb.to(g.dtype)
    if g.ndim != 2 or g.shape[0] != plans.recv.n_edge:
        raise ValueError("gather_pair_bwd: g must be [E, H]")
    hdim = g.shape[1]
    _check_widths("gather_pair_bwd", hdim)
    _check_cuda(dev, g.dtype, g=g)
    _check_plans(plans, dev, n_node)
    dpa = torch.empty((n_node, hdim), dtype=g.dtype, device=dev)
    dpb = torch.empty_like(dpa)
    la = row_launch(hdim, g.dtype, _alignment(g, dpa, dpb))
    code = _lib().gnn_gather_pair_bwd(
        _DTYPE_CODES[g.dtype], n_node, hdim, la.item_bytes, la.log_lanes,
        _ptr(g), *(x for p in (plans.recv, plans.send)
                   for x in (_ptr(p.seg_ptr), _ptr(p.order),
                             _ptr(p.long_seg), len(p.long_seg))),
        _ptr(dpa), _ptr(dpb), _stream(g))
    _raise_on_error(code, "gnn_gather_pair_bwd")
    gather_pair_bwd.launches += 1
    return dpa, dpb


def spmm_raw(h, w, plan: EdgePlan):
    """``out[n] = sum_{e: seg[e]==n} w[e] * h[oth[e]]`` in one kernel
    launch, no VJP attached: :func:`aggregate_pair`'s forward kernel over
    one plan.  ``h``: [V, D]; ``w``: [E] edge weights in EDGE order (read
    through the plan's ``order``).  Returns [V, D] in ``h.dtype``, each
    element rounded once from its f32 sum."""
    w = w.float()
    dev = _kernel_device(h, "spmm")
    if dev is None:
        return spmm_reference(h, sort_edge_weights(w, plan), plan.sorted_seg,
                              plan.sorted_oth, plan.n_node).to(h.dtype)
    v, d = h.shape
    if w.shape != (plan.n_edge,):
        raise ValueError("spmm: w must be [E]")
    _check_widths("spmm", d)
    _check_cuda(dev, h.dtype, h=h)
    _check_cuda(dev, torch.float32, w=w)
    _check_plan("spmm", plan, dev, v)
    out = torch.empty_like(h)
    la = row_launch(d, h.dtype, _alignment(h, out))
    code = _lib().gnn_spmm(
        _DTYPE_CODES[h.dtype], v, d, la.item_bytes, la.log_lanes, _ptr(h),
        _ptr(w), _ptr(plan.seg_ptr), _ptr(plan.sorted_oth), _ptr(plan.order),
        _ptr(plan.long_seg), len(plan.long_seg), _ptr(out), _stream(h))
    _raise_on_error(code, "gnn_spmm")
    spmm.launches += 1
    return out


def _sddmm(name, plan: EdgePlan, a, b, u=None, v=None):
    """:func:`sddmm`, or :func:`sddmm_dual` with ``u`` and ``v``."""
    wrapper = sddmm if u is None else sddmm_dual
    dev = _kernel_device(a, name)
    if dev is None:
        out = sddmm_reference(a, b, plan.sorted_seg, plan.sorted_oth)
        if u is not None:
            out = out + sddmm_reference(v, u, plan.sorted_seg,
                                        plan.sorted_oth)
        return out.index_select(0, plan.inv_order)
    tabs = dict(a=a, b=b) if u is None else dict(p=a, q=b, u=u, v=v)
    n, d = a.shape
    if any(t.shape != (n, d) for t in tabs.values()):
        raise ValueError(f"{name}: the tables must all be [V, D]")
    _check_widths(name, d)
    _check_cuda(dev, a.dtype, **tabs)
    _check_plan(name, plan, dev, n)
    out = torch.empty(plan.n_edge, dtype=torch.float32, device=dev)
    la = row_launch(d, a.dtype, _alignment(*tabs.values()))
    code = getattr(_lib(), f"gnn_{name}")(
        _DTYPE_CODES[a.dtype], n, d, la.item_bytes, la.log_lanes,
        *map(_ptr, tabs.values()), _ptr(plan.seg_ptr), _ptr(plan.sorted_oth),
        _ptr(plan.order), _ptr(plan.long_seg), len(plan.long_seg),
        _ptr(out), _stream(a))
    _raise_on_error(code, f"gnn_{name}")
    wrapper.launches += 1
    return out


def sddmm(a, b, plan: EdgePlan):
    """Sampled dense-dense product ``out[e] = <a[seg[e]], b[oth[e]]>`` in
    one kernel launch.  ``a``/``b``: [V, D].  Returns [E] f32 in EDGE
    order; it is the gradient of :func:`spmm_raw` with respect to ``w``."""
    return _sddmm("sddmm", plan, a, b)


def sddmm_dual(p, q, u, v, plan: EdgePlan):
    """``out[e] = <p[seg[e]], q[oth[e]]> + <u[oth[e]], v[seg[e]]>`` in one
    kernel launch, :func:`sddmm`'s kernel with a second pair of tables,
    each lane adding the two products element by element as
    :func:`aggregate_pair_bwd` sums ``dw``: with the recv plan,
    ``sddmm_dual(g_mi, h, g_mo, h, recv)`` is the ``dw`` of
    :func:`aggregate_pair`.  Four [V, D] tables; returns [E] f32 in EDGE
    order."""
    return _sddmm("sddmm_dual", plan, p, q, u, v)


# ---------------------------------------------------------------------------
# Autograd Functions: the kernels forward and backward
# ---------------------------------------------------------------------------

def _grad_as(g, dtype):
    """An output gradient as a kernel operand: in ``dtype``, contiguous
    (autograd hands column slices of a concatenation's gradient)."""
    return g.to(dtype).contiguous()


class _IterationPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pa, pb, h, em_sorted, w2, b1, b2, plans):
        mi, mo, sig = iteration_pair_fwd(pa, pb, h, em_sorted, w2, b1, b2,
                                         plans)
        ctx.plans, ctx.sig = plans, sig      # sig: [E] f32, or None
        ctx.save_for_backward(pa, pb, h, em_sorted, w2, b1, b2)
        return mi, mo

    @staticmethod
    def backward(ctx, g_mi, g_mo):
        pa, pb, h, em_sorted, w2, b1, b2 = ctx.saved_tensors
        dh, dpa, dpb, dw2, db1, db2 = iteration_pair_bwd(
            pa, pb, h, em_sorted, w2, b1, b2, _grad_as(g_mi, h.dtype),
            _grad_as(g_mo, h.dtype), ctx.plans, ctx.sig)
        return dpa, dpb, dh, None, dw2, db1, db2, None


class _AggregatePair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, plans):
        ctx.plans = plans
        ctx.save_for_backward(h, w)
        return _aggregate_pair_fwd(h, w, plans)

    @staticmethod
    def backward(ctx, g_mi, g_mo):
        h, w = ctx.saved_tensors
        dh, dw = aggregate_pair_bwd(h, w, _grad_as(g_mi, h.dtype),
                                    _grad_as(g_mo, h.dtype), ctx.plans)
        return dh, dw, None


class _GatherPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pa, pb, senders, receivers, plans):
        ctx.plans = plans
        ctx.dtypes = pa.dtype, pb.dtype
        return gather_pair_fwd(pa, pb, senders, receivers)

    @staticmethod
    def backward(ctx, g):
        dpa, dpb = gather_pair_bwd(_grad_as(g, ctx.dtypes[0]), ctx.plans)
        return dpa, dpb.to(ctx.dtypes[1]), None, None, None


class _Spmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, plan, plan_t):
        ctx.plans = plan, plan_t
        ctx.save_for_backward(h, w)
        return spmm_raw(h, w, plan)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        plan, plan_t = ctx.plans
        g = _grad_as(g, h.dtype)
        return spmm_raw(g, w, plan_t), sddmm(g, h, plan), None, None


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def iteration_pair(pa, pb, h, em_sorted, w2, b1, b2, plans: AggPlans):
    """Whole-iteration fusion: edge-MLP scoring, sigmoid and both weighted
    aggregations, forward and backward, each one wrapper call counted as
    one launch (the forward is 2-3 CUDA launches, the backward 3: see
    :func:`iteration_pair_fwd` and :func:`iteration_pair_bwd`); the
    backward takes the edge scores the forward computed.

    ``pa``/``pb``: [V, H] endpoint projections (``h @ W1a`` / ``h @ W1b``,
    masks applied); ``em_sorted``: [E] f32 edge mask in the recv plan's
    order (:func:`sort_edge_weights`); ``w2``/``b1``: [H]; ``b2``: [1].
    Returns ``(mi, mo)`` [V, D] in ``h.dtype``.
    """
    return _IterationPair.apply(pa, pb, h, em_sorted, w2, b1, b2, plans)


def aggregate_pair(h, w, plans: AggPlans):
    """Fused edge-weighted neighbour aggregation, both directions, in one
    kernel launch, forward and backward.  ``w``: [E] weights in EDGE
    order, mask included.  Returns ``(mi, mo)`` [V, D] in ``h.dtype``."""
    dev = _kernel_device(h, "aggregate_pair")
    w = w.float()
    if dev is not None:
        v, d = h.shape
        if w.shape != (plans.recv.n_edge,):
            raise ValueError("aggregate_pair: w must be [E]")
        _check_widths("aggregate_pair", d)
        _check_cuda(dev, h.dtype, h=h)
        _check_cuda(dev, torch.float32, w=w)
        _check_plans(plans, dev, v)
    return _AggregatePair.apply(h, w, plans)


def gather_pair(pa, pb, senders, receivers, plans: AggPlans):
    """``out[e] = pa[senders[e]] + pb[receivers[e]]`` in the input dtype,
    EDGE order: the projection-form first layer of the edge MLP.  The
    forward, a row gather, is one kernel launch (:func:`gather_pair_fwd`);
    the backward, two [E, H]-row segment sums, is another
    (:func:`gather_pair_bwd`)."""
    dev = _kernel_device(pa, "gather_pair")
    if dev is not None:
        if pb.dtype != pa.dtype or pb.shape != pa.shape:
            raise ValueError("gather_pair: pa and pb must match")
        if senders.shape != (plans.recv.n_edge,):
            raise ValueError("gather_pair: senders and plans differ in "
                             "their edge count")
        _check_plans(plans, dev, pa.shape[0])
    return _GatherPair.apply(pa, pb, senders, receivers, plans)


def spmm(h, w, plan: EdgePlan, plan_t: EdgePlan):
    """Single-direction differentiable SpMM, :func:`spmm_raw` over
    ``plan``; ``plan_t`` is its transpose (for a graph's
    :class:`AggPlans`, ``(plans.recv, plans.send)`` or the reverse).  The
    backward is ``dh = spmm_raw(g, w, plan_t)`` and ``dw = sddmm(g, h,
    plan)``, each one kernel launch."""
    if plan_t.n_node != plan.n_node or plan_t.n_edge != plan.n_edge:
        raise ValueError("spmm: plan_t must be the transpose of plan")
    w = w.float()
    return _Spmm.apply(h, w, plan, plan_t)


iteration_pair.launches = 0
aggregate_pair.launches = 0
gather_pair.launches = 0
iteration_pair_bwd.launches = 0
aggregate_pair_bwd.launches = 0
gather_pair_bwd.launches = 0
spmm.launches = 0
sddmm.launches = 0
sddmm_dual.launches = 0


# Wrappers of other modules' kernels that count here too
# (:func:`register_kernel_wrappers`).
_REGISTERED_WRAPPERS: list = []


def register_kernel_wrappers(*wrappers):
    """Has :func:`launch_counts` and its kin cover ``wrappers`` (each
    counting in ``<wrapper>.launches``): the probes' kernels
    (``ops/cuda/probes.py``) register themselves when imported."""
    _REGISTERED_WRAPPERS.extend(
        f for f in wrappers if f not in _REGISTERED_WRAPPERS)


def _kernel_wrappers() -> tuple:
    from gnn_fpga_tpu_torch.ops.cuda.doublets import select_segments
    from gnn_fpga_tpu_torch.ops.cuda.segment_sum import sorted_segment_sum

    return (iteration_pair, aggregate_pair, gather_pair, iteration_pair_bwd,
            aggregate_pair_bwd, gather_pair_bwd, spmm, sddmm, sddmm_dual,
            sorted_segment_sum, select_segments) + tuple(_REGISTERED_WRAPPERS)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset, by name: the
    wrappers of this module, :func:`~gnn_fpga_tpu_torch.ops.cuda.
    segment_sum.sorted_segment_sum`, :func:`~gnn_fpga_tpu_torch.ops.
    cuda.doublets.select_segments` and those registered by
    :func:`register_kernel_wrappers`."""
    return {f.__name__: f.launches for f in _kernel_wrappers()}


def reset_launch_counts():
    for f in _kernel_wrappers():
        f.launches = 0


def add_launch_counts(counts: dict):
    """Adds ``counts`` (by wrapper name, as :func:`launch_counts` gives
    them) to the wrappers' counts: a CUDA graph's replay launches the
    kernels its capture recorded (``core/capture.py``)."""
    for f in _kernel_wrappers():
        f.launches += counts.get(f.__name__, 0)
