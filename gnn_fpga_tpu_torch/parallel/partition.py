"""Graph (context) parallelism: one large graph partitioned across ranks.

The counterpart of ``gnn_fpga_tpu/parallel/partition.py``.  A graph is
row-partitioned over the mesh's ``graph`` dimension:

- nodes are split into contiguous ranges, one per rank;
- every edge belongs to the rank that owns its **receiver**, so the
  receiver-side aggregation ``mi`` is a local segment sum;
- each message-passing iteration moves only **halo rows**: a rank pulls
  the remote rows its edges reference with one all_to_all over the
  precomputed ``send_idx`` plan, gathers edges from the local + halo
  *extended* table ``[N_local + P*S, D]``, and pushes the sender-side
  partials of the halo rows back to their owners with the reverse
  all_to_all and a scatter-add (``exchange="halo"``);
  ``exchange="allgather"`` replicates the whole activation table instead.

The shard body (:func:`sharded_logits`) runs on each rank for its own
shard (one rank a shard; the JAX package's ``shard_map``), in one of three
forms: with ``plans`` and tanh and ``cfg.fused_iteration``, each
iteration is one :func:`~gnn_fpga_tpu_torch.ops.cuda.spmm.iteration_pair`
kernel on the extended table (the owned rows' projections, the halo rows'
``pa`` tail, ``pb`` zero-padded over the halo rows); with ``plans`` and no
fusion, :func:`~gnn_fpga_tpu_torch.ops.cuda.spmm.aggregate_pair` on the
extended table; without, gathers and segment sums.  With ``plans`` the
edge network's first layer (the final edge head's, and each unfused
iteration's) is :func:`~gnn_fpga_tpu_torch.ops.cuda.spmm.gather_pair` on
the extended table, as on one device.  Every collective is
built from ``all_to_all_single`` and ``all_gather_into_tensor``
(``parallel/collectives.py``) and carries its adjoint for the backward.

Deliberate differences: the plans of the extended table are the port's
``AggPlans`` padded to one :class:`~gnn_fpga_tpu_torch.ops.cuda.spmm.
PlanCapacity` for all shards, where the JAX package unifies kernel
windows and rounds shard edge counts to tile multiples; with plans
the edge network's first layer runs in projection form (the JAX shard
body gathers the rows and multiplies after); the halo
scatter-add sums the ``P`` blocks one after the other, so that a row
that several shards pull gets its partials in rank order on every run
(within a block a row appears once; the pad slots all name row 0 and add
exact zeros).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from gnn_fpga_tpu_torch.core.graph import (Graph, TensorFields, _np,
                                           index_fields, stack_fields)
from gnn_fpga_tpu_torch.models import mpnn
from gnn_fpga_tpu_torch.ops import segment as ops
from gnn_fpga_tpu_torch.parallel import data_parallel as dp
from gnn_fpga_tpu_torch.parallel import mesh as mesh_lib
from gnn_fpga_tpu_torch.parallel.collectives import (Comm, all_gather_rows,
                                                     all_to_all,
                                                     reduce_scatter)


@dataclasses.dataclass(frozen=True)
class PartitionedGraph(TensorFields):
    """A graph split into P receiver-owned shards, stacked on axis 0
    (:meth:`shard` takes one out, without the leading axis).

    Shapes (per shard, stacked leading P):
      x:           [P, N_local, F]   node features of owned nodes
      senders:     [P, E_local]      GLOBAL sender ids
      receivers:   [P, E_local]      LOCAL receiver ids (0 .. N_local-1)
      y:           [P, E_local]      edge labels
      edge_mask:   [P, E_local]
      node_mask:   [P, N_local]
      senders_ext: [P, E_local]      sender index into the local + halo
                                     extended table [N_local + P*S rows]
      send_idx:    [P, P*S]          local rows this shard sends; block q
                                     (size S) = rows destined to (and whose
                                     partials return from) shard q
      node_y:      [P, N_local]      hit labels, or None
      plans:       the shards' AggPlans over the extended table, padded
                   to one PlanCapacity and stacked on P, or None
    """

    x: torch.Tensor
    senders: torch.Tensor
    receivers: torch.Tensor
    y: torch.Tensor
    edge_mask: torch.Tensor
    node_mask: torch.Tensor
    senders_ext: Optional[torch.Tensor] = None
    send_idx: Optional[torch.Tensor] = None
    node_y: Optional[torch.Tensor] = None
    plans: Optional[object] = None

    @property
    def n_parts(self) -> int:
        return self.x.shape[0]

    @property
    def n_local(self) -> int:
        return self.x.shape[-2]

    @property
    def n_global(self) -> int:
        return self.x.shape[0] * self.x.shape[1]

    @property
    def halo_size(self) -> int:
        """Per-pair halo row count S (padded, static)."""
        return self.send_idx.shape[-1] // self.n_parts

    def shard(self, p: int) -> "PartitionedGraph":
        """Shard ``p`` alone: every tensor's leading axis indexed."""
        return index_fields(self, p)


def _round_up8(x: int) -> int:
    return ((x + 7) // 8) * 8


def partition_graph(g: Graph, n_parts: int, plans: bool = False,
                    edge_capacity: Optional[int] = None,
                    halo_capacity: Optional[int] = None,
                    capacity=None) -> PartitionedGraph:
    """Split one (unbatched, possibly padded) graph into receiver-owned
    shards (host-side numpy; one-time preprocessing per graph).

    Nodes are padded to a multiple of ``n_parts`` (pad rows masked).  Each
    shard's edges are those whose receiver falls in its node range, padded
    to the largest shard's edge count; pad edges run from the shard's
    first to its last local node and are masked.

    ``plans=True`` also builds each shard's
    :class:`~gnn_fpga_tpu_torch.ops.cuda.spmm.AggPlans` over its local +
    halo extended table (``N_local + P*S`` rows, senders ``senders_ext``,
    local receivers), padded to ``capacity`` (a ``PlanCapacity``; default:
    the least that holds every shard's) and stacked on the P axis.

    ``edge_capacity`` / ``halo_capacity`` / ``capacity`` pin the static
    per-shard edge count, per-pair halo size S and plan capacity: a
    partitioned graph's shapes depend on its data, so a stream of batches
    pins them to one worst case (the train CLI does) and one captured step
    serves every batch.  A graph over a pin raises ``ValueError``.
    """
    x = _np(g.x)
    senders = _np(g.senders)
    receivers = _np(g.receivers)
    y = _np(g.y)
    em = _np(g.edge_mask)
    nm = _np(g.node_mask)

    n = x.shape[0]
    n_local = -(-n // n_parts)
    n_pad = n_local * n_parts
    if n_pad > n:
        pad = n_pad - n
        x = np.pad(x, ((0, pad), (0, 0)))
        nm = np.pad(nm, (0, pad))

    owner = receivers // n_local
    # drop masked (padding) edges entirely; they are re-padded per shard
    keep = em > 0
    parts = []
    max_e = 0
    for p in range(n_parts):
        sel = keep & (owner == p)
        parts.append((senders[sel], receivers[sel] - p * n_local, y[sel]))
        max_e = max(max_e, int(sel.sum()))
    max_e = max(max_e, 1)
    if edge_capacity is not None:
        if edge_capacity < max_e:
            raise ValueError(
                f"edge_capacity={edge_capacity} < required shard edge "
                f"count {max_e}")
        max_e = int(edge_capacity)

    def pad_part(p, s, r, yy):
        e = len(s)
        pad = max_e - e
        return (
            # pad edges point at an OWNED row so they never create halo
            # demand; edge_mask == 0 zeroes their contributions.
            np.pad(s, (0, pad), constant_values=p * n_local),
            np.pad(r, (0, pad), constant_values=n_local - 1),
            np.pad(yy, (0, pad)),
            np.pad(np.ones(e, np.float32), (0, pad)),
        )

    padded = [pad_part(p, *part) for p, part in enumerate(parts)]

    # --- halo plan: need[p][q] = q-owned global rows p's edges reference
    need = [[np.zeros(0, np.int64)] * n_parts for _ in range(n_parts)]
    for p in range(n_parts):
        s = padded[p][0]
        s_owner = s // n_local
        for q in range(n_parts):
            if q == p:
                continue
            need[p][q] = np.unique(s[s_owner == q])
    s_pair = max(
        [len(need[p][q]) for p in range(n_parts) for q in range(n_parts)]
        + [1])
    s_pair = _round_up8(s_pair)
    if halo_capacity is not None:
        if halo_capacity < s_pair:
            raise ValueError(
                f"halo_capacity={halo_capacity} < required per-pair halo "
                f"size {s_pair}")
        s_pair = _round_up8(int(halo_capacity))

    senders_ext = []
    send_idx = []
    for p in range(n_parts):
        s = padded[p][0]
        s_owner = s // n_local
        ext = s - p * n_local  # local rows map directly
        for q in range(n_parts):
            if q == p:
                continue
            sel = s_owner == q
            # position of each remote sender within need[p][q]
            pos = np.searchsorted(need[p][q], s[sel])
            ext[sel] = n_local + q * s_pair + pos
        senders_ext.append(ext)
        # rows p sends: block q = what q needs FROM p (pad slots -> row 0;
        # their returning partials are zero: no edge reads a pad slot)
        blocks = []
        for q in range(n_parts):
            rows = (need[q][p] - p * n_local) if q != p else np.zeros(0, np.int64)
            blocks.append(np.pad(rows, (0, s_pair - len(rows))))
        send_idx.append(np.concatenate(blocks))

    node_y = None
    if g.node_y is not None:
        node_y = _np(g.node_y)
        if n_pad > n:
            node_y = np.pad(node_y, (0, n_pad - n))
        node_y = torch.from_numpy(
            np.stack(np.split(node_y, n_parts)).astype(np.float32))

    stacked_plans = None
    if plans:
        from gnn_fpga_tpu_torch.ops.cuda import spmm

        n_ext = n_local + n_parts * s_pair
        per_shard = [spmm.build_agg_plans(senders_ext[p], padded[p][1], n_ext)
                     for p in range(n_parts)]
        if capacity is None:
            capacity = spmm.PlanCapacity.covering(*per_shard)
        stacked_plans = stack_fields([spmm.pad_plans(pl, capacity)
                                      for pl in per_shard], "plans")

    as_t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt))
    return PartitionedGraph(
        x=as_t(np.stack(np.split(x, n_parts)), np.float32),
        senders=as_t(np.stack([p[0] for p in padded]), np.int32),
        receivers=as_t(np.stack([p[1] for p in padded]), np.int32),
        y=as_t(np.stack([p[2] for p in padded]), np.float32),
        edge_mask=as_t(np.stack([p[3] for p in padded]), np.float32),
        node_mask=as_t(np.stack(np.split(nm, n_parts)), np.float32),
        senders_ext=as_t(np.stack(senders_ext), np.int32),
        send_idx=as_t(np.stack(send_idx), np.int32),
        node_y=node_y,
        plans=stacked_plans,
    )


def shard_capacity(*pgs: PartitionedGraph):
    """The least ``PlanCapacity`` that holds the plans of every shard of
    ``pgs`` (built with ``plans=True``): their real entries, pads not
    counted."""
    from gnn_fpga_tpu_torch.ops.cuda import spmm

    return spmm.PlanCapacity.covering(
        *(pg.shard(p).plans for pg in pgs for p in range(pg.n_parts)))


# ---------------------------------------------------------------------------
# The shard body: the forward of one shard, run by each rank on its own
# ---------------------------------------------------------------------------

def sharded_logits(model, shard: PartitionedGraph, comm: Comm, masks=None,
                   exchange: str = "halo", head: str = "edge"):
    """The message-passing forward of one shard (no leading P axis), run by
    each rank of ``comm`` (the mesh's ``graph`` group) on its own shard:
    this shard's edge logits ``[E_local]`` (``head="edge"``) or node logits
    ``[N_local]`` (``head="node"``, a NodeClassifier's ``output`` layer),
    in f32.  A SegmentClassifierUnshared runs each iteration's own
    networks and scores the edges with its ``output`` network; the model's
    ``cfg.compute_dtype`` is honoured (logits return in f32).

    ``exchange="halo"``: each iteration pulls only the remote rows this
    shard's edges reference, gathers edges from the local + halo extended
    table, and pushes the sender-side partials of the halo rows back to
    their owners.  ``exchange="allgather"``: each iteration gathers the
    whole table and reduce-scatters the sender-side partials.  The
    receiver-side sums ``mi`` are local either way (edges belong to the
    receiver's shard).  Semantics identical to the single-graph forward of
    ``models/mpnn.py``.
    """
    if exchange not in ("halo", "allgather"):
        raise ValueError(f"unknown exchange {exchange!r}")
    cfg = model.cfg
    act = cfg.activation
    unshared = hasattr(model, "edge_stack")
    if unshared and masks:
        raise ValueError("SegmentClassifierUnshared takes no pruning masks")
    masks_e, masks_n = mpnn._mask(masks, "edge"), mpnn._mask(masks, "node")
    params, x = mpnn._cast_for_compute(model, shard.x, cfg.compute_dtype)
    n_local = x.shape[0]
    halo = exchange == "halo"
    em = shard.edge_mask.to(x.dtype)[:, None]

    if halo:
        senders, recv = shard.senders_ext, shard.receivers
        send_idx = shard.send_idx
        s_pair = send_idx.shape[0] // comm.size
        n_ext = n_local + send_idx.shape[0]

        def pull(h):
            """This shard's halo rows, ``[P*S, D]`` (one all_to_all)."""
            return all_to_all(h.index_select(0, send_idx), comm)

        def extend(h):
            return torch.cat([h, pull(h)], dim=0)

        def reduce_ext(partials):
            """Return the halo rows' partials to their owners and add them
            in, one block after the other."""
            back = all_to_all(partials[n_local:], comm)
            out = partials[:n_local]
            for q in range(comm.size):
                blk = slice(q * s_pair, (q + 1) * s_pair)
                out = out.index_add(0, send_idx[blk], back[blk])
            return out
    else:
        senders = shard.senders
        recv = shard.receivers + comm.rank * n_local
        n_ext = n_local * comm.size

        def extend(h):
            return all_gather_rows(h, comm)

        def reduce_ext(partials):
            return reduce_scatter(partials, comm)

    use_plans = halo and shard.plans is not None
    use_fused = use_plans and act is torch.tanh and cfg.fused_iteration
    if use_plans:
        from gnn_fpga_tpu_torch.ops.cuda.spmm import (aggregate_pair,
                                                      gather_pair,
                                                      iteration_pair,
                                                      sort_edge_weights)
        em_sorted = sort_edge_weights(shard.edge_mask, shard.plans.recv)

    def pad_halo(t):
        """``t`` over the owned rows, zero over the halo rows: a receiver
        half, which only owned rows' edges read."""
        return torch.cat([t, t.new_zeros((n_ext - n_local, t.shape[1]))])

    def edge_logits(p, h, h_ext, m):
        """The edge MLP with its first layer split by endpoint; in halo
        mode the receiver half reads only owned rows.  With plans the
        first layer is applied before the gather (projection form) and
        the pair gathered by :func:`~gnn_fpga_tpu_torch.ops.cuda.spmm.
        gather_pair`, as on one device; the JAX package gathers the rows
        and multiplies after."""
        wa = mpnn._masked(p["pa"], mpnn._mask(m, "pa"))
        wb = mpnn._masked(p["pb"], mpnn._mask(m, "pb"))
        if use_plans:
            pre = gather_pair(F.linear(h_ext, wa), pad_halo(F.linear(h, wb)),
                              senders, recv, shard.plans) * em
        else:
            pre = (F.linear(ops.gather(h_ext, senders) * em, wa)
                   + F.linear(ops.gather(h if halo else h_ext, recv) * em,
                              wb))
        z = act(pre + p["b1"])
        return mpnn._linear(p["l2"], z, mpnn._mask(m, "l2"))[..., 0]

    def body(h, ep, np_):
        if use_fused:
            # the projections of the owned rows need no halo row; only
            # the halo rows' pa tail waits for the exchange
            wa = mpnn._masked(ep["pa"], mpnn._mask(masks_e, "pa"))
            wb = mpnn._masked(ep["pb"], mpnn._mask(masks_e, "pb"))
            w2 = mpnn._masked(ep["l2"], mpnn._mask(masks_e, "l2"))[0]
            halo_rows = pull(h)
            pa = torch.cat([F.linear(h, wa), F.linear(halo_rows, wa)])
            mi_ext, mo_partial = iteration_pair(
                pa, pad_halo(F.linear(h, wb)), torch.cat([h, halo_rows]),
                em_sorted, w2, ep["b1"], ep["l2"]["b"], shard.plans)
            mi, mo = mi_ext[:n_local], reduce_ext(mo_partial)
        elif use_plans:
            h_ext = extend(h)
            e = torch.sigmoid(edge_logits(ep, h, h_ext, masks_e))
            mi_ext, mo_partial = aggregate_pair(
                h_ext, e * shard.edge_mask.to(h_ext.dtype), shard.plans)
            mi, mo = mi_ext[:n_local], reduce_ext(mo_partial)
        else:
            h_ext = extend(h)
            e = torch.sigmoid(edge_logits(ep, h, h_ext, masks_e))
            bo = ops.gather(h_ext, senders) * em
            bi = ops.gather(h if halo else h_ext, recv) * em
            mi = ops.weighted_segment_sum(bo, e, shard.receivers, n_local)
            mo = reduce_ext(ops.weighted_segment_sum(bi, e, senders, n_ext))
        h = mpnn.node_mlp(np_, mi, mo, h, masks_n, act)
        return torch.cat([h, x], dim=-1)

    h = mpnn._input_layer(params, x, act)
    iters = (zip(params["edge_stack"], params["node_stack"]) if unshared
             else [(params["edge"], params["node"])] * cfg.n_iters)
    for ep, np_ in iters:
        h = body(h, ep, np_)
    if head == "node":
        return mpnn._linear(params["output"], h)[..., 0].float()
    out_p = params["output"] if unshared else params["edge"]
    return edge_logits(out_p, h, extend(h), masks_e).float()


def local_shard(pg: PartitionedGraph, rank: int, device,
                axis: int = 0) -> PartitionedGraph:
    """Rank ``rank``'s shard of ``pg`` on ``device``.  ``axis`` is where
    ``pg`` holds its P shards: 0 for one partitioned graph (``x`` is
    ``[P, N_local, F]``), 1 for a stack of them (``[K, P, N_local, F]``,
    from :func:`~gnn_fpga_tpu_torch.train.trainer.stack_batches`, whose
    shard keeps the step axis K), as the JAX package shards
    ``P(None, GRAPH)``; any other ``x`` raises ``ValueError``."""
    if pg.x.dim() != 3 + axis:
        raise ValueError(
            f"local_shard: x of shape {tuple(pg.x.shape)} does not hold "
            f"the shards on axis {axis} (expected {3 + axis} dimensions)")
    return index_fields(pg, rank, axis).to(device)


def sharded_loss(model, shard: PartitionedGraph, comm: Comm, masks=None,
                 exchange: str = "halo", target: str = "edge",
                 pos_weight: float = 1.0, l1: float = 0.0):
    """``(objective, loss)`` of the partitioned step: the masked BCE summed
    and counted over all shards (``loss``, the same on every rank, with
    the L1 term once), and this rank's share of it to backpropagate."""
    logits = sharded_logits(model, shard, comm, masks, exchange, target)
    if target == "node":
        targets, mask = shard.node_y, shard.node_mask
    else:
        targets, mask = shard.y, shard.edge_mask
    s, c = dp.bce_sums(logits, targets, mask, pos_weight)
    objective, loss = dp.global_mean(s, c, comm)
    return dp.add_l1(objective, loss, model, l1, masks, comm)


def graph_comm(mesh) -> Comm:
    """The collectives over ``mesh``'s ``graph`` dimension."""
    return Comm(mesh.get_group(mesh_lib.GRAPH_AXIS))


def make_sharded_forward(mesh, model, masks=None, exchange: str = "halo",
                         head: str = "edge"):
    """``fwd(pg) -> logits [P, E_local]`` (``[P, N_local]`` with
    ``head="node"``): each rank runs :func:`sharded_logits` on its shard of
    the stacked ``pg`` and the shards' logits are gathered, so every rank
    returns all of them."""
    comm = graph_comm(mesh)
    device = mesh_lib.mesh_device(mesh)

    def fwd(pg):
        shard = local_shard(pg, comm.rank, device)
        return comm.all_gather(sharded_logits(model, shard, comm, masks,
                                              exchange, head))

    return fwd


def make_sharded_train_step(optimizer, mesh, model, l1: float = 0.0,
                            masks=None, exchange: str = "halo",
                            target: str = "edge", pos_weight: float = 1.0):
    """``step(pg) -> loss``: one optimizer step of ``model`` on one
    partitioned graph: the masked BCE over all shards, this rank's share
    backpropagated through the exchanges' adjoints, the parameter
    gradients summed over the group, L1 once, the masks re-applied after
    the update.  ``target="node"`` trains the hit classifier on
    ``pg.node_y``."""
    comm = graph_comm(mesh)
    device = mesh_lib.mesh_device(mesh)

    def loss_fn(shard):
        return sharded_loss(model, shard, comm, masks, exchange, target,
                            pos_weight, l1)

    def step(pg):
        return dp.train_step(optimizer, model, loss_fn,
                             local_shard(pg, comm.rank, device), comm, masks)

    return step
