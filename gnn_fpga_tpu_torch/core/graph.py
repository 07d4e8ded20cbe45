"""COO hit graphs as PyTorch tensors.

The counterpart of ``gnn_fpga_tpu/core/graph.py``.  A graph is an edge
list: ``senders[e]`` is the node an edge leaves from, ``receivers[e]``
the node it arrives at.  Construction (padding, batching, packing, NPZ
I/O, plan building) runs host-side in numpy, exactly as in the JAX
package, and the result is wrapped as CPU tensors; move a graph to the
card with :meth:`Graph.to`.

Padding convention: padded edges have ``edge_mask == 0`` and point at the
FIRST pad node (``n_real_nodes``), whose features are zero, so masked
gathers reproduce the all-zero rows of zero-padded dense incidence
matrices.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch


def _tensor(a, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype))


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class TensorFields:
    """Methods of the frozen dataclasses that carry tensors (:class:`Graph`
    and the kernels' plans): each applies to every tensor field and
    recurses into fields that are themselves ``TensorFields``; other fields
    (host ints such as ``SortedSegments.n_kept``) are kept as they are."""

    def _map(self, fn):
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, TensorFields)):
                kw[f.name] = fn(v)
        return dataclasses.replace(self, **kw)

    def to(self, device, non_blocking: bool = False):
        """A copy on ``device``; with ``non_blocking`` a copy from pinned
        host memory is asynchronous on the current stream."""
        return self._map(lambda v: v.to(device, non_blocking=non_blocking))

    def pin_memory(self):
        """A copy in page-locked host memory (needs a CUDA device)."""
        return self._map(lambda v: v.pin_memory())

    def tensors(self) -> Iterator[torch.Tensor]:
        """Every tensor, nested fields included."""
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                yield v
            elif isinstance(v, TensorFields):
                yield from v.tensors()


def stack_fields(items, name: str = "batch"):
    """Stack tensors, or :class:`TensorFields` of one structure, along a
    new axis 0 (what ``jax.tree.map(jnp.stack, ...)`` does to pytrees).

    The tensors of a field must agree in shape, dtype and device, a field
    must be None in all items or in none, and host fields (a plan's node,
    edge, item and slot counts) must be equal: anything else raises
    ``ValueError`` naming the field (``name`` and its path).  The stack of
    one item is a view of it."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        if any(not isinstance(t, torch.Tensor) or t.shape != first.shape
               or t.dtype != first.dtype or t.device != first.device
               for t in items):
            raise ValueError(
                f"cannot stack {name}: shapes, dtypes or devices differ: "
                f"{[_describe(t) for t in items]}")
        # a stack of one is a view of it
        return first.unsqueeze(0) if len(items) == 1 else torch.stack(items)
    if any(type(it) is not type(first) for it in items):
        raise ValueError(f"cannot stack {name}: types differ: "
                         f"{[type(it).__name__ for it in items]}")
    kw = {}
    for f in dataclasses.fields(first):
        vals = [getattr(it, f.name) for it in items]
        path = f"{name}.{f.name}"
        held = [isinstance(v, (torch.Tensor, TensorFields)) for v in vals]
        if any(held) and not all(held):
            raise ValueError(f"cannot stack {path}: "
                             f"{[_describe(v) for v in vals]}")
        if held[0]:
            kw[f.name] = stack_fields(vals, path)
        elif any(v != vals[0] for v in vals):
            raise ValueError(f"cannot stack {path}: {vals}")
    return dataclasses.replace(first, **kw)


def _describe(t) -> str:
    if not isinstance(t, torch.Tensor):
        return repr(t)
    return f"{tuple(t.shape)} {t.dtype} {t.device}"


def index_fields(v, k, axis: int = 0):
    """``k`` (an index or a slice) of axis ``axis`` of every tensor of
    ``v`` (a tensor or a :class:`TensorFields`): with the defaults, one
    item of a :func:`stack_fields` stack without its leading axis.  Views,
    no copy."""
    if isinstance(v, torch.Tensor):
        return v[(slice(None),) * axis + (k,)]
    return v._map(lambda t: index_fields(t, k, axis))


@dataclasses.dataclass(frozen=True)
class Graph(TensorFields):
    """A (possibly padded, possibly batched) COO hit graph.

    Per-graph shapes are ``x: [N, F]`` float32, ``senders/receivers: [E]``
    int32, ``y: [E]``, ``node_mask: [N]``, ``edge_mask: [E]``; fields may
    carry one leading batch axis (:func:`batch_graphs`).  ``plans`` holds
    the sorted-edge plans of the CUDA kernels (:func:`attach_plans`, single
    packed graphs only).  ``blocks`` is the :class:`~gnn_fpga_tpu_torch.ops.
    blocked.BlockedPlan` of the ``blocked`` route
    (:func:`~gnn_fpga_tpu_torch.ops.blocked.attach_blocks_layered`), with
    the same leading batch axis as the edge arrays.
    """

    x: torch.Tensor
    senders: torch.Tensor
    receivers: torch.Tensor
    y: torch.Tensor
    node_mask: torch.Tensor
    edge_mask: torch.Tensor
    node_y: Optional[torch.Tensor] = None
    plans: Optional[object] = None
    blocks: Optional[object] = None

    @property
    def n_node(self) -> int:
        return self.x.shape[-2]

    @property
    def n_edge(self) -> int:
        return self.senders.shape[-1]

    @property
    def n_feature(self) -> int:
        return self.x.shape[-1]

    def replace(self, **kw) -> "Graph":
        return dataclasses.replace(self, **kw)


def from_coo(x, senders, receivers, y, node_y=None) -> Graph:
    """Build an unpadded Graph from raw COO arrays (all real, masks = 1)."""
    x = np.asarray(x, dtype=np.float32)
    n_node = x.shape[0]
    n_edge = len(senders)
    return Graph(
        x=_tensor(x, np.float32),
        senders=_tensor(senders, np.int32),
        receivers=_tensor(receivers, np.int32),
        y=_tensor(y, np.float32),
        node_mask=torch.ones(n_node, dtype=torch.float32),
        edge_mask=torch.ones(n_edge, dtype=torch.float32),
        node_y=None if node_y is None else _tensor(node_y, np.float32),
    )


def pad_graph(g: Graph, n_node: int, n_edge: int) -> Graph:
    """Pad a single graph to ``(n_node, n_edge)``.

    Padded edges point at the first pad-node slot (the graph's real node
    count) when one exists, otherwise at node 0; they are masked either
    way.  Pass ``n_node >= g.n_node + 1`` when ``n_edge > g.n_edge`` to keep
    the pad node.
    """
    rn, re = int(g.x.shape[0]), int(g.senders.shape[0])
    if rn > n_node or re > n_edge:
        raise ValueError(
            f"graph ({rn} nodes, {re} edges) exceeds pad target "
            f"({n_node}, {n_edge})")
    pad_node_idx = rn if n_node > rn else 0

    def _pad(a, total, fill=0.0):
        a = _np(a)
        widths = [(0, total - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, widths, constant_values=fill)

    return Graph(
        x=_tensor(_pad(g.x, n_node), np.float32),
        senders=_tensor(_pad(g.senders, n_edge, pad_node_idx), np.int32),
        receivers=_tensor(_pad(g.receivers, n_edge, pad_node_idx), np.int32),
        y=_tensor(_pad(g.y, n_edge), np.float32),
        node_mask=_tensor(_pad(g.node_mask, n_node), np.float32),
        edge_mask=_tensor(_pad(g.edge_mask, n_edge), np.float32),
        node_y=None if g.node_y is None
        else _tensor(_pad(g.node_y, n_node), np.float32),
    )


def batch_graphs(graphs, n_node: Optional[int] = None,
                 n_edge: Optional[int] = None) -> Graph:
    """Pad every graph to one static ``(n_node, n_edge)`` and stack them
    along a leading batch axis (default: the largest graph plus one pad
    node)."""
    if n_node is None:
        n_node = max(int(g.x.shape[0]) for g in graphs) + 1
    if n_edge is None:
        n_edge = max(int(g.senders.shape[0]) for g in graphs)
    padded = [pad_graph(g, n_node, n_edge) for g in graphs]
    has_node_y = all(p.node_y is not None for p in padded)
    return Graph(
        x=torch.stack([p.x for p in padded]),
        senders=torch.stack([p.senders for p in padded]),
        receivers=torch.stack([p.receivers for p in padded]),
        y=torch.stack([p.y for p in padded]),
        node_mask=torch.stack([p.node_mask for p in padded]),
        edge_mask=torch.stack([p.edge_mask for p in padded]),
        node_y=torch.stack([p.node_y for p in padded]) if has_node_y else None,
    )


def pack_graphs(graphs, n_node: Optional[int] = None,
                n_edge: Optional[int] = None) -> Graph:
    """Concatenate graphs into ONE flat packed graph.

    Senders/receivers are offset by each graph's node start, so one
    aggregation covers the whole batch; the inputs' masks are carried.
    With ``n_node``/``n_edge`` the result is padded by :func:`pad_graph`.
    """
    xs, ss, rs, ys, nys, nms, ems = [], [], [], [], [], [], []
    offset = 0
    for g in graphs:
        xs.append(_np(g.x))
        ss.append(_np(g.senders) + offset)
        rs.append(_np(g.receivers) + offset)
        ys.append(_np(g.y))
        nms.append(_np(g.node_mask))
        ems.append(_np(g.edge_mask))
        if g.node_y is not None:
            nys.append(_np(g.node_y))
        offset += int(g.x.shape[0])
    flat = from_coo(
        np.concatenate(xs), np.concatenate(ss), np.concatenate(rs),
        np.concatenate(ys),
        node_y=np.concatenate(nys) if len(nys) == len(graphs) else None)
    flat = flat.replace(node_mask=_tensor(np.concatenate(nms), np.float32),
                        edge_mask=_tensor(np.concatenate(ems), np.float32))
    if n_node is not None or n_edge is not None:
        tot_n = n_node if n_node is not None else int(flat.x.shape[0]) + 1
        tot_e = n_edge if n_edge is not None else int(flat.senders.shape[0])
        flat = pad_graph(flat, tot_n, tot_e)
    return flat


def unbatch_graphs(g: Graph) -> list:
    """Split a batched Graph (leading batch axis) into single graphs.  The
    single graphs carry no ``plans`` or ``blocks``: the blocked route takes
    a batch whole."""
    if g.x.ndim != 3:
        raise ValueError("unbatch_graphs expects a batched Graph [B, N, F]")
    fields = [f.name for f in dataclasses.fields(Graph)
              if f.name not in ("plans", "blocks")]
    return [Graph(**{k: None if getattr(g, k) is None else getattr(g, k)[i]
                     for k in fields})
            for i in range(g.x.shape[0])]


def layer_offsets_from_layers(layers,
                              n_layers: Optional[int] = None) -> np.ndarray:
    """Per-node detector-layer array (ascending, real nodes only) ->
    ``layer_offsets`` ``[n_layers + 1]`` for
    :func:`gnn_fpga_tpu_torch.ops.blocked.attach_blocks_layered`.  Pad
    nodes past the real ones sit outside every layer range."""
    layers = _np(layers)
    if layers.ndim != 1:
        raise ValueError("layers must be a per-node 1-D array")
    if np.any(np.diff(layers) < 0):
        raise ValueError(
            "nodes must be sorted by layer for the blocked path "
            "(prepare CLIs sort hits by layer before graph construction)")
    if n_layers is None:
        n_layers = int(layers.max()) + 1
    off = np.searchsorted(layers, np.arange(n_layers + 1),
                          side="left").astype(np.int64)
    off[-1] = len(layers)
    return off


def attach_plans(g: Graph, per_graph_plans=None, capacity=None) -> Graph:
    """Attach the sorted-edge plans of the CUDA kernels to a single packed
    graph, enabling ``aggregation="pallas"`` in the models; the plans
    follow the graph's device.

    Without ``per_graph_plans`` they are built host-side from the graph's
    edges (:func:`gnn_fpga_tpu_torch.ops.cuda.spmm.build_agg_plans`).
    With them (the plans of the graphs :func:`pack_graphs` packed into
    ``g``, in order, each built once when the dataset is loaded) they are
    composed (:func:`~gnn_fpga_tpu_torch.ops.cuda.spmm.compose_agg_plans`),
    which gives the same plans without sorting the batch's edges again.
    With ``capacity`` (a :class:`~gnn_fpga_tpu_torch.ops.cuda.spmm.
    PlanCapacity`) they are padded to it
    (:func:`~gnn_fpga_tpu_torch.ops.cuda.spmm.pad_plans`), so that every
    batch of a bucket has one static shape and one captured step serves
    them all; plans that exceed it raise ``ValueError``.
    """
    from gnn_fpga_tpu_torch.ops.cuda import spmm

    if g.x.ndim != 2:
        raise ValueError("plans only apply to single packed graphs")
    if per_graph_plans is None:
        plans = spmm.build_agg_plans(_np(g.senders), _np(g.receivers),
                                     g.n_node)
    else:
        nodes = np.array([p.recv.n_node for p in per_graph_plans], np.int64)
        edges = np.array([p.recv.n_edge for p in per_graph_plans], np.int64)
        plans = spmm.compose_agg_plans(
            per_graph_plans, np.cumsum(nodes) - nodes,
            np.cumsum(edges) - edges, g.n_node, g.n_edge)
    if capacity is not None:
        plans = spmm.pad_plans(plans, capacity)
    return g.replace(plans=plans.to(g.x.device))


# ---------------------------------------------------------------------------
# Dense incidence-matrix conversion (the reference's interchange format)
# ---------------------------------------------------------------------------

def to_dense_incidence(g: Graph):
    """``(X, Ri, Ro, y)`` numpy arrays as in the reference's ``Graph``:
    ``Ri[receivers[e], e] = Ro[senders[e], e] = 1``; masked edges give
    all-zero columns."""
    n, e = g.n_node, g.n_edge
    ri = np.zeros((n, e), dtype=np.float32)
    ro = np.zeros((n, e), dtype=np.float32)
    cols = np.arange(e)[_np(g.edge_mask) > 0]
    ri[_np(g.receivers)[cols], cols] = 1
    ro[_np(g.senders)[cols], cols] = 1
    return _np(g.x), ri, ro, _np(g.y)


def from_dense_incidence(x, ri, ro, y, node_y=None) -> Graph:
    """Inverse of :func:`to_dense_incidence`; all-zero columns become
    masked edges."""
    ri, ro = np.asarray(ri), np.asarray(ro)
    g = from_coo(x, np.argmax(ro, axis=0), np.argmax(ri, axis=0), y,
                 node_y=node_y)
    return g.replace(
        edge_mask=_tensor(ri.sum(axis=0) > 0, np.float32) * g.edge_mask)


# ---------------------------------------------------------------------------
# NPZ I/O: file-compatible with the JAX package and the reference's
# SparseGraph archives (keys X, Ri_rows, Ri_cols, Ro_rows, Ro_cols, y)
# ---------------------------------------------------------------------------

def save_npz(g: Graph, filename, **extra) -> None:
    """Write the real (unmasked) part of a graph as a SparseGraph NPZ;
    ``extra`` appends per-graph properties."""
    em = _np(g.edge_mask) > 0
    nm = _np(g.node_mask) > 0
    cols = np.arange(int(em.sum()), dtype=np.int64)
    arrays = dict(
        X=_np(g.x)[nm],
        Ri_rows=_np(g.receivers)[em].astype(np.int64),
        Ri_cols=cols,
        Ro_rows=_np(g.senders)[em].astype(np.int64),
        Ro_cols=cols,
        y=_np(g.y)[em],
    )
    if g.node_y is not None:
        arrays["node_y"] = _np(g.node_y)[nm]
    np.savez(filename, **arrays, **extra)


def load_npz(filename) -> Graph:
    """Load a SparseGraph NPZ; Ri_cols/Ro_cols need not be sorted."""
    with np.load(filename) as f:
        data = {k: f[k] for k in f.files}
    n_edge = len(data["y"])
    receivers = np.zeros(n_edge, dtype=np.int32)
    senders = np.zeros(n_edge, dtype=np.int32)
    receivers[data["Ri_cols"].astype(np.int64)] = data["Ri_rows"].astype(np.int32)
    senders[data["Ro_cols"].astype(np.int64)] = data["Ro_rows"].astype(np.int32)
    return from_coo(data["X"], senders, receivers, data["y"],
                    node_y=data.get("node_y"))


# The keys of a SparseGraph NPZ that load_npz reads; any other key is an
# extra (per-node ``layer``, per-graph pt, eta, ...).
_SPARSE_KEYS = ("X", "Ri_rows", "Ri_cols", "Ro_rows", "Ro_cols", "y",
                "node_y")


def load_npz_with_extras(filename):
    """``(graph, extras)``: :func:`load_npz` and the file's other arrays
    by key."""
    with np.load(filename) as f:
        extras = {k: f[k] for k in f.files if k not in _SPARSE_KEYS}
    return load_npz(filename), extras
