"""The interaction-network models in PyTorch.

The counterpart of ``gnn_fpga_tpu/models/mpnn.py``, with its three heads:

- :class:`SegmentClassifier`, an edge (track-segment) classifier whose
  edge and node networks are shared across ``n_iters`` message-passing
  iterations;
- :class:`SegmentClassifierUnshared`, the same with each iteration's own
  edge and node networks (``nn.ModuleList``s ``edge_stack`` and
  ``node_stack``) and a separate ``output`` edge network;
- :class:`NodeClassifier`, the hit classifier: shared networks and a
  ``d -> 1`` ``output`` layer on the final node table.

Each runs

    input MLP -> [H, X] -> n_iters x (edge net -> node net -> [H, X])
    -> head (final edge net, or the node layer)

on a COO :class:`~gnn_fpga_tpu_torch.core.graph.Graph`, single or batched
(leading batch axis, as the JAX package ``vmap``s its forward).

An edge network stores its first layer ``[2D, H]`` as the sender and
receiver halves ``pa``/``pb`` (``cat([h[s], h[r]]) @ W1 == (h @ W1a)[s] +
(h @ W1b)[r]``) plus the bias ``b1``.  Pruning masks are a dict shaped
like the submodules (``{"edge": {"pa", "pb", "l2"}, "node": {"l1", "l2"}}``,
each ``[out, in]``) and are applied as ``w * mask`` inside each matmul.

Routes follow the JAX package's ``aggregation`` selection exactly:
``"blocked"`` (per-layer-pair one-hot matmuls, ``ops/blocked.py``, needs
``graph.blocks``), ``"dense"`` (one-hot incidence matmuls,
``ops/dense_incidence.py``), ``"pallas"`` (the fused CUDA kernels of
``ops/cuda/spmm.py``, forward and backward, which need ``graph.plans``)
and ``"sparse"`` (gather / segment-sum).  The blocked and dense routes
take a batch whole, folded into the batch of their matmuls; the sparse and
pallas routes score a batch graph by graph.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from gnn_fpga_tpu_torch.core.device import default_device
from gnn_fpga_tpu_torch.core.graph import Graph, unbatch_graphs
from gnn_fpga_tpu_torch.ops import blocked as blk
from gnn_fpga_tpu_torch.ops import dense_incidence as dinc
from gnn_fpga_tpu_torch.ops import segment as ops

Masks = Optional[dict]   # {"edge": {...}, "node": {...}} of [out, in] masks


@dataclasses.dataclass(frozen=True)
class SegmentClassifierConfig:
    input_dim: int = 3
    hidden_dim: int = 8
    n_iters: int = 3
    # activation of every hidden layer (reference default: tanh)
    activation: Callable = torch.tanh
    # parameter dtype (f32 master weights)
    dtype: torch.dtype = torch.float32
    # when set, params and features are cast to it for the forward pass;
    # logits return in f32
    compute_dtype: Optional[torch.dtype] = None
    # "sparse" | "dense" | "blocked" | "pallas" | "auto" (blocked if
    # graph.blocks, else pallas if graph.plans, else dense iff one graph's
    # n_node * n_edge is at most _DENSE_AUTO_LIMIT, else sparse)
    aggregation: str = "auto"
    # on the pallas route with tanh: one fused kernel per iteration
    # (ops.cuda.spmm.iteration_pair); False runs the edge MLP in PyTorch
    # and aggregates with ops.cuda.spmm.aggregate_pair
    fused_iteration: bool = True
    # recompute each message-passing iteration in the backward pass
    # (torch.utils.checkpoint) instead of keeping its activations
    remat: bool = False


@dataclasses.dataclass(frozen=True)
class NodeClassifierConfig:
    """The hit classifier's settings; the fields mean what they mean in
    :class:`SegmentClassifierConfig`."""
    input_dim: int = 4
    hidden_dim: int = 8
    n_iters: int = 1
    activation: Callable = torch.tanh
    dtype: torch.dtype = torch.float32
    aggregation: str = "auto"
    compute_dtype: Optional[torch.dtype] = None
    remat: bool = False
    fused_iteration: bool = True


# ---------------------------------------------------------------------------
# Modules and initialisation
# ---------------------------------------------------------------------------

def _weight(out_dim, in_dim, dtype, device):
    return nn.Parameter(torch.empty(out_dim, in_dim, dtype=dtype, device=device))


def _bias(dim, dtype, device):
    return nn.Parameter(torch.empty(dim, dtype=dtype, device=device))


class _Linear(nn.Module):
    """``y = x @ weight.T + bias`` with uninitialised parameters (filled by
    :meth:`SegmentClassifier.reset_parameters` or the JAX loader)."""

    def __init__(self, in_dim, out_dim, dtype, device, bias=True):
        super().__init__()
        self.weight = _weight(out_dim, in_dim, dtype, device)
        self.bias = _bias(out_dim, dtype, device) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class EdgeNetwork(nn.Module):
    """Two-layer edge MLP ``2D -> H -> 1`` with its first layer split into
    sender (``pa``) and receiver (``pb``) halves."""

    def __init__(self, input_dim, hidden_dim, dtype, device):
        super().__init__()
        self.pa = _Linear(input_dim, hidden_dim, dtype, device, bias=False)
        self.pb = _Linear(input_dim, hidden_dim, dtype, device, bias=False)
        self.b1 = _bias(hidden_dim, dtype, device)
        self.l2 = _Linear(hidden_dim, 1, dtype, device)


class NodeNetwork(nn.Module):
    """Two-layer node MLP ``3D -> H -> H``."""

    def __init__(self, input_dim, output_dim, dtype, device):
        super().__init__()
        self.l1 = _Linear(3 * input_dim, output_dim, dtype, device)
        self.l2 = _Linear(output_dim, output_dim, dtype, device)


def _fan_ins(module: nn.Module) -> dict:
    """Parameter name -> fan-in: a layer's input width, and for an edge
    network's split first layer (``pa``, ``pb``, ``b1``) that of the whole
    ``[2D, H]``."""
    fan_in = {}
    for name, m in module.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, EdgeNetwork):
            for p in ("pa.weight", "pb.weight", "b1"):
                fan_in[pre + p] = 2 * m.pa.weight.shape[1]
        elif isinstance(m, _Linear):
            for p, _ in m.named_parameters():
                fan_in.setdefault(pre + p, m.weight.shape[1])
    return fan_in


class _Model(nn.Module):
    """What the three heads share: the input layer and the initialisation.
    Each head's parameters go on ``device``, the CUDA device when it is
    None (:func:`~gnn_fpga_tpu_torch.core.device.default_device`: with no
    card that raises; pass ``device="cpu"`` for the CPU)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for every weight and bias,
        the PyTorch 0.4 ``nn.Linear`` default the JAX package keeps.  The
        split first edge layer uses the fan-in of the whole ``[2D, H]``."""
        fan_in = _fan_ins(self)
        for name, p in self.named_parameters():
            bound = 1.0 / math.sqrt(fan_in[name])
            u = torch.rand(p.shape, generator=generator, dtype=torch.float32)
            p.copy_(u * (2 * bound) - bound)


class SegmentClassifier(_Model):
    """Shared-weight SegmentClassifier; ``forward`` returns edge logits."""

    def __init__(self, cfg: SegmentClassifierConfig,
                 generator: torch.Generator, device=None):
        super().__init__(cfg)
        device = default_device(device)
        d = cfg.input_dim + cfg.hidden_dim
        self.input = _Linear(cfg.input_dim, cfg.hidden_dim, cfg.dtype, device)
        self.edge = EdgeNetwork(d, cfg.hidden_dim, cfg.dtype, device)
        self.node = NodeNetwork(d, cfg.hidden_dim, cfg.dtype, device)
        self.reset_parameters(generator)

    def forward(self, graph: Graph, masks: Masks = None) -> torch.Tensor:
        return segment_classifier_logits(self, graph, masks)


class SegmentClassifierUnshared(_Model):
    """SegmentClassifier with per-iteration weights
    (``MPNN_Seg_Toy2D.ipynb:cell14``): ``edge_stack[i]`` and
    ``node_stack[i]`` run iteration ``i``, the ``output`` edge network
    scores the edges; ``forward`` returns edge logits.  Takes no pruning
    masks."""

    def __init__(self, cfg: SegmentClassifierConfig,
                 generator: torch.Generator, device=None):
        super().__init__(cfg)
        device = default_device(device)
        d = cfg.input_dim + cfg.hidden_dim
        h = cfg.hidden_dim
        self.input = _Linear(cfg.input_dim, h, cfg.dtype, device)
        self.edge_stack = nn.ModuleList(
            EdgeNetwork(d, h, cfg.dtype, device) for _ in range(cfg.n_iters))
        self.node_stack = nn.ModuleList(
            NodeNetwork(d, h, cfg.dtype, device) for _ in range(cfg.n_iters))
        self.output = EdgeNetwork(d, h, cfg.dtype, device)
        self.reset_parameters(generator)

    def forward(self, graph: Graph, masks: Masks = None) -> torch.Tensor:
        return segment_classifier_unshared_logits(self, graph, masks)


class NodeClassifier(_Model):
    """Shared-weight interaction network with a per-node head
    (``MPNN_HitClassifier.ipynb:cell21``): ``forward`` returns node
    logits ``[V]`` (``[B, V]`` for a batched graph)."""

    def __init__(self, cfg: NodeClassifierConfig,
                 generator: torch.Generator, device=None):
        super().__init__(cfg)
        device = default_device(device)
        d = cfg.input_dim + cfg.hidden_dim
        self.input = _Linear(cfg.input_dim, cfg.hidden_dim, cfg.dtype, device)
        self.edge = EdgeNetwork(d, cfg.hidden_dim, cfg.dtype, device)
        self.node = NodeNetwork(d, cfg.hidden_dim, cfg.dtype, device)
        self.output = _Linear(d, 1, cfg.dtype, device)
        self.reset_parameters(generator)

    def forward(self, graph: Graph, masks: Masks = None) -> torch.Tensor:
        return node_classifier_logits(self, graph, masks)


def init_segment_classifier(cfg: SegmentClassifierConfig,
                            generator: torch.Generator,
                            device=None) -> SegmentClassifier:
    """A SegmentClassifier with weights drawn from ``generator``."""
    return SegmentClassifier(cfg, generator, device)


def init_segment_classifier_unshared(cfg: SegmentClassifierConfig,
                                     generator: torch.Generator,
                                     device=None) -> SegmentClassifierUnshared:
    """A SegmentClassifierUnshared with weights drawn from ``generator``."""
    return SegmentClassifierUnshared(cfg, generator, device)


def init_node_classifier(cfg: NodeClassifierConfig,
                         generator: torch.Generator,
                         device=None) -> NodeClassifier:
    """A NodeClassifier with weights drawn from ``generator``."""
    return NodeClassifier(cfg, generator, device)


def count_params(model: nn.Module) -> int:
    """Total parameter count."""
    return sum(p.numel() for p in model.parameters())


def _params_of(module: nn.Module, cast) -> object:
    """A module's parameters as the nested dict (lists for
    ``nn.ModuleList``s) the route functions read: ``{"w", "b"}`` for a
    layer, the module's own parameters by name, its children by name."""
    if isinstance(module, _Linear):
        return {"w": cast(module.weight),
                "b": None if module.bias is None else cast(module.bias)}
    if isinstance(module, nn.ModuleList):
        return [_params_of(m, cast) for m in module]
    out = {k: _params_of(m, cast) for k, m in module.named_children()}
    out.update((k, cast(p)) for k, p in module.named_parameters(recurse=False))
    return out


def _cast_for_compute(model: nn.Module, x, compute_dtype) -> tuple:
    """The model's parameters as a nested dict (:func:`_params_of`), cast
    (with ``x``) to ``compute_dtype`` when it is set."""
    c = (lambda t: t) if compute_dtype is None else (
        lambda t: t.to(compute_dtype))
    return _params_of(model, c), c(x)


def _masked(p, mask):
    # The {0, 1} mask is cast to the weight's dtype, which is exact, so a
    # masked layer runs in the compute dtype; the JAX package instead
    # promotes bf16 weights to f32 under an f32 mask (ROADMAP Queue 3,
    # tests/test_torch_heads.py measures the gap).
    w = p["w"]
    return w if mask is None else w * mask.to(w.dtype)


def _linear(p, x, mask=None):
    return F.linear(x, _masked(p, mask), p["b"])


def _mask(masks, name):
    return None if masks is None else masks.get(name)


# ---------------------------------------------------------------------------
# Edge / node networks
# ---------------------------------------------------------------------------

def _edge_mlp(params, b, masks: Masks, activation):
    """The edge MLP on endpoint features ``b = [bo, bi]``: Linear -> act ->
    Linear."""
    w1 = torch.cat([_masked(params["pa"], _mask(masks, "pa")),
                    _masked(params["pb"], _mask(masks, "pb"))], dim=1)
    z = activation(F.linear(b, w1, params["b1"]))
    return _linear(params["l2"], z, _mask(masks, "l2"))[..., 0]


def edge_network_logits(params, h, graph: Graph, masks: Masks = None,
                        activation=torch.tanh):
    """Edge logits from ``[h[senders], h[receivers]]`` -> Linear -> act ->
    Linear (masked edges' inputs are zero)."""
    b = ops.edge_concat(h, graph.senders, graph.receivers, graph.edge_mask)
    return _edge_mlp(params, b, masks, activation)


def _dense_edge_logits(params, bo, bi, masks: Masks, activation):
    """The edge MLP on the endpoint features of the dense and blocked
    routes."""
    return _edge_mlp(params, torch.cat([bo, bi], dim=-1), masks, activation)


def edge_network_logits_proj(params, h, graph: Graph, masks: Masks = None,
                             activation=torch.tanh):
    """:func:`edge_network_logits` in projection form: the first layer is
    applied to the node table before the gather,
    ``(h @ W1a)[s] + (h @ W1b)[r]``, so no ``[E, 2D]`` tensor exists.  With
    ``graph.plans`` the gather pair runs through
    :func:`~gnn_fpga_tpu_torch.ops.cuda.spmm.gather_pair`, whose backward
    is a kernel."""
    pa = F.linear(h, _masked(params["pa"], _mask(masks, "pa")))
    pb = F.linear(h, _masked(params["pb"], _mask(masks, "pb")))
    em = graph.edge_mask.to(h.dtype)[:, None]
    if graph.plans is not None:
        from gnn_fpga_tpu_torch.ops.cuda.spmm import gather_pair
        pre = gather_pair(pa, pb, graph.senders, graph.receivers,
                          graph.plans) * em
    else:
        pre = (ops.gather(pa, graph.senders)
               + ops.gather(pb, graph.receivers)) * em
    z = activation(pre + params["b1"])
    return _linear(params["l2"], z, _mask(masks, "l2"))[..., 0]


def node_mlp(params, mi, mo, h, masks: Masks = None, activation=torch.tanh):
    """The node MLP on precomputed aggregations: ``[mi, mo, h]`` -> Linear
    -> act -> Linear -> act."""
    m = torch.cat([mi, mo, h], dim=-1)
    z = activation(_linear(params["l1"], m, _mask(masks, "l1")))
    return activation(_linear(params["l2"], z, _mask(masks, "l2")))


def node_network(params, h, e, graph: Graph, masks: Masks = None,
                 activation=torch.tanh, use_pallas: bool = False):
    """New node features from the edge-weighted aggregations
    ``mi[n] = sum_{recv==n} e * h[send]`` and
    ``mo[n] = sum_{send==n} e * h[recv]``; with ``use_pallas`` both run in
    one :func:`~gnn_fpga_tpu_torch.ops.cuda.spmm.aggregate_pair` launch."""
    n = h.shape[0]
    em = graph.edge_mask.to(h.dtype)
    if use_pallas:
        from gnn_fpga_tpu_torch.ops.cuda.spmm import aggregate_pair
        mi, mo = aggregate_pair(h, e * em, graph.plans)
    else:
        bo = ops.gather(h, graph.senders) * em[:, None]
        bi = ops.gather(h, graph.receivers) * em[:, None]
        mi = ops.weighted_segment_sum(bo, e, graph.receivers, n)
        mo = ops.weighted_segment_sum(bi, e, graph.senders, n)
    return node_mlp(params, mi, mo, h, masks, activation)


def _fused_iter_body(graph: Graph, x, act, masks_e, masks_n):
    """One message-passing iteration whose edge scoring and both
    aggregations run as one
    :func:`~gnn_fpga_tpu_torch.ops.cuda.spmm.iteration_pair` kernel
    (needs ``graph.plans`` and tanh).  Returns ``body(h, ep, np_)``."""
    from gnn_fpga_tpu_torch.ops.cuda.spmm import (iteration_pair,
                                                  sort_edge_weights)
    em_sorted = sort_edge_weights(graph.edge_mask, graph.plans.recv)

    def body(h, ep, np_):
        pa = F.linear(h, _masked(ep["pa"], _mask(masks_e, "pa")))
        pb = F.linear(h, _masked(ep["pb"], _mask(masks_e, "pb")))
        w2 = _masked(ep["l2"], _mask(masks_e, "l2"))[0]
        mi, mo = iteration_pair(pa, pb, h, em_sorted, w2, ep["b1"],
                                ep["l2"]["b"], graph.plans)
        h = node_mlp(np_, mi, mo, h, masks_n, act)
        return torch.cat([h, x], dim=-1)

    return body


def _unfused_iter_body(graph: Graph, x, act, masks_e, masks_n, use_pallas):
    """One message-passing iteration as separate edge and node networks
    (``aggregate_pair`` kernel with ``use_pallas``).  Returns
    ``body(h, ep, np_)``."""
    edge_logits = edge_network_logits_proj if use_pallas else edge_network_logits

    def body(h, ep, np_):
        e = torch.sigmoid(edge_logits(ep, h, graph, masks_e, act))
        h = node_network(np_, h, e, graph, masks_n, act, use_pallas=use_pallas)
        return torch.cat([h, x], dim=-1)

    return body


# ---------------------------------------------------------------------------
# Routing (the JAX package's _use_dense / _use_pallas / _use_blocked)
# ---------------------------------------------------------------------------

# The JAX package routes graphs with n_node * n_edge at or below this to
# its dense one-hot incidence route under aggregation="auto".
_DENSE_AUTO_LIMIT = 8_000_000


def _use_dense(cfg, graph: Graph) -> bool:
    if cfg.aggregation == "dense":
        return True
    if cfg.aggregation in ("sparse", "pallas"):
        return False
    if cfg.aggregation == "auto" and graph.plans is not None:
        return False
    if graph.x.shape[-2] * graph.senders.shape[-1] <= _DENSE_AUTO_LIMIT:
        return True
    warnings.warn(
        f"aggregation='auto' on a graph with n_node*n_edge = "
        f"{graph.x.shape[-2] * graph.senders.shape[-1]:,} > "
        f"{_DENSE_AUTO_LIMIT:,} and no plans attached: taking the slow "
        "gather/segment-sum route.  Attach plans "
        "(core.graph.attach_plans) for the fused CUDA kernels.",
        stacklevel=3)
    return False


def _use_pallas(cfg, graph: Graph) -> bool:
    if cfg.aggregation == "pallas":
        if graph.plans is None:
            raise ValueError(
                "aggregation='pallas' needs graph.plans — attach with "
                "gnn_fpga_tpu_torch.core.graph.attach_plans(graph)")
        return True
    return cfg.aggregation == "auto" and graph.plans is not None


def _use_blocked(cfg, graph: Graph) -> bool:
    if cfg.aggregation == "blocked":
        if graph.blocks is None:
            raise ValueError("aggregation='blocked' needs graph.blocks")
        return True
    return cfg.aggregation == "auto" and graph.blocks is not None


# ---------------------------------------------------------------------------
# Dense and blocked routes (one-hot matmuls; a batch runs whole)
# ---------------------------------------------------------------------------

def _input_layer(params, x, act):
    return torch.cat([act(_linear(params["input"], x)), x], dim=-1)


def _dense_prelude(model, graph: Graph, cfg, act):
    """Cast parameters and features, build the incidence matrices in the
    compute dtype, run the input MLP."""
    n_node = graph.x.shape[-2]
    params, x = _cast_for_compute(model, graph.x, cfg.compute_dtype)
    ri = dinc.incidence(graph.receivers, n_node, graph.edge_mask, x.dtype)
    ro = dinc.incidence(graph.senders, n_node, graph.edge_mask, x.dtype)
    return params, x, ri, ro, _input_layer(params, x, act)


def _dense_mp_body(ri, ro, x, masks_e, masks_n, act):
    """One message-passing iteration with one-hot incidence matmuls; the
    endpoint features ``bo``/``bi`` feed both the edge scorer and the
    aggregation.  Returns ``body(h, ep, np_)``."""

    def body(h, ep, np_):
        bo = dinc.gather_bmm(ro, h)
        bi = dinc.gather_bmm(ri, h)
        e = torch.sigmoid(_dense_edge_logits(ep, bo, bi, masks_e, act))
        mi = dinc.scatter_bmm(ri, bo, e)
        mo = dinc.scatter_bmm(ro, bi, e)
        return torch.cat([node_mlp(np_, mi, mo, h, masks_n, act), x], dim=-1)

    return body


def _dense_mp_logits(model, graph: Graph, cfg, masks_e, masks_n, act, iters,
                     head):
    """Forward on the dense incidence route: the iterations over
    ``iters(params)``, then ``head(params, h, edge_logits)``."""
    params, x, ri, ro, h = _dense_prelude(model, graph, cfg, act)
    body = _dense_mp_body(ri, ro, x, masks_e, masks_n, act)
    for ep, np_ in iters(params):
        h = body(h, ep, np_)
    edge_logits = lambda p, m: _dense_edge_logits(
        p, dinc.gather_bmm(ro, h), dinc.gather_bmm(ri, h), m, act)
    return head(params, h, edge_logits).float()


def _blocked_prelude(model, graph: Graph, cfg, act):
    """Cast parameters and features, build the block broadcast matrix and
    the local incidence one-hots in the compute dtype, run the input MLP."""
    plan = graph.blocks
    params, x = _cast_for_compute(model, graph.x, cfg.compute_dtype)
    g = blk.broadcast_matrix(plan, graph.x.shape[-2], x.dtype)
    ri, ro = blk.local_incidence(plan, graph.edge_mask, x.dtype)
    return params, x, g, ri, ro, plan.n_blocks, _input_layer(params, x, act)


def _blocked_mp_body(g, ri, ro, x, masks_e, masks_n, act, n_blocks):
    """One message-passing iteration in block layout: the dense body's
    contraction restricted to the incidence's non-zero blocks.  Returns
    ``body(h, ep, np_)``."""

    def body(h, ep, np_):
        hb = blk.gather_blocks(g, h, n_blocks)
        bo = blk.gather_bmm(ro, hb)
        bi = blk.gather_bmm(ri, hb)
        e = torch.sigmoid(_dense_edge_logits(ep, bo, bi, masks_e, act))
        mi = blk.reduce_blocks(g, blk.scatter_bmm(ri, bo, e))
        mo = blk.reduce_blocks(g, blk.scatter_bmm(ro, bi, e))
        return torch.cat([node_mlp(np_, mi, mo, h, masks_n, act), x], dim=-1)

    return body


def _blocked_mp_logits(model, graph: Graph, cfg, masks_e, masks_n, act,
                       iters, head):
    """Forward on the blocked route, as :func:`_dense_mp_logits`.  Edge
    logits come out in block order, which is the graph's edge order after
    :func:`~gnn_fpga_tpu_torch.ops.blocked.attach_blocks_layered`; the
    node table ``h`` stays global, so a node head reads it as it is."""
    params, x, g, ri, ro, nb, h = _blocked_prelude(model, graph, cfg, act)
    body = _blocked_mp_body(g, ri, ro, x, masks_e, masks_n, act, nb)
    for ep, np_ in iters(params):
        h = body(h, ep, np_)

    def edge_logits(p, m):
        hb = blk.gather_blocks(g, h, nb)
        return _dense_edge_logits(p, blk.gather_bmm(ro, hb),
                                  blk.gather_bmm(ri, hb), m, act).flatten(-2)

    return head(params, h, edge_logits).float()


def _sparse_mp_logits(model, graph: Graph, cfg, masks_e, masks_n, act, iters,
                      head, remat):
    """Forward of a single graph on the pallas route (fused iterations
    with tanh and ``cfg.fused_iteration``, else ``gather_pair`` and
    ``aggregate_pair``) or the sparse route, as :func:`_dense_mp_logits`;
    with ``remat`` each iteration is recomputed in the backward pass."""
    use_pallas = _use_pallas(cfg, graph)
    edge_net = edge_network_logits_proj if use_pallas else edge_network_logits
    params, x = _cast_for_compute(model, graph.x, cfg.compute_dtype)
    h = _input_layer(params, x, act)
    if use_pallas and cfg.fused_iteration and act is torch.tanh:
        body = _fused_iter_body(graph, x, act, masks_e, masks_n)
    else:
        body = _unfused_iter_body(graph, x, act, masks_e, masks_n, use_pallas)
    for ep, np_ in iters(params):
        if remat and torch.is_grad_enabled():
            h = checkpoint(body, h, ep, np_, use_reentrant=False)
        else:
            h = body(h, ep, np_)
    edge_logits = lambda p, m: edge_net(p, h, graph, m, act)
    return head(params, h, edge_logits).float()


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _logits(model, graph: Graph, masks: Masks, iters, head, remat: bool):
    """Logits (f32) on the route that ``model.cfg.aggregation`` selects for
    ``graph``, in the JAX package's order: blocked, dense, pallas, sparse.
    ``iters(params)`` gives each iteration's ``(edge, node)`` parameters;
    ``head(params, h, edge_logits)`` turns the final node table into
    logits, where ``edge_logits(edge_params, edge_masks)`` scores the
    edges on the route taken."""
    cfg = model.cfg
    act = cfg.activation
    masks_e = _mask(masks, "edge")
    masks_n = _mask(masks, "node")
    if graph.x.ndim not in (2, 3):
        raise ValueError("expected a graph [V, F] or a batch [B, V, F]")
    if _use_blocked(cfg, graph):
        return _blocked_mp_logits(model, graph, cfg, masks_e, masks_n, act,
                                  iters, head)
    if _use_dense(cfg, graph):
        return _dense_mp_logits(model, graph, cfg, masks_e, masks_n, act,
                                iters, head)
    if graph.x.ndim == 3:
        return torch.stack([_logits(model, g, masks, iters, head, remat)
                            for g in unbatch_graphs(graph)])
    return _sparse_mp_logits(model, graph, cfg, masks_e, masks_n, act, iters,
                             head, remat)


def _shared_iters(cfg):
    """The iterations of a shared-weight model: ``n_iters`` times the
    ``edge`` and ``node`` networks."""
    return lambda params: [(params["edge"], params["node"])] * cfg.n_iters


def segment_classifier_logits(model: SegmentClassifier, graph: Graph,
                              masks: Masks = None) -> torch.Tensor:
    """Final edge logits (f32), ``[E]`` for a single graph and ``[B, E]``
    for a batched one, on the route that ``model.cfg.aggregation`` selects
    for it (in the JAX package's order: blocked, dense, pallas, sparse)."""
    masks_e = _mask(masks, "edge")
    return _logits(model, graph, masks, _shared_iters(model.cfg),
                   lambda params, h, edge_logits: edge_logits(params["edge"],
                                                              masks_e),
                   model.cfg.remat)


def segment_classifier(model: SegmentClassifier, graph: Graph,
                       masks: Masks = None) -> torch.Tensor:
    """Edge probabilities: the sigmoid of the logits."""
    return torch.sigmoid(segment_classifier_logits(model, graph, masks))


def segment_classifier_unshared_logits(model: SegmentClassifierUnshared,
                                       graph: Graph,
                                       masks: Masks = None) -> torch.Tensor:
    """Edge logits of the unshared head, routed as
    :func:`segment_classifier_logits`: iteration ``i`` runs
    ``edge_stack[i]``/``node_stack[i]`` and the ``output`` edge network
    scores the edges (on the pallas route through ``gather_pair``).  The
    JAX package accepts masks here and drops them, which would keep
    pruned weights training; the port raises instead.  As in the JAX
    package, ``cfg.remat`` is not applied."""
    if masks:          # an empty dict, magnitude_masks' own, masks nothing
        raise ValueError("SegmentClassifierUnshared takes no pruning masks")
    return _logits(model, graph, None,
                   lambda params: zip(params["edge_stack"],
                                      params["node_stack"]),
                   lambda params, h, edge_logits: edge_logits(
                       params["output"], None),
                   False)


def segment_classifier_unshared(model: SegmentClassifierUnshared,
                                graph: Graph,
                                masks: Masks = None) -> torch.Tensor:
    """Edge probabilities of the unshared head."""
    return torch.sigmoid(segment_classifier_unshared_logits(model, graph,
                                                            masks))


def node_classifier_logits(model: NodeClassifier, graph: Graph,
                           masks: Masks = None) -> torch.Tensor:
    """Node logits (f32), ``[V]`` for a single graph and ``[B, V]`` for a
    batched one: the shared iterations on the route
    :func:`segment_classifier_logits` would take, then the ``output``
    layer on the final node table (unmasked)."""
    return _logits(model, graph, masks, _shared_iters(model.cfg),
                   lambda params, h, _: _linear(params["output"], h)[..., 0],
                   model.cfg.remat)


def node_classifier(model: NodeClassifier, graph: Graph,
                    masks: Masks = None) -> torch.Tensor:
    """Node probabilities: the sigmoid of the logits."""
    return torch.sigmoid(node_classifier_logits(model, graph, masks))


def segment_classifier_intermediates(model: SegmentClassifier, graph: Graph,
                                     masks: Masks = None):
    """Forward of a single graph on the sparse route, in the parameters'
    dtype, that also returns each iteration's activations:
    ``(probabilities, es, hs)`` with the ``n_iters`` edge scores ``[E]`` and
    the ``n_iters + 1`` node tables ``[V, H + F]``."""
    act = model.cfg.activation
    masks_e = _mask(masks, "edge")
    masks_n = _mask(masks, "node")
    params, x = _cast_for_compute(model, graph.x, None)
    h = _input_layer(params, x, act)
    es, hs = [], [h]
    for _ in range(model.cfg.n_iters):
        e = torch.sigmoid(edge_network_logits(params["edge"], h, graph,
                                              masks_e, act))
        h = torch.cat([node_network(params["node"], h, e, graph, masks_n,
                                    act), x], dim=-1)
        es.append(e)
        hs.append(h)
    logits = edge_network_logits(params["edge"], h, graph, masks_e, act)
    return torch.sigmoid(logits), es, hs
