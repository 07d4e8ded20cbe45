"""The Exa.TrkX Interaction Network: an edge classifier with a state on the
edges as well as on the nodes.

Ju et al., "Performance of a geometric deep learning pipeline for HL-LHC
particle tracking", Eur. Phys. J. C 81 (2021) 876 (arXiv:2103.16701);
``InteractionGNN`` of the Tracking-ML-Exa.TrkX code.  With ``mlp`` a stack
of ``mlp_layers`` x (Linear -> LayerNorm -> ReLU) and ``s``/``r`` an
edge's sender and receiver::

    encode:   h = mlp_n0(x),  e = mlp_e0([h[s], h[r]])
    n_iters x (the node and edge networks shared across iterations):
              m[n] = sum_{r(k)==n} e_k + sum_{s(k)==n} e_k
              h <- h + mlp_node([h, m])
              e <- e + mlp_edge([h[s], h[r], e])
    head:     one logit an edge, mlp_head([h[s], h[r], e]) and a last
              Linear to width 1 (no LayerNorm, no activation)

Each MLP is an ``nn.Sequential`` of ``nn.Linear``, ``nn.LayerNorm`` and
``nn.ReLU`` as the reference code's ``make_mlp`` builds it, so the
parameters carry its names (``edge_network.0.weight``, ``.1.weight`` the
LayerNorm's scale, ...).  The forward does not call the Sequentials: every
parameter is cast to the compute dtype once a forward, and an MLP whose
input is ``[h[s], h[r], e]`` takes its first layer in projection form,
``W1 = [Wa | Wb | We]``::

    [h[s], h[r], e] @ W1^T + b = gather_pair(h Wa^T + b, h Wb^T)[k] + e We^T

so the products run on the V node rows and no ``[E, 3H]`` tensor exists.
The gathers and the sum onto both ends are the kernels of
``ops/cuda/spmm.py`` (``gather_pair``, ``edge_sum``; their plain versions
on CPU tensors), which need ``graph.plans``.  Pad edges are not masked:
``core/graph.py``'s padding convention points every pad edge at the first
pad node, so a pad edge's rows reach pad nodes alone.  A graph with pad
edges and no pad node (its pad edges then on node 0) raises; the check
reads the masks on the host, once an eager forward (not while a CUDA graph
is captured).

Under a profiler the forward is the spans ``gnn.ign.encode``, one
``gnn.ign.message`` an iteration, and ``gnn.ign.head``
(:func:`~gnn_fpga_tpu_torch.utils.profiling.span`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gnn_fpga_tpu_torch.core.device import default_device
from gnn_fpga_tpu_torch.core.graph import Graph
from gnn_fpga_tpu_torch.ops.cuda import spmm
from gnn_fpga_tpu_torch.ops.cuda.layer_norm import (layer_norm_relu,
                                                    linear_layer_norm_relu)
from gnn_fpga_tpu_torch.utils.profiling import span

LAYER_NORM_EPS = 1e-5     # nn.LayerNorm's default, as the reference code


@dataclasses.dataclass(frozen=True)
class InteractionGNNConfig:
    input_dim: int = 2
    hidden_dim: int = 128
    n_iters: int = 8
    # Linear -> LayerNorm -> ReLU layers an MLP (the head adds its Linear
    # to width 1)
    mlp_layers: int = 3
    # parameter dtype (f32 master weights)
    dtype: torch.dtype = torch.float32
    # when set, params and features are cast to it for the forward pass;
    # logits return in f32
    compute_dtype: Optional[torch.dtype] = None


def _mlp(in_dim, hidden, n_layers, dtype, device, out_dim=None):
    """``n_layers`` x (Linear -> LayerNorm -> ReLU), then with ``out_dim``
    a Linear to it; parameters uninitialised."""
    mods = []
    for i in range(n_layers):
        mods += [nn.utils.skip_init(nn.Linear, in_dim if i == 0 else hidden,
                                    hidden, dtype=dtype, device=device),
                 nn.utils.skip_init(nn.LayerNorm, hidden, eps=LAYER_NORM_EPS,
                                    dtype=dtype, device=device),
                 nn.ReLU()]
    if out_dim is not None:
        mods.append(nn.utils.skip_init(nn.Linear, hidden, out_dim,
                                       dtype=dtype, device=device))
    return nn.Sequential(*mods)


class InteractionGNN(nn.Module):
    """The Interaction Network; ``forward`` returns edge logits ``[E]``,
    f32.  Parameters go on ``device``,
    the CUDA device when it is None (pass ``device="cpu"`` for the
    CPU)."""

    def __init__(self, cfg: InteractionGNNConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.cfg = cfg
        device = default_device(device)
        h, n, dt = cfg.hidden_dim, cfg.mlp_layers, cfg.dtype
        self.node_encoder = _mlp(cfg.input_dim, h, n, dt, device)
        self.edge_encoder = _mlp(2 * h, h, n, dt, device)
        self.node_network = _mlp(2 * h, h, n, dt, device)
        self.edge_network = _mlp(3 * h, h, n, dt, device)
        self.output_edge_classifier = _mlp(3 * h, h, n, dt, device, out_dim=1)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Each Linear's weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in))
        (``nn.Linear``'s bounds), each LayerNorm's scale 1 and shift 0."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                for p in (m.weight, m.bias):
                    u = torch.rand(p.shape, generator=generator,
                                   dtype=torch.float32)
                    p.copy_(u * (2 * bound) - bound)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(self, graph: Graph, masks=None) -> torch.Tensor:
        return interaction_gnn_logits(self, graph, masks)


def init_interaction_gnn(cfg: InteractionGNNConfig,
                         generator: torch.Generator,
                         device=None) -> InteractionGNN:
    """An InteractionGNN with weights drawn from ``generator``."""
    return InteractionGNN(cfg, generator, device)


def _layers(seq: nn.Sequential, cast) -> tuple:
    """An MLP's parameters in the compute dtype: ``[(weight, bias,
    norm_weight, norm_bias)]`` a hidden layer, and the last Linear's
    ``(weight, bias)`` or None."""
    mods = list(seq)
    hidden = [(cast(lin.weight), cast(lin.bias), cast(ln.weight),
               cast(ln.bias)) for lin, ln in zip(mods[0::3], mods[1::3])]
    out = (cast(mods[-1].weight), cast(mods[-1].bias)) if len(mods) % 3 \
        else None
    return hidden, out


def _run_mlp(layers, x=None, first=None):
    """The hidden layers on ``x``, or with ``first`` given (the first
    Linear's output, its bias added, already computed) from there; then
    the last Linear if the MLP has one.  Each hidden layer is
    :func:`~gnn_fpga_tpu_torch.ops.cuda.layer_norm.linear_layer_norm_relu`
    (on the card the bias-free product and the fused kernels, which add
    the bias and sum its gradient)."""
    hidden, out = layers
    for i, (w, b, g, beta) in enumerate(hidden):
        if i == 0 and first is not None:
            x = layer_norm_relu(first, None, g, beta, LAYER_NORM_EPS)
        else:
            x = linear_layer_norm_relu(x, w, b, g, beta, LAYER_NORM_EPS)
    return x if out is None else F.linear(x, *out)


def _pair_mlp(layers, h, e, pair):
    """An MLP on ``[h[s], h[r], e]`` (``[h[s], h[r]]`` with ``e`` None),
    its first layer in projection form (:func:`pair_first_layer`)."""
    w, b = layers[0][0][:2]
    return _run_mlp(layers, first=pair_first_layer(w, b, h, e, pair))


def pair_first_layer(w, b, h, e, pair):
    """``[h[s], h[r], e] @ w^T + b`` (``[h[s], h[r]]`` with ``e`` None) in
    projection form: ``pair(h Wa^T + b, h Wb^T) + e We^T``, ``w = [Wa |
    Wb | We]``, where ``pair(pa, pb)[k] = pa[s_k] + pb[r_k]``."""
    hd = h.shape[-1]
    y = pair(F.linear(h, w[:, :hd], b), F.linear(h, w[:, hd:2 * hd]))
    return y if e is None else torch.addmm(y, e, w[:, 2 * hd:].t())


def _check_pad_edges(graph: Graph) -> None:
    """Raises unless every pad edge (``edge_mask == 0``) joins two pad
    nodes (``node_mask == 0``): the forward sums every edge's row onto its
    ends unmasked."""
    pad = graph.edge_mask == 0
    real_end = (graph.node_mask[graph.senders.long()] != 0) | (
        graph.node_mask[graph.receivers.long()] != 0)
    if bool((pad & real_end).any()):
        raise ValueError(
            "InteractionGNN: a pad edge ends on a real node; pad the graph "
            "with a pad node for its pad edges (core.graph.pad_graph)")


def interaction_gnn_logits(model: InteractionGNN, graph: Graph,
                           masks=None) -> torch.Tensor:
    """Edge logits ``[E]`` (f32) of one graph ``[V, F]`` with plans
    (several graphs are packed into one: ``core.graph.pack_graphs``).
    Takes no pruning masks."""
    if masks:
        raise ValueError("InteractionGNN takes no pruning masks")
    if graph.x.ndim != 2:
        raise ValueError("expected one graph [V, F]: pack a batch into one "
                         "(gnn_fpga_tpu_torch.core.graph.pack_graphs)")
    if graph.plans is None:
        raise ValueError(
            "InteractionGNN needs graph.plans — attach with "
            "gnn_fpga_tpu_torch.core.graph.attach_plans(graph)")
    cfg = model.cfg
    cd = cfg.compute_dtype
    cast = (lambda t: t) if cd is None else (lambda t: t.to(cd))
    x = cast(graph.x)
    s, r, plans = graph.senders, graph.receivers, graph.plans
    pair = lambda pa, pb: spmm.gather_pair(pa, pb, s, r, plans)
    if (x.device.type != "cuda"
            or not torch.cuda.is_current_stream_capturing()):
        _check_pad_edges(graph)
    node_net = _layers(model.node_network, cast)
    edge_net = _layers(model.edge_network, cast)
    with span("gnn.ign.encode"):
        h = _run_mlp(_layers(model.node_encoder, cast), x)
        e = _pair_mlp(_layers(model.edge_encoder, cast), h, None, pair)
    for _ in range(cfg.n_iters):
        with span("gnn.ign.message"):
            m = spmm.edge_sum(e, s, r, plans)
            h = h + _run_mlp(node_net, torch.cat([h, m], dim=-1))
            e = e + _pair_mlp(edge_net, h, e, pair)
    with span("gnn.ign.head"):
        z = _pair_mlp(_layers(model.output_edge_classifier, cast), h, e,
                      pair)
    return z[:, 0].float()
