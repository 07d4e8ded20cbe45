"""The Exa.TrkX Interaction Network (Ju et al., EPJC 81 (2021) 876,
arXiv:2103.16701; ``InteractionGNN`` in Tracking-ML-Exa.TrkX): node and
edge states of width ``H``, encoded, updated ``n_iters`` times by shared
residual networks, then one logit an edge.  With ``mlp`` a stack of
``mlp_layers`` x (Linear -> LayerNorm -> ReLU) and ``s``/``r`` an edge's
sender and receiver:

    h = mlp_n0(x),  e = mlp_e0([h[s], h[r]])
    n_iters x:  m[n] = sum_{r == n} e + sum_{s == n} e
                h = h + mlp_node([h, m])
                e = e + mlp_edge([h[s], h[r], e])
    head:       mlp_head([h[s], h[r], e]), then a Linear to width 1

on one graph given as plain arrays (sector graphs concatenated, every edge
real, :meth:`port_bench.gen.Event.packed`): the concatenations are made
whole and the sums are ``index_add``.  Parameters are named as the
reference code's ``make_mlp`` Sequentials name them: in each MLP, Linear
``3i``, LayerNorm ``3i + 1``, and the head's last Linear ``3L``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

EPS = 1e-5    # nn.LayerNorm's default
# (name, input width in units of H, or None for the input features)
MLPS = (("node_encoder", None), ("edge_encoder", 2), ("node_network", 2),
        ("edge_network", 3), ("output_edge_classifier", 3))


def leaves(cfg: dict) -> list:
    """Linear weights ``[out, in]`` and biases with the Linear's fan-in;
    LayerNorm scales and shifts ``[H]`` with fan-in 1 (drawn as every
    leaf is, from U(-1, 1))."""
    h, n = cfg["hidden_dim"], cfg["mlp_layers"]
    out = []
    for name, width in MLPS:
        fan = cfg["input_dim"] if width is None else width * h
        for i in range(n):
            lin, ln = f"{name}.{3 * i}", f"{name}.{3 * i + 1}"
            out += [(lin + ".weight", (h, fan), fan), (lin + ".bias", (h,), fan),
                    (ln + ".weight", (h,), 1), (ln + ".bias", (h,), 1)]
            fan = h
    last = f"output_edge_classifier.{3 * n}"
    return out + [(last + ".weight", (1, h), h), (last + ".bias", (1,), h)]


def logits(w: dict, g: dict, cfg: dict, r: Callable):
    """Edge logits ``[E]``, float32; ``r`` rounds what a lower precision
    would."""
    n_layers = cfg["mlp_layers"]
    lin = lambda t, name: r(t @ r(w[name + ".weight"]).T
                            + r(w[name + ".bias"]))

    def mlp(name, t):
        for i in range(n_layers):
            t = lin(t, f"{name}.{3 * i}")
            ln = f"{name}.{3 * i + 1}"
            t = r(F.layer_norm(t, t.shape[-1:], r(w[ln + ".weight"]),
                               r(w[ln + ".bias"]), EPS))
            t = torch.relu(t)
        return t

    s, rcv = g["senders"], g["receivers"]
    h = mlp("node_encoder", r(g["x"]))
    e = mlp("edge_encoder", torch.cat([h[s], h[rcv]], dim=1))
    for _ in range(cfg["n_iters"]):
        m = r(torch.zeros_like(h).index_add(0, rcv, e).index_add(0, s, e))
        h = r(h + mlp("node_network", torch.cat([h, m], dim=1)))
        e = r(e + mlp("edge_network", torch.cat([h[s], h[rcv], e], dim=1)))
    z = mlp("output_edge_classifier", torch.cat([h[s], h[rcv], e], dim=1))
    return lin(z, f"output_edge_classifier.{3 * n_layers}")[:, 0].float()


def forward_flops(cfg: dict, n_node: float, n_edge: float) -> float:
    """Useful forward FLOPs on ``n_node`` and ``n_edge`` REAL nodes and
    edges, 2 a multiply-add, with the published ``[E, 2H]`` and ``[E, 3H]``
    first layers (not the projection form the program runs), and 2 E H for
    the sum onto both ends; LayerNorm, ReLU and the residual adds count
    as bytes:

        2V(FH + (L-1)H^2) + 2E(2H^2 + (L-1)H^2)
        + n_iters [2V(2H^2 + (L-1)H^2) + 2E(3H^2 + (L-1)H^2) + 2EH]
        + 2E(3H^2 + (L-1)H^2 + H)
    """
    v, e = float(n_node), float(n_edge)
    h, f, n = cfg["hidden_dim"], cfg["input_dim"], cfg["mlp_layers"]
    deep = (n - 1) * h * h
    node_enc = 2 * v * (f * h + deep)
    edge_enc = 2 * e * (2 * h * h + deep)
    node_net = 2 * v * (2 * h * h + deep)
    edge_net = 2 * e * (3 * h * h + deep)
    head = 2 * e * (3 * h * h + deep + h)
    return (node_enc + edge_enc
            + cfg["n_iters"] * (node_net + edge_net + 2 * e * h) + head)
