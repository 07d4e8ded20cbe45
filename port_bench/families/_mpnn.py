"""The interaction networks of jmduarte/gnn-fpga, shared by the segment
and node classifier families.

It follows the published description (``MPNN_Seg_ACTS_mu200.ipynb``,
``MPNN_HitClassifier.ipynb``):

    h = [tanh(x @ Wi + bi), x]
    n_iters x:  e = sigmoid(l2(tanh(pa h[s] + pb h[r] + b1)))   (edge net)
                mi[n] = sum_{r == n} e h[s],  mo[n] = sum_{s == n} e h[r]
                h = [tanh(l2(tanh(l1([mi, mo, h])))), x]          (node net)
    head:       edge logits l2(tanh(pa h[s] + pb h[r] + b1)), or node
                logits h @ Wout + bout

on one graph given as plain arrays (sector graphs concatenated,
:meth:`port_bench.gen.Event.packed`): aggregation is worked out here from
the senders and receivers with ``index_add``.  ``head`` is ``"edge"`` or
``"node"``.
"""

from __future__ import annotations

from typing import Callable

import torch


def leaves(cfg: dict, head: str) -> list:
    """Weights ``[out, in]``, each drawn from U(-1/sqrt(fan_in),
    1/sqrt(fan_in)); the edge network's split first layer takes the
    fan-in of the whole ``[2D, H]``."""
    f, h = cfg["input_dim"], cfg["hidden_dim"]
    d = f + h
    out = [("input.weight", (h, f), f), ("input.bias", (h,), f),
           ("edge.pa.weight", (h, d), 2 * d), ("edge.pb.weight", (h, d), 2 * d),
           ("edge.b1", (h,), 2 * d),
           ("edge.l2.weight", (1, h), h), ("edge.l2.bias", (1,), h),
           ("node.l1.weight", (h, 3 * d), 3 * d), ("node.l1.bias", (h,), 3 * d),
           ("node.l2.weight", (h, h), h), ("node.l2.bias", (h,), h)]
    if head == "node":
        out += [("output.weight", (1, d), d), ("output.bias", (1,), d)]
    return out


def logits(w: dict, g: dict, cfg: dict, r: Callable, head: str):
    """Edge logits ``[E]`` or node logits ``[V]``, float32."""
    lin = lambda t, name: r(t @ r(w[name + ".weight"]).T
                            + r(w[name + ".bias"]))
    x = r(g["x"])
    s, rcv = g["senders"], g["receivers"]
    h = torch.cat([r(torch.tanh(lin(x, "input"))), x], dim=1)

    def edge_net(h):
        pre = r(h[s] @ r(w["edge.pa.weight"]).T) + r(h[rcv] @ r(w["edge.pb.weight"]).T)
        z = r(torch.tanh(r(pre + r(w["edge.b1"]))))
        return lin(z, "edge.l2")[:, 0]

    for _ in range(cfg["n_iters"]):
        e = r(torch.sigmoid(edge_net(h)))[:, None]
        mi = r(torch.zeros_like(h).index_add(0, rcv, r(e * h[s])))
        mo = r(torch.zeros_like(h).index_add(0, s, r(e * h[rcv])))
        z = r(torch.tanh(lin(torch.cat([mi, mo, h], dim=1), "node.l1")))
        h = torch.cat([r(torch.tanh(lin(z, "node.l2"))), x], dim=1)
    if head == "node":
        return lin(h, "output")[:, 0].float()
    return edge_net(h).float()


def forward_flops(cfg: dict, n_node: float, n_edge: float,
                  head: str) -> float:
    """Useful forward FLOPs on ``n_node`` and ``n_edge`` REAL (mask-summed)
    nodes and edges: 2 FLOPs a multiply-add in every MLP matmul, 4 an edge
    and node width for the two weighted aggregations; gathers count as
    bytes.  The input layer, ``n_iters`` edge networks, aggregations and
    node networks, then the head: a last edge network, or the ``d -> 1``
    output layer on every real node.  The edge head's count is
    ``gnn_fpga_tpu_torch/utils/flops.py``'s SegmentClassifier count (the
    JAX package's arithmetic), float for float."""
    v, e = float(n_node), float(n_edge)
    h, d_in = cfg["hidden_dim"], cfg["input_dim"]
    d = h + d_in
    edge_mlp = 2 * e * h * (2 * d + 1)
    node_mlp = 2 * v * h * (3 * d + h)
    agg = 4 * e * d
    input_mlp = 2 * v * d_in * h
    last = 2 * v * d if head == "node" else edge_mlp
    return input_mlp + cfg["n_iters"] * (edge_mlp + agg + node_mlp) + last
