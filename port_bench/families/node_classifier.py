"""The hit classifier (``MPNN_HitClassifier.ipynb``): the interaction
network of :mod:`port_bench.families._mpnn` with a node head, one logit
a hit."""

from __future__ import annotations

from port_bench.families import _mpnn


def leaves(cfg: dict) -> list:
    return _mpnn.leaves(cfg, "node")


def logits(w: dict, g: dict, cfg: dict, r):
    return _mpnn.logits(w, g, cfg, r, "node")


def forward_flops(cfg: dict, n_node: float, n_edge: float) -> float:
    return _mpnn.forward_flops(cfg, n_node, n_edge, "node")
