"""The segment classifier (``MPNN_Seg_ACTS_mu200.ipynb``): the
interaction network of :mod:`port_bench.families._mpnn` with an edge
head, one logit a segment."""

from __future__ import annotations

from port_bench.families import _mpnn


def leaves(cfg: dict) -> list:
    return _mpnn.leaves(cfg, "edge")


def logits(w: dict, g: dict, cfg: dict, r):
    return _mpnn.logits(w, g, cfg, r, "edge")


def forward_flops(cfg: dict, n_node: float, n_edge: float) -> float:
    return _mpnn.forward_flops(cfg, n_node, n_edge, "edge")
