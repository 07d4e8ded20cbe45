"""What the port's interaction networks (``models/mpnn.py``) share on the
program's side."""

from __future__ import annotations

import torch


def config_kwargs(cfg: dict, mix: dict) -> dict:
    """The fields of ``SegmentClassifierConfig`` and ``NodeClassifierConfig``
    that the configuration and the mix's route set."""
    return dict(input_dim=cfg["input_dim"], hidden_dim=cfg["hidden_dim"],
                n_iters=cfg["n_iters"], dtype=getattr(torch, cfg["param_dtype"]),
                compute_dtype=getattr(torch, cfg["compute_dtype"]),
                aggregation=mix["route"])


def kernel_shapes(batch, cfg: dict) -> dict:
    """Padded nodes and edges, the node table's width ``d`` (input and
    hidden) and the hidden width, the compute dtype's bytes."""
    return dict(v=batch.n_node, e=batch.n_edge,
                d=cfg["input_dim"] + cfg["hidden_dim"], hdim=cfg["hidden_dim"],
                dtype_bytes=torch.finfo(
                    getattr(torch, cfg["compute_dtype"])).bits // 8)
