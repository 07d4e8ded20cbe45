"""The port's InteractionGNN (``models/interaction_gnn.py``)."""

from __future__ import annotations

import torch


def make_model(cfg: dict, mix: dict, device):
    """The model runs on the plans and the kernels of ``ops/cuda/spmm.py``
    alone: a mix of another route raises."""
    from gnn_fpga_tpu_torch.models import interaction_gnn as ign

    if mix["route"] != "pallas":
        raise ValueError(f"InteractionGNN runs on the pallas route, not "
                         f"{mix['route']!r}")
    return ign.init_interaction_gnn(
        ign.InteractionGNNConfig(
            input_dim=cfg["input_dim"], hidden_dim=cfg["hidden_dim"],
            n_iters=cfg["n_iters"], mlp_layers=cfg["mlp_layers"],
            dtype=getattr(torch, cfg["param_dtype"]),
            compute_dtype=getattr(torch, cfg["compute_dtype"])),
        torch.Generator(), device)


def kernel_shapes(batch, cfg: dict) -> dict:
    """Padded nodes and edges; the gathers' and the sum's rows are ``H``
    wide on both sides (``d = hdim = H``); the compute dtype's bytes."""
    h = cfg["hidden_dim"]
    return dict(v=batch.n_node, e=batch.n_edge, d=h, hdim=h,
                dtype_bytes=torch.finfo(
                    getattr(torch, cfg["compute_dtype"])).bits // 8)
