"""The port's NodeClassifier (``models/mpnn.py``)."""

from __future__ import annotations

import torch

from port_bench.builders import _mpnn

kernel_shapes = _mpnn.kernel_shapes


def make_model(cfg: dict, mix: dict, device):
    from gnn_fpga_tpu_torch.models import mpnn

    return mpnn.init_node_classifier(
        mpnn.NodeClassifierConfig(**_mpnn.config_kwargs(cfg, mix)),
        torch.Generator(), device)
