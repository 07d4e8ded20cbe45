"""The device the port's entry points put their tensors on."""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """``device`` as given, or the CUDA device when it is None.

    The port runs on the card unless the caller asks for the CPU
    (``device="cpu"``): with no card and no device given this raises
    rather than quietly running on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: gnn_fpga_tpu_torch runs on the GPU by default; "
            "pass device='cpu' to run on the CPU")
    return torch.device("cuda")
