"""Dense-incidence (one-hot matmul) message-passing primitives.

The counterpart of ``gnn_fpga_tpu/ops/dense_incidence.py``: the
reference's ``bmm(Ri, ...)`` forms, with the one-hot incidence matrices
``R[v, e] = 1 iff idx[e] == v`` built once per call and reused across
iterations and forward/backward:

    gather:  bo = Ro^T @ h          ([V, E]^T @ [V, F])
    scatter: mi = Ri @ (e * bo)     ([V, E] @ [E, F])

Every function takes one graph or a batch (leading axes); a batch runs as
one batched matmul.  These are plain large products that the JAX package
leaves to XLA, so the port leaves them to ``torch.matmul``.
"""

from __future__ import annotations

from typing import Optional

import torch


def incidence(idx: torch.Tensor, n_node: int,
              edge_mask: Optional[torch.Tensor] = None,
              dtype=torch.bfloat16) -> torch.Tensor:
    """One-hot incidence ``R[..., v, e] = 1 iff idx[..., e] == v``, shape
    ``[..., n_node, E]`` in ``dtype``; masked columns are zero."""
    nodes = torch.arange(n_node, device=idx.device)
    r = (idx.unsqueeze(-2) == nodes[:, None]).to(dtype)
    if edge_mask is not None:
        r = r * edge_mask.to(dtype).unsqueeze(-2)
    return r


def gather_bmm(r: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``bo[e] = h[idx[e]]`` as ``R^T @ h`` (masked rows are zero)."""
    return r.transpose(-1, -2) @ h.to(r.dtype)


def scatter_bmm(r: torch.Tensor, messages: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[v] = sum_{e: idx[e]==v} weights[e] * messages[e]`` as
    ``R @ (weights * messages)``; the weights scale the [E, F] messages,
    not the incidence."""
    m = messages.to(r.dtype)
    if weights is not None:
        m = m * weights.to(r.dtype).unsqueeze(-1)
    return r @ m
