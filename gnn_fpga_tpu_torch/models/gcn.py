"""Graph-convolutional models on dense adjacencies.

The counterpart of ``gnn_fpga_tpu/models/gcn.py``: the adjacency builders
(numpy, a copy of the JAX package's, so that the port imports nothing of
it), the graph-conv layers ``A X W + b`` and ``X W1 + A X W2 + b``, and
the GCN / GCRN per-node binary classifier.  The graphs are small and of
fixed size (layers x tracks nodes), so a batch is a leading axis on
``x: [..., N, F]`` and ``a: [..., N, N]`` and every layer is a batched
matmul.

The module tree mirrors the JAX parameter tree (``extract``, ``gc[i]``
with ``linear`` or ``node`` / ``neighbor``, ``head``), which
:mod:`gnn_fpga_tpu_torch.utils.serialization` carries across in both
directions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import numpy as np
import torch
from torch import nn

from gnn_fpga_tpu_torch.core.device import default_device
from gnn_fpga_tpu_torch.models.mpnn import _Linear, count_params  # noqa: F401


# ---------------------------------------------------------------------------
# Adjacency construction and normalisation (numpy)
# ---------------------------------------------------------------------------

def layer_adjacency(l: np.ndarray) -> np.ndarray:
    """Binary adjacency connecting all hits on adjacent layers.
    ``l``: [B, N]."""
    return (np.abs(l[:, None, :] - l[:, :, None]) == 1).astype(np.float32)


def toy_adjacency(x: np.ndarray, r: np.ndarray, l: np.ndarray,
                  y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(adj, adj_y)``: hits on adjacent layers connected iff the straight
    line through them enters and exits the detector inside (0, 1), and the
    true (same-track) adjacency."""
    adj_l = layer_adjacency(l)
    dx = x[:, None, :] - x[:, :, None]
    dr = r[:, None, :] - r[:, :, None]
    dr = np.where(dr == 0, 1e-7, dr)
    slope = dx / dr
    rn = r.max()
    x0 = x[:, None, :] - slope * r[:, None, :]
    xn = x[:, None, :] + slope * (rn - r[:, None, :])
    adj = adj_l * ((x0 < 1) & (x0 > 0)) * ((xn < 1) & (xn > 0))
    adj_y = (y[:, None, :] == y[:, :, None]) * adj_l
    return adj.astype(np.float32), adj_y.astype(np.float32)


def row_norm_adjacency(a: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Rows normalised to sum 1."""
    d = a.sum(axis=-1, keepdims=True)
    return (a / np.maximum(d, eps)).astype(np.float32)


def kipf_welling_adjacency(a: np.ndarray) -> np.ndarray:
    """Symmetric normalisation with self-loops, D^-1/2 (A + I) D^-1/2."""
    n = a.shape[-1]
    ahat = a + np.eye(n, dtype=a.dtype)[None]
    dinv = 1.0 / np.sqrt(ahat.sum(axis=-1))
    return (dinv[:, :, None] * ahat * dinv[:, None, :]).astype(np.float32)


def segment_indices(hit_adj: np.ndarray) -> np.ndarray:
    """Upper-triangular nonzeros of the hit adjacency as per-event segment
    endpoint pairs [B, S, 2] (every event has the same segment count)."""
    b = hit_adj.shape[0]
    ev, i, j = np.nonzero(np.triu(hit_adj))
    return np.stack([i, j], axis=-1).reshape(b, -1, 2)


def segment_adjacency(seg_idx: np.ndarray) -> np.ndarray:
    """Segments adjacent iff one's end hit is the other's start,
    symmetrised."""
    share = (seg_idx[:, :, None, 1] == seg_idx[:, None, :, 0])
    return np.maximum(share, share.transpose(0, 2, 1)).astype(np.float32)


def segment_labels(hit_y: np.ndarray, seg_idx: np.ndarray) -> np.ndarray:
    """Segment truth: both endpoints on the same track."""
    ev = np.arange(hit_y.shape[0])[:, None, None]
    seg_hit_y = hit_y[ev, seg_idx]
    return (seg_hit_y[:, :, 0] == seg_hit_y[:, :, 1]).astype(np.float32)


def segment_slopes(hit_x: np.ndarray, hit_r: np.ndarray,
                   seg_idx: np.ndarray) -> np.ndarray:
    """Per-segment dx/dr slope."""
    ev = np.arange(hit_x.shape[0])[:, None, None]
    sx = hit_x[ev, seg_idx]
    sr = hit_r[ev, seg_idx]
    return ((sx[:, :, 1] - sx[:, :, 0])
            / (sr[:, :, 1] - sr[:, :, 0])).astype(np.float32)


def gaussian_slope_kernel(seg_slope: np.ndarray,
                          sigma: float = 0.01) -> np.ndarray:
    """Edge weights from slope agreement, exp(-dslope^2 / 2 sigma^2)."""
    ds = seg_slope[:, None, :] - seg_slope[:, :, None]
    return np.exp(-(ds ** 2) / (2 * sigma ** 2)).astype(np.float32)


# ---------------------------------------------------------------------------
# Graph-conv layers
# ---------------------------------------------------------------------------

@torch.no_grad()
def uniform_init(module: nn.Module, generator: torch.Generator) -> None:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for the weight and bias of every
    layer of ``module`` (a submodule with a ``weight`` parameter), fan_in
    being the inputs of one output (the JAX package's bounds)."""
    for m in module.modules():
        own = dict(m.named_parameters(recurse=False))
        if "weight" in own:
            bound = 1.0 / math.sqrt(own["weight"][0].numel())
            for p in own.values():
                u = torch.rand(p.shape, generator=generator)
                p.copy_(u * (2 * bound) - bound)


class GraphConv(nn.Module):
    """``A X W + b``."""

    def __init__(self, in_dim, out_dim, dtype, device):
        super().__init__()
        self.linear = _Linear(in_dim, out_dim, dtype, device)

    def forward(self, x, a):
        return self.linear(a @ x)


class GraphConvSelfInt(nn.Module):
    """``X W1 + A X W2 + b``: the self-interaction separated, the
    neighbour term without a bias."""

    def __init__(self, in_dim, out_dim, dtype, device):
        super().__init__()
        self.node = _Linear(in_dim, out_dim, dtype, device)
        self.neighbor = _Linear(in_dim, out_dim, dtype, device, bias=False)

    def forward(self, x, a):
        return self.node(x) + self.neighbor(a @ x)


_GC_KINDS = {"conv": GraphConv, "self_int": GraphConvSelfInt}


# ---------------------------------------------------------------------------
# Classifier
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GCNConfig:
    input_dim: int = 3
    hidden_dims: Tuple[int, ...] = (8, 8, 8)
    gc_kind: str = "self_int"     # conv | self_int
    residual: bool = False        # GCRN: concat input features per layer
    activation: Callable = torch.relu
    dtype: torch.dtype = torch.float32


class GCNClassifier(nn.Module):
    """GCN (GCRN with ``residual``) per-node binary classifier: feature
    extractor, graph-conv stack, per-node head.  ``forward(x, a)`` returns
    per-node logits ``[..., N]``.  Parameters go on ``device``, the CUDA
    device when it is None."""

    def __init__(self, cfg: GCNConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.cfg = cfg
        device = default_device(device)
        dims = list(cfg.hidden_dims)
        extra = cfg.input_dim if cfg.residual else 0
        layer = _GC_KINDS[cfg.gc_kind]
        self.extract = _Linear(cfg.input_dim, dims[0], cfg.dtype, device)
        self.gc = nn.ModuleList(
            layer(dims[i] + extra, dims[i + 1], cfg.dtype, device)
            for i in range(len(dims) - 1))
        self.head = _Linear(dims[-1], 1, cfg.dtype, device)
        uniform_init(self, generator)

    def forward(self, x, a):
        act = self.cfg.activation
        h = act(self.extract(x))
        for conv in self.gc:
            if self.cfg.residual:
                h = torch.cat([h, x], dim=-1)
            h = act(conv(h, a))
        return self.head(h)[..., 0]


def init_gcn_classifier(cfg: GCNConfig, generator: torch.Generator,
                        device=None) -> GCNClassifier:
    return GCNClassifier(cfg, generator, device)


def gcn_classifier(model: GCNClassifier, x, a):
    """Per-node probabilities: the sigmoid of ``model(x, a)``."""
    return torch.sigmoid(model(x, a))
