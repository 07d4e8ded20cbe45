"""Non-GNN baseline models.

The counterpart of ``gnn_fpga_tpu/models/baselines.py``:

- :class:`FCSegmentClassifier`: fully-connected segment classifier over the
  flattened node features;
- :class:`FCSegmenter`: hit-clustering FC segmenter, a per-hit softmax over
  the next layer's hits;
- :class:`ConvSegmenter`: each hit stacked with all hits on the adjacent
  layers (:func:`stack_adjacent_features`), 1x1 feature convs, then
  same-layer convs over the track axis;
- :class:`SeededFC`, :class:`SeededCNN`, :class:`SeededLSTM`: seeded track
  finding as an image task over (layer x track-slot) hit grids.

Each module's ``forward`` returns pre-softmax / pre-sigmoid scores; pair
them with :func:`softmax_xent` or a sigmoid BCE.  The module trees mirror
the JAX parameter trees, which
:mod:`gnn_fpga_tpu_torch.utils.serialization` carries across in both
directions: a conv's weight is ``[out, in, kh, kw]`` here and HWIO there,
and the LSTM keeps the JAX layout (``wx: [in, 4H]``, ``wh: [H, 4H]``,
``b: [4H]``, gates ``i, f, g, o``) and runs its cell as the JAX package
does.  Parameters go on ``device``, the CUDA device when it is None.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gnn_fpga_tpu_torch.core.device import default_device
from gnn_fpga_tpu_torch.models.gcn import uniform_init
from gnn_fpga_tpu_torch.models.mpnn import _Linear, count_params  # noqa: F401


def softmax_xent(logits, targets):
    """Mean categorical cross-entropy over the last axis (rows of
    ``targets`` one-hot or row-stochastic)."""
    return -(targets * F.log_softmax(logits, dim=-1)).sum(-1).mean()


def row_accuracy(logits, targets):
    """Fraction of rows whose argmax matches the target's argmax."""
    return (logits.argmax(-1) == targets.argmax(-1)).float().mean()


class _Conv(nn.Module):
    """A 2-D convolution: weight ``[out, in, kh, kw]`` and bias, applied
    to NCHW input with 'same' padding: a kernel of k takes ``(k - 1) // 2``
    zeros before and the rest after, as XLA's ``SAME`` pads, so an even
    kernel pads one more after than before."""

    def __init__(self, in_ch, out_ch, kh, kw, dtype, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kh, kw,
                                               dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.empty(out_ch, dtype=dtype,
                                             device=device))

    def forward(self, x):
        kh, kw = self.weight.shape[2:]
        pad = ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2)
        return F.conv2d(F.pad(x, pad), self.weight, self.bias)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# FCSegmentClassifier
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FCSegmentClassifierConfig:
    n_hits: int = 40
    n_segments: int = 144
    input_dim: int = 2
    hidden_dim: int = 32
    dtype: torch.dtype = torch.float32


class FCSegmentClassifier(nn.Module):
    """Per-edge logits ``(..., n_segments)`` from the flattened node
    features ``(..., n_hits, input_dim)`` (the topology is ignored)."""

    def __init__(self, cfg: FCSegmentClassifierConfig,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.cfg = cfg
        device = default_device(device)
        self.l1 = _Linear(cfg.n_hits * cfg.input_dim, cfg.hidden_dim,
                          cfg.dtype, device)
        self.l2 = _Linear(cfg.hidden_dim, cfg.n_segments, cfg.dtype, device)
        uniform_init(self, generator)

    def forward(self, x):
        flat = x.reshape(x.shape[:-2] + (self.cfg.n_hits
                                         * self.cfg.input_dim,))
        return self.l2(torch.relu(self.l1(flat)))


# ---------------------------------------------------------------------------
# Hit-clustering segmenters
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SegmenterConfig:
    n_layers: int = 10
    n_tracks: int = 4
    hidden_dim: int = 100
    dtype: torch.dtype = torch.float32


class FCSegmenter(nn.Module):
    """``grids (B, L, T)`` -> ``(B, (L-1)*T, T)`` logits: row r scores hit
    r's continuation over the next layer's slots."""

    def __init__(self, cfg: SegmenterConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.cfg = cfg
        device = default_device(device)
        nl, nt, h = cfg.n_layers, cfg.n_tracks, cfg.hidden_dim
        self.l1 = _Linear(nl * nt, h, cfg.dtype, device)
        self.l2 = _Linear(h, h, cfg.dtype, device)
        self.out = _Linear(h, (nl - 1) * nt * nt, cfg.dtype, device)
        uniform_init(self, generator)

    def forward(self, grids):
        b = grids.shape[0]
        h = torch.relu(self.l1(grids.reshape(b, -1)))
        h = torch.relu(self.l2(h))
        nl, nt = self.cfg.n_layers, self.cfg.n_tracks
        return self.out(h).reshape(b, (nl - 1) * nt, nt)


@dataclasses.dataclass(frozen=True)
class ConvSegmenterConfig:
    n_layers: int = 10
    n_tracks: int = 4
    adj_filters: Sequence[int] = (32, 32, 32, 32)
    lay_filters: Sequence[int] = (16, 16)
    dtype: torch.dtype = torch.float32


def stack_adjacent_features(x):
    """Each hit's features stacked with ALL hits' on the previous and next
    layers: ``(B, L, T, F)`` -> ``(B, L, T, F + 2*T*F)``, the adjacent
    blocks zero on the boundary layers."""
    b, nl, nt, f = x.shape
    flat = x.reshape(b, nl, nt * f)
    rep = flat[:, :, None, :].expand(b, nl, nt, nt * f)
    pad = x.new_zeros((b, 1, nt, nt * f))
    padded = torch.cat([pad, rep, pad], dim=1)
    return torch.cat([padded[:, :-2], x, padded[:, 2:]], dim=-1)


class ConvSegmenter(nn.Module):
    """``grids (B, L, T)`` -> ``(B, (L-1)*T, T)`` next-layer association
    logits: adjacent-layer stacking and 1x1 convs, the input concatenated
    back, the last layer dropped, same-layer convs of width T over the
    track axis, a final conv to T channels."""

    def __init__(self, cfg: ConvSegmenterConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.cfg = cfg
        device = default_device(device)
        nt = cfg.n_tracks
        adj, f = [], 1
        for nf in cfg.adj_filters:
            adj.append(_Linear(f + 2 * nt * f, nf, cfg.dtype, device))
            f = nf
        self.adj = nn.ModuleList(adj)
        f += 1  # the input concatenated back
        lay = []
        for nf in cfg.lay_filters:
            lay.append(_Conv(f, nf, 1, nt, cfg.dtype, device))
            f = nf
        self.lay = nn.ModuleList(lay)
        self.out = _Conv(f, nt, 1, nt, cfg.dtype, device)
        uniform_init(self, generator)

    def forward(self, grids):
        b = grids.shape[0]
        x = grids[..., None]                                  # (B, L, T, 1)
        h = x
        for layer in self.adj:
            h = torch.relu(layer(stack_adjacent_features(h)))
        h = _nchw(torch.cat([h, x], dim=-1)[:, :-1])          # (B, F+1, L-1, T)
        for layer in self.lay:
            h = torch.relu(layer(h))
        out = _nhwc(self.out(h))
        nl, nt = self.cfg.n_layers, self.cfg.n_tracks
        return out.reshape(b, (nl - 1) * nt, nt)


# ---------------------------------------------------------------------------
# Seeded track finding on hit grids
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SeededConfig:
    n_layers: int = 10
    n_tracks: int = 10
    seed_size: int = 3
    hidden_dim: int = 100
    dtype: torch.dtype = torch.float32


class SeededFC(nn.Module):
    """``(grids (B, L, T), seeds (B, seed, T))`` -> per-layer slot logits
    ``(B, L, T)``: three ReLU layers over the flattened grid and seeds."""

    def __init__(self, cfg: SeededConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.cfg = cfg
        device = default_device(device)
        nl, nt, h = cfg.n_layers, cfg.n_tracks, cfg.hidden_dim
        self.l1 = _Linear(nl * nt + cfg.seed_size * nt, h, cfg.dtype, device)
        self.l2 = _Linear(h, h, cfg.dtype, device)
        self.l3 = _Linear(h, h, cfg.dtype, device)
        self.out = _Linear(h, nl * nt, cfg.dtype, device)
        uniform_init(self, generator)

    def forward(self, grids, seeds):
        b = grids.shape[0]
        h = torch.cat([grids.reshape(b, -1), seeds.reshape(b, -1)], dim=-1)
        for layer in (self.l1, self.l2, self.l3):
            h = torch.relu(layer(h))
        return self.out(h).reshape(b, self.cfg.n_layers,
                                            self.cfg.n_tracks)


@dataclasses.dataclass(frozen=True)
class SeededCNNConfig:
    n_layers: int = 10
    n_tracks: int = 10
    seed_size: int = 3
    n_conv: int = 8
    n_filters: int = 8
    kernel: int = 5
    dtype: torch.dtype = torch.float32


def _seed_channel(seeds, n_layers):
    """The seed one-hots zero-padded to a full ``(B, L, T)`` channel."""
    b, s, nt = seeds.shape
    return torch.cat([seeds, seeds.new_zeros((b, n_layers - s, nt))], dim=1)


class SeededCNN(nn.Module):
    """Stacked k x k 'same' convs over the 2-channel (hit grid, seed map)
    image, the last to one channel: per-layer slot logits ``(B, L, T)``."""

    def __init__(self, cfg: SeededCNNConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.cfg = cfg
        device = default_device(device)
        convs, f = [], 2
        for i in range(cfg.n_conv):
            nf = cfg.n_filters if i < cfg.n_conv - 1 else 1
            convs.append(_Conv(f, nf, cfg.kernel, cfg.kernel, cfg.dtype,
                               device))
            f = nf
        self.conv = nn.ModuleList(convs)
        uniform_init(self, generator)

    def forward(self, grids, seeds):
        h = torch.stack([grids, _seed_channel(seeds, self.cfg.n_layers)],
                        dim=1)                                # (B, 2, L, T)
        for i, layer in enumerate(self.conv):
            h = layer(h)
            if i < len(self.conv) - 1:
                h = torch.relu(h)
        return h[:, 0]


@dataclasses.dataclass(frozen=True)
class SeededLSTMConfig:
    n_layers: int = 10
    n_tracks: int = 10
    seed_size: int = 3
    hidden_dim: int = 10
    dtype: torch.dtype = torch.float32


class SeededLSTM(nn.Module):
    """An LSTM over the detector-layer sequence of ``[hit positions, seed
    channel]`` and a dense slot head per layer: logits ``(B, L, T)``."""

    def __init__(self, cfg: SeededLSTMConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.cfg = cfg
        device = default_device(device)
        in_dim, h = 2 * cfg.n_tracks, cfg.hidden_dim
        empty = lambda *shape: nn.Parameter(
            torch.empty(shape, dtype=cfg.dtype, device=device))
        self.wx = empty(in_dim, 4 * h)
        self.wh = empty(h, 4 * h)
        self.b = empty(4 * h)
        self.out = _Linear(h, cfg.n_tracks, cfg.dtype, device)
        with torch.no_grad():
            bound = 1.0 / math.sqrt(h)
            for p in (self.wx, self.wh):
                u = torch.rand(p.shape, generator=generator)
                p.copy_(u * (2 * bound) - bound)
            self.b.zero_()
            self.b[h:2 * h] = 1.0      # forget-gate bias 1 (Keras default)
        uniform_init(self.out, generator)

    def forward(self, grids, seeds):
        seq = torch.cat([grids, _seed_channel(seeds, self.cfg.n_layers)],
                        dim=-1)                               # (B, L, 2T)
        b, h_dim = seq.shape[0], self.cfg.hidden_dim
        h = seq.new_zeros((b, h_dim))
        c = seq.new_zeros((b, h_dim))
        hs = []
        for t in range(seq.shape[1]):
            z = seq[:, t] @ self.wx + h @ self.wh + self.b
            i, f, g, o = z.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        return self.out(torch.stack(hs, dim=1))
