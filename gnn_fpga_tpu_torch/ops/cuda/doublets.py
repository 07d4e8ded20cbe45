"""The doublet cross-join of graph preprocessing, batched over layer pairs.

For each layer pair ``p``, every (inner hit ``i``, outer hit ``j``) of
the pair is kept when the line through the two hits passes the cuts
(``gnn_fpga_tpu/data/doublets.py::select_segments_arrays``):

    dphi = wrap(phi2[j] - phi1[i]),  dr = r2[j] - r1[i],  dz = z2[j] - z1[i]
    |dphi / dr| < phi_slope_cut[p]   and   |z1[i] - r1[i] * dz / dr| < z0_max

The hits of all pairs come concatenated: inner ``r1, phi1, z1`` [N1] and
outer ``r2, phi2, z2`` [N2] float64, with int64 offsets ``off1, off2``
[P + 1] (pair ``p``'s inner hits are ``off1[p]:off1[p+1]``) and one f64
cut a pair.  :func:`select_segments` returns the kept ``(i1, i2)`` as
int64 rows of the concatenated hits, pair by pair and, within a pair, in
``np.nonzero``'s row-major order.

On the card it is a hand-written CUDA kernel (``csrc/doublets.cu``), the
counterpart of the repo's C++ ``native/doublets.cpp``: a count pass, a
prefix sum, one host sync that sizes the output, and an emit pass.  On the
CPU :func:`select_segments` runs :func:`select_segments_reference`, the
same function in PyTorch, chunked over inner rows.  Both compute every
quantity in float64 in numpy's operation order, so their edges equal
numpy's bit for bit.
"""

from __future__ import annotations

import math

import torch

from gnn_fpga_tpu_torch.ops.cuda._build import kernel_device, launch

# Elements of one [rows, N2] temporary of the plain version (f64: 32 MB)
CHUNK_ELEMS = 1 << 22


def wrap_dphi(dphi: torch.Tensor) -> torch.Tensor:
    """``dphi`` wrapped into [-pi, pi] by numpy's two ``where``s
    (``calc_dphi``), one after the other."""
    dphi = torch.where(dphi > math.pi, dphi - 2 * math.pi, dphi)
    return torch.where(dphi < -math.pi, dphi + 2 * math.pi, dphi)


def select_segments_reference(r1, phi1, z1, r2, phi2, z2, off1, off2,
                              phi_slope_cuts, z0_max: float,
                              chunk_elems: int = CHUNK_ELEMS):
    """The plain PyTorch version of :func:`select_segments`: pair by pair,
    the pair's inner rows in chunks whose ``[rows, N2]`` temporaries hold
    at most ``chunk_elems`` elements (one row at least)."""
    o1, o2 = off1.tolist(), off2.tolist()
    cuts = [float(c) for c in phi_slope_cuts.tolist()]
    z0_max = float(z0_max)
    parts1, parts2 = [], []
    for p, cut in enumerate(cuts):
        a2, b2 = o2[p], o2[p + 1]
        if b2 == a2:
            continue
        rj, pj, zj = r2[a2:b2][None], phi2[a2:b2][None], z2[a2:b2][None]
        rows = max(1, chunk_elems // (b2 - a2))
        for s in range(o1[p], o1[p + 1], rows):
            e = min(s + rows, o1[p + 1])
            ri, pi, zi = r1[s:e, None], phi1[s:e, None], z1[s:e, None]
            dphi = wrap_dphi(pj - pi)
            dr = rj - ri
            dz = zj - zi
            phi_slope = dphi / dr
            z0 = zi - ri * dz / dr
            good = (phi_slope.abs() < cut) & (z0.abs() < z0_max)
            ii, jj = torch.nonzero(good, as_tuple=True)
            parts1.append(ii + s)
            parts2.append(jj + a2)
    if not parts1:
        empty = torch.zeros(0, dtype=torch.int64, device=r1.device)
        return empty, empty.clone()
    return torch.cat(parts1), torch.cat(parts2)


def _check(r1, phi1, z1, r2, phi2, z2, off1, off2, phi_slope_cuts):
    n1, n2, n_pairs = r1.shape[0], r2.shape[0], phi_slope_cuts.shape[0]
    for name, t, n, dt in (("r1", r1, n1, torch.float64),
                           ("phi1", phi1, n1, torch.float64),
                           ("z1", z1, n1, torch.float64),
                           ("r2", r2, n2, torch.float64),
                           ("phi2", phi2, n2, torch.float64),
                           ("z2", z2, n2, torch.float64),
                           ("off1", off1, n_pairs + 1, torch.int64),
                           ("off2", off2, n_pairs + 1, torch.int64),
                           ("phi_slope_cuts", phi_slope_cuts, n_pairs,
                            torch.float64)):
        if t.device != r1.device:
            raise ValueError(f"{name} is on {t.device}, expected {r1.device}")
        if t.dtype != dt or t.shape != (n,):
            raise ValueError(f"{name} must be {dt} of shape ({n},), got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def select_segments(r1, phi1, z1, r2, phi2, z2, off1, off2, phi_slope_cuts,
                    z0_max: float):
    """The kept ``(i1, i2)`` of every layer pair (module docstring), int64
    on the hits' device.  On the card the CUDA kernel (one count and one
    emit launch, one host sync between, counted as one
    ``select_segments``); on the CPU the plain version.  The
    offsets must start at 0, rise, and end at N1 and N2: the kernel reads
    every hit they name."""
    _check(r1, phi1, z1, r2, phi2, z2, off1, off2, phi_slope_cuts)
    dev = kernel_device(r1, "select_segments")
    if dev is None:
        return select_segments_reference(r1, phi1, z1, r2, phi2, z2, off1,
                                         off2, phi_slope_cuts, z0_max)
    n_pairs, n1 = phi_slope_cuts.shape[0], r1.shape[0]
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    if n_pairs == 0 or n1 == 0 or r2.shape[0] == 0:
        return empty, empty.clone()
    args = (n_pairs, n1, r1, phi1, z1, r2, phi2, z2, off1, off2,
            phi_slope_cuts, float(z0_max))
    counts = torch.empty(n1, dtype=torch.int64, device=dev)
    launch("gnn_doublet_count", *args, counts, count="select_segments")
    ends = torch.cumsum(counts, 0)
    total = int(ends[-1])                  # the one host sync
    out1 = torch.empty(total, dtype=torch.int64, device=dev)
    out2 = torch.empty(total, dtype=torch.int64, device=dev)
    if total:
        launch("gnn_doublet_emit", *args, ends, out1, out2)
    return out1, out2
