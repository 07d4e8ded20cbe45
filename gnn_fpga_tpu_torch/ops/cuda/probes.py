"""The probes' kernels (``csrc/probes.cu``, and a variant of
``csrc/iteration_bwd.cu``): instruments that measure the card, run by
``gnn_fpga_tpu_torch/probes/`` and ``chip_smoke.py``'s ``probes`` phase,
never by the model.

- :func:`passthrough` (``out = x * 2``) and :func:`gather_rows` (``out =
  h[idx]``): the copy and gather rates (the counterparts of the TPU
  probes ``benchmarks/probe_bw.py::passthrough``, ``benchmarks/
  probe_ops.py::passthrough`` and ``::gather_kernel_builder``);
- :func:`ablate_rows`: the single-direction SpMM (:func:`~gnn_fpga_tpu_
  torch.ops.cuda.spmm.spmm_raw`) with its gather, its scatter, both or its
  rows taken out, and on rows padded to a 16-byte pitch (``benchmarks/
  probe_spmm_ablate.py``'s bodies);
- :func:`iteration_pair_bwd_recompute`: the fused iteration's backward
  forming the edge scores itself, against which the production backward
  (:func:`~gnn_fpga_tpu_torch.ops.cuda.spmm.iteration_pair_bwd`, which
  reads the forward's scores: ``benchmarks/probe_iter.py::_stash_bwd``'s
  function; its plain version, which reads the scores, is
  ``spmm.iteration_pair_bwd_stashed_reference``) is timed.

Each wrapper runs its kernel on CUDA tensors and its plain version
(``*_reference``) on CPU tensors, and counts its launches in
``<wrapper>.launches``, which ``spmm.launch_counts`` gathers once this
module is imported (``spmm.register_kernel_wrappers``).
"""

from __future__ import annotations

import torch

from gnn_fpga_tpu_torch.ops.cuda import spmm
from gnn_fpga_tpu_torch.ops.segment import segment_sum

# Sorted edges a group of the ablation's group modes sums (the TPU
# probe's tile of 256 edges times 8 subtiles; csrc/probes.cu kAblateGroup),
# and the rows its modes without a gather read, h[j mod STATIC_ROWS].
ABLATE_GROUP = 2048
STATIC_ROWS = 256
# The ablation's modes (csrc/probes.cu Mode): "aligned" is "full" on a
# table whose rows are padded to a 16-byte pitch (:func:`pad_rows`).
ABLATION_MODES = ("full", "no_gather", "no_scatter", "compute", "ids_only",
                  "aligned")
_MODE_CODES = {"full": 0, "no_gather": 1, "no_scatter": 2, "compute": 3,
               "ids_only": 4, "aligned": 0}
PASSTHROUGH_VECTORS = (1, 2, 4)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def passthrough_reference(x):
    """``x * 2`` in ``x.dtype`` (exact in f32 and bf16)."""
    return x * 2


def gather_rows_reference(h, idx):
    """``h[idx]``."""
    return h.index_select(0, idx)


def _groups(rows, n_edge):
    """Sums of ``rows`` [E, ...] over consecutive groups of
    :data:`ABLATE_GROUP` edges, in f32."""
    n_groups = -(-n_edge // ABLATE_GROUP)
    pad = n_groups * ABLATE_GROUP - n_edge
    rows = torch.nn.functional.pad(rows, (0, 0) * (rows.ndim - 1) + (0, pad))
    return rows.reshape(n_groups, ABLATE_GROUP, *rows.shape[1:]).sum(1)


def ablate_rows_reference(h, w, plan: spmm.EdgePlan, mode: str):
    """What :func:`ablate_rows` computes, in f32: ``w`` [E] in EDGE order,
    the rows of sorted position ``j`` at ``h[plan.sorted_oth[j]]``
    (``full``, ``no_scatter``, ``aligned``) or ``h[j mod 256]``
    (``no_gather``, ``compute``), summed by node (``full``,
    ``no_gather``, ``aligned``: [V, D]) or over groups of
    :data:`ABLATE_GROUP` sorted edges (``no_scatter``, ``compute``: [G,
    D]); ``ids_only``: ``(sum w, sum oth)`` a group, [G, 2]."""
    if mode not in ABLATION_MODES:
        raise ValueError(f"ablate_rows: unknown mode {mode!r}")
    w_sorted = spmm.sort_edge_weights(w, plan)
    e = plan.n_edge
    if mode == "ids_only":
        return _groups(torch.stack([w_sorted, plan.sorted_oth.float()], 1), e)
    if mode in ("no_gather", "compute"):
        pos = torch.arange(e, device=h.device) % STATIC_ROWS
        rows = h.float().index_select(0, pos)
    else:
        rows = h.float().index_select(0, plan.sorted_oth)
    msgs = rows * w_sorted[:, None]
    if mode in ("no_scatter", "compute"):
        return _groups(msgs, e)
    return segment_sum(msgs, plan.sorted_seg, plan.n_node)


# ---------------------------------------------------------------------------
# Kernel wrappers: CPU tensors take the plain version, CUDA tensors launch
# ---------------------------------------------------------------------------

def _item_bytes(row_bytes: int, align: int) -> int:
    """The widest item, at most 16 bytes, that divides a row and the
    tables' alignment."""
    item = 16
    while item > 1 and (row_bytes % item or align % item):
        item //= 2
    return item


def passthrough(x, vectors: int = 4):
    """``x * 2`` in one kernel launch, in 16-byte vectors, ``vectors`` of
    them (1, 2 or 4) loaded by a thread before it stores any.  ``x``:
    contiguous f32 or bf16, 16-byte aligned."""
    dev = spmm._kernel_device(x, "passthrough")
    if dev is None:
        return passthrough_reference(x)
    if vectors not in PASSTHROUGH_VECTORS:
        raise ValueError(f"passthrough: vectors must be one of "
                         f"{PASSTHROUGH_VECTORS}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("passthrough: x must be contiguous and 16-byte "
                         "aligned")
    out = torch.empty_like(x)
    code = spmm._lib().gnn_passthrough(spmm._DTYPE_CODES[x.dtype], x.numel(),
                                       vectors, spmm._ptr(x),
                                       spmm._ptr(out), spmm._stream(x))
    spmm._raise_on_error(code, "gnn_passthrough")
    passthrough.launches += 1
    return out


def gather_rows(h, idx):
    """``h[idx]`` in one kernel launch: ``h`` [V, D] (f32 or bf16),
    ``idx`` [E] int32 in [0, V); a thread copies one item of a row, 16
    bytes where the row and ``h``'s alignment allow.  Bit for bit equal to
    ``h.index_select(0, idx)``.  An id outside [0, V) raises on the CPU
    and stops the kernel at a device-side assert on the card."""
    dev = spmm._kernel_device(h, "gather_rows")
    if dev is None:
        return gather_rows_reference(h, idx)
    if h.ndim != 2 or idx.ndim != 1:
        raise ValueError("gather_rows: h must be [V, D] and idx [E]")
    spmm._check_cuda(dev, h.dtype, h=h)
    spmm._check_cuda(dev, torch.int32, idx=idx)
    n_node, d = h.shape
    out = torch.empty((idx.shape[0], d), dtype=h.dtype, device=dev)
    row_bytes = d * h.element_size()
    item = _item_bytes(row_bytes, spmm._alignment(h, out))
    code = spmm._lib().gnn_gather_rows(n_node, idx.shape[0], row_bytes, item,
                                       spmm._ptr(h), spmm._ptr(idx),
                                       spmm._ptr(out), spmm._stream(h))
    spmm._raise_on_error(code, "gnn_gather_rows")
    gather_rows.launches += 1
    return out


def pad_rows(h):
    """A copy of ``h`` [V, D] whose rows are padded with zeros to a pitch
    of a multiple of 16 bytes (D = 66: 72 in bf16, 68 in f32; D = 128:
    unchanged), the table of the ``aligned`` ablation."""
    per = 16 // h.element_size()
    pitch = -(-h.shape[1] // per) * per
    out = torch.zeros((h.shape[0], pitch), dtype=h.dtype, device=h.device)
    out[:, :h.shape[1]] = h
    return out


def ablate_rows(h, w, plan: spmm.EdgePlan, mode: str, width=None):
    """One launch of ``csrc/probes.cu``'s ablation of the single-direction
    SpMM in ``mode`` (:data:`ABLATION_MODES`, defined by
    :func:`ablate_rows_reference`).  ``h``: [V, D] f32 or bf16 (for
    ``aligned``: :func:`pad_rows` of the table, and ``width`` its D);
    ``w``: [E] f32 in EDGE order.  Returns [V, D] (by node) or [G, D]
    (groups) in ``h.dtype``, each element rounded once from its f32 sum,
    or [G, 2] f32 (``ids_only``); ``aligned`` returns the first ``width``
    columns of its padded output (a view).  ``full`` equals
    :func:`~gnn_fpga_tpu_torch.ops.cuda.spmm.spmm_raw` and ``aligned``
    equals ``full`` bit for bit.  The kernel is instantiated for D = 128,
    66 and 66 padded, in f32 and bf16; other widths raise."""
    if mode not in ABLATION_MODES:
        raise ValueError(f"ablate_rows: unknown mode {mode!r}")
    if (mode == "aligned") != (width is not None):
        raise ValueError("ablate_rows: width is given with mode 'aligned' "
                         "only")
    w = w.float()
    dev = spmm._kernel_device(h, "ablate_rows")
    if dev is None:
        table = h if width is None else h[:, :width]
        out = ablate_rows_reference(table, w, plan,
                                    "full" if mode == "aligned" else mode)
        return out if mode == "ids_only" else out.to(h.dtype)
    v, pitch = h.shape
    if w.shape != (plan.n_edge,):
        raise ValueError("ablate_rows: w must be [E]")
    if mode in ("no_gather", "compute") and v < STATIC_ROWS:
        raise ValueError(f"ablate_rows: {mode} reads rows j mod "
                         f"{STATIC_ROWS}, so needs V >= {STATIC_ROWS}")
    spmm._check_widths("ablate_rows", pitch)
    spmm._check_cuda(dev, h.dtype, h=h)
    spmm._check_cuda(dev, torch.float32, w=w)
    spmm._check_plan("ablate_rows", plan, dev, v)
    n_groups = -(-plan.n_edge // ABLATE_GROUP)
    if mode == "ids_only":
        out = torch.empty((n_groups, 2), dtype=torch.float32, device=dev)
    else:
        rows = n_groups if mode in ("no_scatter", "compute") else v
        out = torch.empty((rows, pitch), dtype=h.dtype, device=dev)
    if mode == "aligned":
        if pitch * h.element_size() % 16 or width > pitch:
            raise ValueError("ablate_rows: 'aligned' takes pad_rows(table)")
        # 16-byte items on the lanes full takes at the table's width, so
        # that each column is summed in full's order
        item, log_lanes = 16, spmm.row_launch(width, h.dtype).log_lanes
    else:
        la = spmm.row_launch(pitch, h.dtype, spmm._alignment(h, out))
        item, log_lanes = la.item_bytes, la.log_lanes
    code = spmm._lib().gnn_ablate_rows(
        _MODE_CODES[mode], spmm._DTYPE_CODES[h.dtype], v, plan.n_edge, pitch,
        item, log_lanes, spmm._ptr(h), spmm._ptr(w), spmm._ptr(plan.seg_ptr),
        spmm._ptr(plan.sorted_oth), spmm._ptr(plan.order),
        spmm._ptr(plan.long_seg), len(plan.long_seg), spmm._ptr(out),
        spmm._stream(h))
    spmm._raise_on_error(code, "gnn_ablate_rows")
    ablate_rows.launches += 1
    return out if width is None else out[:, :width]


def iteration_pair_bwd_recompute(pa, pb, h, em_sorted, w2, b1, b2, g_mi,
                                 g_mo, plans: spmm.AggPlans):
    """The VJP of :func:`~gnn_fpga_tpu_torch.ops.cuda.spmm.iteration_pair`
    with the edge scores formed in the backward (``sigmoid(z . w2 + b2)``
    in the recv pass) rather than read: the production kernel's variant
    ``gnn_iteration_pair_bwd_recompute``, 3 CUDA launches counted as one.
    Arguments and results as ``spmm.iteration_pair_bwd``'s, without
    ``sig_sorted``; its plain version is
    ``spmm.iteration_pair_bwd_reference``."""
    dev = spmm._kernel_device(h, "iteration_pair_bwd_recompute")
    if dev is None:
        return spmm.iteration_pair_bwd(pa, pb, h, em_sorted, w2, b1, b2,
                                       g_mi, g_mo, plans)
    spmm._check_iteration("iteration_pair_bwd_recompute", pa, pb, h,
                          em_sorted, w2, b1, b2, plans, g_mi=g_mi, g_mo=g_mo)
    out = spmm._launch_iteration_bwd("gnn_iteration_pair_bwd_recompute", b2,
                                     pa, pb, h, em_sorted, w2, b1, b2, g_mi,
                                     g_mo, plans)
    iteration_pair_bwd_recompute.launches += 1
    return out


passthrough.launches = 0
gather_rows.launches = 0
ablate_rows.launches = 0
iteration_pair_bwd_recompute.launches = 0

spmm.register_kernel_wrappers(passthrough, gather_rows, ablate_rows,
                              iteration_pair_bwd_recompute)
