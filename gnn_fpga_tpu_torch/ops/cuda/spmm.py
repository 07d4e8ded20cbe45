"""Sorted-edge plans and the message-passing kernels, forward and backward.

The counterpart of ``gnn_fpga_tpu/ops/pallas/spmm.py``.  The iteration's two
edge-weighted aggregations

    mi[n] = sum_{e: recv[e]==n} w[e] * h[send[e]]
    mo[n] = sum_{e: send[e]==n} w[e] * h[recv[e]]

run on the card as hand-written CUDA kernels (``csrc/spmm.cu``):

- :func:`iteration_pair` computes the edge weights itself from the edge
  MLP (``w = sigmoid(tanh((pa[s] + pb[r]) * em + b1) . w2 + b2) * em``),
  so no ``[E, H]`` intermediate exists;
- :func:`aggregate_pair` takes the weights as given;
- :func:`gather_pair` is the final edge layer's ``pa[s] + pb[r]``; its
  forward is a plain row gather.

Each is a ``torch.autograd.Function`` whose backward is a kernel too
(``csrc/spmm_bwd.cu``): :func:`iteration_pair_bwd`,
:func:`aggregate_pair_bwd` and :func:`gather_pair_bwd`.  The backwards
save only the V-sized inputs and recompute per-edge values, as the JAX
package's VJPs do.

The single-direction API runs on ``csrc/spmm_ops.cu``: :func:`spmm_raw`
(one direction of the aggregation over one plan), :func:`spmm` (with its
VJP, ``dh`` through the transpose plan and ``dw`` through :func:`sddmm`),
:func:`sddmm` (``out[e] = <a[seg], b[oth]>``) and :func:`sddmm_dual`.

The plans keep the JAX package's receiver-sorted and sender-sorted edge
orders, from a stable argsort, and add CSR row pointers, so each node's
row is reduced by one warp without atomics.  The TPU's gather windows,
prebuilt one-hots and tile padding are not needed: Hopper gathers rows
natively.

Each kernel wrapper runs its kernel on CUDA tensors and its plain PyTorch
version (``*_reference``) on CPU tensors, and counts its kernel launches
in ``<wrapper>.launches`` (:func:`launch_counts`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gnn_fpga_tpu_torch.ops.segment import segment_sum

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_WIDTH = 256   # 8 row chunks of 32 lanes in csrc/


@dataclasses.dataclass(frozen=True)
class EdgePlan:
    """Sorted-edge plan for one aggregation direction.

    ``seg`` is the endpoint the edges are grouped by, ``oth`` the gathered
    endpoint.  All arrays int32:

      order:      [E]   sorted position -> edge index (seg ascending, stable)
      inv_order:  [E]   edge index -> sorted position
      sorted_seg: [E]   seg ids in sorted order
      sorted_oth: [E]   oth ids in sorted order
      seg_ptr:    [V+1] CSR offsets: node n's edges are
                        ``sorted_*[seg_ptr[n]:seg_ptr[n+1]]``
    """

    order: torch.Tensor
    inv_order: torch.Tensor
    sorted_seg: torch.Tensor
    sorted_oth: torch.Tensor
    seg_ptr: torch.Tensor
    n_node: int
    n_edge: int

    def to(self, device) -> "EdgePlan":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device)
                     for f in ("order", "inv_order", "sorted_seg",
                               "sorted_oth", "seg_ptr")})


@dataclasses.dataclass(frozen=True)
class AggPlans:
    """The (receiver-sorted, sender-sorted) plan pair of a graph.

    ``recv`` groups edges by receiver and gathers senders (``mi``); ``send``
    is its transpose (``mo``).  ``send_in_recv[j]`` is the position in the
    recv order of the ``j``-th send-sorted edge: it lets the send side read
    weights that arrive in recv order (:func:`sort_edge_weights`).
    """

    recv: EdgePlan
    send: EdgePlan
    send_in_recv: torch.Tensor

    def to(self, device) -> "AggPlans":
        return AggPlans(self.recv.to(device), self.send.to(device),
                        self.send_in_recv.to(device))


def build_edge_plan(seg_ids, oth_ids, n_node: int) -> EdgePlan:
    """Host-side (numpy) plan for one aggregation direction."""
    seg_ids = np.asarray(seg_ids, np.int64)
    oth_ids = np.asarray(oth_ids, np.int64)
    e = len(seg_ids)
    if e >= 2 ** 31 or n_node >= 2 ** 31:
        raise ValueError("plans index edges and nodes with int32")
    if e and (min(seg_ids.min(), oth_ids.min()) < 0
              or max(seg_ids.max(), oth_ids.max()) >= n_node):
        raise ValueError("edge ids must be in [0, n_node)")
    order = np.argsort(seg_ids, kind="stable")
    inv_order = np.argsort(order, kind="stable")
    seg_ptr = np.zeros(n_node + 1, np.int64)
    np.cumsum(np.bincount(seg_ids, minlength=n_node), out=seg_ptr[1:])
    as_t = lambda a: torch.from_numpy(a.astype(np.int32))
    return EdgePlan(order=as_t(order), inv_order=as_t(inv_order),
                    sorted_seg=as_t(seg_ids[order]),
                    sorted_oth=as_t(oth_ids[order]), seg_ptr=as_t(seg_ptr),
                    n_node=int(n_node), n_edge=e)


def build_agg_plans(senders, receivers, n_node: int) -> AggPlans:
    """Both aggregation directions of a graph topology (host-side)."""
    recv = build_edge_plan(receivers, senders, n_node)
    send = build_edge_plan(senders, receivers, n_node)
    send_in_recv = recv.inv_order.index_select(0, send.order.long())
    return AggPlans(recv=recv, send=send, send_in_recv=send_in_recv)


def sort_edge_weights(w: torch.Tensor, plan: EdgePlan) -> torch.Tensor:
    """[E] edge weights (or mask) permuted into the plan's order, in f32."""
    return w.float().index_select(0, plan.order)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' check on the card).
# They work in any edge order, given senders/receivers in that order, and
# return f32.
# ---------------------------------------------------------------------------

def aggregate_pair_reference(h, w, senders, receivers, n_node):
    """``(mi, mo)`` in f32; ``w`` includes the mask."""
    hf, w = h.float(), w.float()[:, None]
    mi = segment_sum(hf.index_select(0, senders) * w, receivers, n_node)
    mo = segment_sum(hf.index_select(0, receivers) * w, senders, n_node)
    return mi, mo


def iteration_pair_reference(pa, pb, h, em, w2, b1, b2, senders, receivers,
                             n_node, activation=torch.tanh):
    """:func:`iteration_pair` in plain PyTorch, in f32."""
    em = em.float()
    pre = (pa.float().index_select(0, senders)
           + pb.float().index_select(0, receivers)) * em[:, None]
    z = activation(pre + b1.float())
    e = torch.sigmoid(z @ w2.float().reshape(-1)
                      + b2.float().reshape(())) * em
    return aggregate_pair_reference(h, e, senders, receivers, n_node)


def gather_pair_reference(pa, pb, senders, receivers):
    """``out[e] = pa[senders[e]] + pb[receivers[e]]`` in the input dtype."""
    return pa.index_select(0, senders) + pb.index_select(0, receivers)


def aggregate_pair_bwd_reference(h, w, g_mi, g_mo, senders, receivers,
                                 n_node):
    """VJP of :func:`aggregate_pair_reference`, in closed form (the JAX
    kernel's ``_agg_bwd_kernel``): ``(dh, dw)``, with ``dw`` in the given
    edge order."""
    hf, w = h.float(), w.float()[:, None]
    gmi_r = g_mi.float().index_select(0, receivers)
    gmo_s = g_mo.float().index_select(0, senders)
    dw = ((gmi_r * hf.index_select(0, senders)).sum(1)
          + (gmo_s * hf.index_select(0, receivers)).sum(1))
    dh = (segment_sum(w * gmi_r, senders, n_node)
          + segment_sum(w * gmo_s, receivers, n_node))
    return dh, dw


def iteration_pair_bwd_reference(pa, pb, h, em, w2, b1, b2, g_mi, g_mo,
                                 senders, receivers, n_node):
    """VJP of :func:`iteration_pair_reference` (tanh), in closed form (the
    JAX kernel's ``_iter_pair_bwd_kernel``, recomputing z and the edge
    score): ``(dh, dpa, dpb, dw2, db1, db2)``, ``db2`` of shape [1]."""
    em = em.float()
    w2 = w2.float().reshape(-1)
    hf = h.float()
    pre = (pa.float().index_select(0, senders)
           + pb.float().index_select(0, receivers)) * em[:, None]
    z = torch.tanh(pre + b1.float())
    sig = torch.sigmoid(z @ w2 + b2.float().reshape(()))
    e = (sig * em)[:, None]
    gmi_r = g_mi.float().index_select(0, receivers)
    gmo_s = g_mo.float().index_select(0, senders)
    de = ((gmi_r * hf.index_select(0, senders)).sum(1)
          + (gmo_s * hf.index_select(0, receivers)).sum(1))
    dlogit = de * em * sig * (1 - sig)
    dz1 = dlogit[:, None] * w2 * (1 - z * z)      # dz * (1 - z^2), no em
    dpre = dz1 * em[:, None]
    dh = (segment_sum(e * gmi_r, senders, n_node)
          + segment_sum(e * gmo_s, receivers, n_node))
    return (dh, segment_sum(dpre, senders, n_node),
            segment_sum(dpre, receivers, n_node),
            (z * dlogit[:, None]).sum(0), dz1.sum(0), dlogit.sum().reshape(1))


def gather_pair_bwd_reference(g, senders, receivers, n_node):
    """VJP of :func:`gather_pair_reference` (the JAX kernel's
    ``_gather_bwd_kernel``): ``(dpa, dpb)`` in f32."""
    g = g.float()
    return segment_sum(g, senders, n_node), segment_sum(g, receivers, n_node)


def spmm_reference(h, w, seg_ids, oth_ids, n_node):
    """``out[n] = sum_{seg[e]==n} w[e] * h[oth[e]]`` in f32."""
    return segment_sum(h.float().index_select(0, oth_ids) * w.float()[:, None],
                       seg_ids, n_node)


def sddmm_reference(a, b, seg_ids, oth_ids):
    """``out[e] = <a[seg[e]], b[oth[e]]>`` in f32."""
    return (a.float().index_select(0, seg_ids)
            * b.float().index_select(0, oth_ids)).sum(1)


def sddmm_dual_reference(p, q, u, v, seg_ids, oth_ids):
    """``out[e] = <p[seg[e]], q[oth[e]]> + <u[oth[e]], v[seg[e]]>`` in f32."""
    return (sddmm_reference(p, q, seg_ids, oth_ids)
            + sddmm_reference(v, u, seg_ids, oth_ids))


# ---------------------------------------------------------------------------
# Checks and launch plumbing
# ---------------------------------------------------------------------------

def _check_cuda(device, dtype, **tensors):
    """Device, dtype and contiguity checks before passing raw pointers."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_plan(name, plan: EdgePlan, device, n_node: int):
    if plan.n_node != n_node:
        raise ValueError(f"{name}: plan is for {plan.n_node} nodes, tables "
                         f"for {n_node}")
    _check_cuda(device, torch.int32, seg_ptr=plan.seg_ptr,
                sorted_oth=plan.sorted_oth, order=plan.order)


def _check_plans(plans: AggPlans, device, n_node: int):
    if plans.send.n_edge != plans.recv.n_edge:
        raise ValueError("recv and send plans differ in their edge count")
    _check_plan("recv plan", plans.recv, device, n_node)
    _check_plan("send plan", plans.send, device, n_node)
    _check_cuda(device, torch.int32, send_in_recv=plans.send_in_recv)


def _kernel_device(h, name):
    """Tables on the CPU take the plain version (None); anything other
    than a CUDA device is refused rather than falling back."""
    if h.device.type == "cpu":
        return None
    if h.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {h.device}, expected CPU or CUDA")
    if h.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {h.dtype}")
    return h.device


def _check_widths(name, *widths):
    if max(widths) > _MAX_WIDTH:
        raise ValueError(f"{name}: widths above {_MAX_WIDTH}")


def _check_iteration(name, pa, pb, h, em_sorted, w2, b1, b2, plans, **grads):
    """Shapes, dtypes and devices of :func:`iteration_pair`'s arguments
    (and its output gradients) before a kernel launch."""
    dev = h.device
    v, d = h.shape
    hdim = pa.shape[-1]
    if (pa.shape != (v, hdim) or pb.shape != (v, hdim)
            or w2.shape != (hdim,) or b1.shape != (hdim,) or b2.numel() != 1
            or em_sorted.shape != (plans.recv.n_edge,)
            or any(g.shape != (v, d) for g in grads.values())):
        raise ValueError(f"{name}: inconsistent shapes")
    _check_widths(name, d, hdim)
    _check_cuda(dev, h.dtype, pa=pa, pb=pb, h=h, w2=w2, b1=b1, b2=b2,
                **grads)
    _check_cuda(dev, torch.float32, em_sorted=em_sorted)
    _check_plans(plans, dev, v)


def _raise_on_error(code: int, name: str):
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError_t {code})")


def _ptr(t):
    return t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _lib():
    from gnn_fpga_tpu_torch.ops.cuda._build import load_library
    return load_library()


# ---------------------------------------------------------------------------
# Kernel wrappers: CPU tensors take the plain version, CUDA tensors launch
# ---------------------------------------------------------------------------

def _iteration_pair_fwd(pa, pb, h, em_sorted, w2, b1, b2, plans):
    if h.device.type == "cpu":
        r = plans.recv
        mi, mo = iteration_pair_reference(pa, pb, h, em_sorted, w2, b1, b2,
                                          r.sorted_oth, r.sorted_seg,
                                          h.shape[0])
        return mi.to(h.dtype), mo.to(h.dtype)
    v, d = h.shape
    mi = torch.empty_like(h)
    mo = torch.empty_like(h)
    code = _lib().gnn_iteration_pair_fwd(
        _DTYPE_CODES[h.dtype], v, d, pa.shape[1],
        _ptr(pa), _ptr(pb), _ptr(h), _ptr(em_sorted),
        _ptr(plans.send_in_recv), _ptr(w2), _ptr(b1), _ptr(b2),
        _ptr(plans.recv.seg_ptr), _ptr(plans.recv.sorted_oth),
        _ptr(plans.send.seg_ptr), _ptr(plans.send.sorted_oth),
        _ptr(mi), _ptr(mo), _stream(h))
    _raise_on_error(code, "gnn_iteration_pair_fwd")
    iteration_pair.launches += 1
    return mi, mo


def _aggregate_pair_fwd(h, w, plans):
    if h.device.type == "cpu":
        r = plans.recv
        mi, mo = aggregate_pair_reference(h, sort_edge_weights(w, r),
                                          r.sorted_oth, r.sorted_seg,
                                          h.shape[0])
        return mi.to(h.dtype), mo.to(h.dtype)
    v, d = h.shape
    mi = torch.empty_like(h)
    mo = torch.empty_like(h)
    code = _lib().gnn_aggregate_pair_fwd(
        _DTYPE_CODES[h.dtype], v, d, _ptr(h), _ptr(w),
        _ptr(plans.recv.seg_ptr), _ptr(plans.recv.sorted_oth),
        _ptr(plans.recv.order), _ptr(plans.send.seg_ptr),
        _ptr(plans.send.sorted_oth), _ptr(plans.send.order),
        _ptr(mi), _ptr(mo), _stream(h))
    _raise_on_error(code, "gnn_aggregate_pair_fwd")
    aggregate_pair.launches += 1
    return mi, mo


def iteration_pair_bwd(pa, pb, h, em_sorted, w2, b1, b2, g_mi, g_mo,
                       plans: AggPlans):
    """VJP of :func:`iteration_pair` in one kernel launch (plus a small
    fixed-order reduction of the parameter sums): ``(dh, dpa, dpb, dw2,
    db1, db2)`` in ``h.dtype``, ``db2`` shaped like ``b2``.  ``g_mi`` and
    ``g_mo`` are [V, D] in ``h.dtype``."""
    dev = _kernel_device(h, "iteration_pair_bwd")
    if dev is None:
        r = plans.recv
        out = iteration_pair_bwd_reference(pa, pb, h, em_sorted, w2, b1, b2,
                                           g_mi, g_mo, r.sorted_oth,
                                           r.sorted_seg, h.shape[0])
        out = out[:-1] + (out[-1].reshape(b2.shape),)
        return tuple(t.to(h.dtype) for t in out)
    _check_iteration("iteration_pair_bwd", pa, pb, h, em_sorted, w2, b1, b2,
                     plans, g_mi=g_mi, g_mo=g_mo)
    lib = _lib()
    v, d = h.shape
    hdim = pa.shape[1]
    dh, dpa, dpb = (torch.empty_like(h), torch.empty_like(pa),
                    torch.empty_like(pb))
    dw2, db1, db2 = (torch.empty_like(w2), torch.empty_like(b1),
                     torch.empty_like(b2))
    n_scratch = lib.gnn_iteration_pair_bwd_scratch(v, hdim)
    scratch = torch.empty(max(n_scratch, 1), dtype=torch.float32, device=dev)
    code = lib.gnn_iteration_pair_bwd(
        _DTYPE_CODES[h.dtype], v, d, hdim,
        _ptr(pa), _ptr(pb), _ptr(h), _ptr(em_sorted),
        _ptr(plans.send_in_recv), _ptr(w2), _ptr(b1), _ptr(b2),
        _ptr(g_mi), _ptr(g_mo),
        _ptr(plans.recv.seg_ptr), _ptr(plans.recv.sorted_oth),
        _ptr(plans.send.seg_ptr), _ptr(plans.send.sorted_oth),
        _ptr(dh), _ptr(dpa), _ptr(dpb), _ptr(scratch), scratch.numel(),
        _ptr(dw2), _ptr(db1), _ptr(db2), _stream(h))
    _raise_on_error(code, "gnn_iteration_pair_bwd")
    iteration_pair_bwd.launches += 1
    return dh, dpa, dpb, dw2, db1, db2


def aggregate_pair_bwd(h, w, g_mi, g_mo, plans: AggPlans):
    """VJP of :func:`aggregate_pair` in one kernel launch: ``(dh, dw)``,
    ``dh`` in ``h.dtype``, ``dw`` [E] f32 in EDGE order.  ``w`` is [E] f32
    in edge order; ``g_mi``/``g_mo`` are [V, D] in ``h.dtype``."""
    dev = _kernel_device(h, "aggregate_pair_bwd")
    if dev is None:
        r = plans.recv
        dh, dw = aggregate_pair_bwd_reference(
            h, sort_edge_weights(w, r), g_mi, g_mo, r.sorted_oth,
            r.sorted_seg, h.shape[0])
        return dh.to(h.dtype), dw.index_select(0, r.inv_order)
    v, d = h.shape
    if (w.shape != (plans.recv.n_edge,) or g_mi.shape != (v, d)
            or g_mo.shape != (v, d)):
        raise ValueError("aggregate_pair_bwd: inconsistent shapes")
    _check_widths("aggregate_pair_bwd", d)
    _check_cuda(dev, h.dtype, h=h, g_mi=g_mi, g_mo=g_mo)
    _check_cuda(dev, torch.float32, w=w)
    _check_plans(plans, dev, v)
    dh = torch.empty_like(h)
    dw = torch.empty_like(w)
    code = _lib().gnn_aggregate_pair_bwd(
        _DTYPE_CODES[h.dtype], v, d, _ptr(h), _ptr(w), _ptr(g_mi),
        _ptr(g_mo), _ptr(plans.recv.seg_ptr), _ptr(plans.recv.sorted_oth),
        _ptr(plans.recv.order), _ptr(plans.send.seg_ptr),
        _ptr(plans.send.sorted_oth), _ptr(plans.send.order),
        _ptr(dh), _ptr(dw), _stream(h))
    _raise_on_error(code, "gnn_aggregate_pair_bwd")
    aggregate_pair_bwd.launches += 1
    return dh, dw


def gather_pair_bwd(g, plans: AggPlans):
    """VJP of :func:`gather_pair` in one kernel launch: ``(dpa, dpb)``
    [V, H] in ``g.dtype``, from ``g`` [E, H] in EDGE order."""
    n_node = plans.recv.n_node
    dev = _kernel_device(g, "gather_pair_bwd")
    if dev is None:
        r = plans.recv
        dpa, dpb = gather_pair_bwd_reference(g.index_select(0, r.order),
                                             r.sorted_oth, r.sorted_seg,
                                             n_node)
        return dpa.to(g.dtype), dpb.to(g.dtype)
    if g.ndim != 2 or g.shape[0] != plans.recv.n_edge:
        raise ValueError("gather_pair_bwd: g must be [E, H]")
    hdim = g.shape[1]
    _check_widths("gather_pair_bwd", hdim)
    _check_cuda(dev, g.dtype, g=g)
    _check_plans(plans, dev, n_node)
    dpa = torch.empty((n_node, hdim), dtype=g.dtype, device=dev)
    dpb = torch.empty_like(dpa)
    code = _lib().gnn_gather_pair_bwd(
        _DTYPE_CODES[g.dtype], n_node, hdim, _ptr(g),
        _ptr(plans.recv.seg_ptr), _ptr(plans.recv.order),
        _ptr(plans.send.seg_ptr), _ptr(plans.send.order),
        _ptr(dpa), _ptr(dpb), _stream(g))
    _raise_on_error(code, "gnn_gather_pair_bwd")
    gather_pair_bwd.launches += 1
    return dpa, dpb


def spmm_raw(h, w, plan: EdgePlan):
    """``out[n] = sum_{e: seg[e]==n} w[e] * h[oth[e]]`` in one kernel
    launch, no VJP attached.  ``h``: [V, D]; ``w``: [E] edge weights in
    EDGE order (read through the plan's ``order``).  Returns [V, D] in
    ``h.dtype``."""
    w = w.float()
    dev = _kernel_device(h, "spmm")
    if dev is None:
        return spmm_reference(h, sort_edge_weights(w, plan), plan.sorted_seg,
                              plan.sorted_oth, plan.n_node).to(h.dtype)
    v, d = h.shape
    if w.shape != (plan.n_edge,):
        raise ValueError("spmm: w must be [E]")
    _check_widths("spmm", d)
    _check_cuda(dev, h.dtype, h=h)
    _check_cuda(dev, torch.float32, w=w)
    _check_plan("spmm", plan, dev, v)
    out = torch.empty_like(h)
    code = _lib().gnn_spmm(
        _DTYPE_CODES[h.dtype], v, d, _ptr(h), _ptr(w), _ptr(plan.seg_ptr),
        _ptr(plan.sorted_oth), _ptr(plan.order), _ptr(out), _stream(h))
    _raise_on_error(code, "gnn_spmm")
    spmm.launches += 1
    return out


def _sddmm(name, plan: EdgePlan, a, b, u=None, v=None):
    """:func:`sddmm`, or :func:`sddmm_dual` with ``u`` and ``v``."""
    wrapper = sddmm if u is None else sddmm_dual
    dev = _kernel_device(a, name)
    if dev is None:
        out = sddmm_reference(a, b, plan.sorted_seg, plan.sorted_oth)
        if u is not None:
            out = out + sddmm_reference(v, u, plan.sorted_seg,
                                        plan.sorted_oth)
        return out.index_select(0, plan.inv_order)
    tabs = dict(a=a, b=b) if u is None else dict(p=a, q=b, u=u, v=v)
    n, d = a.shape
    if any(t.shape != (n, d) for t in tabs.values()):
        raise ValueError(f"{name}: the tables must all be [V, D]")
    _check_widths(name, d)
    _check_cuda(dev, a.dtype, **tabs)
    _check_plan(name, plan, dev, n)
    out = torch.empty(plan.n_edge, dtype=torch.float32, device=dev)
    code = _lib().gnn_sddmm(
        _DTYPE_CODES[a.dtype], n, d, _ptr(a), _ptr(b),
        None if u is None else _ptr(u), None if v is None else _ptr(v),
        _ptr(plan.seg_ptr), _ptr(plan.sorted_oth), _ptr(plan.order),
        _ptr(out), _stream(a))
    _raise_on_error(code, "gnn_sddmm")
    wrapper.launches += 1
    return out


def sddmm(a, b, plan: EdgePlan):
    """Sampled dense-dense product ``out[e] = <a[seg[e]], b[oth[e]]>`` in
    one kernel launch.  ``a``/``b``: [V, D].  Returns [E] f32 in EDGE
    order; it is the gradient of :func:`spmm_raw` with respect to ``w``."""
    return _sddmm("sddmm", plan, a, b)


def sddmm_dual(p, q, u, v, plan: EdgePlan):
    """``out[e] = <p[seg[e]], q[oth[e]]> + <u[oth[e]], v[seg[e]]>`` in one
    kernel launch: with the recv plan, ``sddmm_dual(g_mi, h, g_mo, h,
    recv)`` is the ``dw`` of :func:`aggregate_pair`.  Four [V, D] tables;
    returns [E] f32 in EDGE order."""
    return _sddmm("sddmm_dual", plan, p, q, u, v)


# ---------------------------------------------------------------------------
# Autograd Functions: the kernels forward and backward
# ---------------------------------------------------------------------------

def _grad_as(g, dtype):
    """An output gradient as a kernel operand: in ``dtype``, contiguous
    (autograd hands column slices of a concatenation's gradient)."""
    return g.to(dtype).contiguous()


class _IterationPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pa, pb, h, em_sorted, w2, b1, b2, plans):
        ctx.plans = plans
        ctx.save_for_backward(pa, pb, h, em_sorted, w2, b1, b2)
        return _iteration_pair_fwd(pa, pb, h, em_sorted, w2, b1, b2, plans)

    @staticmethod
    def backward(ctx, g_mi, g_mo):
        pa, pb, h, em_sorted, w2, b1, b2 = ctx.saved_tensors
        dh, dpa, dpb, dw2, db1, db2 = iteration_pair_bwd(
            pa, pb, h, em_sorted, w2, b1, b2, _grad_as(g_mi, h.dtype),
            _grad_as(g_mo, h.dtype), ctx.plans)
        return dpa, dpb, dh, None, dw2, db1, db2, None


class _AggregatePair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, plans):
        ctx.plans = plans
        ctx.save_for_backward(h, w)
        return _aggregate_pair_fwd(h, w, plans)

    @staticmethod
    def backward(ctx, g_mi, g_mo):
        h, w = ctx.saved_tensors
        dh, dw = aggregate_pair_bwd(h, w, _grad_as(g_mi, h.dtype),
                                    _grad_as(g_mo, h.dtype), ctx.plans)
        return dh, dw, None


class _GatherPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pa, pb, senders, receivers, plans):
        ctx.plans = plans
        ctx.dtypes = pa.dtype, pb.dtype
        return gather_pair_reference(pa, pb, senders, receivers)

    @staticmethod
    def backward(ctx, g):
        dpa, dpb = gather_pair_bwd(_grad_as(g, ctx.dtypes[0]), ctx.plans)
        return dpa, dpb.to(ctx.dtypes[1]), None, None, None


class _Spmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, plan, plan_t):
        ctx.plans = plan, plan_t
        ctx.save_for_backward(h, w)
        return spmm_raw(h, w, plan)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        plan, plan_t = ctx.plans
        g = _grad_as(g, h.dtype)
        return spmm_raw(g, w, plan_t), sddmm(g, h, plan), None, None


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def iteration_pair(pa, pb, h, em_sorted, w2, b1, b2, plans: AggPlans):
    """Whole-iteration fusion: edge-MLP scoring, sigmoid and both weighted
    aggregations in one kernel launch, forward and backward.

    ``pa``/``pb``: [V, H] endpoint projections (``h @ W1a`` / ``h @ W1b``,
    masks applied); ``em_sorted``: [E] f32 edge mask in the recv plan's
    order (:func:`sort_edge_weights`); ``w2``/``b1``: [H]; ``b2``: [1].
    Returns ``(mi, mo)`` [V, D] in ``h.dtype``.
    """
    if _kernel_device(h, "iteration_pair") is not None:
        _check_iteration("iteration_pair", pa, pb, h, em_sorted, w2, b1, b2,
                         plans)
    return _IterationPair.apply(pa, pb, h, em_sorted, w2, b1, b2, plans)


def aggregate_pair(h, w, plans: AggPlans):
    """Fused edge-weighted neighbour aggregation, both directions, in one
    kernel launch, forward and backward.  ``w``: [E] weights in EDGE
    order, mask included.  Returns ``(mi, mo)`` [V, D] in ``h.dtype``."""
    dev = _kernel_device(h, "aggregate_pair")
    w = w.float()
    if dev is not None:
        v, d = h.shape
        if w.shape != (plans.recv.n_edge,):
            raise ValueError("aggregate_pair: w must be [E]")
        _check_widths("aggregate_pair", d)
        _check_cuda(dev, h.dtype, h=h)
        _check_cuda(dev, torch.float32, w=w)
        _check_plans(plans, dev, v)
    return _AggregatePair.apply(h, w, plans)


def gather_pair(pa, pb, senders, receivers, plans: AggPlans):
    """``out[e] = pa[senders[e]] + pb[receivers[e]]`` in the input dtype,
    EDGE order: the projection-form first layer of the edge MLP.  The
    forward is a row gather (``index_select``); the backward, two [E,
    H]-row segment sums, is one kernel launch (:func:`gather_pair_bwd`)."""
    dev = _kernel_device(pa, "gather_pair")
    if dev is not None:
        if pb.dtype != pa.dtype or pb.shape != pa.shape:
            raise ValueError("gather_pair: pa and pb must match")
        _check_plans(plans, dev, pa.shape[0])
    return _GatherPair.apply(pa, pb, senders, receivers, plans)


def spmm(h, w, plan: EdgePlan, plan_t: EdgePlan):
    """Single-direction differentiable SpMM, :func:`spmm_raw` over
    ``plan``; ``plan_t`` is its transpose (for a graph's
    :class:`AggPlans`, ``(plans.recv, plans.send)`` or the reverse).  The
    backward is ``dh = spmm_raw(g, w, plan_t)`` and ``dw = sddmm(g, h,
    plan)``, each one kernel launch."""
    if plan_t.n_node != plan.n_node or plan_t.n_edge != plan.n_edge:
        raise ValueError("spmm: plan_t must be the transpose of plan")
    w = w.float()
    return _Spmm.apply(h, w, plan, plan_t)


iteration_pair.launches = 0
aggregate_pair.launches = 0
iteration_pair_bwd.launches = 0
aggregate_pair_bwd.launches = 0
gather_pair_bwd.launches = 0
spmm.launches = 0
sddmm.launches = 0
sddmm_dual.launches = 0


def _kernel_wrappers() -> tuple:
    from gnn_fpga_tpu_torch.ops.cuda.segment_sum import sorted_segment_sum

    return (iteration_pair, aggregate_pair, iteration_pair_bwd,
            aggregate_pair_bwd, gather_pair_bwd, spmm, sddmm, sddmm_dual,
            sorted_segment_sum)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset, by name: the
    wrappers of this module and :func:`~gnn_fpga_tpu_torch.ops.cuda.
    segment_sum.sorted_segment_sum`."""
    return {f.__name__: f.launches for f in _kernel_wrappers()}


def reset_launch_counts():
    for f in _kernel_wrappers():
        f.launches = 0
