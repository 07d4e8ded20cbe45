"""One buffer a batch: the layout that places a batch's tensors in one flat
allocation, and the tree of views over it.

A packed event with its plans is some twenty tensors.  Copied one tensor
at a time, each copy is a call from Python (and a release of the
interpreter lock that a prefetching thread shares with the consumer).  A
:class:`Layout` places every tensor of a batch's :func:`signature` at an
offset of one flat byte buffer, each offset a multiple of :data:`ALIGN`
(512 bytes, the alignment the caching allocator gives a tensor of its
own, so the kernels see the alignment they saw), and builds the batch's
tree over such a buffer: the same classes and host fields, each tensor a
view of its dtype and shape.  Layouts are cached by signature.

A :class:`Staged` buffer is one such buffer with its view tree, built
once and filled batch after batch with one batched copy
(``torch._foreach_copy_``).  The tree records that it is staged
(:func:`staged_in`), so :func:`signature` reads it from the layout
without a walk, and a :class:`~gnn_fpga_tpu_torch.core.capture.
CapturedCall` loads it into its own buffer of the same layout with one
copy.  :meth:`Staged.held` says whether anything outside the owner still
references the buffer, which is when its owner may not fill it again.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from gnn_fpga_tpu_torch.core.graph import TensorFields

ALIGN = 512

_FIELDS: dict = {}          # a TensorFields class -> its field names
_LAYOUTS: dict = {}         # signature -> Layout
_MARK = "_staged_in"        # the attribute a staged tree carries


def _names(cls) -> tuple:
    names = _FIELDS.get(cls)
    if names is None:
        names = _FIELDS[cls] = tuple(f.name for f in dataclasses.fields(cls))
    return names


def _walk(v, out: list):
    if isinstance(v, torch.Tensor):
        out.append(v)
        return (tuple(v.shape), v.dtype)
    if isinstance(v, TensorFields):
        return (type(v).__name__,) + tuple(
            (name, _walk(getattr(v, name), out)) for name in _names(type(v)))
    return v


def flatten(batch) -> tuple:
    """``(signature(batch), its tensors in field order)`` in one walk of
    the tree (the order of :meth:`TensorFields.tensors`)."""
    tensors: list = []
    return _walk(batch, tensors), tensors


def signature(batch) -> tuple:
    """The static signature of a batch (a tensor or a
    :class:`~gnn_fpga_tpu_torch.core.graph.TensorFields` tree such as a
    :class:`~gnn_fpga_tpu_torch.core.graph.Graph` with its plans or
    blocks): every tensor's shape and dtype, and every host field (the
    plans' node, edge, item and slot counts), by field.  Batches of one
    signature can share one captured program; the device is not part of
    it (a host batch is copied straight into the buffers).  A staged tree
    gives its layout's signature without a walk."""
    mark = staged_in(batch)
    if mark is not None:
        return mark[0].signature
    return _walk(batch, [])


def staged_in(batch):
    """``(layout, buffer)`` where ``batch`` is the view tree of a
    :class:`Staged` buffer, else None.  Trees derived from it (a field
    replaced, a slice) are not staged."""
    return getattr(batch, _MARK, None)


def _skeleton(v, specs: list):
    """``v``'s tree with each tensor replaced by its index in ``specs``
    (where its shape and dtype go)."""
    if isinstance(v, torch.Tensor):
        specs.append((tuple(v.shape), v.dtype))
        return len(specs) - 1
    host, kids = {}, []
    for name in _names(type(v)):
        f = getattr(v, name)
        if isinstance(f, (torch.Tensor, TensorFields)):
            kids.append((name, _skeleton(f, specs)))
        else:
            host[name] = f
    return type(v), host, tuple(kids)


def _build(skel, flat: list, nodes: list):
    if isinstance(skel, int):
        return flat[skel]
    cls, host, kids = skel
    node = cls(**host, **{name: _build(k, flat, nodes) for name, k in kids})
    nodes.append(node)
    return node


class Layout:
    """Where each tensor of one signature lives in a flat byte buffer.

    ``offsets[i]`` is the byte offset of the ``i``-th tensor (field order),
    a multiple of :data:`ALIGN`; ``nbytes`` the buffer's size (each
    tensor's bytes rounded up to :data:`ALIGN`).  Both depend on the
    signature alone.  Use :func:`layout`, which caches one a signature."""

    def __init__(self, sig: tuple, batch):
        self.signature = sig
        self.specs: list = []
        self._skeleton = _skeleton(batch, self.specs)
        offsets, end = [], 0
        for shape, dtype in self.specs:
            offsets.append(end)
            n = dtype.itemsize
            for s in shape:
                n *= s
            end += -(-n // ALIGN) * ALIGN
        self.offsets, self.nbytes = tuple(offsets), end

    def buffer(self, device, pin_memory: bool = False) -> torch.Tensor:
        """A zeroed byte buffer of this layout on ``device``."""
        return torch.zeros(self.nbytes, dtype=torch.uint8, device=device,
                           pin_memory=pin_memory)

    def flat_views(self, buffer: torch.Tensor) -> list:
        """The tensors' views over ``buffer``, in field order."""
        out = []
        for (shape, dtype), o in zip(self.specs, self.offsets):
            n = dtype.itemsize
            for s in shape:
                n *= s
            out.append(buffer[o:o + n].view(dtype).view(shape))
        return out

    def views(self, buffer: torch.Tensor) -> tuple:
        """``(tree, tensors, nodes)``: the batch's tree over ``buffer``,
        its tensors in field order, and its tree nodes (the tree last)."""
        flat, nodes = self.flat_views(buffer), []
        return _build(self._skeleton, flat, nodes), flat, nodes


def layout(batch, sig=None) -> Layout:
    """The :class:`Layout` of ``batch``'s signature (``sig`` where the
    caller has it), built from ``batch`` the first time."""
    if sig is None:
        sig = signature(batch)
    found = _LAYOUTS.get(sig)
    if found is None:
        found = _LAYOUTS.setdefault(sig, Layout(sig, batch))
    return found


def _use_count(storage) -> int:
    return torch._C._storage_Use_Count(storage._cdata)


class Staged:
    """A zeroed byte buffer of ``layout`` on ``device`` with its view tree,
    built once.

    ``tree`` is the batch's tree over ``buffer`` and ``tensors`` its
    tensors in field order, the destinations of one batched copy.  The
    tree carries the mark that :func:`staged_in` reads."""

    def __init__(self, layout: Layout, device):
        self.layout = layout
        self.buffer = layout.buffer(device)
        self.tree, self.tensors, nodes = layout.views(self.buffer)
        self._mark = (layout, self.buffer)
        object.__setattr__(self.tree, _MARK, self._mark)
        self._storage = self.buffer.untyped_storage()
        self._objects = nodes + self.tensors + [self.buffer, self._mark]
        del nodes          # the counts below are this object's alone
        self._base = self._counts()

    def _counts(self) -> list:
        return ([sys.getrefcount(o) for o in self._objects]
                + [t._use_count() for t in self.tensors]
                + [_use_count(self._storage)])

    def held(self) -> bool:
        """Whether anything outside this object references the buffer: a
        node of the tree, one of its tensors, the buffer or the tree's
        mark (a reference from Python), one of its tensors kept by native
        code (autograd's saved tensors), or any other view of its
        memory."""
        return self._counts() != self._base
