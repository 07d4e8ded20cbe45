"""The collectives of the parallel paths, built from two primitives.

Every collective here is ``all_to_all_single`` or ``all_gather_into_tensor``
on a byte view of a contiguous tensor, so one code path serves NCCL and
gloo and any dtype:

- :meth:`Comm.all_to_all`: ``x`` is ``P`` blocks along dim 0; block ``q``
  goes to rank ``q``, and block ``q`` of the result came from rank ``q``
  (``jax.lax.all_to_all(..., tiled=True)``);
- :meth:`Comm.all_gather`: every rank's ``x``, stacked ``[P, ...]`` in
  rank order;
- :meth:`Comm.reduce_scatter`: an all_to_all, then the ``P`` blocks
  received summed in rank order (``jax.lax.psum_scatter``);
- :meth:`Comm.all_sum`: an all_gather, then summed in rank order
  (``jax.lax.psum``): the same bits on every rank.

The differentiable forms, whose backward is the adjoint collective:
:func:`all_to_all` (adjoint: all_to_all), :func:`all_gather_rows`
(adjoint: reduce-scatter) and :func:`reduce_scatter` (adjoint: all_gather).
A plain collective carries no gradient, and a missing adjoint would leave
the halo rows' gradients wrong.

Under gloo a CUDA tensor is passed as it is: gloo takes CUDA tensors for
both primitives and stages them through the host itself.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A flat uint8 view of a contiguous tensor (its memory, not a copy)."""
    return t.reshape(-1).view(torch.uint8)


class Comm:
    """The collectives over one process group (None: the default group).

    ``rank`` and ``size`` are this process's rank in the group and the
    group's size."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = dist.get_backend(group)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Tiled all_to_all of ``x`` (``P`` equal blocks along dim 0)."""
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(_bytes(out), _bytes(x), group=self.group)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[P, *x.shape]``: every rank's ``x`` in rank order."""
        x = x.contiguous()
        out = x.new_empty((self.size,) + tuple(x.shape))
        dist.all_gather_into_tensor(_bytes(out), _bytes(x),
                                    group=self.group)
        return out

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (``P`` blocks along dim 0) summed over the ranks, this
        rank's block: the blocks received summed in rank order."""
        n = x.shape[0] // self.size
        return self.all_to_all(x).reshape((self.size, n) +
                                          tuple(x.shape[1:])).sum(0)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks in rank order (identical bits on
        every rank)."""
        return self.all_gather(x).sum(0)

    def barrier(self) -> None:
        """Returns once every rank has reached it (the host waits)."""
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if self.backend == "nccl" else torch.device("cpu")
        self.all_sum(torch.zeros(1, device=dev)).item()


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_to_all(g), None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.all_gather(x).flatten(0, 1)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.reduce_scatter(g), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.reduce_scatter(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather(g).flatten(0, 1), None


def all_to_all(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Differentiable tiled all_to_all; its backward is the reverse
    all_to_all."""
    return _AllToAll.apply(x, comm)


def all_gather_rows(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Differentiable tiled all_gather, ``[P * n, ...]`` from ``[n, ...]``
    (``jax.lax.all_gather(..., tiled=True)``); its backward is a
    reduce-scatter."""
    return _AllGatherRows.apply(x, comm)


def reduce_scatter(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Differentiable reduce-scatter (:meth:`Comm.reduce_scatter`); its
    backward is an all_gather."""
    return _ReduceScatter.apply(x, comm)
