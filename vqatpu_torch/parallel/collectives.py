"""Collectives over one axis of the device mesh, and Megatron's conjugate
operators as autograd functions.

:class:`Group` runs a collective over one process group.  It chooses the
collective by the group's backend, explicitly: under NCCL it calls
``all_gather_into_tensor`` and ``reduce_scatter_tensor``; under gloo, which
with CUDA tensors is only certain to run ``all_reduce`` and ``broadcast``,
it builds the gather from a zero-padded ``all_reduce`` (every other rank's
slot adds exact zeros) and the reduce-scatter from an ``all_reduce`` and a
slice.  Under gloo, float16 and bfloat16 tensors are reduced in float32.
A group of one process runs no collective at all.

The operators of the tensor-parallel region (``tp > 1``):

- :func:`copy_to` (Megatron's *f*): identity forward, all-reduce backward.
  A replicated tensor enters a region whose ranks each use a part of it
  (a column-split layer, the rank-split attention): each rank's gradient
  is a partial sum.
- :func:`reduce_from` (*g*): all-reduce forward, identity backward.  The
  partial sums of a row-split layer, or the partial attention logits over
  a rank shard, become the replicated whole; every rank then holds the
  whole gradient.
- :func:`all_reduce_both`: all-reduce both ways, for a sum whose every rank
  keeps using its own part afterwards (the squared norm of a column-split
  weight).
- :func:`gather_from`: all-gather forward along ``dim``, the rank's slice
  of the gradient backward (the vocab-split classifier's logits).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

_NARROW = (torch.float16, torch.bfloat16)


class Group:
    """A process group over ``ranks`` (global ranks, in mesh order); this
    process is ``ranks[index]``.  ``pg`` None with one rank: every
    collective is the identity."""

    def __init__(self, pg, ranks: Sequence[int], rank: int,
                 backend: Optional[str]):
        self.pg = pg
        self.ranks = tuple(ranks)
        self.size = len(self.ranks)
        self.index = self.ranks.index(rank)
        self.backend = backend

    def __repr__(self) -> str:
        return f"Group({self.backend}, ranks={self.ranks}, index={self.index})"

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the group, in place; returns ``t``."""
        if self.size == 1:
            return t
        if self.backend == "gloo" and t.dtype in _NARROW:
            wide = t.float()
            dist.all_reduce(wide, group=self.pg)
            return t.copy_(wide)
        dist.all_reduce(t, group=self.pg)
        return t

    def broadcast(self, t: torch.Tensor, src_index: int = 0) -> torch.Tensor:
        """``t`` of the group's ``src_index``-th rank, in place."""
        if self.size > 1:
            dist.broadcast(t, self.ranks[src_index], group=self.pg)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim``, in rank order."""
        if self.size == 1:
            return t
        t = t.contiguous()
        if self.backend == "nccl":
            out = torch.empty((self.size,) + tuple(t.shape), dtype=t.dtype,
                              device=t.device)
            dist.all_gather_into_tensor(out, t, group=self.pg)
        else:
            out = torch.zeros((self.size,) + tuple(t.shape), dtype=t.dtype,
                              device=t.device)
            out[self.index] = t
            self.all_reduce(out)
        return torch.cat(out.unbind(0), dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's ``1/size`` slice along ``dim`` of the group's sum of
        ``t`` (``t.shape[dim]`` divisible by the size)."""
        if self.size == 1:
            return t
        n = t.shape[dim]
        if n % self.size:
            raise ValueError(f"reduce_scatter: dim {dim} of {n} rows does "
                             f"not split over {self.size} ranks")
        if self.backend == "nccl":
            src = t.movedim(dim, 0).contiguous()
            out = torch.empty((n // self.size,) + tuple(src.shape[1:]),
                              dtype=t.dtype, device=t.device)
            dist.reduce_scatter_tensor(out, src, group=self.pg)
            return out.movedim(0, dim)
        summed = self.all_reduce(t.clone())
        return summed.chunk(self.size, dim)[self.index].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.clone()), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        part = g.chunk(ctx.group.size, ctx.dim)[ctx.group.index]
        return part.contiguous(), None, None


def copy_to(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    return x if group is None or group.size == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    return (x if group is None or group.size == 1
            else _ReduceFrom.apply(x, group))


def all_reduce_both(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    return copy_to(reduce_from(x, group), group)


def gather_from(x: torch.Tensor, group: Optional[Group],
                dim: int = -1) -> torch.Tensor:
    if group is None or group.size == 1:
        return x
    return _GatherFrom.apply(x, group, dim % x.dim())
