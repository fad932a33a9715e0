"""The collectives of the mesh path, and the autograd of each.

``glom_tpu`` differentiates ``ppermute``, ``psum``, ``all_gather`` and
``all_to_all`` inside ``shard_map``; ``torch.distributed``'s collectives have
no autograd.  Each one the port's mesh path runs is an
``autograd.Function`` here, with the transpose JAX gives it:

  * :func:`shift` -- a ring step: send to the rank ``offset`` ahead along the
    axis, receive from the one ``offset`` behind; its backward shifts the
    gradient the other way (``ppermute``'s transpose);
  * :func:`all_to_all` -- tiled: split one dimension across the axis,
    concatenate what arrives along another; its backward is the inverse
    exchange;
  * :func:`reduce_from` -- the sum of a partial result over the axis, whose
    cotangent is replicated: the backward passes it through (summing it, as
    ``torch.distributed.nn.functional.all_reduce`` does, would count it once
    per rank);
  * :func:`copy_to` -- the identity on a replicated input whose per-rank
    gradients are partial: the backward sums them over the axis;
  * :func:`gather_from` -- the all-gather of per-rank slices into the
    replicated whole; its backward takes this rank's slice of the replicated
    cotangent;
  * :func:`gather_sum` -- the all-gather of per-rank slices into a whole
    that each rank uses differently (each rank's loss reads all of it): its
    backward sums the ranks' cotangents, then takes this rank's slice.

The pipeline (``parallel/pipeline.py``) differentiates its schedule itself
and takes two more, with no autograd: :func:`raw_send_recv`, one link of a
chain along the axis (``glom_tpu``'s ``ppermute`` over the pairs
``(i, i + 1)``, where the first rank receives nothing), and
:func:`raw_broadcast`, one rank's tensor to every rank along the axis
(``glom_tpu``'s ``psum`` of a buffer that only its owner holds non-zero).

Each is the identity along an axis of one rank.  With the gloo backend a CUDA
tensor goes through a pinned host copy for every collective but
``all_reduce`` (gloo takes CUDA tensors for ``broadcast``, ``all_reduce``
and ``barrier`` only): two ranks sharing one card, which NCCL refuses, run
that way when their caller names gloo.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from glom_tpu_torch.parallel.mesh import AxisGroup


def _live(axis: Optional[AxisGroup]) -> bool:
    return axis is not None and axis.size > 1


def _staged(x: torch.Tensor, axis: AxisGroup) -> bool:
    """True when ``x`` must cross ``axis`` through a host copy."""
    return x.is_cuda and dist.get_backend(axis.group) == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host


def raw_all_reduce(x: torch.Tensor, axis: Optional[AxisGroup]) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, in a new tensor."""
    out = x.clone()
    if _live(axis):
        dist.all_reduce(out, group=axis.group)
    return out


def raw_all_gather(x: torch.Tensor, axis: Optional[AxisGroup], dim: int) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated along ``dim`` in axis
    order."""
    if not _live(axis):
        return x
    src = x.contiguous()
    staged = _staged(src, axis)
    if staged:
        src = _to_host(src)
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device, non_blocking=True) if staged else out


def raw_all_to_all(x: torch.Tensor, axis: Optional[AxisGroup], split_dim: int,
                   concat_dim: int) -> torch.Tensor:
    """``x`` split into ``axis.size`` chunks along ``split_dim``, chunk ``j``
    to rank ``j``; what arrives is concatenated along ``concat_dim`` in axis
    order (``jax.lax.all_to_all(..., tiled=True)``)."""
    if not _live(axis):
        return x
    size = axis.size
    if x.shape[split_dim] % size:
        raise ValueError(f"all_to_all: dimension {split_dim} of size {x.shape[split_dim]} "
                         f"does not split over {size} ranks")
    chunks = [c.contiguous() for c in torch.chunk(x, size, dim=split_dim)]
    staged = _staged(x, axis)
    if staged:
        chunks = [_to_host(c) for c in chunks]
    outs = [torch.empty_like(c) for c in chunks]
    if dist.get_backend(axis.group) == "gloo":
        # gloo has no alltoall in every release (2.11's lacks it): one send
        # and one receive a peer
        i = axis.index
        outs[i] = chunks[i]
        ops = [dist.P2POp(op, t, axis.ranks[j], group=axis.group)
               for j in range(size) if j != i
               for op, t in ((dist.isend, chunks[j]), (dist.irecv, outs[j]))]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    else:
        dist.all_to_all(outs, chunks, group=axis.group)
    out = torch.cat(outs, dim=concat_dim)
    return out.to(x.device, non_blocking=True) if staged else out


def raw_shift(x: torch.Tensor, axis: Optional[AxisGroup], offset: int) -> torch.Tensor:
    """Send ``x`` to the rank ``offset`` ahead along ``axis`` and return what
    the rank ``offset`` behind sent."""
    if not _live(axis) or offset % axis.size == 0:
        return x
    src = x.contiguous()
    staged = _staged(src, axis)
    if staged:
        src = _to_host(src)
    out = torch.empty_like(src)
    size, i = axis.size, axis.index
    ops = [dist.P2POp(dist.isend, src, axis.ranks[(i + offset) % size], group=axis.group),
           dist.P2POp(dist.irecv, out, axis.ranks[(i - offset) % size], group=axis.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(x.device, non_blocking=True) if staged else out


def raw_send_recv(x: Optional[torch.Tensor], axis: AxisGroup, *, send_to: Optional[int] = None,
                  recv_from: Optional[int] = None,
                  like: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """Send ``x`` to the rank at index ``send_to`` along ``axis`` and receive
    from the one at ``recv_from`` a tensor of ``like``'s shape, dtype and
    device, as one batch of point-to-point operations; either may be None.
    Returns what arrived (None when nothing was received).  Every send must
    meet its peer's receive in the same call."""
    if send_to is None and recv_from is None:
        return None
    ops, out = [], None
    staged = _staged(x if x is not None else like, axis)
    if send_to is not None:
        src = x.contiguous()
        src = _to_host(src) if staged else src
        ops.append(dist.P2POp(dist.isend, src, axis.ranks[send_to], group=axis.group))
    if recv_from is not None:
        out = torch.empty(like.shape, dtype=like.dtype, pin_memory=True) if staged else \
            torch.empty(like.shape, dtype=like.dtype, device=like.device)
        ops.append(dist.P2POp(dist.irecv, out, axis.ranks[recv_from], group=axis.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if out is None or not staged:
        return out
    return out.to(like.device, non_blocking=True)


def raw_broadcast(x: torch.Tensor, axis: Optional[AxisGroup], owner: int) -> torch.Tensor:
    """The owner's ``x`` (the rank at index ``owner`` along ``axis``) written
    into ``x`` on every rank along it; each rank passes a contiguous tensor
    of the owner's shape and dtype.  gloo takes CUDA tensors here."""
    if _live(axis):
        dist.broadcast(x, src=axis.ranks[owner], group=axis.group)
    return x


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, offset):
        ctx.axis, ctx.offset = axis, offset
        return raw_shift(x, axis, offset)

    @staticmethod
    def backward(ctx, g):
        return raw_shift(g, ctx.axis, -ctx.offset), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.axis, ctx.dims = axis, (split_dim, concat_dim)
        return raw_all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return raw_all_to_all(g, ctx.axis, concat_dim, split_dim), None, None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return raw_all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return raw_all_reduce(g, ctx.axis), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.width = axis, dim, x.shape[dim]
        return raw_all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        i, w = ctx.axis.index, ctx.width
        return g.narrow(ctx.dim, i * w, w), None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.width = axis, dim, x.shape[dim]
        return raw_all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        i, w = ctx.axis.index, ctx.width
        return raw_all_reduce(g, ctx.axis).narrow(ctx.dim, i * w, w), None, None


def shift(x: torch.Tensor, axis: Optional[AxisGroup], offset: int) -> torch.Tensor:
    return _Shift.apply(x, axis, offset) if _live(axis) else x


def all_to_all(x: torch.Tensor, axis: Optional[AxisGroup], split_dim: int,
               concat_dim: int) -> torch.Tensor:
    return _AllToAll.apply(x, axis, split_dim, concat_dim) if _live(axis) else x


def reduce_from(x: torch.Tensor, axis: Optional[AxisGroup]) -> torch.Tensor:
    return _ReduceFrom.apply(x, axis) if _live(axis) else x


def copy_to(x: torch.Tensor, axis: Optional[AxisGroup]) -> torch.Tensor:
    return _CopyTo.apply(x, axis) if _live(axis) else x


def gather_from(x: torch.Tensor, axis: Optional[AxisGroup], dim: int) -> torch.Tensor:
    return _GatherFrom.apply(x, axis, dim % x.dim()) if _live(axis) else x


def gather_sum(x: torch.Tensor, axis: Optional[AxisGroup], dim: int) -> torch.Tensor:
    return _GatherSum.apply(x, axis, dim % x.dim()) if _live(axis) else x
