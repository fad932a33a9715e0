"""Consensus attention: the wrappers of the hand-written CUDA kernels
``csrc/consensus.cu`` (the forward) and ``csrc/consensus_bwd.cu`` (K6, dKV,
and K7, dQ).  The forward replaces both forward TPU kernels of
``glom_tpu/kernels/consensus_pallas.py``: ``_forward`` (K4, K/V resident)
and ``_forward_blocked`` (K5, K/V streamed, for n > 1024).  On Hopper K/V is
always streamed, so one kernel covers every n.  K6 and K7 replace
``_backward_flash``'s ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``.

:func:`consensus_attention` is the forward.  Under autograd it runs inside a
``torch.autograd.Function`` that saves ``(levels, mask, out, lse)``, as
``consensus_pallas.py::_fwd`` does, and, with ``flash_bwd=True``,
differentiates through K6 and K7; with ``flash_bwd=False`` its backward is
the plain VJP of :func:`~glom_tpu_torch.ops.consensus.consensus_attention`,
as ``consensus_pallas.py::_bwd`` chooses.

Each wrapper takes CPU tensors to its kernel's plain version
(``glom_tpu_torch.ops.consensus``) and CUDA tensors to the kernel, and
raises on anything the kernel does not take.  There is no fallback from a
kernel to its plain version.  ``consensus_attention.launches``,
``consensus_dkv.launches`` and ``consensus_dq.launches`` count the kernels'
launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from glom_tpu_torch.kernels import _build
from glom_tpu_torch.kernels._common import (DTYPE_CODES, MAX_DIM, count, fresh_copy, on_device,
                                            vector_aligned)
from glom_tpu_torch.ops import consensus as plain

_p, _i64, _i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# glom_consensus(levels, sb, sn, sl, mask, out, lse, ws, b, n, L, dim,
#                attend_self, splits, dtype, stream): csrc/consensus.cu
_ARGTYPES = [_p, _i64, _i64, _i64, _p, _p, _p, _p, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _p]
# glom_consensus_bwd_{dkv,dq}(levels, sb, sn, sl, go, lse, delta, mask, out,
#                             b, n, L, dim, attend_self, dtype, stream): csrc/consensus_bwd.cu
_BWD_ARGTYPES = [_p, _i64, _i64, _i64, _p, _p, _p, _p, _p, _i32, _i32, _i32, _i32, _i32, _i32, _p]


def _kernel():
    """The forward kernel's C entry point, built and loaded on first use."""
    return _build.function("consensus", "glom_consensus", _ARGTYPES)


def _bwd_kernel(symbol: str):
    """A backward kernel's C entry point, built and loaded on first use."""
    return _build.function("consensus_bwd", symbol, _BWD_ARGTYPES)


def planned_splits(device: torch.device, b: int, n: int, L: int, d: int, dtype) -> int:
    """How many blocks share a query tile's keys on ``device``
    (``glom_consensus_splits``: the count that fills the card's SMs in the
    fewest steps), cached per shape."""
    with torch.cuda.device(device):
        return _build.plan("consensus", "glom_consensus_splits", torch.cuda.current_device(),
                           b, n, L, d, DTYPE_CODES[dtype])


def _rows_aligned(levels: torch.Tensor) -> bool:
    """Every (b, i, l) row of ``levels`` on a 16-byte boundary; a dimension of
    size 1 is never stepped over."""
    per_vector = 16 // levels.element_size()
    return levels.data_ptr() % 16 == 0 and all(
        s % per_vector == 0 for s, size in zip(levels.stride()[:3], levels.shape[:3]) if size > 1)


def _check(levels: torch.Tensor, mask: Optional[torch.Tensor]) -> None:
    if levels.dim() != 4:
        raise ValueError(f"levels must be (b, n, L, d), got shape {tuple(levels.shape)}")
    if levels.dtype not in DTYPE_CODES:
        raise TypeError(f"consensus kernel takes float32 or bfloat16, got {levels.dtype}")
    b, n, L, d = levels.shape
    if d % 128 != 0 or d > MAX_DIM:
        raise ValueError(f"consensus kernel needs d a multiple of 128 and <= {MAX_DIM}, got {d}")
    if levels.stride(3) != 1:
        raise ValueError("levels' last dimension must be contiguous")
    if b * L > 65535:
        raise ValueError(f"consensus kernel takes b * L <= 65535, got {b * L}")
    if mask is not None:
        if tuple(mask.shape) != (n, n):
            raise ValueError(f"non_local_mask must be ({n}, {n}), got {tuple(mask.shape)}")
        if mask.dtype not in (torch.bool, torch.int8):
            raise TypeError(f"non_local_mask must be bool or int8, got {mask.dtype}")
        if mask.device != levels.device or not mask.is_contiguous():
            raise ValueError("non_local_mask must be contiguous and on levels' device")


def _forward(levels, attend_self, non_local_mask, splits):
    if not on_device("consensus_attention", levels):
        return plain.consensus_attention(
            levels, attend_self=attend_self, non_local_mask=non_local_mask)
    _check(levels, non_local_mask)
    if not _rows_aligned(levels):
        # the kernel copies rows in 16-byte vectors; a fresh contiguous copy
        # starts on the allocator's boundary and, with d % 128 == 0, so does
        # every row
        levels = fresh_copy(levels)
    b, n, L, d = levels.shape
    out = torch.empty((b, n, L, d), dtype=levels.dtype, device=levels.device)
    lse = torch.empty((b, L, n, 1), dtype=torch.float32, device=levels.device)
    if b * n == 0:
        return out, lse
    if splits is None:
        splits = planned_splits(levels.device, b, n, L, d, levels.dtype)
    elif splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    # per split: the unnormalized (b, n, L, d) sums and a (max, sum) per row
    ws = (torch.empty((splits, b * n * L * (d + 2)), dtype=torch.float32, device=levels.device)
          if splits > 1 else None)
    fn = _kernel()
    with torch.cuda.device(levels.device):
        code = fn(
            levels.data_ptr(), levels.stride(0), levels.stride(1), levels.stride(2),
            None if non_local_mask is None else non_local_mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(), None if ws is None else ws.data_ptr(),
            b, n, L, d, int(bool(attend_self)), splits, DTYPE_CODES[levels.dtype],
            torch.cuda.current_stream(levels.device).cuda_stream,
        )
    _build.check("consensus", code)
    count(consensus_attention)
    return out, lse


def _backward_kernel(wrapper, fn, symbol, levels, dout, lse, delta, attend_self, non_local_mask):
    """Launch K6 or K7 (``symbol``, counted on ``wrapper``) or, on the CPU,
    its plain version ``fn``."""
    if not on_device(symbol, levels):
        return fn(levels, dout, lse, delta, attend_self=attend_self,
                  non_local_mask=non_local_mask)
    _check(levels, non_local_mask)
    b, n, L, d = levels.shape
    want = {"dout": ((b, n, L, d), levels.dtype), "lse": ((b, L, n, 1), torch.float32),
            "delta": ((b, L, n, 1), torch.float32)}
    for name, t in (("dout", dout), ("lse", lse), ("delta", delta)):
        shape, dtype = want[name]
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != levels.device:
            raise ValueError(f"{name} must be {shape} {dtype} on {levels.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # the kernels read rows as 4-element vectors: rows off that boundary are
    # copied into fresh storage first, as the forward does
    if not vector_aligned(levels, *levels.stride()[:3]):
        levels = fresh_copy(levels)
    if not vector_aligned(dout):
        dout = fresh_copy(dout)
    out = torch.empty((b, n, L, d), dtype=levels.dtype, device=levels.device)
    if b * n == 0:
        return out
    with torch.cuda.device(levels.device):
        code = _bwd_kernel(symbol)(
            levels.data_ptr(), levels.stride(0), levels.stride(1), levels.stride(2),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            None if non_local_mask is None else non_local_mask.data_ptr(), out.data_ptr(),
            b, n, L, d, int(bool(attend_self)), DTYPE_CODES[levels.dtype],
            torch.cuda.current_stream(levels.device).cuda_stream,
        )
    _build.check("consensus_bwd", code)
    count(wrapper)
    return out


def consensus_dkv(levels, dout, lse, delta, *, attend_self=False, non_local_mask=None):
    """K6: the gradient through the keys and values,
    ``normalize_vjp(dS^T Q scale) + P^T dO``, ``(b, n, L, d)`` in ``levels``'
    type.  ``dout`` (levels' type, contiguous), ``lse`` and ``delta``
    (``(b, L, n, 1)`` float32, contiguous)."""
    return _backward_kernel(consensus_dkv, plain.consensus_dkv, "glom_consensus_bwd_dkv",
                            levels, dout, lse, delta, attend_self, non_local_mask)


def consensus_dq(levels, dout, lse, delta, *, attend_self=False, non_local_mask=None):
    """K7: the gradient through the queries, ``dS K scale``; arguments as
    :func:`consensus_dkv`'s."""
    return _backward_kernel(consensus_dq, plain.consensus_dq, "glom_consensus_bwd_dq",
                            levels, dout, lse, delta, attend_self, non_local_mask)


def consensus_backward(levels, non_local_mask, out, lse, g, *, attend_self=False):
    """dLevels of :func:`consensus_attention` at ``levels`` for the
    cotangent ``g`` of ``out``: ``delta = rowsum(dO * O)`` in float32 (a plain
    reduction, as ``consensus_pallas.py::_backward_flash`` leaves it to XLA),
    then K7 + K6, added in ``levels``' type."""
    do = g.to(levels.dtype).contiguous()
    delta = (do.float() * out.float()).sum(dim=-1).permute(0, 2, 1).unsqueeze(-1).contiguous()
    kw = dict(attend_self=attend_self, non_local_mask=non_local_mask)
    dq = consensus_dq(levels, do, lse, delta, **kw)
    dkv = consensus_dkv(levels, do, lse, delta, **kw)
    return (dq + dkv).to(levels.dtype)


def plain_vjp(levels, non_local_mask, g, *, attend_self=False):
    """dLevels by autograd through the plain
    :func:`~glom_tpu_torch.ops.consensus.consensus_attention`: the
    ``flash_bwd=False`` backward (``consensus_pallas.py::_bwd``'s dense VJP)."""
    with torch.enable_grad():
        x = levels.detach().requires_grad_(True)
        out, _ = plain.consensus_attention(x, attend_self=attend_self,
                                           non_local_mask=non_local_mask)
        (dx,) = torch.autograd.grad(out, [x], g.to(out.dtype))
    return dx


class _Consensus(torch.autograd.Function):
    """The forward kernel; K6 + K7 (``flash_bwd``) or the plain VJP backward.
    ``lse`` is an output without a gradient."""

    @staticmethod
    def forward(ctx, levels, non_local_mask, attend_self, splits, flash_bwd):
        out, lse = _forward(levels, attend_self, non_local_mask, splits)
        ctx.save_for_backward(levels, non_local_mask, out, lse)
        ctx.attend_self, ctx.flash_bwd = attend_self, flash_bwd
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        levels, mask, out, lse = ctx.saved_tensors
        if ctx.flash_bwd:
            dlevels = consensus_backward(levels, mask, out, lse, g, attend_self=ctx.attend_self)
        else:
            dlevels = plain_vjp(levels, mask, g, attend_self=ctx.attend_self)
        return dlevels, None, None, None, None


def consensus_attention(
    levels: torch.Tensor,
    *,
    attend_self: bool = False,
    non_local_mask: Optional[torch.Tensor] = None,
    splits: Optional[int] = None,
    flash_bwd: bool = True,
):
    """``(b, n, L, d) -> (out (b, n, L, d), lse (b, L, n, 1) float32)``.
    ``non_local_mask``: optional ``(n, n)`` bool or int8, nonzero = blocked.

    ``splits`` (CUDA only): how many blocks share a query tile's keys
    (default: :func:`planned_splits`).  With more than one, each writes its
    unnormalized sums and row statistics to an f32 workspace and a second,
    elementwise kernel combines them in a fixed order; the call still
    counts as one launch.

    When autograd records the call, the gradient is K6 + K7
    (``flash_bwd=True``) or the plain VJP (``False``)."""
    if torch.is_grad_enabled() and levels.requires_grad:
        return _Consensus.apply(levels, non_local_mask, attend_self, splits, flash_bwd)
    return _forward(levels, attend_self, non_local_mask, splits)


consensus_attention.launches = 0
consensus_dkv.launches = 0
consensus_dq.launches = 0
