"""Consensus attention: the wrappers of the hand-written CUDA kernels
``csrc/consensus.cu`` (the forward) and ``csrc/consensus_bwd.cu`` (K6, dKV,
and K7, dQ).  The forward replaces both forward TPU kernels of
``glom_tpu/kernels/consensus_pallas.py``: ``_forward`` (K4, K/V resident)
and ``_forward_blocked`` (K5, K/V streamed, for n > 1024).  On Hopper K/V is
always streamed, so one kernel covers every n.  The kernels take d a
multiple of 128: up to 512 ``csrc/consensus_fwd.cuh``'s kernel, above it
``csrc/consensus_wide.cuh``'s design (the logits through a float32
workspace the wrapper allocates, :func:`workspace_floats`).  K6 and K7
replace ``_backward_flash``'s ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel`` at
the same widths: K6 above 512 is ``csrc/consensus_bwd_wide.cuh``'s design
(through a float32 workspace the wrapper allocates,
:func:`bwd_workspace_floats`).  K6 hands K7 the scaled logit gradient dS' it
forms, so K7 recomputes nothing.  The wrappers take any d: off a multiple of
128 they copy the levels (and dO) zero-padded to one (``_common.py``), pass
the model's width, whose ``d^-1/2`` scales the logits, to K4 and K6 (K7's
dS' carries it), and slice the results back.

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
from glom_tpu_torch.kernels._common import (DTYPE_CODES, check_width, count, fresh_copy, on_device,
                                            pad_last, padded_width, unpad, vector_aligned)
from glom_tpu_torch.ops import consensus as plain

_p, _i64, _i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# glom_consensus(levels, sb, sn, sl, mask, out, lse, ws, b, n, L, dim, width,
#                attend_self, splits, dtype, stream): csrc/consensus.cu
_ARGTYPES = [_p, _i64, _i64, _i64, _p, _p, _p, _p] + [_i32] * 8 + [_p]
# glom_consensus_bwd_dkv(levels, sb, sn, sl, go, lse, delta, mask, out, ds,
#                        ws, b, n, L, dim, width, attend_self, dtype, stream):
#                        csrc/consensus_bwd.cu
_DKV_ARGTYPES = [_p, _i64, _i64, _i64] + [_p] * 7 + [_i32] * 7 + [_p]
# glom_consensus_bwd_dq(levels, sb, sn, sl, ds, out, b, n, L, dim, dtype, stream)
_DQ_ARGTYPES = [_p, _i64, _i64, _i64, _p, _p, _i32, _i32, _i32, _i32, _i32, _p]


def _kernel():
    """The forward kernel's C entry point, built and loaded on first use."""
    return _build.function("consensus", "glom_consensus", _ARGTYPES)


def workspace_floats(b: int, n: int, L: int, d: int, splits: int, dtype) -> int:
    """The float32 elements of a forward call's workspace
    (``glom_consensus_workspace``): none with the narrow kernel (d <= 512)
    and one split; per split beyond one the unnormalized sums and a (max,
    sum) per row; above d=512 the wide design's logits, key scales,
    transposed keys and split sums (``csrc/consensus_wide.cuh``); ``d`` as
    the kernel runs it (padded)."""
    d = padded_width(d)
    floats = _build.function("consensus", "glom_consensus_workspace", [_i32] * 6,
                             ctypes.c_longlong)(b, n, L, d, splits, DTYPE_CODES[dtype])
    if floats < 0:
        raise RuntimeError(f"glom_consensus_workspace{(b, n, L, d, splits)} refused its arguments")
    return floats


def _bwd_kernel(symbol: str, argtypes):
    """A backward kernel's C entry point, built and loaded on first use."""
    return _build.function("consensus_bwd", symbol, argtypes)


def bwd_workspace_floats(b: int, n: int, L: int, d: int, dtype) -> int:
    """The float32 elements of a K6 call's workspace
    (``glom_consensus_bwd_workspace``): none up to d=512; above it the wide
    design's S, dP, their transposed products' operands, key scales,
    transposed keys, dV and dK (``csrc/consensus_bwd_wide.cuh``); ``d`` as
    the kernel runs it (padded)."""
    d = padded_width(d)
    floats = _build.function("consensus_bwd", "glom_consensus_bwd_workspace", [_i32] * 5,
                             ctypes.c_longlong)(b, n, L, d, DTYPE_CODES[dtype])
    if floats < 0:
        raise RuntimeError(f"glom_consensus_bwd_workspace{(b, n, L, d)} refused its arguments")
    return floats


def planned_splits(device: torch.device, b: int, n: int, L: int, d: int, dtype) -> int:
    """How many blocks share a query tile's keys on ``device``
    (``glom_consensus_splits``: the count that fills the card's SMs in the
    fewest steps), cached per shape; ``d`` as the kernel runs it (padded)."""
    with torch.cuda.device(device):
        return _build.plan("consensus", "glom_consensus_splits", torch.cuda.current_device(),
                           b, n, L, padded_width(d), DTYPE_CODES[dtype])


def _rows_aligned(levels: torch.Tensor) -> bool:
    """Every (b, i, l) row of ``levels`` on a 16-byte boundary; a dimension of
    size 1 is never stepped over."""
    per_vector = 16 // levels.element_size()
    return levels.data_ptr() % 16 == 0 and all(
        s % per_vector == 0 for s, size in zip(levels.stride()[:3], levels.shape[:3]) if size > 1)


def _check(levels: torch.Tensor, mask: Optional[torch.Tensor],
           kernel: str = "consensus kernel (K4)") -> None:
    """Raise on what ``kernel`` (K4, K6 or K7) does not take; any positive
    width (padded to a multiple of 128 by the wrappers)."""
    if levels.dim() != 4:
        raise ValueError(f"levels must be (b, n, L, d), got shape {tuple(levels.shape)}")
    if levels.dtype not in DTYPE_CODES:
        raise TypeError(f"consensus kernel takes float32 or bfloat16, got {levels.dtype}")
    b, n, L, d = levels.shape
    check_width(kernel, d)
    if levels.stride(3) != 1 and padded_width(d) == d:
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


def _kernel_levels(levels: torch.Tensor) -> torch.Tensor:
    """``levels`` as the kernels read them: zero-padded to a multiple of 128
    in a fresh contiguous copy where d is off one (every row then on the
    allocator's boundary), else copied only where its rows are off the
    kernels' 16-byte boundary."""
    d = levels.shape[-1]
    if padded_width(d) != d:
        return pad_last(levels, padded_width(d))
    # the kernels copy rows in 16-byte vectors; a fresh contiguous copy
    # starts on the allocator's boundary and, with d % 128 == 0, so does
    # every row
    return levels if _rows_aligned(levels) else fresh_copy(levels)


def _forward(levels, attend_self, non_local_mask, splits):
    if not on_device("consensus_attention", levels):
        return plain.consensus_attention(
            levels, attend_self=attend_self, non_local_mask=non_local_mask)
    _check(levels, non_local_mask)
    shape, width = levels.shape, levels.shape[-1]
    levels = _kernel_levels(levels)
    b, n, L, d = levels.shape
    out = torch.empty((b, n, L, d), dtype=levels.dtype, device=levels.device)
    lse = torch.empty((b, L, n, 1), dtype=torch.float32, device=levels.device)
    if b * n == 0:
        return unpad(out, shape), lse
    if splits is None:
        splits = planned_splits(levels.device, b, n, L, d, levels.dtype)
    elif splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    floats = workspace_floats(b, n, L, d, splits, levels.dtype)
    ws = torch.empty((floats,), dtype=torch.float32, device=levels.device) if floats else None
    fn = _kernel()
    with torch.cuda.device(levels.device):
        code = fn(
            levels.data_ptr(), levels.stride(0), levels.stride(1), levels.stride(2),
            None if non_local_mask is None else non_local_mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(), None if ws is None else ws.data_ptr(),
            b, n, L, d, width, int(bool(attend_self)), splits, DTYPE_CODES[levels.dtype],
            torch.cuda.current_stream(levels.device).cuda_stream,
        )
    _build.check("consensus", code)
    count(consensus_attention)
    return unpad(out, shape), lse


def _bwd_inputs(levels, dout, lse, delta, non_local_mask):
    """Check what K6 and K7 read and return ``(levels, dout)`` as they read
    them: zero-padded to a multiple of 128 in fresh storage where d is off
    one, else each copied into fresh storage where its rows are off the
    kernels' 16-byte ``cp.async`` boundary (as the forward does)."""
    _check(levels, non_local_mask, "consensus_dkv kernel (K6)")
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
    if padded_width(d) != d:
        return pad_last(levels, padded_width(d)), pad_last(dout, padded_width(d))
    if not vector_aligned(levels, *levels.stride()[:3], nbytes=16):
        levels = fresh_copy(levels)
    if not vector_aligned(dout, nbytes=16):
        dout = fresh_copy(dout)
    return levels, dout


def ds_shape(levels: torch.Tensor) -> tuple:
    """The shape of the dS' K6 hands K7 for ``levels`` (b, n, L, d):
    ``(b, L, n, n rounded up to 32)``, float32."""
    b, n, L, _ = levels.shape
    return (b, L, n, plain.ds_columns(n))


def _check_ds(levels, ds):
    if (tuple(ds.shape) != ds_shape(levels) or ds.dtype != torch.float32
            or ds.device != levels.device or not ds.is_contiguous() or ds.data_ptr() % 16):
        raise ValueError(f"ds must be {ds_shape(levels)} float32, contiguous and 16-byte "
                         f"aligned on {levels.device}, got {tuple(ds.shape)} {ds.dtype} on "
                         f"{ds.device}")


def _launch_dkv(levels, dout, lse, delta, attend_self, non_local_mask, ds, width):
    """K6 on checked inputs, for a model of width ``width`` (the levels'
    own, or less where they are zero-padded); stores dS' into ``ds`` unless
    it is None.  Its workspace (above d=512) lives only inside this call."""
    b, n, L, d = levels.shape
    out = torch.empty((b, n, L, d), dtype=levels.dtype, device=levels.device)
    floats = bwd_workspace_floats(b, n, L, d, levels.dtype)
    ws = torch.empty((floats,), dtype=torch.float32, device=levels.device) if floats else None
    with torch.cuda.device(levels.device):
        code = _bwd_kernel("glom_consensus_bwd_dkv", _DKV_ARGTYPES)(
            levels.data_ptr(), levels.stride(0), levels.stride(1), levels.stride(2),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            None if non_local_mask is None else non_local_mask.data_ptr(), out.data_ptr(),
            None if ds is None else ds.data_ptr(), None if ws is None else ws.data_ptr(),
            b, n, L, d, width, int(bool(attend_self)), DTYPE_CODES[levels.dtype],
            torch.cuda.current_stream(levels.device).cuda_stream)
    _build.check("consensus_bwd", code)
    return out


def _launch_dq(levels, ds):
    """K7 on checked inputs and K6's dS'."""
    b, n, L, d = levels.shape
    out = torch.empty((b, n, L, d), dtype=levels.dtype, device=levels.device)
    with torch.cuda.device(levels.device):
        code = _bwd_kernel("glom_consensus_bwd_dq", _DQ_ARGTYPES)(
            levels.data_ptr(), levels.stride(0), levels.stride(1), levels.stride(2),
            ds.data_ptr(), out.data_ptr(), b, n, L, d, DTYPE_CODES[levels.dtype],
            torch.cuda.current_stream(levels.device).cuda_stream)
    _build.check("consensus_bwd", code)
    return out


def consensus_dkv(levels, dout, lse, delta, *, attend_self=False, non_local_mask=None,
                  keep_ds=False):
    """K6: the gradient through the keys and values,
    ``normalize_vjp(dS^T Q scale) + P^T dO``, ``(b, n, L, d)`` in ``levels``'
    type.  ``dout`` (levels' type, contiguous), ``lse`` and ``delta``
    (``(b, L, n, 1)`` float32, contiguous).

    ``keep_ds``: also return the dS' K7 reads, ``(dkv, ds)``: ``dS'_ij =
    dS_ij kscale_j``, float32 :func:`ds_shape`, stored by the same launch
    (the plain :func:`~glom_tpu_torch.ops.consensus.consensus_ds` on the
    CPU)."""
    if not on_device("glom_consensus_bwd_dkv", levels):
        kw = dict(attend_self=attend_self, non_local_mask=non_local_mask)
        dkv = plain.consensus_dkv(levels, dout, lse, delta, **kw)
        return (dkv, plain.consensus_ds(levels, dout, lse, delta, **kw)) if keep_ds else dkv
    shape = levels.shape
    levels, dout = _bwd_inputs(levels, dout, lse, delta, non_local_mask)
    ds = (torch.empty(ds_shape(levels), dtype=torch.float32, device=levels.device)
          if keep_ds else None)
    if levels.shape[0] * levels.shape[1] == 0:
        out = torch.empty(shape, dtype=levels.dtype, device=levels.device)
        return (out, ds) if keep_ds else out
    out = unpad(_launch_dkv(levels, dout, lse, delta, attend_self, non_local_mask, ds, shape[-1]),
                shape)
    count(consensus_dkv)
    return (out, ds) if keep_ds else out


def consensus_dq(levels, dout, lse, delta, *, attend_self=False, non_local_mask=None, ds=None):
    """K7: the gradient through the queries, ``dS K scale``, as ``dS' V``
    on the ``ds`` that ``consensus_dkv(..., keep_ds=True)`` returned for the
    same arguments; K7 recomputes neither S nor dP, so on the card it raises
    without ``ds``.  On the CPU, with ``ds`` it is its plain twin on that
    dS' (:func:`~glom_tpu_torch.ops.consensus.consensus_dq_from_ds`), and
    without it the plain K7 on :func:`consensus_dkv`'s arguments."""
    if not on_device("glom_consensus_bwd_dq", levels):
        if ds is None:
            return plain.consensus_dq(levels, dout, lse, delta, attend_self=attend_self,
                                      non_local_mask=non_local_mask)
        _check_ds(levels, ds)
        return plain.consensus_dq_from_ds(levels, ds)
    if ds is None:
        raise ValueError("consensus_dq reads the dS' K6 stores: pass the ds of "
                         "consensus_dkv(levels, dout, lse, delta, keep_ds=True)")
    _check(levels, non_local_mask, "consensus_dq kernel (K7)")
    _check_ds(levels, ds)
    shape = levels.shape
    if padded_width(shape[-1]) != shape[-1]:
        levels = pad_last(levels, padded_width(shape[-1]))
    elif not vector_aligned(levels, *levels.stride()[:3], nbytes=16):
        levels = fresh_copy(levels)
    if levels.shape[0] * levels.shape[1] == 0:
        return torch.empty(shape, dtype=levels.dtype, device=levels.device)
    out = unpad(_launch_dq(levels, ds), shape)
    count(consensus_dq)
    return out


# The dS' workspace of consensus_backward is capped at this many bytes:
# above it, K6 and K7 run over views of levels holding fewer (b, l) pairs.
DS_CHUNK_BYTES = 256 << 20


def ds_chunks(b: int, n: int, L: int, limit: Optional[int] = None):
    """The ``(batch slice, level slice)`` views over which consensus_backward
    runs K6 and K7 so that each chunk's dS' stays within ``limit`` bytes
    (default :data:`DS_CHUNK_BYTES`): all of it where it fits, else whole
    batch rows, else levels of one batch row at a time."""
    limit = DS_CHUNK_BYTES if limit is None else limit
    pairs = max(1, limit // (4 * n * plain.ds_columns(n)))
    if pairs >= b * L:
        return [(slice(0, b), slice(0, L))]
    if pairs >= L:
        rows = pairs // L
        return [(slice(i, min(b, i + rows)), slice(0, L)) for i in range(0, b, rows)]
    return [(slice(i, i + 1), slice(j, min(L, j + pairs)))
            for i in range(b) for j in range(0, L, pairs)]


def consensus_backward(levels, non_local_mask, out, lse, g, *, attend_self=False):
    """dLevels of :func:`consensus_attention` at ``levels`` for the
    cotangent ``g`` of ``out``: ``delta = rowsum(dO * O)`` in float32 (a plain
    reduction, as ``consensus_pallas.py::_backward_flash`` leaves it to XLA),
    then K6, which hands K7 its dS', then K7, added in ``levels``' type.  The
    dS' (and above d=512 K6's workspace) lives only inside this call; where
    the dS' would pass :data:`DS_CHUNK_BYTES` the pair runs over views of
    ``levels`` (:func:`ds_chunks`), and the call still counts one launch of
    each."""
    do = g.to(levels.dtype).contiguous()
    delta = (do.float() * out.float()).sum(dim=-1).permute(0, 2, 1).unsqueeze(-1).contiguous()
    kw = dict(attend_self=attend_self, non_local_mask=non_local_mask)
    if not on_device("consensus_backward", levels):
        dkv, ds = consensus_dkv(levels, do, lse, delta, keep_ds=True, **kw)
        return (consensus_dq(levels, do, lse, delta, ds=ds, **kw) + dkv).to(levels.dtype)
    shape = levels.shape
    levels, do = _bwd_inputs(levels, do, lse, delta, non_local_mask)
    b, n, L, d = levels.shape
    dlevels = torch.empty((b, n, L, d), dtype=levels.dtype, device=levels.device)
    if b * n == 0:
        return unpad(dlevels, shape)
    for bs, ls in ds_chunks(b, n, L):
        lv = levels[bs, :, ls]
        ds = torch.empty(ds_shape(lv), dtype=torch.float32, device=levels.device)
        dkv = _launch_dkv(lv, do[bs, :, ls].contiguous(), lse[bs, ls].contiguous(),
                          delta[bs, ls].contiguous(), attend_self, non_local_mask, ds, shape[-1])
        dq = _launch_dq(lv, ds)
        del ds
        torch.add(dq, dkv, out=dlevels[bs, :, ls])
    count(consensus_dkv)
    count(consensus_dq)
    return unpad(dlevels, shape)


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
    unnormalized sums and row statistics (above d=512: its share of P V) to
    an f32 workspace and a second, elementwise kernel combines them in a
    fixed order; the call still counts as one launch.

    When autograd records the call, the gradient is K6 + K7
    (``flash_bwd=True``) or the plain VJP (``False``)."""
    if torch.is_grad_enabled() and levels.requires_grad:
        return _Consensus.apply(levels, non_local_mask, attend_self, splits, flash_bwd)
    return _forward(levels, attend_self, non_local_mask, splits)


consensus_attention.launches = 0
consensus_dkv.launches = 0
consensus_dq.launches = 0
