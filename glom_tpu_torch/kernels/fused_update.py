"""The fused level update: the wrapper of the hand-written CUDA kernels of
``csrc/fused_update.cu`` (K8), which replace the TPU kernel of
``glom_tpu/kernels/fused_update_pallas.py`` (``_forward``, body ``_kernel``).

One GLOM iteration,

    new[l] = (levels[l] + BU_l(stack[l]) + TD_l(levels[l+1] + pos)
              + consensus(levels)[l]) / div_l

with ``stack = [tokens, levels]``, no top-down term at the top level and
``div = [4, ..., 4, 3]``, in one call of the C entry ``glom_fused_update``,
which launches on the caller's stream: the top-down input ``levels[l+1] +
pos`` in float32; K8a, the hidden of both nets as one tiled product over
their 2L-1 groups (K1's tiles); the consensus term in float32 (K4's
kernel); and K8b, both nets' second layer and the whole update as one tiled
product, rounded once.  No concatenation, pad, sum or divide runs outside
them.  The hidden, the top-down input and the consensus term live in one
float32 workspace that the wrapper allocates for the call and frees.

:func:`fused_level_update` is the entry point.  Its plain PyTorch version is
:func:`plain_update`: :func:`reference_update`, the unfused composition (cat,
two grouped FFs, pad, consensus, divisors), on float32 copies of the inputs,
rounded once to the levels' type, as the TPU kernel computes in float32 and
rounds once at its store.  In float32 the two are the same function.  CPU
tensors take it, CUDA tensors take the kernels, and the wrapper raises on
anything they do not take; inputs whose rows lie off the 16-byte boundary
the kernels read them on are copied into fresh storage first, as
``glom_tpu``'s kernel takes any layout, and at widths off the kernels'
multiples (d of 128, h of 64) every input is copied zero-padded to them
(``_common.py``), the model's width passed for the consensus logits'
``d^-1/2``, and the update sliced back.  There is no fallback from the
kernels to the plain version.  ``fused_level_update.launches`` counts the
calls of the C entry, one a call.  A call whose K8b tiles leave the card
part-empty splits each tile's hidden over several blocks
(:func:`planned_splits`); their partial sums go through the workspace and
an ordered second kernel adds them.

The gradient, as in ``fused_update_pallas.py::_bwd``: K8 has no backward
kernel.  :class:`_FusedUpdate` saves the inputs and differentiates the
unfused composition (:func:`reference_update`, in the inputs' own type)
built from the port's own ``grouped_ff`` and ``consensus_attention``
wrappers, so on the card a backward runs K1 and K4 again and then K2, K3
(``ff_fused_bwd``), K6 and K7.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from glom_tpu_torch.kernels import _build
from glom_tpu_torch.kernels._common import (DTYPE_CODES, check_width, count, fresh_copy,
                                            kernels_take, on_device, pad_ff_params, pad_last,
                                            padded_hidden, padded_width, unpad, vector_aligned)
from glom_tpu_torch.kernels.consensus import consensus_attention
from glom_tpu_torch.kernels.consensus import planned_splits as planned_key_splits
from glom_tpu_torch.kernels.ff import grouped_ff
from glom_tpu_torch.ops import consensus as plain_consensus
from glom_tpu_torch.ops import feedforward as plain_ff

# glom_tpu's bound on the fused path (consensus_pallas._ONE_SHOT_MAX_N): its
# kernel keeps a whole K/V row on-chip.  K8 streams the keys and takes any n,
# but both packages choose the same path for the same config.
ONE_SHOT_MAX_N = 1024

# The most blocks that may share a K8b tile: csrc/fused_update.cu
MAX_SPLITS = 8

_FF_NAMES = ("w1", "b1", "w2", "b2")
_p, _i64, _i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# glom_fused_update(levels, sb, sn, sl, bottom, tsb, tsn, pos, psn, bw1, bb1,
#                   bw2, bb2, tw1, tb1, tw2, tb2, mask, out, ws, ws_floats, b,
#                   n, L, dim, width, hidden, attend_self, splits, cons_splits,
#                   dtype, stream): csrc/fused_update.cu
_ARGTYPES = ([_p, _i64, _i64, _i64, _p, _i64, _i64, _p, _i64] + [_p] * 11 + [_i64]
             + [_i32] * 10 + [_p])
# glom_fused_update_workspace(b, n, L, dim, hidden, splits, cons_splits)
_WS_ARGTYPES = [_i32] * 7


def _kernel():
    """The kernels' C entry point, built and loaded on first use."""
    return _build.function("fused_update", "glom_fused_update", _ARGTYPES)


def _workspace_floats(b: int, n: int, L: int, d: int, h: int, splits: int,
                      key_splits: int) -> int:
    """The float32 elements of a call's workspace
    (``glom_fused_update_workspace``): both nets' hidden, the top-down input,
    the consensus term and its lse, and the split workspaces; ``d`` and
    ``h`` as the kernels run them (padded)."""
    d, h = padded_width(d), padded_hidden(h)
    floats = _build.function("fused_update", "glom_fused_update_workspace", _WS_ARGTYPES,
                             ctypes.c_longlong)(b, n, L, d, h, splits, key_splits)
    if floats < 0:
        raise RuntimeError(f"glom_fused_update_workspace{(b, n, L, d, h, splits, key_splits)} "
                           "refused its arguments")
    return floats


def kernel_supports(dim: int, hidden: int) -> bool:
    """The widths K8's wrapper takes: any positive ``dim`` and ``hidden``
    (``_common.kernels_take``; off the kernels' multiples it pads), which its
    gradient's K1-K7 take too."""
    return kernels_take(dim) and hidden > 0


def supports_config(config, device=None) -> bool:
    """True when the fused level update can take this model shape on
    ``device`` (default: the CPU): ``glom_tpu``'s bound on n, and on a CUDA
    device positive widths (:func:`kernel_supports`: the wrapper pads any
    other to the kernels' multiples) in place of the TPU's VMEM envelope and
    lane alignment.  On the CPU, where the plain version runs, only the n
    bound applies, as in ``glom_tpu``'s interpret mode."""
    if config.num_patches > ONE_SHOT_MAX_N:
        return False
    if device is None or torch.device(device).type == "cpu":
        return True
    return kernel_supports(config.dim, config.dim * config.ff_mult)


def planned_splits(device: torch.device, b: int, n: int, L: int, d: int, h: int, dtype) -> int:
    """How many blocks share a K8b tile's hidden on ``device``
    (``glom_fused_update_splits``, K1b's rule), cached per shape; ``d`` and
    ``h`` as the kernels run them (padded)."""
    with torch.cuda.device(device):
        return _build.plan("fused_update", "glom_fused_update_splits", torch.cuda.current_device(),
                           b, n, L, padded_width(d), padded_hidden(h), DTYPE_CODES[dtype])


_DIVISORS: dict = {}
_divisors_lock = threading.Lock()


def update_divisors(levels_count: int, dtype, device=None) -> torch.Tensor:
    """``(L, 1)`` divisors [4, ..., 4, 3]: the top level has no top-down term.

    Built once per ``(L, dtype, device)`` and then reused: the forward runs
    no host-to-device copy, so a CUDA graph can capture it.  Made outside
    inference mode, so a tensor first asked for by a server can still be
    saved for a later backward."""
    key = (levels_count, dtype, torch.device("cpu" if device is None else device))
    divisors = _DIVISORS.get(key)
    if divisors is None:
        with _divisors_lock, torch.inference_mode(False):
            divisors = _DIVISORS.get(key)
            if divisors is None:
                host = torch.full((levels_count, 1), 4.0, dtype=torch.float32)
                host[-1] = 3.0
                divisors = _DIVISORS[key] = host.to(device=key[2], dtype=dtype)
    return divisors


def reference_update(bu, td, levels, bottom_level, pos_embs, non_local_mask=None, *,
                     attend_self: bool = False, ff_fn=None, consensus_fn=None) -> torch.Tensor:
    """The unfused composition of the same iteration, combined exactly like
    ``models/glom._update_step``, in the inputs' type: what the gradient of
    :class:`_FusedUpdate` differentiates, and, on float32 copies,
    :func:`plain_update`.  ``ff_fn`` and ``consensus_fn`` default to the
    plain ops; the backward of :class:`_FusedUpdate` passes the kernel
    wrappers instead, as ``fused_update_pallas.py::reference_update``
    composes the Pallas kernels."""
    ff_fn = ff_fn if ff_fn is not None else plain_ff.grouped_ff_apply
    consensus_fn = consensus_fn if consensus_fn is not None else plain_consensus.consensus_attention
    levels_with_input = torch.cat([bottom_level, levels], dim=-2)
    bu_out = ff_fn(bu, levels_with_input[..., :-1, :])
    td_out = ff_fn(td, levels_with_input[..., 2:, :] + pos_embs)
    td_out = F.pad(td_out, (0, 0, 0, 1))   # zero at the top level
    cons, _ = consensus_fn(levels, attend_self=attend_self, non_local_mask=non_local_mask)
    divisors = update_divisors(levels.shape[2], levels.dtype, levels.device)
    return (levels + bu_out + td_out + cons) / divisors


def plain_update(bu, td, levels, bottom_level, pos_embs, non_local_mask=None, *,
                 attend_self: bool = False) -> torch.Tensor:
    """What K8 computes, in plain PyTorch: :func:`reference_update` on float32
    copies of every input, rounded once to ``levels``' dtype
    (``fused_update_pallas.py::_kernel`` casts its inputs to float32 and its
    output back once).  In float32 it is :func:`reference_update` bit for bit;
    in bfloat16 the unfused composition rounds the ``pos`` sum and each term
    apart, and this function does not."""
    f32 = lambda tree: {k: v.float() for k, v in tree.items()}
    out = reference_update(f32(bu), f32(td), levels.float(), bottom_level.float(),
                           pos_embs.float(), non_local_mask, attend_self=attend_self)
    return out.to(levels.dtype)


def _rows_aligned(t: torch.Tensor) -> bool:
    """Whether the kernels read ``t`` (levels, bottom or pos) as it lies: every
    row on a 16-byte boundary (they copy rows in 16-byte pieces; a dimension
    of size 1 is never stepped over) and its (b, n) axes flattening to one
    row axis."""
    b, n = t.shape[:2]
    strides = [s for s, size in zip(t.stride()[:-1], t.shape[:-1]) if size > 1]
    flat = b == 1 or n == 1 or t.stride(0) == n * t.stride(1)
    return flat and vector_aligned(t, *strides, nbytes=16)


def _kernel_input(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels read it: itself, or a fresh copy when
    :func:`_rows_aligned` says no (``glom_tpu``'s kernel takes any layout)."""
    return t if _rows_aligned(t) else fresh_copy(t)


def _check(bu, td, levels, bottom, pos, mask) -> None:
    if levels.dim() != 4:
        raise ValueError(f"levels must be (b, n, L, d), got shape {tuple(levels.shape)}")
    if levels.dtype not in DTYPE_CODES:
        raise TypeError(f"fused_level_update kernel takes float32 or bfloat16, got {levels.dtype}")
    b, n, L, d = levels.shape
    h = bu["w1"].shape[-1]
    if L < 2:
        raise ValueError(f"fused_level_update needs at least 2 levels, got {L}")
    check_width("fused_level_update kernel (K8)", d)
    if not kernel_supports(d, h):
        raise ValueError(f"fused_level_update kernel (K8) needs a positive hidden width, got h={h}")
    padded = padded_width(d) != d or padded_hidden(h) != h
    if b * L > 65535:
        raise ValueError(f"fused_level_update kernel takes b * L <= 65535, got {b * L}")
    for name, t, shape in (("levels", levels, (b, n, L, d)), ("bottom_level", bottom, (b, n, 1, d)),
                           ("pos_embs", pos, (1, n, 1, d))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != levels.dtype or t.device != levels.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; the kernel needs levels' "
                            f"{levels.dtype} on {levels.device}")
        if t.stride(-1) != 1 and not padded:
            raise ValueError(f"{name}'s last dimension must be contiguous (strides {t.stride()})")
    for net, params, g in (("bottom_up", bu, L), ("top_down", td, L - 1)):
        shapes = {"w1": (g, d, h), "b1": (g, h), "w2": (g, h, d), "b2": (g, d)}
        for name, shape in shapes.items():
            p = params[name]
            if tuple(p.shape) != shape:
                raise ValueError(f"{net}/{name} must be {shape}, got {tuple(p.shape)}")
            if p.dtype != levels.dtype or p.device != levels.device:
                raise TypeError(f"{net}/{name} is {p.dtype} on {p.device}; the kernel needs "
                                f"levels' {levels.dtype} on {levels.device}")
            if padded:
                continue   # the kernels read a padded copy
            if not p.is_contiguous():
                raise ValueError(f"{net}/{name} must be contiguous")
            if name in ("w1", "w2") and p.data_ptr() % 16:
                raise ValueError(f"{net}/{name} must start on a 16-byte boundary")
    if mask is not None:
        if tuple(mask.shape) != (n, n):
            raise ValueError(f"non_local_mask must be ({n}, {n}), got {tuple(mask.shape)}")
        if mask.dtype not in (torch.bool, torch.int8):
            raise TypeError(f"non_local_mask must be bool or int8, got {mask.dtype}")
        if mask.device != levels.device or not mask.is_contiguous():
            raise ValueError("non_local_mask must be contiguous and on levels' device")


def _forward(bu, td, levels, bottom, pos, mask, attend_self, splits=None) -> torch.Tensor:
    if not on_device("fused_level_update", levels):
        return plain_update(bu, td, levels, bottom, pos, mask, attend_self=attend_self)
    _check(bu, td, levels, bottom, pos, mask)
    shape, width = levels.shape, levels.shape[-1]
    d, h = padded_width(width), padded_hidden(bu["w1"].shape[-1])
    if (d, h) != (width, bu["w1"].shape[-1]):
        bu, td = pad_ff_params(bu, d, h), pad_ff_params(td, d, h)
        levels, bottom, pos = (pad_last(t, d) for t in (levels, bottom, pos))
    else:
        levels, bottom, pos = (_kernel_input(t) for t in (levels, bottom, pos))
    b, n, L, _ = levels.shape
    out = torch.empty((b, n, L, d), dtype=levels.dtype, device=levels.device)
    if b * n == 0:
        return unpad(out, shape)
    if splits is None:
        splits = planned_splits(levels.device, b, n, L, d, h, levels.dtype)
    elif not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"splits must be 1 to {MAX_SPLITS}, got {splits}")
    key_splits = planned_key_splits(levels.device, b, n, L, d, levels.dtype)
    ws = torch.empty(_workspace_floats(b, n, L, d, h, splits, key_splits), dtype=torch.float32,
                     device=levels.device)
    fn = _kernel()
    with torch.cuda.device(levels.device):
        code = fn(
            levels.data_ptr(), levels.stride(0), levels.stride(1), levels.stride(2),
            bottom.data_ptr(), bottom.stride(0), bottom.stride(1),
            pos.data_ptr(), pos.stride(1),
            *(bu[k].data_ptr() for k in _FF_NAMES), *(td[k].data_ptr() for k in _FF_NAMES),
            None if mask is None else mask.data_ptr(), out.data_ptr(), ws.data_ptr(), ws.numel(),
            b, n, L, d, width, h, int(bool(attend_self)), splits, key_splits,
            DTYPE_CODES[levels.dtype], torch.cuda.current_stream(levels.device).cuda_stream,
        )
    _build.check("fused_update", code)
    count(fused_level_update)
    return unpad(out, shape)


class _FusedUpdate(torch.autograd.Function):
    """K8 forward; the backward differentiates the unfused composition of the
    kernel wrappers at the saved inputs (``fused_update_pallas.py::_bwd``)."""

    @staticmethod
    def forward(ctx, attend_self, ff_fused_bwd, mask, levels, bottom, pos, *weights):
        ctx.save_for_backward(levels, bottom, pos, *weights)
        ctx.mask, ctx.attend_self, ctx.ff_fused_bwd = mask, attend_self, ff_fused_bwd
        bu, td = dict(zip(_FF_NAMES, weights[:4])), dict(zip(_FF_NAMES, weights[4:]))
        return _forward(bu, td, levels, bottom, pos, mask, attend_self)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
            levels, bottom, pos = leaves[:3]
            bu, td = dict(zip(_FF_NAMES, leaves[3:7])), dict(zip(_FF_NAMES, leaves[7:]))
            out = reference_update(
                bu, td, levels, bottom, pos, ctx.mask, attend_self=ctx.attend_self,
                ff_fn=lambda p, x: grouped_ff(p, x, fused_bwd=ctx.ff_fused_bwd),
                consensus_fn=consensus_attention)
            wanted = [t for t, need in zip(leaves, needs) if need]
            grads = iter(torch.autograd.grad(out, wanted, g.to(out.dtype), allow_unused=True))
        return (None, None, None, *(next(grads) if need else None for need in needs))


def fused_level_update(
    bu_params: dict,
    td_params: dict,
    levels: torch.Tensor,
    bottom_level: torch.Tensor,
    pos_embs: torch.Tensor,
    *,
    attend_self: bool = False,
    non_local_mask: Optional[torch.Tensor] = None,
    ff_fused_bwd: bool = False,
    splits: Optional[int] = None,
) -> torch.Tensor:
    """One GLOM iteration through K8's kernels: drop-in for the body of
    ``models/glom._update_step`` (``levels`` ``(b, n, L, d)``,
    ``bottom_level`` ``(b, n, 1, d)``, ``pos_embs`` ``(1, n, 1, d)``,
    ``non_local_mask`` optional ``(n, n)`` bool or int8, nonzero = blocked).

    ``ff_fused_bwd`` mirrors ``GlomConfig.ff_fused_bwd``: it picks the
    grouped-FF backward (K2 + K3 or the plain VJP) that the gradient's
    unfused composition runs, so fused-path gradients are the unfused
    path's under the same config.

    ``splits`` (CUDA only, and only where autograd does not record the call):
    how many blocks share a K8b tile's hidden, 1 to 8; default
    :func:`planned_splits`."""
    weights = [bu_params[k] for k in _FF_NAMES] + [td_params[k] for k in _FF_NAMES]
    leaves = [levels, bottom_level, pos_embs] + weights
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        return _FusedUpdate.apply(attend_self, ff_fused_bwd, non_local_mask, *leaves)
    return _forward(bu_params, td_params, levels, bottom_level, pos_embs, non_local_mask,
                    attend_self, splits)


fused_level_update.launches = 0
