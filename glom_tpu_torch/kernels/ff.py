"""Grouped feed-forward: the wrappers of the hand-written CUDA kernels
``csrc/grouped_ff.cu`` (K1, the forward) and ``csrc/grouped_ff_bwd.cu`` (K2,
dX, and K3, dW), which replace the TPU kernels of
``glom_tpu/kernels/ff_pallas.py``: ``_forward``, and ``_backward_fused``'s
``_bwd_dx_kernel`` and ``_bwd_dw_kernel``.

:func:`grouped_ff` is the forward: K1a forms the hidden ``gelu(x W1 + b1)``
in a float32 ``(g, rows, h)`` buffer that the wrapper allocates, and K1b
multiplies it by W2; the buffer is freed when the call returns and never
saved for autograd.  Under autograd it runs inside a
``torch.autograd.Function`` that saves ``(x, params)`` only and, with
``fused_bwd=True``, differentiates through K2 and K3: K2 recomputes the
hidden per tile and hands it to K3 (``keep_hidden``), which reduces it over
the rows; the hidden is freed when the backward returns.  With
``fused_bwd=False`` the backward is the plain VJP of
:func:`~glom_tpu_torch.ops.feedforward.grouped_ff_apply`, as
``ff_pallas.py::_bwd`` chooses.

Each wrapper takes CPU tensors to its kernel's plain version
(``glom_tpu_torch.ops.feedforward``) and CUDA tensors to the kernel, and
raises on anything the kernel does not take.  There is no fallback from a
kernel to its plain version.  ``grouped_ff.launches``,
``grouped_ff_dx.launches`` and ``grouped_ff_dw.launches`` count the
kernels' launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from glom_tpu_torch.kernels import _build
from glom_tpu_torch.kernels._common import (DTYPE_CODES, MAX_DIM, count, fresh_copy, on_device,
                                            vector_aligned)
from glom_tpu_torch.ops import feedforward as plain

HIDDEN_CHUNK = 64      # h must be a multiple (K1's and K8's kernels)

_p, _i64, _i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# glom_grouped_ff(x, row_stride, group_stride, w1, b1, w2, b2, out, ws, hid,
#                 rows, groups, dim, hidden, splits, dtype, stream): csrc/grouped_ff.cu
_ARGTYPES = [_p, _i64, _i64, _p, _p, _p, _p, _p, _p, _p, _i32, _i32, _i32, _i32, _i32, _i32, _p]
# glom_grouped_ff_bwd_dx(x, row_stride, group_stride, w1, b1, w2, go, dx, ws,
#                        hid, dh, rows, groups, dim, hidden, splits, dtype,
#                        stream): csrc/grouped_ff_bwd.cu
_DX_ARGTYPES = [_p, _i64, _i64, _p, _p, _p, _p, _p, _p, _p, _p, _i32, _i32, _i32, _i32, _i32, _i32,
                _p]
# glom_grouped_ff_bwd_dw(x, row_stride, group_stride, go, hid, dh, dw1, db1,
#                        dw2, ws, rows, groups, dim, hidden, splits, dtype,
#                        stream)
_DW_ARGTYPES = [_p, _i64, _i64, _p, _p, _p, _p, _p, _p, _p, _i32, _i32, _i32, _i32, _i32, _i32, _p]


def _kernel():
    """The forward kernel's C entry point, built and loaded on first use."""
    return _build.function("grouped_ff", "glom_grouped_ff", _ARGTYPES)


def _bwd_kernels():
    """The backward kernels' C entry points (dX, dW), built on first use."""
    return (_build.function("grouped_ff_bwd", "glom_grouped_ff_bwd_dx", _DX_ARGTYPES),
            _build.function("grouped_ff_bwd", "glom_grouped_ff_bwd_dw", _DW_ARGTYPES))


def planned_splits(device: torch.device, rows: int, g: int, d: int, h: int, dtype) -> int:
    """How many blocks share an output tile's hidden dimension in K1b on
    ``device`` (``glom_grouped_ff_splits``, K3's rule over hidden slabs),
    cached per shape."""
    with torch.cuda.device(device):
        return _build.plan("grouped_ff", "glom_grouped_ff_splits", torch.cuda.current_device(),
                           rows, g, d, h, DTYPE_CODES[dtype])


def planned_dx_splits(device: torch.device, rows: int, g: int, d: int, h: int, dtype) -> int:
    """How many blocks share a row tile's hidden dimension in K2 on
    ``device`` (``glom_grouped_ff_bwd_dx_splits``), cached per shape."""
    with torch.cuda.device(device):
        return _build.plan("grouped_ff_bwd", "glom_grouped_ff_bwd_dx_splits",
                           torch.cuda.current_device(), rows, g, d, h, DTYPE_CODES[dtype])


def planned_dw_splits(device: torch.device, rows: int, g: int, d: int, h: int, dtype) -> int:
    """How many blocks share an output tile's rows in K3 on ``device``
    (``glom_grouped_ff_bwd_dw_splits``, K2's rule over row slabs), cached
    per shape."""
    with torch.cuda.device(device):
        return _build.plan("grouped_ff_bwd", "glom_grouped_ff_bwd_dw_splits",
                           torch.cuda.current_device(), rows, g, d, h, DTYPE_CODES[dtype])


def _check(params: dict, x: torch.Tensor):
    if x.dim() != 4:
        raise ValueError(f"x must be (b, n, g, d), got shape {tuple(x.shape)}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"grouped_ff kernel takes float32 or bfloat16, got {x.dtype}")
    b, n, g, d = x.shape
    h = params["w1"].shape[-1]
    shapes = {"w1": (g, d, h), "b1": (g, h), "w2": (g, h, d), "b2": (g, d)}
    for name, shape in shapes.items():
        p = params[name]
        if tuple(p.shape) != shape:
            raise ValueError(f"{name} must be {shape} for x {tuple(x.shape)}, got {tuple(p.shape)}")
        if p.dtype != x.dtype or p.device != x.device:
            raise TypeError(
                f"{name} is {p.dtype} on {p.device}; the kernel needs x's "
                f"{x.dtype} on {x.device}"
            )
        if not p.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in ("w1", "w2") and p.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel copies it with cp.async)")
    if d % 128 != 0 or d > MAX_DIM:
        raise ValueError(f"grouped_ff kernel needs d a multiple of 128 and <= {MAX_DIM}, got {d}")
    if h % HIDDEN_CHUNK != 0:
        raise ValueError(f"grouped_ff kernel needs h a multiple of {HIDDEN_CHUNK}, got {h}")
    if x.stride(3) != 1:
        raise ValueError("x's last dimension must be contiguous")
    if b > 1 and n > 1 and x.stride(0) != n * x.stride(1):
        raise ValueError(
            "x's (b, n) axes must flatten to one row axis "
            f"(strides {x.stride()}); pass x.contiguous()"
        )


def _row_stride(x: torch.Tensor) -> int:
    return x.stride(1) if x.shape[1] > 1 else x.stride(0)


def _forward(params: dict, x: torch.Tensor, splits: Optional[int]) -> torch.Tensor:
    if not on_device("grouped_ff", x):
        return plain.grouped_ff_apply(params, x)
    x = _kernel_input(params, x)
    b, n, g, d = x.shape
    h = params["w1"].shape[-1]
    out = torch.empty((b, n, g, d), dtype=x.dtype, device=x.device)
    if b * n == 0:
        return out
    splits = _splits(splits, planned_splits, x, h)
    ws = (torch.empty((splits, b * n * g * d), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    hid = torch.empty((g, b * n, h), dtype=torch.float32, device=x.device)
    fn = _kernel()
    with torch.cuda.device(x.device):
        code = fn(
            x.data_ptr(), _row_stride(x), x.stride(2),
            params["w1"].data_ptr(), params["b1"].data_ptr(),
            params["w2"].data_ptr(), params["b2"].data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), hid.data_ptr(),
            b * n, g, d, h, splits, DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check("grouped_ff", code)
    count(grouped_ff)
    return out


def _kernel_input(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernels read it: checked, and copied into fresh storage
    when its rows are off a 16-byte boundary (K1 and K3 copy them in
    16-byte pieces, K2 reads them as 4-element vectors; ``glom_tpu``'s
    kernels take any layout)."""
    _check(params, x)
    if vector_aligned(x, _row_stride(x), x.stride(2), nbytes=16):
        return x
    return fresh_copy(x)


def _cotangent(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The cotangent as the backward kernels read it: ``x``'s type (the
    contract of ``ff_pallas.py::_backward_fused``), ``x``'s shape,
    contiguous, on a 16-byte boundary."""
    if tuple(g.shape) != tuple(x.shape):
        raise ValueError(f"cotangent {tuple(g.shape)} does not match x {tuple(x.shape)}")
    go = g.to(x.dtype).contiguous()
    return go if vector_aligned(go, nbytes=16) else fresh_copy(go)


def _splits(splits: Optional[int], plan, x: torch.Tensor, h: int) -> int:
    b, n, gr, d = x.shape
    if splits is None:
        return plan(x.device, b * n, gr, d, h, x.dtype)
    if splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    return splits


def grouped_ff_dx(params: dict, x: torch.Tensor, g: torch.Tensor, *,
                  splits: Optional[int] = None, keep_hidden: bool = False):
    """K2: ``dX = [(dO W2^T) * gelu'(x W1 + b1)] W1^T``, ``(b, n, g, d)`` in
    ``x``'s type; ``g`` is dO.  ``x`` is read through its strides.

    ``splits``: how many blocks share a row tile's hidden dimension
    (default: :func:`planned_dx_splits`); with more than one their partial
    sums go through an f32 workspace, added in a fixed order by a second
    kernel, and the call still counts as one launch.

    ``keep_hidden``: also return the hidden K3 reads, ``(dx, (hid, dh))``:
    ``hid = gelu(x W1 + b1)`` and ``dh = (dO W2^T) * gelu'(x W1 + b1)``,
    each ``(g, b * n, h)`` float32, stored by the same launch."""
    if not on_device("grouped_ff_dx", x):
        dx = plain.grouped_ff_dx(params, x, g)
        return (dx, plain.grouped_ff_hidden(params, x, g)) if keep_hidden else dx
    x = _kernel_input(params, x)
    go = _cotangent(x, g)
    b, n, gr, d = x.shape
    h = params["w1"].shape[-1]
    dx = torch.empty((b, n, gr, d), dtype=x.dtype, device=x.device)
    hidden = (tuple(torch.empty((gr, b * n, h), dtype=torch.float32, device=x.device)
                    for _ in range(2)) if keep_hidden else None)
    if b * n == 0:
        return (dx, hidden) if keep_hidden else dx
    splits = _splits(splits, planned_dx_splits, x, h)
    ws = (torch.empty((splits, b * n * gr * d), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    fn, _ = _bwd_kernels()
    with torch.cuda.device(x.device):
        code = fn(
            x.data_ptr(), _row_stride(x), x.stride(2),
            params["w1"].data_ptr(), params["b1"].data_ptr(), params["w2"].data_ptr(),
            go.data_ptr(), dx.data_ptr(), None if ws is None else ws.data_ptr(),
            None if hidden is None else hidden[0].data_ptr(),
            None if hidden is None else hidden[1].data_ptr(),
            b * n, gr, d, h, splits, DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check("grouped_ff_bwd", code)
    count(grouped_ff_dx)
    return (dx, hidden) if keep_hidden else dx


def grouped_ff_dw(params: dict, x: torch.Tensor, g: torch.Tensor, hidden, *,
                  splits: Optional[int] = None):
    """K3: ``(dW1 = X^T dH, db1 = 1^T dH, dW2 = H^T dO)`` summed over every
    row, in the weights' type; ``g`` is dO and ``hidden`` the ``(hid, dh)``
    that ``grouped_ff_dx(..., keep_hidden=True)`` returned for the same
    ``(params, x, g)``.  K3 reads the hidden and recomputes nothing, so it
    has no path without one.

    ``splits``: how many blocks share an output tile's rows (default:
    :func:`planned_dw_splits`); with more than one their partial sums go
    through an f32 workspace, added in a fixed order by a second kernel,
    and the call still counts as one launch."""
    if hidden is None:
        raise ValueError("grouped_ff_dw reads the hidden K2 stores: pass the (hid, dh) of "
                         "grouped_ff_dx(params, x, g, keep_hidden=True)")
    hid, dh = hidden
    if not on_device("grouped_ff_dw", x):
        return plain.grouped_ff_dw_from_hidden(x, g, hid, dh, params["w1"].dtype)
    x = _kernel_input(params, x)
    go = _cotangent(x, g)
    b, n, gr, d = x.shape
    h = params["w1"].shape[-1]
    for name, t in (("hid", hid), ("dh", dh)):
        if (tuple(t.shape) != (gr, b * n, h) or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be ({gr}, {b * n}, {h}) float32, contiguous and "
                             f"16-byte aligned on {x.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    dw1 = torch.empty_like(params["w1"])
    db1 = torch.empty_like(params["b1"])
    dw2 = torch.empty_like(params["w2"])
    if b * n == 0:
        return dw1.zero_(), db1.zero_(), dw2.zero_()
    splits = _splits(splits, planned_dw_splits, x, h)
    ws = (torch.empty((splits, gr * (2 * d * h + h)), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    _, fn = _bwd_kernels()
    with torch.cuda.device(x.device):
        code = fn(
            x.data_ptr(), _row_stride(x), x.stride(2), go.data_ptr(), hid.data_ptr(),
            dh.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
            None if ws is None else ws.data_ptr(), b * n, gr, d, h, splits,
            DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check("grouped_ff_bwd", code)
    count(grouped_ff_dw)
    return dw1, db1, dw2


def grouped_ff_backward(params: dict, x: torch.Tensor, g: torch.Tensor):
    """``(dx, dparams)`` of :func:`grouped_ff` at ``x`` for the cotangent
    ``g``: K2, which hands its hidden to K3, K3, and ``db2 = sum of dO`` in
    float32 (a plain reduction, as ``ff_pallas.py::_backward_fused`` leaves
    it to XLA).  The hidden is freed when this returns."""
    dx, hidden = grouped_ff_dx(params, x, g, keep_hidden=True)
    dw1, db1, dw2 = grouped_ff_dw(params, x, g, hidden)
    del hidden
    db2 = g.to(x.dtype).float().sum(dim=(0, 1)).to(params["b2"].dtype)
    return dx, {"w1": dw1, "b1": db1, "w2": dw2, "b2": db2}


def plain_vjp(params: dict, x: torch.Tensor, g: torch.Tensor):
    """``(dx, dparams)`` by autograd through the plain
    :func:`~glom_tpu_torch.ops.feedforward.grouped_ff_apply`: the
    ``fused_bwd=False`` backward (``ff_pallas.py::_bwd``'s einsum VJP)."""
    names = ("w1", "b1", "w2", "b2")
    with torch.enable_grad():
        xd = x.detach().requires_grad_(True)
        pd = {k: params[k].detach().requires_grad_(True) for k in names}
        y = plain.grouped_ff_apply(pd, xd)
        grads = torch.autograd.grad(y, [xd] + [pd[k] for k in names], g.to(y.dtype))
    return grads[0], dict(zip(names, grads[1:]))


class _GroupedFF(torch.autograd.Function):
    """K1 forward; K2 + K3 (``fused_bwd``) or the plain VJP backward.  Saves
    ``(x, params)`` only, as ``ff_pallas.py::_fwd`` does."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, splits, fused_bwd):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.fused_bwd = fused_bwd
        return _forward({"w1": w1, "b1": b1, "w2": w2, "b2": b2}, x, splits)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, b2 = ctx.saved_tensors
        params = {"w1": w1, "b1": b1, "w2": w2, "b2": b2}
        vjp = grouped_ff_backward if ctx.fused_bwd else plain_vjp
        dx, dp = vjp(params, x, g)
        return dx, dp["w1"], dp["b1"], dp["w2"], dp["b2"], None, None


def grouped_ff(params: dict, x: torch.Tensor, *, splits: Optional[int] = None,
               fused_bwd: bool = True) -> torch.Tensor:
    """``(b, n, g, d) -> (b, n, g, d)``: per group g,
    ``gelu(x @ w1[g] + b1[g]) @ w2[g] + b2[g]`` (exact-erf GELU).  Drop-in
    for :func:`glom_tpu_torch.ops.feedforward.grouped_ff_apply`.

    ``splits``: how many blocks share an output tile's hidden dimension in
    K1b (default: :func:`planned_splits`).  With more than one, the partial
    sums go through an f32 workspace and a third, elementwise kernel adds
    them in a fixed order with ``b2``; the call still counts as one launch.

    When autograd records the call, the gradient is K2 + K3
    (``fused_bwd=True``) or the plain VJP (``False``)."""
    leaves = (x, params["w1"], params["b1"], params["w2"], params["b2"])
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        return _GroupedFF.apply(*leaves, splits, fused_bwd)
    return _forward(params, x, splits)


grouped_ff.launches = 0
grouped_ff_dx.launches = 0
grouped_ff_dw.launches = 0
