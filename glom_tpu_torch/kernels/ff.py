"""Grouped feed-forward: the wrapper of the hand-written CUDA kernel
``csrc/grouped_ff.cu``, which replaces the TPU kernel
``glom_tpu/kernels/ff_pallas.py::_forward``.

:func:`grouped_ff` takes CPU tensors to the plain version
(:func:`glom_tpu_torch.ops.feedforward.grouped_ff_apply`) and CUDA tensors
to the kernel, and raises on anything the kernel does not take.  There is
no fallback from the kernel to the plain version.  ``grouped_ff.launches``
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from glom_tpu_torch.kernels import _build
from glom_tpu_torch.ops.feedforward import grouped_ff_apply

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HIDDEN_CHUNK = 64      # the kernel's hidden chunk: h must be a multiple
MAX_DIM = 512          # the kernel holds a (64, d) f32 accumulator in registers

_p, _i64, _i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# glom_grouped_ff(x, row_stride, group_stride, w1, b1, w2, b2, out, ws, rows,
#                 groups, dim, hidden, splits, dtype, stream): csrc/grouped_ff.cu
_ARGTYPES = [_p, _i64, _i64, _p, _p, _p, _p, _p, _p, _i32, _i32, _i32, _i32, _i32, _i32, _p]
_lock = threading.Lock()


def _kernel():
    """The kernel's C entry point, built and loaded on first use."""
    return _build.function("grouped_ff", "glom_grouped_ff", _ARGTYPES)


def planned_splits(device: torch.device, rows: int, g: int, d: int, h: int, dtype) -> int:
    """How many blocks share a row tile's hidden dimension on ``device``
    (``glom_grouped_ff_splits``: the count that fills the card's SMs in the
    fewest steps), cached per shape."""
    with torch.cuda.device(device):
        return _build.plan("grouped_ff", "glom_grouped_ff_splits", torch.cuda.current_device(),
                           rows, g, d, h, DTYPE_CODES[dtype])


def check_no_grad(*tensors) -> None:
    """The kernels have no backward yet: refuse to build a graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the port's CUDA kernels are forward-only; their backward kernels "
            "are ROADMAP queue 2 (the training slice). Run under "
            "torch.inference_mode() or torch.no_grad()"
        )


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


def grouped_ff(params: dict, x: torch.Tensor, *, splits: Optional[int] = None) -> torch.Tensor:
    """``(b, n, g, d) -> (b, n, g, d)``: per group g,
    ``gelu(x @ w1[g] + b1[g]) @ w2[g] + b2[g]`` (exact-erf GELU).  Drop-in
    for :func:`glom_tpu_torch.ops.feedforward.grouped_ff_apply`.

    ``splits``: how many blocks share a row tile's hidden dimension
    (default: :func:`planned_splits`).  With more than one, the partial sums
    go through an f32 workspace and a second, elementwise kernel adds them
    in a fixed order; the call still counts as one launch."""
    check_no_grad(x, *params.values())
    if x.device.type == "cpu":
        return grouped_ff_apply(params, x)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_ff runs on cpu or cuda tensors, got {x.device}")
    _check(params, x)
    b, n, g, d = x.shape
    h = params["w1"].shape[-1]
    out = torch.empty((b, n, g, d), dtype=x.dtype, device=x.device)
    if b * n == 0:
        return out
    if splits is None:
        splits = planned_splits(x.device, b * n, g, d, h, x.dtype)
    elif splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    ws = (torch.empty((splits, b * n * g * d), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    row_stride = x.stride(1) if n > 1 else x.stride(0)
    fn = _kernel()
    with torch.cuda.device(x.device):
        code = fn(
            x.data_ptr(), row_stride, x.stride(2),
            params["w1"].data_ptr(), params["b1"].data_ptr(),
            params["w2"].data_ptr(), params["b2"].data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            b * n, g, d, h, splits, DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check("grouped_ff", code)
    with _lock:
        grouped_ff.launches += 1
    return out


grouped_ff.launches = 0
