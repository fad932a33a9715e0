"""Consensus attention: the wrapper of the hand-written CUDA kernel
``csrc/consensus.cu``, which replaces both TPU kernels of
``glom_tpu/kernels/consensus_pallas.py``: ``_forward`` (K/V resident) and
``_forward_blocked`` (K/V streamed, for n > 1024).  On Hopper K/V is always
streamed, so one kernel covers every n.

:func:`consensus_attention` takes CPU tensors to the plain version
(:func:`glom_tpu_torch.ops.consensus.consensus_attention`) and CUDA tensors
to the kernel, and raises on anything the kernel does not take.  There is
no fallback from the kernel to the plain version.
``consensus_attention.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from glom_tpu_torch.kernels import _build
from glom_tpu_torch.kernels.ff import DTYPE_CODES, MAX_DIM, check_no_grad
from glom_tpu_torch.ops import consensus as plain

_p, _i64, _i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# glom_consensus(levels, sb, sn, sl, mask, out, lse, ws, b, n, L, dim,
#                attend_self, splits, dtype, stream): csrc/consensus.cu
_ARGTYPES = [_p, _i64, _i64, _i64, _p, _p, _p, _p, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _p]
_lock = threading.Lock()


def _kernel():
    """The kernel's C entry point, built and loaded on first use."""
    return _build.function("consensus", "glom_consensus", _ARGTYPES)


def planned_splits(device: torch.device, b: int, n: int, L: int, d: int, dtype) -> int:
    """How many blocks share a query tile's keys on ``device``
    (``glom_consensus_splits``: the count that fills the card's SMs in the
    fewest steps), cached per shape."""
    with torch.cuda.device(device):
        return _build.plan("consensus", "glom_consensus_splits", torch.cuda.current_device(),
                           b, n, L, d, DTYPE_CODES[dtype])


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


def consensus_attention(
    levels: torch.Tensor,
    *,
    attend_self: bool = False,
    non_local_mask: Optional[torch.Tensor] = None,
    splits: Optional[int] = None,
):
    """``(b, n, L, d) -> (out (b, n, L, d), lse (b, L, n, 1) float32)``.
    ``non_local_mask``: optional ``(n, n)`` bool or int8, nonzero = blocked.

    ``splits`` (CUDA only): how many blocks share a query tile's keys
    (default: :func:`planned_splits`).  With more than one, each writes its
    unnormalized sums and row statistics to an f32 workspace and a second,
    elementwise kernel combines them in a fixed order; the call still
    counts as one launch."""
    check_no_grad(levels)
    if levels.device.type == "cpu":
        return plain.consensus_attention(
            levels, attend_self=attend_self, non_local_mask=non_local_mask)
    if levels.device.type != "cuda":
        raise ValueError(f"consensus_attention runs on cpu or cuda tensors, got {levels.device}")
    _check(levels, non_local_mask)
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
    with _lock:
        consensus_attention.launches += 1
    return out, lse


consensus_attention.launches = 0
