"""What every kernel wrapper shares: the element types the kernels take,
their width limit, the device test that picks the kernel or its plain
version, the alignment test of the kernels' vector loads and the fresh copy
that meets it, and the launch counter."""

from __future__ import annotations

import threading

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 512          # the kernels hold a (64, d) f32 accumulator in registers

_lock = threading.Lock()


def count(fn) -> None:
    """Add one to a wrapper's launch count; called only where its kernel launched."""
    with _lock:
        fn.launches += 1


def on_device(name: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel's), False for a CPU one (the plain
    version's); raises for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {x.device}")
    return True


def vector_aligned(t: torch.Tensor, *strides: int, nbytes: int = 0) -> bool:
    """Whether every row of ``t`` (rows ``strides`` apart, in elements)
    starts on a boundary of ``nbytes`` (default: 4 elements), as a kernel's
    vector loads or 16-byte ``cp.async`` copies read them."""
    size = nbytes or 4 * t.element_size()
    return t.data_ptr() % size == 0 and all(s * t.element_size() % size == 0 for s in strides)


def fresh_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into new contiguous storage, which starts on the
    allocator's boundary (``contiguous()`` would hand back a contiguous
    tensor that starts off a boundary as it is)."""
    return torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)
