"""What every kernel wrapper shares: the element types the kernels take,
the one account of the widths they take, the device test that picks the
kernel or its plain version, the alignment test of the kernels' vector
loads and the fresh copy that meets it, and the launch counter, which also
counts the launches a CUDA graph replays."""

from __future__ import annotations

import contextlib
import threading
from typing import Dict

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def kernels_take(d: int) -> bool:
    """Whether the kernels (K1-K4, K6-K8) take width ``d``: any positive
    multiple of 128 (above 512, K4 is csrc/consensus_wide.cuh's design, K6
    csrc/consensus_bwd_wide.cuh's and K2 grouped_ff_bwd.cu's composition on
    the tiled product)."""
    return d > 0 and d % 128 == 0


def check_width(kernel: str, d: int) -> None:
    """Raise ``ValueError`` naming ``kernel`` when it does not take width ``d``."""
    if not kernels_take(d):
        raise ValueError(f"{kernel} needs d a multiple of 128, got d={d}")

_lock = threading.Lock()
# per thread: the launches recorded into the CUDA graph being captured, or None
_capture = threading.local()


def count(fn) -> None:
    """Add one to a wrapper's launch count; called only where its kernel
    launched.  Inside :func:`recording_launches` (a CUDA graph capture, which
    records the launch and runs nothing) it goes to the graph's record
    instead, and :func:`add_replayed` counts it at every replay."""
    recorded = getattr(_capture, "launches", None)
    if recorded is not None:
        recorded[fn] = recorded.get(fn, 0) + 1
        return
    with _lock:
        fn.launches += 1


@contextlib.contextmanager
def recording_launches():
    """Within the block, this thread's launches go to the yielded
    ``{wrapper: launches}`` (one graph's launches per replay) and not to the
    wrappers' counts."""
    recorded: Dict = {}
    _capture.launches = recorded
    try:
        yield recorded
    finally:
        _capture.launches = None


def add_replayed(recorded: Dict) -> None:
    """Count one replay of a graph whose capture recorded ``recorded``."""
    with _lock:
        for fn, n in recorded.items():
            fn.launches += n


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
