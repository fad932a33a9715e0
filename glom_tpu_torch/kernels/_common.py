"""What every kernel wrapper shares: the element types the kernels take,
the one account of the widths they take and of the zero padding that takes
every other width to them, the device test that picks the kernel or its
plain version, the alignment test of the kernels' vector loads and the
fresh copy that meets it, and the launch counter, which also counts the
launches a CUDA graph replays.

The CUDA kernels (K1-K4, K6-K8) are built for ``d`` a multiple of
:data:`LANE` (128) and a hidden width ``h`` a multiple of
:data:`HIDDEN_CHUNK` (64).  Their wrappers take any ``d > 0`` and ``h > 0``,
as ``glom_tpu``'s kernels do: they copy each operand into fresh storage
zero-padded in its last dimensions (:func:`padded_width`,
:func:`padded_hidden`, :func:`pad_to`, :func:`pad_last`,
:func:`pad_ff_params`), run the kernels at the padded widths and slice the
results back (:func:`unpad`).  The padding is exact: a zero column adds
nothing to a product and nothing to a key's norm, GELU(0) = 0 and the padded
rows of W2 are zero, so a padded hidden unit adds nothing either way, and
the padded columns of every output and gradient are sliced away.  The one
term that reads ``d`` itself, the consensus logits' ``d^-1/2``, is passed to
the kernels as the model's width.  At widths already on the multiples
nothing is copied."""

from __future__ import annotations

import contextlib
import threading
from typing import Dict

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
LANE = 128          # the kernels' d is a multiple
HIDDEN_CHUNK = 64   # and their h (K1, K2, K3 and K8's nets)


def kernels_take(d: int) -> bool:
    """Whether the kernels' wrappers take width ``d``: any positive width
    (padded to :func:`padded_width` where it is off a multiple of 128)."""
    return d > 0


def check_width(kernel: str, d: int) -> None:
    """Raise ``ValueError`` naming ``kernel`` for a width that is not
    positive."""
    if not kernels_take(d):
        raise ValueError(f"{kernel} needs a positive width, got d={d}")


def padded_width(d: int) -> int:
    """``d`` rounded up to a multiple of :data:`LANE`: the width the
    kernels run a model of width ``d`` at."""
    return -(-d // LANE) * LANE


def padded_hidden(h: int) -> int:
    """``h`` rounded up to a multiple of :data:`HIDDEN_CHUNK`."""
    return -(-h // HIDDEN_CHUNK) * HIDDEN_CHUNK


def pad_to(t: torch.Tensor, shape) -> torch.Tensor:
    """``t`` itself where it already has ``shape``; else a fresh contiguous
    tensor of ``shape`` (each dimension at least ``t``'s), zero but for
    ``t`` in its leading corner."""
    shape = tuple(shape)
    if tuple(t.shape) == shape:
        return t
    out = t.new_zeros(shape)
    out[tuple(slice(0, s) for s in t.shape)] = t
    return out


def pad_last(t: torch.Tensor, to: int) -> torch.Tensor:
    """``t`` zero-padded in its last dimension to ``to`` (:func:`pad_to`)."""
    return pad_to(t, (*t.shape[:-1], to))


def pad_ff_params(params: dict, d: int, h: int) -> dict:
    """A grouped FF's ``{w1 (g, d, h), b1 (g, h), w2 (g, h, d), b2 (g, d)}``
    zero-padded to widths ``d`` and ``h`` (each parameter is itself where it
    is already that wide)."""
    g = params["w1"].shape[0]
    shapes = {"w1": (g, d, h), "b1": (g, h), "w2": (g, h, d), "b2": (g, d)}
    return {k: pad_to(params[k], shape) for k, shape in shapes.items()}


def unpad(t: torch.Tensor, shape) -> torch.Tensor:
    """The leading ``shape`` corner of ``t``, contiguous; ``t`` itself where
    it already has ``shape``."""
    shape = tuple(shape)
    if tuple(t.shape) == shape:
        return t
    return t[tuple(slice(0, s) for s in shape)].contiguous()


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
