"""Tracing / profiling / numerics debugging (``glom_tpu/profiling.py``).

The PyTorch counterparts of ``glom_tpu``'s XLA-backed helpers:

  * ``trace(logdir)`` — ``torch.profiler`` over the host and, on a card, the
    CUDA kernels, written into ``logdir`` as a Chrome/Perfetto trace
    (``trace-<ns>.json``); ``Trainer.fit`` takes it through
    ``TrainConfig.profile_dir`` and ``tools/bench.py`` through
    ``--profile-dir``.
  * ``annotate(name)`` — a named region in that trace (and an NVTX range on
    a card).
  * ``cost_analysis(fn, *args)`` — ``{"flops": ...}`` of one call, counted
    by ``torch.utils.flop_counter.FlopCounterMode``.  It counts aten
    operations only: the port's CUDA kernels launch through ``ctypes`` and
    are invisible to it, so a count taken on a kernel path is short.  Take
    it on the plain path of the same configuration (``tools/mfu.py`` does).
    Under ``remat`` it includes what the backward recomputes, as XLA's
    compiled count does.
  * ``memory_analysis(fn, *args)`` — the peak device memory of one call;
    ``{}`` (with a warning) when ``fn`` runs on no card, as ``glom_tpu``'s
    degrades on backends that do not report.
  * ``device_memory_profile(path)`` — the CUDA caching allocator's snapshot.
  * ``debug_nans(enable)`` — autograd's anomaly detection.

The XLA-only parts of ``glom_tpu/profiling.py`` (``compiled_cost_analysis``,
``compiled_memory_analysis``, ``snapshot_from_compiled``,
``compile_snapshot``) go with ``obs/forensics.py`` (ROADMAP queue 1,
item 7).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import warnings
from typing import Any, Dict, Iterator

import torch

TRACE_PREFIX = "trace-"


def trace_files(logdir: str) -> list:
    """The traces :func:`trace` wrote into ``logdir``, oldest first."""
    if not os.path.isdir(logdir):
        return []
    names = sorted(f for f in os.listdir(logdir)
                   if f.startswith(TRACE_PREFIX) and f.endswith(".json"))
    return [os.path.join(logdir, f) for f in names]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside the block into a new Chrome/Perfetto trace
    file in ``logdir``: host operations and the :func:`annotate` regions,
    and, where a card is available, its kernels.  The card is synchronised
    at the block's end, so the trace holds the work the block issued."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"{TRACE_PREFIX}{time.time_ns()}.json")
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region for traces: ``with annotate("step"): ...``.  Without an
    active profiler the region costs a few microseconds of host time."""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def cost_analysis(fn, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once and return ``{"flops": n}``: the
    floating-point operations of the aten matrix products, convolutions and
    attention it ran (``FlopCounterMode``; 2 m n k a product), its backward
    included when ``fn`` runs one.  Work inside the port's CUDA kernels is
    not counted (module docstring)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops())}


def _tensors(obj) -> Iterator[torch.Tensor]:
    """Every tensor in nested dicts, lists, tuples and dataclasses."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def memory_analysis(fn, *args, **kwargs) -> Dict[str, Any]:
    """Device memory of one call of ``fn(*args, **kwargs)`` on the card its
    tensor arguments live on, in bytes: ``peak_bytes``
    (``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``),
    ``resident_bytes`` (allocated before the call) and their difference
    ``temp_bytes``.  ``{}`` with a warning, and ``fn`` not called, when no
    argument is on a card."""
    cuda = [t for t in _tensors((args, kwargs)) if t.is_cuda]
    if not cuda:
        warnings.warn("memory_analysis: no argument is on a CUDA device; the CPU "
                      "reports no device memory", stacklevel=2)
        return {}
    device = cuda[0].device
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    resident = torch.cuda.memory_allocated(device)
    out = fn(*args, **kwargs)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    del out
    return {"peak_bytes": peak, "resident_bytes": resident, "temp_bytes": peak - resident}


def device_memory_profile(path: str) -> None:
    """Dump the CUDA caching allocator's snapshot (segments and blocks; with
    ``torch.cuda.memory._record_memory_history`` on, the allocations' stacks
    too) to ``path``, a pickle that ``torch.cuda._memory_viz`` renders.
    Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_memory_profile needs a CUDA device")
    torch.cuda.memory._dump_snapshot(path)


def debug_nans(enable: bool = True) -> None:
    """Toggle autograd's anomaly detection: a backward that produces NaN
    raises, naming the forward operation that created the failing node.

    This is the interactive DEBUGGING tool — it slows every step and must
    stay off on the hot path.  For always-on NaN MONITORING during training
    use ``TrainConfig.monitor_numerics`` (``obs/monitors.py``'s counts, a few
    reductions per step)."""
    torch.autograd.set_detect_anomaly(enable)
