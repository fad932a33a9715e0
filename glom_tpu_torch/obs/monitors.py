"""Runtime health monitors (``glom_tpu/obs/monitors.py``): rebuilds, device
memory, numerics.

  * :class:`RecompileMonitor` — ``glom_tpu``'s watches a jitted step's
    compile cache.  The port's step is eager, so nothing recompiles in
    XLA's sense; what must not happen mid-run is a kernel build or load
    (``kernels/_build.py::events``) or a CUDA graph capture.  The monitor
    keeps ``glom_tpu``'s interface (``poll``, ``compiles``, ``recompiles``,
    ``available``) over a count the caller passes: the trainer passes the
    builds and loads of ``_build.events()``, a graph cache its captures.
    The first poll is the baseline (``glom_tpu``'s first compile); any
    later growth is a rebuild.
  * :class:`MemoryMonitor` — the card's memory from
    ``torch.cuda.memory_stats`` and its total memory, under ``glom_tpu``'s
    keys; ``{}`` on the CPU, as ``glom_tpu``'s is on a backend that does
    not report.
  * :func:`numerics_metrics` — the step's NaN/Inf summary, computed from
    values the step already produced (a few reductions, no re-execution).
  * :class:`NumericsMonitor` — the host-side window accounting over those
    per-step summaries: NaN-event detection plus grad-norm spike flags
    against a running EMA.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional

import torch


class RecompileMonitor:
    """Track the growth of a rebuild count.

    ``count_fn()`` returns a monotone count (kernel builds and loads, graph
    captures).  ``poll()`` returns the number of NEW events since the last
    poll and adds them to ``compiles``, the lifetime total.  The first
    poll's count is the expected start-up work and counts as one compile,
    so ``recompiles`` (total minus that first) is what health checks alarm
    on.  Inert (always 0) when ``count_fn`` is None."""

    def __init__(self, count_fn: Optional[Callable[[], int]]):
        self._count_fn = count_fn
        self._last: Optional[int] = None
        self.compiles = 0

    @property
    def available(self) -> bool:
        return self._count_fn is not None

    @property
    def recompiles(self) -> int:
        return max(0, self.compiles - 1)

    def poll(self) -> int:
        if self._count_fn is None:
            return 0
        count = int(self._count_fn())
        if self._last is None:
            self._last = count
            self.compiles = 1
            return 1
        new = max(0, count - self._last)
        self._last = count
        self.compiles += new
        return new


class MemoryMonitor:
    """Live device-memory gauges of one card.

    ``sample()`` returns ``{"mem_bytes_in_use", "mem_peak_bytes",
    "mem_bytes_limit"}`` (the caching allocator's allocated bytes, their
    peak, and the card's total memory), or ``{}`` for a CPU device:
    callers merge the dict into their record."""

    def __init__(self, device=None):
        self._device = torch.device(device if device is not None else (
            "cuda" if torch.cuda.is_available() else "cpu"))

    def sample(self) -> Dict[str, float]:
        if self._device.type != "cuda":
            return {}
        stats = torch.cuda.memory_stats(self._device)
        if not stats:
            return {}
        return {"mem_bytes_in_use": float(stats["allocated_bytes.all.current"]),
                "mem_peak_bytes": float(stats["allocated_bytes.all.peak"]),
                "mem_bytes_limit": float(
                    torch.cuda.get_device_properties(self._device).total_memory)}


def numerics_metrics(grads: Iterable[torch.Tensor], loss: torch.Tensor, *,
                     total=None) -> Dict[str, torch.Tensor]:
    """Device scalars of one step: ``nonfinite_grads``, the count of
    non-finite gradient elements over every leaf (0 on a healthy step), and
    ``loss_nonfinite``, 1.0 when the loss is NaN or Inf.  float32, as the JAX
    package counts (exact up to 2**24 bad elements).  ``total`` adds up the
    per-leaf counts (on a mesh of ranks, over the ranks a leaf is split
    over); by default their sum."""
    counts = [(~torch.isfinite(g.float())).sum().float() for g in grads]
    if not counts:
        nonfinite = torch.zeros((), device=loss.device)
    else:
        nonfinite = total(counts) if total is not None else torch.stack(counts).sum()
    loss_bad = (~torch.isfinite(loss.float())).float()
    return {"nonfinite_grads": nonfinite, "loss_nonfinite": loss_bad}


class NumericsMonitor:
    """Host-side window accounting over the per-step summaries.

    ``update(per_step)`` consumes a list of already-fetched per-step metric
    dicts (one logging window) and returns the window summary:

      * ``nonfinite_grads`` — summed bad-element count over the window;
      * ``loss_nonfinite_steps`` — steps whose loss was NaN/Inf;
      * ``grad_norm_spike`` — 1.0 when any step's grad norm exceeded
        ``spike_factor`` x the running EMA of healthy grad norms.

    The EMA ingests finite norms only, and spiking norms enter CLAMPED at
    ``spike_factor`` x the current baseline: a one-step spike barely moves
    the baseline, while a sustained legitimate shift re-baselines within a
    few windows instead of flagging every window forever.
    """

    def __init__(self, spike_factor: float = 10.0, ema_decay: float = 0.95):
        self.spike_factor = spike_factor
        self.ema_decay = ema_decay
        self._ema: Optional[float] = None
        self.nan_events = 0     # windows that saw any nonfinite value
        self.spike_events = 0   # windows that saw a grad-norm spike

    def update(self, per_step) -> Dict[str, float]:
        nonfinite = 0.0
        loss_bad_steps = 0.0
        spike = 0.0
        for m in per_step:
            nonfinite += float(m.get("nonfinite_grads", 0.0))
            loss_bad_steps += float(m.get("loss_nonfinite", 0.0))
            gn = m.get("grad_norm")
            if gn is None:
                continue
            gn = float(gn)
            if not math.isfinite(gn):
                continue  # counted via nonfinite_grads; would poison the EMA
            if self._ema is not None and gn > self.spike_factor * self._ema:
                spike = 1.0
                gn = self.spike_factor * self._ema
            self._ema = gn if self._ema is None else (
                self.ema_decay * self._ema + (1.0 - self.ema_decay) * gn
            )
        if nonfinite or loss_bad_steps:
            self.nan_events += 1
        if spike:
            self.spike_events += 1
        return {
            "nonfinite_grads": nonfinite,
            "loss_nonfinite_steps": loss_bad_steps,
            "grad_norm_spike": spike,
        }
