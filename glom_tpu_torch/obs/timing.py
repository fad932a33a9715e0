"""Phase-timed step-loop accounting (``glom_tpu/obs/timing.py``, copied:
that module imports no JAX, and the port imports nothing of ``glom_tpu``).

``PhaseTimer`` splits the trainer's wall clock into named phases — data
wait, host-to-device put, step dispatch, the log-boundary sync, eval,
checkpoint, stop-poll — so "where does step time go?" has a measured
answer instead of one imgs/sec number that silently absorbs eval and
checkpoint time.

Async-aware by construction: phases time exactly the HOST-side interval of
each loop segment.  CUDA launches are asynchronous, so the ``step`` phase is
the host's time to issue the step (autograd and the kernels' wrappers); the
device compute the host eventually waits on surfaces in the ``log_sync``
phase (the fetch of the step's metrics at the log boundary — the only place
the loop blocks).  No per-step ``torch.cuda.synchronize`` is ever issued,
so instrumentation cannot break the launch pipeline.  On the CPU ``step``
simply IS the compute time.

The clock is injectable for deterministic tests.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

# canonical phase names (JSONL keys are `t_<phase>`); ordering is the
# display order in reports
PHASES = (
    "data_wait",   # next(batches): host input pipeline stall
    "h2d",         # the batch's copy to the device
    "step",        # train-step dispatch (compute on sync backends)
    "log_sync",    # fetch of the step metrics at the log boundary
    "eval",        # eval-suite / psnr run
    "diag",        # GLOM-level diagnostics forward (diag_every cadence)
    "checkpoint",  # save() incl. async-writer handoff
    "stop_poll",   # cross-host preemption-flag allgather
    "log_emit",    # exporter writes of the previous boundary's record
)


class PhaseTimer:
    """Accumulates per-phase seconds over a logging window.

    Usage::

        pt = PhaseTimer()
        with pt.phase("data_wait"):
            img = next(batches)
        ...
        totals = pt.window()   # {'t_data_wait': ..., 't_window': ...} + reset

    ``window()`` also reports ``t_window`` (wall clock since the last
    window cut) and ``window_steps`` so consumers can normalize to
    per-step time without re-deriving the cadence.
    """

    def __init__(self, clock=None, registry=None, tracer=None):
        self._clock = clock or time.monotonic
        self._registry = registry
        self._totals: Dict[str, float] = {}
        self._steps = 0
        self._window_t0 = self._clock()
        self._open: Optional[str] = None
        # -- optional tracing (a tracer with glom_tpu.obs.tracing's
        # start_trace / record / end; not in the port yet): each logging window
        # is one trace (root span `train_window`), each phase() interval a
        # child span — the trainer's analogue of the serving request
        # trace, same span format, same Perfetto export path
        self._tracer = tracer
        self._window_index = 0
        self._window_span = None
        if tracer is not None:
            self._window_span = tracer.start_trace(
                "train_window", attrs={"window": 0})

    @contextlib.contextmanager
    def phase(self, name: str):
        if self._open is not None:
            raise RuntimeError(
                f"phase {name!r} opened inside phase {self._open!r}; phases "
                f"partition the loop and must not nest"
            )
        self._open = name
        t0 = self._clock()
        try:
            yield
        finally:
            t1 = self._clock()
            self.add(name, t1 - t0)
            if self._tracer is not None and self._window_span is not None:
                self._tracer.record(name, self._window_span, t0, t1,
                                    observe=False)
            self._open = None

    def add(self, name: str, seconds: float) -> None:
        """Manual attribution — e.g. the previous boundary's log-emit time,
        measured outside any open phase."""
        self._totals[name] = self._totals.get(name, 0.0) + seconds

    def count_step(self, n: int = 1) -> None:
        self._steps += n

    def window(self) -> Dict[str, float]:
        """Cut the window: return ``{t_<phase>: seconds}`` for every phase
        seen plus ``t_window`` / ``window_steps``, feed the per-step phase
        histograms of the attached registry, and reset the accumulators.
        The window clock restarts at the CUT, so exporter time spent after
        this call lands in the next window (attribute it with
        ``add('log_emit', dt)``)."""
        now = self._clock()
        dt = now - self._window_t0
        out = {f"t_{k}": v for k, v in self._totals.items()}
        out["t_window"] = dt
        out["window_steps"] = self._steps
        if self._registry is not None and self._steps:
            for k, v in self._totals.items():
                self._registry.histogram(
                    f"phase_{k}", unit="seconds/step",
                    help=f"per-step {k} time within one logging window",
                ).observe(v / self._steps)
            self._registry.histogram(
                "step_time", unit="seconds/step",
                help="wall-clock window time per step (all phases)",
            ).observe(dt / self._steps)
        self._totals = {}
        self._window_t0 = now
        if self._tracer is not None and self._window_span is not None:
            self._tracer.end(self._window_span,
                             attrs={"steps": self._steps})
            self._window_index += 1
            self._window_span = self._tracer.start_trace(
                "train_window", attrs={"window": self._window_index})
        self._steps = 0
        return out

    def close(self) -> None:
        """End the open window span without rotating (the loop's exit
        path): the TAIL window past the last log boundary — or the whole
        run when it never reached one — must still export with a closed
        root, or its phase spans render parentless and coverage math has
        no basis.  Idempotent; phases after close are not traced."""
        if self._tracer is not None and self._window_span is not None:
            self._tracer.end(self._window_span, attrs={"steps": self._steps})
            self._window_span = None
