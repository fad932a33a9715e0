"""Anomaly-trigger engine: turns monitor signals into capture decisions.

The port's copy of ``glom_tpu/obs/triggers.py`` (stdlib only), the same code
so both packages export the same metrics, traces and alerts.

The monitors *detect* (recompiles, NaN storms, grad spikes); this module
decides when a detection is worth an evidence capture
(:mod:`glom_tpu.obs.forensics`).  Two pieces:

  * :class:`TriggerEngine` — per-trigger debounce plus a global capture
    budget, so a NaN storm produces ONE bundle (not one per window) and a
    pathological run cannot fill the disk with traces.
  * :class:`StepTimeRegressionMonitor` — the one NEW detector this layer
    adds: a rolling-window step-time p95 regression check (the "the run
    silently got 2x slower" signal that loss curves never show).

Both are plain host-side bookkeeping — no device work, no syncs.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Dict, Optional

# canonical trigger names (bundle directories are `<trigger>-<step>/`)
TRIGGER_NAN = "nan"
TRIGGER_RECOMPILE = "recompile"
TRIGGER_GRAD_SPIKE = "grad_spike"
TRIGGER_STEP_TIME = "step_time_regression"
# serving-side: sustained request-queue overload (glom_tpu.serving)
TRIGGER_QUEUE_SATURATION = "queue_saturation"
# serving-side: multi-window SLO burn-rate breach (glom_tpu_torch.obs.slo)
TRIGGER_SLO_BURN = "slo_burn"
# serving-side: a scale-up recommendation from the dry-run capacity
# advisor (glom_tpu.obs.capacity) persisted past its window threshold —
# the bundle carries the recommendation history and per-rule forecasts
TRIGGER_CAPACITY_PRESSURE = "capacity_pressure"
# serving-side: a shadow/canary deploy candidate burned its error budget
# and was auto-retired (glom_tpu.serving.deploy) — the bundle names the
# offending traces and the before/after version pins
TRIGGER_DEPLOY_ROLLBACK = "deploy_rollback"
# serving-side: a model-QUALITY objective burned its budget (island
# agreement collapsed, live distribution drifted off the reference
# profile — glom_tpu.obs.quality via the SLO burn machinery); the bundle
# names offending trace ids AND their input fingerprints
TRIGGER_QUALITY_DRIFT = "quality_drift"
# resilience-side (glom_tpu.resilience): a checkpoint failed integrity
# verification and was quarantined; a supervised fit() crashed and restarted
TRIGGER_CKPT_CORRUPT = "ckpt_corrupt"
TRIGGER_CRASH_RESTART = "crash_restart"
# elastic multi-host (glom_tpu.resilience.elastic): one fault domain was
# preempted / the coordinator went silent and a successor was elected / a
# restart came back with a different host count and the job re-planned its
# mesh + data-plane partition — each bundle carries the before/after plan
TRIGGER_HOST_PREEMPT = "host_preempt"
TRIGGER_COORDINATOR_LOSS = "coordinator_loss"
TRIGGER_ELASTIC_REPLAN = "elastic_replan"
# terminal paths write bundles DIRECTLY (no debounce/budget — they fire at
# most once per run by construction); named here so readers share the names
TRIGGER_CRASH = "crash"
TRIGGER_PREEMPT = "preempt"


class TriggerEngine:
    """Capture gatekeeper: ``fire(name, step)`` returns True when a capture
    should proceed.

    A firing is accepted unless (a) the same trigger already captured
    within ``debounce_steps`` steps (storm suppression: the FIRST window of
    a NaN storm is the evidence; the next hundred are the same incident),
    or (b) the run already spent its global ``max_captures`` budget
    (captures are expensive — an HLO snapshot may recompile, a trace window
    writes tens of MB).  Suppressed firings are still counted (and exported
    via the registry) so the log shows how big the storm was.
    """

    def __init__(self, *, debounce_steps: int = 200, max_captures: int = 3,
                 registry=None):
        if debounce_steps < 1:
            raise ValueError(f"debounce_steps must be >= 1, got {debounce_steps}")
        if max_captures < 0:
            raise ValueError(f"max_captures must be >= 0, got {max_captures}")
        self.debounce_steps = debounce_steps
        self.max_captures = max_captures
        self._registry = registry
        self._last_fired: Dict[str, int] = {}
        self.captures = 0      # accepted firings (global, all triggers)
        self.suppressed = 0    # rejected firings (debounce or budget)

    def fire(self, name: str, step: int) -> bool:
        last = self._last_fired.get(name)
        debounced = last is not None and step - last < self.debounce_steps
        if debounced or self.captures >= self.max_captures:
            self.suppressed += 1
            if self._registry is not None:
                self._registry.counter(
                    "forensics_suppressed",
                    help="trigger firings suppressed by debounce/budget",
                ).inc()
            return False
        self._last_fired[name] = step
        self.captures += 1
        if self._registry is not None:
            self._registry.counter(
                "forensics_captures", help="accepted forensics captures"
            ).inc()
        return True

    def refund(self, name: str, step: int) -> None:
        """Give back the budget slot of a ``fire`` acceptance whose capture
        FAILED (unwritable disk, bundle error): the global budget must not
        be burned on evidence that never hit disk — a later genuine anomaly
        still deserves its bundle.  The debounce timestamp is kept: a
        persistently failing disk must not turn every storm window into a
        retry (and a warning), only one per debounce horizon."""
        if self._last_fired.get(name) == step and self.captures > 0:
            self.captures -= 1
            if self._registry is not None:
                self._registry.counter(
                    "forensics_capture_failures",
                    help="accepted firings whose bundle write failed",
                ).inc()


def _p95(xs) -> float:
    """Nearest-rank p95 (the registry Histogram's rule, inlined — these
    windows are tiny deques, not Histograms)."""
    ordered = sorted(xs)
    rank = min(len(ordered) - 1, max(0, math.ceil(0.95 * len(ordered)) - 1))
    return ordered[rank]


class QueueSaturationMonitor:
    """Sustained-overload detector for a bounded request queue (the serving
    analogue of :class:`StepTimeRegressionMonitor`: a detector whose firings
    the :class:`TriggerEngine` gates into bundle captures).

    ``update(depth, capacity, shed_delta)`` consumes one observation — the
    queue depth at an admission or flush boundary, the queue's capacity, and
    how many requests were load-shed since the previous observation — and
    returns a detail dict when the queue has been saturated (depth at or
    above ``threshold`` x capacity, or any shedding) for ``sustained``
    CONSECUTIVE observations, else None.  A single full-queue blip is normal
    burst absorption — exactly what the queue is for — so one observation
    never fires; sustained saturation means offered load exceeds service
    rate and the operator needs the evidence bundle.

    On firing the streak resets, so a persistent overload re-fires only
    after another full ``sustained`` run — the TriggerEngine's debounce and
    budget bound it further.  Host-side bookkeeping only.
    """

    def __init__(self, threshold: float = 0.9, sustained: int = 3):
        if not 0.0 < threshold <= 1.0:
            raise ValueError(
                f"threshold must be in (0, 1] (a fraction of queue "
                f"capacity), got {threshold}"
            )
        if sustained < 1:
            raise ValueError(f"sustained must be >= 1, got {sustained}")
        self.threshold = threshold
        self.sustained = sustained
        self._streak = 0
        self._peak_depth = 0
        self._shed_in_streak = 0
        self.saturation_events = 0

    def update(self, depth: int, capacity: int,
               shed_delta: int = 0) -> Optional[Dict[str, float]]:
        saturated = shed_delta > 0 or (
            capacity > 0 and depth >= self.threshold * capacity
        )
        if not saturated:
            self._streak = 0
            self._peak_depth = 0
            self._shed_in_streak = 0
            return None
        self._streak += 1
        self._peak_depth = max(self._peak_depth, int(depth))
        self._shed_in_streak += int(shed_delta)
        if self._streak < self.sustained:
            return None
        detail = {
            "observations": float(self._streak),
            "peak_queue_depth": float(self._peak_depth),
            "queue_capacity": float(capacity),
            "shed_requests": float(self._shed_in_streak),
        }
        self.saturation_events += 1
        self._streak = 0
        self._peak_depth = 0
        self._shed_in_streak = 0
        return detail


class StepTimeRegressionMonitor:
    """Rolling step-time p95 regression detector.

    ``update(per_step_seconds)`` consumes one logging window's mean
    per-step TRAIN time (the trainer already excludes eval/checkpoint/diag
    overhead from it) and returns a detail dict when the p95 of the most
    recent ``recent`` windows exceeds ``factor`` x the p95 of the
    ``baseline`` windows behind them — else None.

    The recent head must be FULL and the baseline must hold at least
    ``min_baseline`` samples before anything can fire, so the first
    windows of a run (compile tail, cache warmup) can never alarm.  On
    firing, the recent head is folded into the baseline: a sustained
    legitimate shift (bigger batch, new data mix) re-baselines instead of
    alarming every window until the budget is gone.
    """

    def __init__(self, factor: float = 2.0, recent: int = 4,
                 baseline: int = 16, min_baseline: int = 8):
        if factor <= 1.0:
            raise ValueError(f"factor must be > 1 (it multiplies the "
                             f"baseline p95), got {factor}")
        if recent < 1 or baseline < min_baseline or min_baseline < 2:
            raise ValueError(
                f"need recent >= 1, baseline >= min_baseline >= 2; got "
                f"recent={recent} baseline={baseline} min_baseline={min_baseline}"
            )
        self.factor = factor
        self._recent_cap = recent
        self._min_baseline = min_baseline
        self._recent: deque = deque()
        self._baseline: deque = deque(maxlen=baseline)
        self.regressions = 0

    def update(self, per_step_seconds: float) -> Optional[Dict[str, float]]:
        x = float(per_step_seconds)
        if not math.isfinite(x) or x < 0:
            return None
        if len(self._recent) == self._recent_cap:
            self._baseline.append(self._recent.popleft())
        self._recent.append(x)
        if (len(self._recent) < self._recent_cap
                or len(self._baseline) < self._min_baseline):
            return None
        base = _p95(self._baseline)
        head = _p95(self._recent)
        if base <= 0 or head <= self.factor * base:
            return None
        self.regressions += 1
        # re-baseline: the regressed level becomes the new normal
        self._baseline.extend(self._recent)
        self._recent.clear()
        return {
            "step_time_p95": head,
            "baseline_p95": base,
            "ratio": head / base,
        }
