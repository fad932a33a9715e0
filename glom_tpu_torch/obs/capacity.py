"""Capacity accounting and the dry-run autoscale advisor.

The port's copy of ``glom_tpu/obs/capacity.py`` (stdlib only), the same code
but for one deliberate difference: :func:`read_bench_ceiling` reads only a
path it is given.  ``glom_tpu``'s falls back to the repository root's
``BENCH_*.json``, and every such file in this repository holds a TPU's rate,
which is no ceiling for a card: here no path means no ceiling, and
``capacity_utilization`` stays absent (the plane never guesses).
``capacity_pressure`` fires through the trigger engine's debounce, is
counted in ``pressure_fired`` and, with a forensics manager, writes a
bundle carrying the recommendation history.

Everything an autoscaler will need to DECIDE, computed
today from signals the serving stack already emits and retained as
series by :mod:`glom_tpu_torch.obs.timeseries`:

  * **duty cycle** — execute-span milliseconds (the
    ``serving_execute_ms`` histogram's ``_sum``) accumulated per wall
    second: the fraction of time the device is doing model work.
  * **effective imgs/s vs the measured ceiling** — the request-counter
    rate against a ``BENCH_*.json`` ``last_measured`` rate (the measured
    -utilization analogue of ``tools/mfu.py``'s analytic MFU).
  * **padding waste** — 1 - batch occupancy over the window, overall and
    per execution bucket.
  * **queue depth / shed ratio trends** and **per-tenant quota headroom**
    (admission-bucket tokens remaining / burst).

All are exported as ``capacity_*`` registry families, so they ride the
existing Prometheus/exemplar path unchanged, AND recorded into the
series store, so ``/debug/series`` can answer ``rate()``/trend/ETA
questions about them.

The **advisor** evaluates a declarative policy
(``--capacity-policy "p95_ms<250,duty<0.8,shed<0.01"``; grammar modeled
on :func:`~glom_tpu_torch.obs.slo.parse_slo`) over those series and emits
scale-up / scale-down / rebalance **recommendations**.  It NEVER acts —
the recommend-only contract is the point: the future autoscaler becomes
"execute what the advisor already says", and until then operators read
the same recommendation from the router timeline, ``/capacity``, and
the observatory console.  A scale-up recommendation that persists
``persist_windows`` evaluation windows fires the debounced
``capacity_pressure`` trigger through the existing
:class:`~glom_tpu_torch.obs.triggers.TriggerEngine` into a forensics bundle.

Stdlib-only, injectable clock, deterministic under a fake clock.
"""

from __future__ import annotations

import glob
import json
import os
import re
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from glom_tpu_torch.obs.timeseries import (
    DEFAULT_TIERS,
    RegistrySampler,
    SeriesStore,
    delta,
    eta_to_threshold,
    linear_trend,
    rate,
    trend_arrow,
)
from glom_tpu_torch.obs.triggers import TRIGGER_CAPACITY_PRESSURE

# recommendation actions (the advisor's whole output vocabulary)
ACTION_SCALE_UP = "scale_up"
ACTION_SCALE_DOWN = "scale_down"
ACTION_REBALANCE = "rebalance"
ACTION_HOLD = "hold"

#: policy signal -> the ``capacity_*`` series the forecasts read
SIGNAL_SERIES = {
    "duty": "capacity_duty_cycle",
    "p95_ms": "capacity_p95_ms",
    "shed": "capacity_shed_ratio",
    "queue": "capacity_queue_depth",
    "util": "capacity_utilization",
    "bulk_backlog": "capacity_bulk_backlog",
    "bulk_reclaimed": "capacity_bulk_reclaimed",
}

DEFAULT_POLICY = "p95_ms<250,duty<0.85,shed<0.01"


# ---------------------------------------------------------------------------
# declarative policy
# ---------------------------------------------------------------------------
_RULE_RE = re.compile(
    r"^(?P<signal>[a-z][a-z0-9_]*)(?P<op><|>)(?P<bound>-?\d+(?:\.\d+)?)$")


@dataclass(frozen=True)
class PolicyRule:
    """One bound: ``duty<0.8`` promises duty stays UNDER 0.8; ``>``
    promises the signal stays over (e.g. ``headroom`` style floors)."""

    signal: str
    op: str         # "<" | ">"
    bound: float

    @property
    def name(self) -> str:
        return f"{self.signal}{self.op}{self.bound:g}"

    def ok(self, value: float) -> bool:
        return value < self.bound if self.op == "<" else value > self.bound

    def load_fraction(self, value: float) -> Optional[float]:
        """How much of the bound is spent, in [0, inf): 1.0 = at the
        bound.  For ``<`` rules value/bound; for ``>`` rules bound/value
        (headroom consumed as the signal falls toward the floor)."""
        if self.op == "<":
            return value / self.bound if self.bound > 0 else None
        return self.bound / value if value > 0 else float("inf")


def parse_capacity_policy(spec: str) -> Tuple[PolicyRule, ...]:
    """Parse ``"p95_ms<250,duty<0.8,shed<0.01"`` — comma-separated
    ``signal{<|>}bound`` terms over the known capacity signals.  Unknown
    signals fail loud at startup (the :func:`~glom_tpu_torch.obs.slo.parse_slo`
    stance: a typo must not become a policy that silently never
    evaluates)."""
    rules: List[PolicyRule] = []
    for term in spec.split(","):
        term = term.strip()
        if not term:
            continue
        m = _RULE_RE.match(term)
        if not m:
            raise ValueError(
                f"unparseable capacity-policy term {term!r} "
                f"(want 'signal<bound' or 'signal>bound')")
        signal = m.group("signal")
        if signal not in SIGNAL_SERIES:
            raise ValueError(
                f"unknown capacity signal {signal!r}; valid signals: "
                f"{sorted(SIGNAL_SERIES)}")
        rules.append(PolicyRule(signal, m.group("op"),
                                float(m.group("bound"))))
    if not rules:
        raise ValueError(f"empty capacity policy {spec!r}")
    return tuple(rules)


def read_bench_ceiling(path: Optional[str] = None) -> Optional[float]:
    """The measured imgs/s/card ceiling from a ``BENCH_*.json``
    ``parsed.last_measured.value`` — ``path`` names a file or a directory
    holding them (newest wins).  Returns None when nothing parseable exists,
    and for ``path=None``: unlike ``glom_tpu``'s, it never reads the
    repository root, whose ``BENCH_*.json`` hold a TPU's rate (capacity
    accounting then skips the utilization ratio, it never guesses)."""
    if path is None:
        return None
    candidates = ([path] if os.path.isfile(path)
                  else sorted(glob.glob(os.path.join(path, "BENCH_*.json")),
                              key=os.path.getmtime, reverse=True))
    for cand in candidates:
        try:
            with open(cand) as f:
                doc = json.load(f)
            value = ((doc.get("parsed") or {})
                     .get("last_measured") or {}).get("value")
            if value is not None and float(value) > 0:
                return float(value)
        except (OSError, ValueError):
            continue
    return None


# ---------------------------------------------------------------------------
# capacity accounting
# ---------------------------------------------------------------------------
class CapacityAccountant:
    """Turns raw serving series into the capacity signal set.

    Reads the store's finest tier over the trailing ``window_s``, writes
    the results back as ``capacity_*`` gauges (Prometheus path) AND as
    series (trend/ETA path).  ``tenants_fn`` supplies the engine's
    :meth:`~glom_tpu_torch.serving.batcher.TenantAdmission.snapshot` when
    tenant quotas are configured."""

    def __init__(self, registry, store: SeriesStore, *,
                 ceiling_imgs_per_sec: Optional[float] = None,
                 window_s: float = 30.0,
                 tenants_fn: Optional[Callable[[], Optional[dict]]] = None):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.registry = registry
        self.store = store
        self.ceiling = ceiling_imgs_per_sec
        self.window_s = float(window_s)
        self.tenants_fn = tenants_fn

    def _window(self, name: str, now: float):
        return self.store.points(name, since=now - self.window_s,
                                 step=self.store.tiers[0][0])

    def signals(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Compute (without exporting) the current signal dict; values
        are None while their inputs have no window yet."""
        now = self.store.now() if now is None else float(now)
        out: Dict[str, Any] = {
            "duty": None, "imgs_per_sec": None, "util": None,
            "shed": None, "queue": None, "p95_ms": None,
            "padding_waste": None, "bulk_backlog": None,
            "bulk_reclaimed": None,
            "ceiling_imgs_per_sec": self.ceiling,
        }
        exec_pts = self._window("serving_execute_ms_sum", now)
        if len(exec_pts) >= 2:
            span = exec_pts[-1][0] - exec_pts[0][0]
            busy_ms = delta(exec_pts)
            if span > 0 and busy_ms is not None and busy_ms >= 0:
                out["duty"] = min(busy_ms / 1000.0 / span, 1.0)
        elif self._window("serving_requests_total", now):
            out["duty"] = 0.0  # serving, but nothing executed this window
        req_rate = rate(self._window("serving_requests_total", now))
        if req_rate is not None:
            out["imgs_per_sec"] = req_rate
            if self.ceiling:
                out["util"] = req_rate / self.ceiling
        shed_pts = self._window("serving_shed_total", now)
        req_pts = self._window("serving_requests_total", now)
        d_shed = delta(shed_pts)
        d_req = delta(req_pts)
        if d_req is not None:
            d_shed = d_shed or 0.0
            served = max(0.0, d_req) + max(0.0, d_shed)
            out["shed"] = (max(0.0, d_shed) / served) if served else 0.0
        queue_pts = self._window("serving_queue_depth", now)
        if queue_pts:
            out["queue"] = sum(v for _, v in queue_pts) / len(queue_pts)
        p95 = self.store.latest("serving_request_ms_p95")
        if p95 is not None:
            out["p95_ms"] = p95
        occ_sum = delta(self._window("serving_batch_occupancy_sum", now))
        occ_n = delta(self._window("serving_batch_occupancy_count", now))
        if occ_sum is not None and occ_n:
            out["padding_waste"] = max(0.0, 1.0 - occ_sum / occ_n)
        # bulk tier: queued offline work is a scale signal (a trough
        # with a backlog is being scavenged, not idle), and the slot
        # rate is the utilization the scavenger reclaims from padding
        # residue + idle windows
        backlog = self.store.latest("bulk_backlog_slots")
        if backlog is not None:
            out["bulk_backlog"] = backlog
        reclaimed = rate(self._window("bulk_slots_total", now))
        if reclaimed is not None:
            out["bulk_reclaimed"] = reclaimed
        return out

    def _per_bucket_waste(self, now: float) -> Dict[str, float]:
        """Windowed padding waste per execution bucket, from the
        ``serving_batch_occupancy_b<k>`` per-bucket histograms."""
        out: Dict[str, float] = {}
        for key in self.store.names("serving_batch_occupancy_b"):
            if not key.endswith("_sum"):
                continue
            base = key[: -len("_sum")]
            occ_sum = delta(self._window(f"{base}_sum", now))
            occ_n = delta(self._window(f"{base}_count", now))
            if occ_sum is not None and occ_n:
                bucket = base[len("serving_batch_occupancy_b"):]
                out[bucket] = max(0.0, 1.0 - occ_sum / occ_n)
        return out

    def update(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One accounting pass: compute, export as ``capacity_*`` gauges,
        record into the store, return the signal dict."""
        now = self.store.now() if now is None else float(now)
        sig = self.signals(now)
        recorded: Dict[str, float] = {}
        gauge_of = {
            "duty": ("capacity_duty_cycle",
                     "execute-span time / wall time, trailing window"),
            "imgs_per_sec": ("capacity_effective_imgs_per_sec",
                             "served image rate, trailing window"),
            "util": ("capacity_utilization",
                     "effective imgs/s vs the BENCH last_measured ceiling"),
            "shed": ("capacity_shed_ratio",
                     "shed / (served + shed), trailing window"),
            "queue": ("capacity_queue_depth",
                      "mean queued images, trailing window"),
            "p95_ms": ("capacity_p95_ms",
                       "request p95 latency (reservoir), ms"),
            "padding_waste": ("capacity_padding_waste",
                              "1 - batch occupancy, trailing window"),
            "bulk_backlog": ("capacity_bulk_backlog",
                             "bulk slots queued but not durably finished"),
            "bulk_reclaimed": ("capacity_bulk_reclaimed",
                               "bulk slots/s reclaimed from bucket "
                               "padding and idle windows"),
        }
        for key, (name, help_) in gauge_of.items():
            if sig[key] is None:
                continue
            value = round(float(sig[key]), 6)
            self.registry.gauge(name, help=help_).set(value)
            recorded[name] = value
        if self.ceiling:
            self.registry.gauge(
                "capacity_ceiling_imgs_per_sec",
                help="measured imgs/s/chip ceiling (BENCH last_measured)",
            ).set(self.ceiling)
        per_bucket = self._per_bucket_waste(now)
        sig["padding_waste_per_bucket"] = per_bucket
        for bucket, waste in per_bucket.items():
            name = self.registry.labeled("capacity_padding_waste_b", bucket)
            self.registry.gauge(
                name, help="1 - batch occupancy for one execution bucket",
            ).set(round(waste, 6))
            recorded[name] = round(waste, 6)
        headroom = self._tenant_headroom()
        sig["tenant_headroom"] = headroom
        for tenant, frac in (headroom or {}).items():
            name = self.registry.labeled("capacity_tenant_headroom_", tenant)
            self.registry.gauge(
                name, help="admission-bucket tokens remaining / burst",
            ).set(round(frac, 6))
            recorded[name] = round(frac, 6)
        # recorded NOW (not on the next sampler pass) so the advisor's
        # trend window always includes the signals it is judging
        self.store.record_snapshot(recorded, t=now)
        return sig

    def _tenant_headroom(self) -> Optional[Dict[str, float]]:
        snap = self.tenants_fn() if self.tenants_fn is not None else None
        if not snap:
            return None
        out: Dict[str, float] = {}
        for tenant, state in snap.items():
            burst = float(state.get("burst") or 0)
            if burst > 0:
                out[tenant] = float(state.get("tokens", 0.0)) / burst
        return out


# ---------------------------------------------------------------------------
# the dry-run advisor
# ---------------------------------------------------------------------------
class CapacityAdvisor:
    """Recommend-only policy evaluator.

    ``evaluate(signals)`` returns one recommendation dict per call:
    ``scale_up`` when any policy rule is violated, ``rebalance`` when no
    rule is violated but per-replica duty cycles have spread apart
    (fleet plane only), ``scale_down`` when every evaluated rule sits
    below ``low_water`` of its bound, ``hold`` otherwise.  ``persisted``
    counts consecutive windows with the same action — the debounce input
    for the ``capacity_pressure`` trigger.  This class never mutates the
    fleet; acting on a recommendation is a DIFFERENT subsystem's job, by
    design."""

    def __init__(self, rules: Sequence[PolicyRule], *,
                 low_water: float = 0.5, duty_spread: float = 0.35,
                 registry=None):
        if not rules:
            raise ValueError("advisor needs at least one policy rule")
        if not 0.0 < low_water < 1.0:
            raise ValueError(f"low_water must be in (0, 1), got {low_water}")
        self.rules = tuple(rules)
        self.low_water = low_water
        self.duty_spread = duty_spread
        self.registry = registry
        self.history: deque = deque(maxlen=128)
        self._streak_action: Optional[str] = None
        self._streak = 0
        self.evaluations = 0

    @property
    def policy(self) -> str:
        return ",".join(r.name for r in self.rules)

    def evaluate(self, signals: Dict[str, Any], *,
                 per_replica_duty: Optional[Dict[str, float]] = None,
                 t: Optional[float] = None) -> Dict[str, Any]:
        self.evaluations += 1
        violations: List[str] = []
        fractions: List[float] = []
        for rule in self.rules:
            value = signals.get(rule.signal)
            if value is None:
                continue
            if not rule.ok(value):
                violations.append(f"{rule.name} (now {value:.4g})")
            frac = rule.load_fraction(value)
            if frac is not None:
                fractions.append(frac)
        spread = None
        if per_replica_duty and len(per_replica_duty) >= 2:
            duties = list(per_replica_duty.values())
            spread = max(duties) - min(duties)
        if violations:
            action, reasons = ACTION_SCALE_UP, violations
        elif spread is not None and spread > self.duty_spread:
            action = ACTION_REBALANCE
            reasons = [f"duty spread {spread:.2f} > {self.duty_spread:.2f} "
                       f"across {len(per_replica_duty)} replicas"]
        elif fractions and max(fractions) < self.low_water:
            backlog = signals.get("bulk_backlog")
            if isinstance(backlog, (int, float)) and backlog > 0:
                # a quiet fleet with queued bulk work is not idle — it
                # is a trough being scavenged; shrinking it now would
                # just stretch the backlog (docs/BULK.md)
                action = ACTION_HOLD
                reasons = [f"trough being scavenged: bulk backlog "
                           f"{backlog:g} slots"]
            else:
                action = ACTION_SCALE_DOWN
                reasons = [f"all signals under {self.low_water:.0%} of "
                           f"policy bounds (peak {max(fractions):.0%})"]
        else:
            action, reasons = ACTION_HOLD, []
        if action == self._streak_action:
            self._streak += 1
        else:
            self._streak_action, self._streak = action, 1
        rec = {
            "t": t,
            "window": self.evaluations,
            "action": action,
            "reasons": reasons,
            "persisted": self._streak,
            "signals": {k: (round(v, 6) if isinstance(v, float) else v)
                        for k, v in signals.items()
                        if not isinstance(v, dict)},
        }
        self.history.append(rec)
        if self.registry is not None:
            pressure = {ACTION_SCALE_UP: 1.0, ACTION_SCALE_DOWN: -1.0}
            self.registry.gauge(
                "capacity_advisor_pressure",
                help="advisor direction: 1 scale-up, -1 scale-down, "
                     "0 hold/rebalance",
            ).set(pressure.get(action, 0.0))
            self.registry.counter(
                "capacity_recommendations_total",
                help="advisor evaluation windows",
            ).inc()
        return rec


def forecasts(store: SeriesStore, rules: Sequence[PolicyRule], *,
              window_s: float = 120.0,
              now: Optional[float] = None) -> List[Dict[str, Any]]:
    """Per-rule trend + ETA-to-threshold over the signal's series: the
    "minutes until this bound is breached at the current slope" read the
    console renders next to each arrow."""
    now = store.now() if now is None else float(now)
    out: List[Dict[str, Any]] = []
    for rule in rules:
        series = SIGNAL_SERIES[rule.signal]
        pts = store.points(series, since=now - window_s,
                           step=store.tiers[0][0])
        fit = linear_trend(pts)
        out.append({
            "rule": rule.name,
            "signal": rule.signal,
            "value": pts[-1][1] if pts else None,
            "slope_per_s": None if fit is None else fit["slope"],
            "arrow": trend_arrow(None if fit is None else fit["slope"]),
            "eta_s": eta_to_threshold(pts, rule.bound),
        })
    return out


# ---------------------------------------------------------------------------
# the per-replica plane (engine-side glue)
# ---------------------------------------------------------------------------
class CapacityPlane:
    """One replica's whole capacity plane: series store + registry
    sampler + accountant + advisor, ticked as a unit.

    ``tick()`` is the deterministic entry (fake clock in tests); a real
    server runs :meth:`start`'s timer thread.  When a scale-up
    recommendation persists ``persist_windows`` evaluation windows the
    plane fires ``capacity_pressure`` through the engine's shared
    :class:`~glom_tpu_torch.obs.triggers.TriggerEngine` (debounce + budget)
    into a forensics bundle carrying the recommendation history."""

    def __init__(self, registry, *, policy: str = DEFAULT_POLICY,
                 ceiling_imgs_per_sec: Optional[float] = None,
                 interval_s: float = 1.0, window_s: float = 30.0,
                 persist_windows: int = 5,
                 tiers: Sequence[Tuple[float, int]] = DEFAULT_TIERS,
                 clock: Optional[Callable[[], float]] = None,
                 triggers=None, forensics=None,
                 tenants_fn: Optional[Callable[[], Optional[dict]]] = None,
                 on_recommend: Optional[Callable[[dict], None]] = None):
        if persist_windows < 1:
            raise ValueError(
                f"persist_windows must be >= 1, got {persist_windows}")
        self._clock = clock if clock is not None else time.monotonic
        self.store = SeriesStore(tiers=tiers, clock=self._clock)
        self.sampler = RegistrySampler(registry, self.store,
                                       interval_s=interval_s,
                                       clock=self._clock)
        self.accountant = CapacityAccountant(
            registry, self.store, ceiling_imgs_per_sec=ceiling_imgs_per_sec,
            window_s=window_s, tenants_fn=tenants_fn)
        self.advisor = CapacityAdvisor(parse_capacity_policy(policy),
                                       registry=registry)
        self.persist_windows = persist_windows
        self.triggers = triggers
        self.forensics = forensics
        self.on_recommend = on_recommend
        self._last_emitted: Optional[str] = None
        self.pressure_fired = 0
        self._lock = threading.Lock()  # tick vs HTTP payload readers
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def tick(self, now: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """Sample-if-due, account, advise.  Returns the recommendation
        when a window was evaluated, else None."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            if not self.sampler.tick(now):
                return None
            signals = self.accountant.update(now)
            rec = self.advisor.evaluate(signals, t=round(now, 6))
            self._after_evaluate(rec)
            return rec

    def _after_evaluate(self, rec: Dict[str, Any]) -> None:
        if self.on_recommend is not None and (
                rec["action"] != self._last_emitted):
            self._last_emitted = rec["action"]
            try:
                self.on_recommend(rec)
            except Exception:  # glomlint: disable=conc-broad-except -- a broken recommendation sink (closed router, test stub) must not kill the sampling thread; the /capacity payload still carries the history
                pass
        if (rec["action"] == ACTION_SCALE_UP
                and rec["persisted"] >= self.persist_windows):
            self._fire_pressure(rec)

    def _fire_pressure(self, rec: Dict[str, Any]) -> None:
        if self.triggers is None:
            return
        window = rec["window"]
        if not self.triggers.fire(TRIGGER_CAPACITY_PRESSURE, window):
            return
        self.pressure_fired += 1
        if self.forensics is None:
            return
        detail = {
            "policy": self.advisor.policy,
            "recommendation": rec,
            "persist_windows": self.persist_windows,
            "history": list(self.advisor.history)[-16:],
            "forecasts": forecasts(self.store, self.advisor.rules),
        }
        path = self.forensics.capture(
            TRIGGER_CAPACITY_PRESSURE, window, detail, trace=False)
        if path is None:
            self.triggers.refund(TRIGGER_CAPACITY_PRESSURE, window)

    # -- views --------------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        """The small dict ``/healthz`` carries (and the router ingests
        for its fleet series): current signals + the latest action."""
        with self._lock:
            last = self.advisor.history[-1] if self.advisor.history else None
            return {
                "signals": dict(last["signals"]) if last else {},
                "action": last["action"] if last else None,
                "persisted": last["persisted"] if last else 0,
                "window": self.accountant.window_s,
            }

    def payload(self) -> Dict[str, Any]:
        """The ``GET /capacity`` body."""
        with self._lock:
            history = list(self.advisor.history)
            return {
                "role": "replica",
                "policy": self.advisor.policy,
                "persist_windows": self.persist_windows,
                "recommendation": history[-1] if history else None,
                "history": history[-16:],
                "forecasts": forecasts(self.store, self.advisor.rules),
                "pressure_fired": self.pressure_fired,
                "series_names": self.store.names("capacity_"),
            }

    def series_payload(self, query_string: str = "") -> Dict[str, Any]:
        return self.store.payload(query_string)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.sampler.interval_s):
                self.tick()

        self._thread = threading.Thread(
            target=loop, name="glom-capacity", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)


# ---------------------------------------------------------------------------
# the fleet plane (router / observatory glue)
# ---------------------------------------------------------------------------
class FleetCapacityPlane:
    """Fleet-aggregate capacity: per-replica signal series (ingested
    from each replica's ``/healthz`` capacity summary, which the router
    health loop already fetches) plus the fleet roll-up the fleet-level
    advisor judges.  Per-replica series are labeled
    (``capacity_duty_cycle{replica="r0"}``); fleet aggregates keep the
    bare name — one store answers both ``/debug/series`` shapes."""

    #: signal -> fleet aggregation over replicas
    _AGG = {
        "duty": "mean", "imgs_per_sec": "sum", "util": "mean",
        "shed": "mean", "queue": "sum", "p95_ms": "max",
        "padding_waste": "mean",
        # bulk tier: backlogs and reclaimed slot rates add across replicas
        "bulk_backlog": "sum", "bulk_reclaimed": "sum",
    }

    def __init__(self, *, policy: str = DEFAULT_POLICY,
                 persist_windows: int = 5,
                 tiers: Sequence[Tuple[float, int]] = DEFAULT_TIERS,
                 clock: Optional[Callable[[], float]] = None,
                 registry=None,
                 on_recommend: Optional[Callable[[dict], None]] = None):
        self._clock = clock if clock is not None else time.monotonic
        self.store = SeriesStore(tiers=tiers, clock=self._clock)
        self.advisor = CapacityAdvisor(parse_capacity_policy(policy),
                                       registry=registry)
        self.registry = registry
        self.persist_windows = persist_windows
        self.on_recommend = on_recommend
        self._last_emitted: Optional[str] = None
        self._lock = threading.Lock()
        # replica -> latest ingested signal dict (bounded by fleet size:
        # one entry per replica name the router knows)
        self._replica_signals: Dict[str, Dict[str, Any]] = {}

    def ingest(self, replica: str, capacity_summary: Optional[dict], *,
               t: Optional[float] = None) -> None:
        """Fold one replica's ``/healthz`` capacity summary in (the
        router calls this from its health pass; stale replicas simply
        stop being ingested and age out of the window)."""
        if not isinstance(capacity_summary, dict):
            return
        signals = capacity_summary.get("signals")
        if not isinstance(signals, dict):
            return
        t = self._clock() if t is None else float(t)
        with self._lock:
            self._replica_signals[replica] = dict(signals)
            numeric = {f"capacity_{_SIGNAL_SUFFIX.get(k, k)}": v
                       for k, v in signals.items()
                       if isinstance(v, (int, float))}
            self.store.record_snapshot(
                numeric, t=t, labels={"replica": replica})

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Aggregate the latest per-replica signals, record the fleet
        series, run the fleet advisor."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            fleet: Dict[str, Any] = {}
            for signal, agg in self._AGG.items():
                values = [s.get(signal) for s in
                          self._replica_signals.values()
                          if isinstance(s.get(signal), (int, float))]
                if not values:
                    fleet[signal] = None
                elif agg == "sum":
                    fleet[signal] = sum(values)
                elif agg == "max":
                    fleet[signal] = max(values)
                else:
                    fleet[signal] = sum(values) / len(values)
            per_duty = {name: s["duty"]
                        for name, s in self._replica_signals.items()
                        if isinstance(s.get("duty"), (int, float))}
            recorded = {
                f"capacity_{_SIGNAL_SUFFIX.get(k, k)}": v
                for k, v in fleet.items() if isinstance(v, (int, float))
            }
            self.store.record_snapshot(recorded, t=now)
            if self.registry is not None:
                for name, value in recorded.items():
                    self.registry.gauge(
                        name, help="fleet-aggregate capacity signal",
                    ).set(round(float(value), 6))
            rec = self.advisor.evaluate(fleet, per_replica_duty=per_duty,
                                        t=round(now, 6))
            rec["per_replica_duty"] = {k: round(v, 4)
                                       for k, v in per_duty.items()}
        if self.on_recommend is not None and (
                rec["action"] != self._last_emitted):
            self._last_emitted = rec["action"]
            try:
                self.on_recommend(rec)
            except Exception:  # glomlint: disable=conc-broad-except -- the timeline sink must not kill the health loop; /capacity still carries the history
                pass
        return rec

    def payload(self) -> Dict[str, Any]:
        """The router's ``GET /capacity`` body."""
        with self._lock:
            history = list(self.advisor.history)
            return {
                "role": "router",
                "policy": self.advisor.policy,
                "persist_windows": self.persist_windows,
                "recommendation": history[-1] if history else None,
                "history": history[-16:],
                "forecasts": forecasts(self.store, self.advisor.rules),
                "replicas": {name: dict(sig) for name, sig
                             in self._replica_signals.items()},
                "series_names": self.store.names("capacity_"),
            }

    def series_payload(self, query_string: str = "") -> Dict[str, Any]:
        return self.store.payload(query_string)


#: advisor signal key -> capacity series suffix (signals() keys mostly
#: match their series names; the exceptions are spelled here once)
_SIGNAL_SUFFIX = {
    "duty": "duty_cycle",
    "imgs_per_sec": "effective_imgs_per_sec",
    "util": "utilization",
    "shed": "shed_ratio",
    "queue": "queue_depth",
    "p95_ms": "p95_ms",
    "padding_waste": "padding_waste",
    "bulk_backlog": "bulk_backlog",
    "bulk_reclaimed": "bulk_reclaimed",
}
