"""Declarative SLOs with multi-window burn-rate alerting.

The port's copy of ``glom_tpu/obs/slo.py`` (stdlib only), the same code
so both packages export the same metrics, traces and alerts.

An SLO is a promise over a window of events — "95% of ``/embed`` requests
under 250 ms", "99% of requests not errors" — and the operational signal
is not the raw percentile but the **burn rate**: how fast the error
budget (the allowed bad fraction) is being spent.  Burn rate 1 means the
budget lasts exactly the window; burn rate 14 means a page-worthy fire.
The multi-window rule (the SRE-workbook standard) requires BOTH a short
and a long window to exceed the threshold: the short window makes the
alert fast, the long window keeps one anomalous second from paging.

Pieces:

  * :class:`SLO` — one declarative target (``parse_slo`` reads the CLI
    form ``embed:p95<250ms`` / ``errors<1%``).
  * :class:`BurnRateEvaluator` — event-fed, injectable-clock evaluator of
    one SLO: ``observe(bad, trace_id)`` + ``evaluate()`` -> detail dict
    when both windows burn past the threshold.
  * :class:`SloManager` — routes request outcomes to evaluators, exports
    burn rates as gauges, and fires the shared
    :class:`~glom_tpu_torch.obs.triggers.TriggerEngine` (``slo_burn`` trigger)
    into a forensics bundle naming the offending trace IDs — with their
    spans attached when a :class:`~glom_tpu_torch.obs.tracing.Tracer` still
    retains them.

Host-side bookkeeping only; deterministic under a fake clock.
"""

from __future__ import annotations

import re
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

from glom_tpu_torch.obs.quality import QUALITY_SLO_METRICS
from glom_tpu_torch.obs.triggers import TRIGGER_QUALITY_DRIFT, TRIGGER_SLO_BURN


@dataclass(frozen=True)
class SLO:
    """One declarative target.

    ``kind`` is ``"latency"`` (bad = latency_ms > threshold_ms; the
    objective encodes the percentile — objective 0.95 + threshold 250
    reads "p95 < 250 ms") or ``"error_rate"`` (bad = request errored;
    objective 0.99 reads "error rate < 1%") or ``"quality"`` (bad = a
    model-quality signal — island ``agreement``, sketch ``drift``,
    shadow-compare ``divergence``, … — crossed ``threshold`` in the
    direction ``bad_below`` encodes).  ``endpoint`` None matches
    every endpoint; ``tenant`` None matches every tenant (a per-tenant
    SLO sees only that tenant's outcomes — the alerting half of the
    bulkhead: tenant A's burn can never page for tenant B's traffic)."""

    name: str
    kind: str                       # "latency" | "error_rate" | "quality"
    objective: float                # good fraction promised, in (0, 1)
    threshold_ms: Optional[float] = None   # latency kind only
    endpoint: Optional[str] = None          # None = all endpoints
    tenant: Optional[str] = None            # None = all tenants
    short_window_s: float = 60.0
    long_window_s: float = 300.0
    burn_threshold: float = 2.0     # both windows must burn past this
    min_events: int = 10            # per window, before it can fire
    # quality kind only: which signal, the bound, and its direction
    # (``agreement>0.55`` promises the value stays ABOVE => bad_below)
    metric: Optional[str] = None
    threshold: Optional[float] = None
    bad_below: bool = False

    def __post_init__(self):
        if self.kind not in ("latency", "error_rate", "quality"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if self.kind == "quality":
            if self.metric not in QUALITY_SLO_METRICS:
                raise ValueError(
                    f"quality SLO metric must be one of "
                    f"{QUALITY_SLO_METRICS}, got {self.metric!r}")
            if self.threshold is None:
                raise ValueError("quality SLO needs a threshold")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {self.objective}"
            )
        if self.kind == "latency" and (
            self.threshold_ms is None or self.threshold_ms <= 0
        ):
            raise ValueError(
                f"latency SLO needs threshold_ms > 0, got {self.threshold_ms}"
            )
        if self.short_window_s <= 0 or self.long_window_s < self.short_window_s:
            raise ValueError(
                f"need 0 < short_window_s <= long_window_s, got "
                f"{self.short_window_s}/{self.long_window_s}"
            )
        if self.burn_threshold <= 0:
            raise ValueError(
                f"burn_threshold must be > 0, got {self.burn_threshold}"
            )

    @property
    def budget(self) -> float:
        """Allowed bad fraction (1 - objective)."""
        return 1.0 - self.objective


_LATENCY_RE = re.compile(
    r"^(?:(?P<tenant>[A-Za-z0-9._-]+)/)?(?:(?P<ep>[a-z_]+):)?"
    r"p(?P<pct>\d{1,2}(?:\.\d+)?)<(?P<ms>\d+(?:\.\d+)?)ms$"
)
_ERROR_RE = re.compile(
    r"^(?:(?P<tenant>[A-Za-z0-9._-]+)/)?(?:(?P<ep>[a-z_]+):)?"
    r"errors<(?P<pct>\d+(?:\.\d+)?)%$"
)
_QUALITY_RE = re.compile(
    r"^(?:(?P<tenant>[A-Za-z0-9._-]+)/)?(?:(?P<ep>[a-z_]+):)?"
    r"(?P<metric>" + "|".join(QUALITY_SLO_METRICS) + r")"
    r"(?P<op>[<>])(?P<val>\d+(?:\.\d+)?)$"
)

#: good fraction promised by a quality objective when the spec doesn't
#: say (quality specs carry a value bound, not a percentile — the burn
#: budget is the 10% of sampled requests allowed to cross it)
QUALITY_DEFAULT_OBJECTIVE = 0.9


def parse_slo(spec: str, **overrides) -> SLO:
    """Parse the CLI form:

      * ``embed:p95<250ms`` — latency: 95% of /embed requests under 250 ms
      * ``p99<1000ms``      — latency, all endpoints
      * ``errors<1%``       — error rate under 1% (objective 0.99)
      * ``embed:errors<0.5%``
      * ``acme/embed:p95<250ms`` — per-tenant: only outcomes tagged
        tenant ``acme`` feed this target (the bulkhead's alerting half)
      * ``acme/errors<1%``
      * ``embed:agreement>0.55`` — quality: sampled /embed requests'
        island agreement must stay above 0.55 (``>`` = bad when below)
      * ``drift<0.25`` — quality: live-vs-reference sketch drift (max
        KS) must stay under 0.25; ``divergence<0.2`` guards the shadow
        lane's primary-vs-candidate comparison the same way

    ``overrides`` pass through to :class:`SLO` (windows, burn threshold).
    """
    spec = spec.strip()
    m = _QUALITY_RE.match(spec)
    if m:
        overrides.setdefault("objective", QUALITY_DEFAULT_OBJECTIVE)
        return SLO(
            name=spec, kind="quality",
            metric=m.group("metric"), threshold=float(m.group("val")),
            bad_below=m.group("op") == ">",
            endpoint=m.group("ep"), tenant=m.group("tenant"), **overrides,
        )
    m = _LATENCY_RE.match(spec)
    if m:
        return SLO(
            name=spec, kind="latency",
            objective=float(m.group("pct")) / 100.0,
            threshold_ms=float(m.group("ms")),
            endpoint=m.group("ep"), tenant=m.group("tenant"), **overrides,
        )
    m = _ERROR_RE.match(spec)
    if m:
        rate = float(m.group("pct")) / 100.0
        if not 0.0 < rate < 1.0:
            raise ValueError(f"error-rate bound must be in (0, 100)%: {spec!r}")
        return SLO(
            name=spec, kind="error_rate", objective=1.0 - rate,
            endpoint=m.group("ep"), tenant=m.group("tenant"), **overrides,
        )
    raise ValueError(
        f"unparseable SLO spec {spec!r} (want '[tenant/][ep:]p95<250ms', "
        f"'[tenant/]errors<1%', or a quality objective like "
        f"'[tenant/][ep:]agreement>0.55' / 'drift<0.25')"
    )


class BurnRateEvaluator:
    """Event-window burn-rate math for one SLO.

    Two rolling windows, each a deque of ``(t, bad[, trace_id])`` events
    with RUNNING total/bad counters: observing is O(1) amortized (append
    + prune the aged head), so the evaluator stays off the request path's
    critical cost even at hundreds of events per second over a minutes-
    long window — a linear rescan per observation would make the SLO
    layer itself the latency it exists to diagnose.  ``evaluate()``
    returns a detail dict when BOTH windows hold ``min_events`` and burn
    past ``burn_threshold`` — else None.  The caller decides what a
    firing costs (the TriggerEngine debounces bundles); this class just
    measures."""

    def __init__(self, slo: SLO, clock: Optional[Callable[[], float]] = None):
        self.slo = slo
        self._clock = clock if clock is not None else time.monotonic
        # short window keeps trace ids (the offender list); long doesn't
        self._short: deque = deque()   # (t, bad, trace_id)
        self._long: deque = deque()    # (t, bad)
        self._short_bad = 0
        self._long_bad = 0

    def observe(self, bad: bool, trace_id: Optional[str] = None) -> None:
        now = self._clock()
        bad = bool(bad)
        self._short.append((now, bad, trace_id))
        self._long.append((now, bad))
        self._short_bad += bad
        self._long_bad += bad
        self._prune(now)

    def _prune(self, now: float) -> None:
        t_short = now - self.slo.short_window_s
        while self._short and self._short[0][0] < t_short:
            self._short_bad -= self._short.popleft()[1]
        t_long = now - self.slo.long_window_s
        while self._long and self._long[0][0] < t_long:
            self._long_bad -= self._long.popleft()[1]

    def burn_rates(self) -> Dict[str, Optional[float]]:
        """Current short/long burn rates (None while a window is below
        ``min_events`` — no basis to report)."""
        self._prune(self._clock())
        out: Dict[str, Optional[float]] = {}
        for label, window, bad in (("short", self._short, self._short_bad),
                                   ("long", self._long, self._long_bad)):
            out[label] = (
                (bad / len(window)) / self.slo.budget
                if len(window) >= self.slo.min_events else None
            )
        return out

    def is_breach(self, rates: Dict[str, Optional[float]]) -> bool:
        short, long_ = rates["short"], rates["long"]
        return (short is not None and long_ is not None
                and short >= self.slo.burn_threshold
                and long_ >= self.slo.burn_threshold)

    def breach_detail(self, rates: Dict[str, Optional[float]]) -> Dict[str, Any]:
        """The firing's evidence, including the offender scan over the
        short window — O(window), so callers invoke it only for firings
        that survive the debounce, not per observation."""
        offending = [tid for _, bad, tid in self._short
                     if bad and tid is not None]
        return {
            "slo": self.slo.name,
            "kind": self.slo.kind,
            "objective": self.slo.objective,
            "burn_rate_short": round(rates["short"], 3),
            "burn_rate_long": round(rates["long"], 3),
            "burn_threshold": self.slo.burn_threshold,
            # newest offenders first, bounded: the bundle must stay small
            "trace_ids": offending[-20:][::-1],
        }

    def evaluate(self) -> Optional[Dict[str, Any]]:
        rates = self.burn_rates()
        return self.breach_detail(rates) if self.is_breach(rates) else None


class SloManager:
    """Routes request outcomes to evaluators and turns burn into action.

    ``observe(endpoint, latency_ms, error, trace_id, step)`` feeds every
    matching SLO and, on a multi-window burn, exports
    ``slo_burn_events`` / per-SLO burn-rate gauges through ``registry``
    and fires ``triggers`` (``slo_burn``) into a ``forensics`` bundle
    whose detail names the offending trace IDs — attaching their spans
    (``slo_traces.json``) when ``tracer`` still retains them.  NOT
    internally locked: the caller serializes ``observe`` (the serving
    engine holds a dedicated SLO lock around it, kept separate from its
    request-path lock so a capture's bundle write never stalls batch
    accounting or the hot-reload swap)."""

    def __init__(self, slos: Sequence[SLO], *, clock=None, registry=None,
                 triggers=None, forensics=None, tracer=None):
        self._clock = clock if clock is not None else time.monotonic
        self.evaluators = [BurnRateEvaluator(s, clock=self._clock)
                           for s in slos]
        self.registry = registry
        self.triggers = triggers
        self.forensics = forensics
        self.tracer = tracer
        # bounded: under a sustained burn EVERY observation produces a
        # detail (only bundle writes are debounced) — an unbounded list
        # would grow for the whole incident
        self.fired: "deque" = deque(maxlen=64)
        # recent (trace_id, input_fingerprint) pairs from the quality
        # path, so a quality_drift bundle can name the INPUTS behind the
        # offending traces; bounded like the offender list itself
        self._quality_fingerprints: "deque" = deque(maxlen=128)

    def observe(self, endpoint: str, latency_ms: Optional[float],
                error: bool, trace_id: Optional[str] = None,
                step: int = 0,
                tenant: Optional[str] = None) -> List[Dict[str, Any]]:
        fired = []
        for ev in self.evaluators:
            slo = ev.slo
            if slo.kind == "quality":
                continue  # fed by observe_quality (sampled post-pass)
            if slo.endpoint is not None and slo.endpoint != endpoint:
                continue
            if slo.tenant is not None and slo.tenant != tenant:
                continue
            if slo.kind == "latency":
                if latency_ms is None:
                    continue  # errored before a latency existed
                bad = latency_ms > slo.threshold_ms
            else:
                bad = error
            ev.observe(bad, trace_id)
            rates = ev.burn_rates()
            if self.registry is not None and rates["short"] is not None:
                # refreshed every observation, breach or not — a gauge
                # only written at breach time would freeze at the breach
                # value forever and never show recovery
                self.registry.gauge(
                    f"slo_burn_rate_{_slug(slo.name)}",
                    help=f"short-window burn rate of SLO {slo.name}",
                ).set(round(rates["short"], 3))
            if not ev.is_breach(rates):
                continue
            # the debounce gates EVERYTHING downstream of a breach: the
            # detection counter, the O(window) offender scan, and the
            # bundle — during a sustained burn every request is a breach
            # observation, and per-request detail building would make the
            # SLO layer the request-path cost it exists to diagnose
            if self.triggers is not None and not self.triggers.fire(
                TRIGGER_SLO_BURN, step
            ):
                continue
            detail = ev.breach_detail(rates)
            fired.append(detail)
            self.fired.append(detail)
            if self.registry is not None:
                self.registry.counter(
                    "slo_burn_events",
                    help="multi-window SLO burn-rate detections "
                         "(debounced; one per incident window)",
                ).inc()
            self._capture(detail, step)
        return fired

    def observe_quality(self, values: Dict[str, float], *,
                        endpoint: Optional[str] = None,
                        trace_id: Optional[str] = None, step: int = 0,
                        tenant: Optional[str] = None,
                        fingerprint: Optional[str] = None,
                        ) -> List[Dict[str, Any]]:
        """Feed one sampled request's quality signals (``{metric:
        value}``; missing metrics skip their evaluators) through every
        matching QUALITY objective.  Same multi-window burn machinery as
        request outcomes, but a breach fires the ``quality_drift``
        trigger and the bundle carries input FINGERPRINTS alongside the
        offending trace ids — "which inputs parsed badly", not just
        "which requests were slow".  Same locking contract as
        :meth:`observe` (the caller serializes)."""
        if trace_id and fingerprint:
            self._quality_fingerprints.append((trace_id, fingerprint))
        fired = []
        for ev in self.evaluators:
            slo = ev.slo
            if slo.kind != "quality":
                continue
            if slo.endpoint is not None and endpoint is not None \
                    and slo.endpoint != endpoint:
                continue
            if slo.tenant is not None and slo.tenant != tenant:
                continue
            value = values.get(slo.metric)
            if value is None:
                continue
            value = float(value)
            bad = (value < slo.threshold if slo.bad_below
                   else value > slo.threshold)
            ev.observe(bad, trace_id)
            rates = ev.burn_rates()
            if self.registry is not None and rates["short"] is not None:
                self.registry.gauge(
                    f"slo_burn_rate_{_slug(slo.name)}",
                    help=f"short-window burn rate of SLO {slo.name}",
                ).set(round(rates["short"], 3))
            if not ev.is_breach(rates):
                continue
            if self.triggers is not None and not self.triggers.fire(
                TRIGGER_QUALITY_DRIFT, step
            ):
                continue
            detail = ev.breach_detail(rates)
            detail["metric"] = slo.metric
            detail["value"] = round(value, 6)
            detail["threshold"] = slo.threshold
            # which INPUTS parsed badly: fingerprints for the offenders
            # (bounded by the fingerprint ring and the trace-id cap)
            known = dict(self._quality_fingerprints)
            detail["fingerprints"] = {
                tid: known[tid] for tid in detail.get("trace_ids", ())
                if tid in known
            }
            fired.append(detail)
            self.fired.append(detail)
            if self.registry is not None:
                self.registry.counter(
                    "quality_drift_events",
                    help="quality-objective burn detections (debounced)",
                ).inc()
            self._capture(detail, step, trigger=TRIGGER_QUALITY_DRIFT)
        return fired

    def _capture(self, detail: Dict[str, Any], step: int,
                 trigger: str = TRIGGER_SLO_BURN) -> None:
        if self.forensics is None:
            return
        extra = None
        if self.tracer is not None and detail.get("trace_ids"):
            traces = {
                tid: [s.to_dict() for s in self.tracer.sink.trace(tid)]
                for tid in detail["trace_ids"]
            }
            extra = {"slo_traces.json": {
                k: v for k, v in traces.items() if v  # evicted traces: omit
            }}
        path = self.forensics.capture(
            trigger, step, detail, trace=False, extra_files=extra,
        )
        if path is None and self.triggers is not None:
            self.triggers.refund(trigger, step)


def _slug(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_]", "_", name)
