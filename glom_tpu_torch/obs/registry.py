"""Typed metric registry.

The port's copy of ``glom_tpu/obs/registry.py`` (stdlib only), the same code
so both packages export the same metrics, traces and alerts.

One ``MetricRegistry`` per run holds every named metric the trainer (or a
tool) reports: counters for monotone totals, gauges for point-in-time
values, histograms for distributions (step/phase times), timers as the
context-manager convenience over a histogram.  ``snapshot()`` flattens the
whole registry into a scalar dict — the single form every exporter
consumes, so adding an exporter never touches the instrumentation sites.

Events are plain strings (the ``event`` field of a log record), replacing
the old magic-float markers (``event=1.0`` resume / ``2.0`` stop).  The
vocabulary lives here so writers and readers share one definition.
"""

from __future__ import annotations

import bisect
import math
import threading
import warnings
from typing import Dict, List, Optional, Tuple

# -- event vocabulary (the `event` field of JSONL records) ----------------
EVENT_RESUME = "resume"              # checkpoint auto-resume at fit start
EVENT_PREEMPT_STOP = "preempt_stop"  # SIGTERM-triggered clean stop
EVENT_RECOMPILE = "recompile"        # XLA recompiled the step fn mid-run
EVENT_NAN = "nan"                    # nonfinite grads/loss seen this window
EVENT_FORENSICS = "forensics"        # a forensics bundle was captured

# legacy float markers (pre-obs logs) -> string events, for readers that
# must keep consuming old JSONL files
LEGACY_EVENT_FLOATS = {1.0: EVENT_RESUME, 2.0: EVENT_PREEMPT_STOP}


class Counter:
    """Monotone total (events, images, recompiles).  ``inc`` only."""

    def __init__(self, name: str, help: str = "", unit: str = ""):
        self.name, self.help, self.unit = name, help, unit
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {amount})")
        self.value += amount


class Gauge:
    """Point-in-time value (loss, memory bytes, agreement score)."""

    def __init__(self, name: str, help: str = "", unit: str = ""):
        self.name, self.help, self.unit = name, help, unit
        self.value: Optional[float] = None

    def set(self, value: float) -> None:
        self.value = float(value)


# Prometheus export needs FIXED cumulative buckets (reservoir percentiles
# can't be aggregated across scrapes/instances, and SLO burn-rate math on
# scraped metrics is rate(_bucket) arithmetic).  One wide log-spaced
# ladder serves both unit regimes this registry holds — seconds (phase
# times, 1e-5 s stop-poll .. multi-second checkpoints) and milliseconds
# (span durations): 1-2.5-5 decades across 1e-4 .. 1e4.
DEFAULT_BUCKETS = tuple(
    m * (10.0 ** e) for e in range(-4, 4) for m in (1.0, 2.5, 5.0)
) + (1e4,)


class Histogram:
    """Streaming distribution: count/sum/min/max, a bounded reservoir of
    recent observations for percentile queries, and exact cumulative
    counts over a fixed bucket ladder (``DEFAULT_BUCKETS``) for the
    Prometheus ``_bucket{le=...}`` exposition — the reservoir answers
    "what is p95 right now", the buckets let a scraper do rate() math
    over time."""

    def __init__(self, name: str, help: str = "", unit: str = "",
                 reservoir: int = 512, buckets=DEFAULT_BUCKETS):
        self.name, self.help, self.unit = name, help, unit
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._reservoir: List[float] = []
        self._cap = reservoir
        self.bucket_bounds = tuple(sorted(float(b) for b in buckets))
        # per-bin counts (NOT cumulative; exporters cumsum at render time)
        self._bucket_counts = [0] * len(self.bucket_bounds)
        # newest exemplar per bucket: bin index -> (exemplar_id, value).
        # Bounded by the fixed ladder (one slot per bin + one for +Inf), so
        # exemplar retention can never grow with traffic.
        self._exemplars: Dict[int, Tuple[str, float]] = {}

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        i = bisect.bisect_left(self.bucket_bounds, value)
        if i < len(self._bucket_counts):
            self._bucket_counts[i] += 1
        # values past the last bound live only in the implicit +Inf bucket
        if exemplar is not None:
            # one slot per bucket, newest wins: "show me a trace that
            # landed in this latency bucket" always answers with a trace
            # the sink plausibly still retains
            self._exemplars[i] = (str(exemplar), value)
        if len(self._reservoir) < self._cap:
            self._reservoir.append(value)
        else:
            # deterministic decimation: overwrite round-robin so the
            # reservoir always reflects a recent window (no RNG in the
            # logging path)
            self._reservoir[self.count % self._cap] = value

    def exemplars(self) -> Dict[float, Tuple[str, float]]:
        """Newest exemplar per bucket, keyed by the bucket's ``le`` bound
        (``math.inf`` for the implicit +Inf bucket): ``{le: (exemplar_id,
        observed_value)}``.  The exemplar id is a trace id when fed by
        :class:`~glom_tpu_torch.obs.tracing.Tracer` — the link a scrape follows
        from a p99 bucket to the request behind it."""
        out: Dict[float, Tuple[str, float]] = {}
        # snapshot first: a request thread's observe() can insert a
        # bucket's FIRST exemplar while a /metrics scrape iterates here —
        # dict growth during iteration raises RuntimeError mid-scrape
        for i, ex in list(self._exemplars.items()):
            bound = (self.bucket_bounds[i] if i < len(self.bucket_bounds)
                     else math.inf)
            out[bound] = ex
        return out

    def bucket_cumulative(self) -> List[int]:
        """Cumulative count at each bound (the ``le`` semantics); the
        implicit ``+Inf`` bucket is ``self.count``."""
        out, total = [], 0
        for c in self._bucket_counts:
            total += c
            out.append(total)
        return out

    def percentile(self, q: float) -> Optional[float]:
        """Nearest-rank percentile over the reservoir, ``q`` in [0, 100]."""
        if not self._reservoir:
            return None
        ordered = sorted(self._reservoir)
        rank = min(len(ordered) - 1, max(0, math.ceil(q / 100.0 * len(ordered)) - 1))
        return ordered[rank]

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None


class Timer:
    """Context-manager facade over a Histogram of seconds."""

    def __init__(self, name: str, help: str = "", clock=None):
        import time

        self.hist = Histogram(name, help, unit="seconds")
        self._clock = clock or time.monotonic
        self._t0: Optional[float] = None

    @property
    def name(self) -> str:
        return self.hist.name

    def __enter__(self) -> "Timer":
        self._t0 = self._clock()
        return self

    def __exit__(self, *exc) -> None:
        self.hist.observe(self._clock() - self._t0)
        self._t0 = None


class MetricRegistry:
    """Namespace of typed metrics.  ``counter``/``gauge``/``histogram``/
    ``timer`` get-or-create by name; re-registering a name as a different
    type is an error (it would silently fork the metric).

    Creation and iteration are locked: the serving path lazily creates
    metrics on request threads (first 4xx reply, first execution of a
    bucket) while ``/metrics`` scrapes iterate — an unlocked dict there
    dies with "dictionary changed size during iteration" mid-scrape.
    Individual metric updates stay unlocked (GIL-atomic enough for
    telemetry; a lock per ``observe`` would tax the hot path)."""

    #: distinct label values one dynamic family may mint before collapsing
    #: to ``__other__`` (see :meth:`labeled`)
    DEFAULT_MAX_LABEL_VALUES = 64

    def __init__(self, max_label_values: int = DEFAULT_MAX_LABEL_VALUES):
        if max_label_values < 1:
            raise ValueError(
                f"max_label_values must be >= 1, got {max_label_values}"
            )
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()
        self.max_label_values = max_label_values
        # family -> distinct label values seen (bounded at the cap; the
        # collapsed __other__ name is not counted against it)
        self._label_values: Dict[str, set] = {}
        self._label_warned: set = set()

    # -- cardinality guard -------------------------------------------------
    OVERFLOW_LABEL = "__other__"

    def labeled(self, family: str, value) -> str:
        """Bound a dynamic metric family's cardinality: returns the derived
        metric name ``<family><value>`` while the family has minted fewer
        than ``max_label_values`` distinct values, and the one collapsed
        name ``<family>__other__`` afterwards (with a one-time warning per
        family and a ``registry_cardinality_overflows_total`` count per
        collapsed observation).  Every dynamic-suffix site — per-bucket
        span histograms, per-replica fleet gauges — must mint names
        through here, so a misbehaving label (a bucketless fallback batch
        size, a replica name echoed from config) can no longer grow
        ``/metrics`` without bound."""
        value = str(value)
        with self._lock:
            seen = self._label_values.setdefault(family, set())
            if value in seen:
                return family + value
            if len(seen) < self.max_label_values:
                seen.add(value)
                return family + value
            warn = family not in self._label_warned
            self._label_warned.add(family)  # glomlint: disable=obs-unbounded-series -- one entry per metric FAMILY (code-defined, not input-defined); the per-value cardinality is what the max_label_values cap above bounds
        # the counter takes the registry lock itself — inc it outside
        self.counter(
            "registry_cardinality_overflows_total",
            help="labeled-metric observations collapsed to __other__ "
                 "(a family hit max_label_values)",
        ).inc()
        if warn:
            warnings.warn(
                f"metric family {family!r} reached {self.max_label_values} "
                f"distinct label values; further values collapse to "
                f"{family}{self.OVERFLOW_LABEL}", stacklevel=2,
            )
        return family + self.OVERFLOW_LABEL

    def _get(self, name: str, cls, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, **kwargs)
                self._metrics[name] = m
        # a Timer aliases its Histogram: histogram() on a timer-registered
        # name returns the underlying hist, not the Timer wrapper
        expected = m.hist if isinstance(m, Timer) and cls is Histogram else m
        if not isinstance(expected, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}"
            )
        return expected

    def counter(self, name: str, help: str = "", unit: str = "") -> Counter:
        return self._get(name, Counter, help=help, unit=unit)

    def gauge(self, name: str, help: str = "", unit: str = "") -> Gauge:
        return self._get(name, Gauge, help=help, unit=unit)

    def histogram(self, name: str, help: str = "", unit: str = "") -> Histogram:
        return self._get(name, Histogram, help=help, unit=unit)

    def timer(self, name: str, help: str = "", clock=None) -> Timer:
        return self._get(name, Timer, help=help, clock=clock)

    def __iter__(self):
        with self._lock:  # snapshot copy: scrapes race lazy creation
            return iter(list(self._metrics.values()))

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._metrics

    def snapshot(self) -> Dict[str, float]:
        """Flatten to ``{name[_suffix]: scalar}`` — counters/gauges by name,
        histograms as ``<name>_{count,sum,mean,p50,p95,max}``.  Unset gauges
        and empty histograms are omitted (exporting a None would force every
        sink to special-case it)."""
        out: Dict[str, float] = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if isinstance(m, Timer):
                m = m.hist
            if isinstance(m, Counter):
                out[m.name] = m.value
            elif isinstance(m, Gauge):
                if m.value is not None:
                    out[m.name] = m.value
            elif isinstance(m, Histogram):
                if m.count:
                    out[f"{m.name}_count"] = float(m.count)
                    out[f"{m.name}_sum"] = m.sum
                    out[f"{m.name}_mean"] = m.mean
                    out[f"{m.name}_p50"] = m.percentile(50)
                    out[f"{m.name}_p95"] = m.percentile(95)
                    out[f"{m.name}_max"] = m.max
        return out
