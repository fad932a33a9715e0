"""Bounded ring-buffer time-series store (TSDB-lite).

The port's copy of ``glom_tpu/obs/timeseries.py`` (stdlib only), the same
code, so both packages keep the same series and answer ``/debug/series`` alike.

An autoscaler needs *trends* — "is this replica heading
toward saturation?" — but every serving signal is an instantaneous gauge
or a monotone counter.  This module retains history without becoming the
memory leak it exists to detect: every series is a fixed set of
downsampling **tiers**, each a ``deque(maxlen=...)`` of fixed-interval
buckets (default 1s x 600 -> 10s x 360 -> 60s x 720, i.e. ten minutes at
second resolution, an hour at 10 s, twelve hours at a minute), so memory
is a compile-time constant per series and the store itself is capped at
``max_series`` names.

Pieces:

  * :class:`SeriesStore` — named series with optional labels, fed by
    ``record()`` / ``record_snapshot()`` (a whole
    :meth:`~glom_tpu_torch.obs.registry.MetricRegistry.snapshot` at once);
    queryable by name/label/since/step (:meth:`SeriesStore.query`), the
    body behind ``GET /debug/series``.
  * :class:`RegistrySampler` — samples a registry into a store at a
    fixed interval; ``tick()`` for injected-clock determinism,
    ``start()`` for a real timer thread.
  * Window math over point lists — :func:`delta`, :func:`rate`,
    :func:`percentile_over`, :func:`linear_trend`, :func:`trend_flip`,
    :func:`eta_to_threshold` — the helpers the capacity advisor
    (:mod:`glom_tpu_torch.obs.capacity`) forecasts from.

Stdlib-only, injectable clock (the :mod:`~glom_tpu_torch.obs.tracing` /
:mod:`~glom_tpu_torch.obs.slo` pattern): deterministic under a fake clock,
``time.monotonic`` in production.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: (interval seconds, buckets retained) fine -> coarse.  Retention spans:
#: 10 min at 1 s, 1 h at 10 s, 12 h at 60 s.
DEFAULT_TIERS: Tuple[Tuple[float, int], ...] = (
    (1.0, 600), (10.0, 360), (60.0, 720),
)

Point = Tuple[float, float]


def series_key(name: str, labels: Optional[Dict[str, str]] = None) -> str:
    """Canonical key: ``name`` bare, or ``name{k="v",...}`` with labels
    sorted — one spelling per (name, labels) so query and record agree."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Series:
    """One named series: the same samples at every tier, sample-and-hold
    per bucket (the last value recorded inside a bucket wins — counters
    stay monotone, gauges read as their freshest value)."""

    __slots__ = ("key", "_tiers")

    def __init__(self, key: str, tiers: Sequence[Tuple[float, int]]):
        self.key = key
        # per tier: (interval, ring of [bucket_start_t, value]) — the ring
        # is the bound; nothing here may grow with sample count
        self._tiers: List[Tuple[float, deque]] = [
            (float(interval), deque(maxlen=int(cap)))
            for interval, cap in tiers
        ]

    def record(self, t: float, value: float) -> None:
        for interval, ring in self._tiers:
            bucket_t = math.floor(t / interval) * interval
            if ring and ring[-1][0] == bucket_t:
                ring[-1][1] = value
            else:
                ring.append([bucket_t, value])

    def points(self, since: Optional[float] = None,
               step: Optional[float] = None) -> List[Point]:
        """Points as ``[(t, value), ...]`` ascending, from the tier that
        best answers the query: the finest tier with ``interval >= step``
        when a step is given, else the finest tier that still retains
        ``since`` (a ten-minute question reads 1 s buckets; a six-hour
        question automatically coarsens to the 60 s tier)."""
        tier = None
        if step is not None and step > 0:
            for interval, ring in self._tiers:
                if interval >= step:
                    tier = (interval, ring)
                    break
        elif since is not None:
            for interval, ring in self._tiers:
                if ring and ring[0][0] <= since:
                    tier = (interval, ring)
                    break
        if tier is None:
            # no selector -> finest view; an unsatisfiable selector
            # (step coarser / since older than any tier) -> coarsest
            tier = (self._tiers[0] if since is None and step is None
                    else self._tiers[-1])
        _, ring = tier
        pts = [(b[0], b[1]) for b in ring]
        if since is not None:
            pts = [p for p in pts if p[0] >= since]
        return pts

    def latest(self) -> Optional[float]:
        ring = self._tiers[0][1]
        return ring[-1][1] if ring else None


class SeriesStore:
    """Bounded map of series.  Thread-safe: one lock covers the name
    table and every ring (a sampler thread writes while HTTP handler
    threads query; sampling is ~one dict pass per second, so a single
    lock is cheaper than a torn deque iteration is debuggable).

    At ``max_series`` distinct keys, NEW names are dropped and counted
    (``dropped_series``) — the store must degrade by losing the newest
    family, never by growing without bound (the cardinality-guard stance
    of :meth:`~glom_tpu_torch.obs.registry.MetricRegistry.labeled`)."""

    def __init__(self, *, tiers: Sequence[Tuple[float, int]] = DEFAULT_TIERS,
                 clock: Optional[Callable[[], float]] = None,
                 max_series: int = 1024):
        if not tiers:
            raise ValueError("need at least one (interval, capacity) tier")
        for interval, cap in tiers:
            if interval <= 0 or cap < 1:
                raise ValueError(
                    f"tier ({interval}, {cap}) needs interval > 0, cap >= 1")
        if max_series < 1:
            raise ValueError(f"max_series must be >= 1, got {max_series}")
        self.tiers = tuple((float(i), int(c)) for i, c in tiers)
        self.max_series = max_series
        self._clock = clock if clock is not None else time.monotonic
        self._series: Dict[str, Series] = {}
        self._lock = threading.Lock()
        self.dropped_series = 0

    def now(self) -> float:
        return self._clock()

    # -- writes -------------------------------------------------------------
    def record(self, name: str, value, *, t: Optional[float] = None,
               labels: Optional[Dict[str, str]] = None) -> None:
        try:
            value = float(value)
        except (TypeError, ValueError):
            return  # non-numeric snapshot entries are not series
        if not math.isfinite(value):
            return
        key = series_key(name, labels)
        t = self._clock() if t is None else float(t)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                if len(self._series) >= self.max_series:
                    self.dropped_series += 1
                    return
                s = self._series[key] = Series(key, self.tiers)
            s.record(t, value)

    def record_snapshot(self, snapshot: Dict[str, float], *,
                        t: Optional[float] = None,
                        labels: Optional[Dict[str, str]] = None) -> None:
        """One registry ``snapshot()`` (or any flat scalar dict) at one
        instant — every entry lands in the same bucket, so cross-series
        math (duty = execute-time delta / wall delta) never sees skew."""
        t = self._clock() if t is None else float(t)
        for name, value in snapshot.items():
            self.record(name, value, t=t, labels=labels)

    # -- reads --------------------------------------------------------------
    def names(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(k for k in self._series if k.startswith(prefix))

    def points(self, name: str, *, labels: Optional[Dict[str, str]] = None,
               since: Optional[float] = None,
               step: Optional[float] = None) -> List[Point]:
        key = series_key(name, labels)
        with self._lock:
            s = self._series.get(key)
            return s.points(since, step) if s is not None else []

    def latest(self, name: str,
               labels: Optional[Dict[str, str]] = None) -> Optional[float]:
        key = series_key(name, labels)
        with self._lock:
            s = self._series.get(key)
            return s.latest() if s is not None else None

    def query(self, name: Optional[str] = None, *,
              prefix: Optional[str] = None,
              since: Optional[float] = None,
              step: Optional[float] = None) -> Dict[str, List[Point]]:
        """Matching series -> points.  ``name`` matches the bare name AND
        every labeled variant (``capacity_duty_cycle`` returns the fleet
        series plus each ``{replica="..."}`` one); ``prefix`` matches by
        key prefix; neither returns nothing (use :meth:`names` to list)."""
        with self._lock:
            if name is not None:
                matched = [s for k, s in self._series.items()
                           if k == name or k.startswith(name + "{")]
            elif prefix is not None:
                matched = [s for k, s in self._series.items()
                           if k.startswith(prefix)]
            else:
                return {}
            return {s.key: s.points(since, step) for s in matched}

    def payload(self, query_string: str = "") -> Dict[str, object]:
        """The ``GET /debug/series?name=&since=&step=&prefix=`` body:
        matched series with points, plus the store's name list when no
        selector was given (discovery).  ``since`` is absolute (the
        store's own clock domain) when >= 0, relative to now when
        negative (``since=-60`` = the last minute)."""
        from urllib.parse import parse_qs

        q = parse_qs(query_string or "")

        def one(key: str) -> Optional[str]:
            vals = q.get(key)
            return vals[0] if vals else None

        name, prefix = one("name"), one("prefix")
        now = self.now()
        try:
            since = float(one("since")) if one("since") is not None else None
            step = float(one("step")) if one("step") is not None else None
        except ValueError:
            return {"error": "since/step must be numbers", "now": now}
        if since is not None and since < 0:
            since = now + since
        out: Dict[str, object] = {
            "now": round(now, 6),
            "tiers": [list(t) for t in self.tiers],
        }
        if name is None and prefix is None:
            out["names"] = self.names()
            return out
        series = self.query(name, prefix=prefix, since=since, step=step)
        out["series"] = {
            k: [[round(t, 6), v] for t, v in pts]
            for k, pts in sorted(series.items())
        }
        return out


class RegistrySampler:
    """Feeds a :class:`SeriesStore` from a registry at a fixed cadence.

    ``tick()`` samples when an interval has elapsed (tests drive it with
    a fake clock); ``start()`` runs ticks on a daemon timer thread for
    real servers.  One sampler per (registry, store) pair."""

    def __init__(self, registry, store: SeriesStore, *,
                 interval_s: float = 1.0,
                 clock: Optional[Callable[[], float]] = None):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.registry = registry
        self.store = store
        self.interval_s = float(interval_s)
        self._clock = clock if clock is not None else time.monotonic
        self._last: Optional[float] = None
        self.samples = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample(self, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else float(now)
        self.store.record_snapshot(self.registry.snapshot(), t=now)
        self._last = now
        self.samples += 1

    def tick(self, now: Optional[float] = None) -> bool:
        now = self._clock() if now is None else float(now)
        if self._last is not None and now - self._last < self.interval_s:
            return False
        self.sample(now)
        return True

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                self.sample()

        self._thread = threading.Thread(
            target=loop, name="glom-series-sampler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)


# ---------------------------------------------------------------------------
# window math (plain functions over [(t, value), ...] lists)
# ---------------------------------------------------------------------------
def delta(points: Sequence[Point]) -> Optional[float]:
    """last - first value; None below two points."""
    if len(points) < 2:
        return None
    return points[-1][1] - points[0][1]


def rate(points: Sequence[Point]) -> Optional[float]:
    """(last - first) / elapsed, per second — the counter-increase rate.
    Negative deltas (a counter reset: restarted replica) read as None,
    not a negative rate: no caller wants -4000 requests/s."""
    if len(points) < 2:
        return None
    dt = points[-1][0] - points[0][0]
    if dt <= 0:
        return None
    dv = points[-1][1] - points[0][1]
    return dv / dt if dv >= 0 else None


def percentile_over(points: Sequence[Point], q: float) -> Optional[float]:
    """Nearest-rank percentile of the VALUES in the window (the registry
    Histogram's rule), q in [0, 100]."""
    if not points:
        return None
    ordered = sorted(v for _, v in points)
    rank = min(len(ordered) - 1,
               max(0, math.ceil(q / 100.0 * len(ordered)) - 1))
    return ordered[rank]


def linear_trend(points: Sequence[Point]) -> Optional[Dict[str, float]]:
    """Least-squares line over the window: ``slope`` in value-units per
    second and ``value_at_end`` (the fit evaluated at the last timestamp
    — smoother than the raw last sample, so ETA math doesn't whipsaw on
    one noisy bucket).  None below two points or a degenerate span."""
    n = len(points)
    if n < 2:
        return None
    t0 = points[0][0]
    ts = [t - t0 for t, _ in points]
    vs = [v for _, v in points]
    mean_t = sum(ts) / n
    mean_v = sum(vs) / n
    var_t = sum((t - mean_t) ** 2 for t in ts)
    if var_t <= 0:
        return None
    slope = sum((t - mean_t) * (v - mean_v)
                for t, v in zip(ts, vs)) / var_t
    intercept = mean_v - slope * mean_t
    return {"slope": slope, "value_at_end": intercept + slope * ts[-1]}


def trend_flip(points: Sequence[Point],
               min_slope: float = 0.0) -> Optional[Dict[str, float]]:
    """Detect ONE change of trend direction in the window: the split
    point whose before/after least-squares slopes differ in sign with
    the largest slope change.  Returns ``{"t": split time,
    "slope_before", "slope_after"}`` or None (no sign flip, or every
    candidate slope within ``min_slope`` of flat).  O(n) per candidate
    over O(n) candidates — windows are ring-bounded, so worst case is a
    few hundred thousand float ops, off the request path."""
    n = len(points)
    if n < 4:
        return None
    best = None
    for i in range(2, n - 1):
        before = linear_trend(points[:i])
        after = linear_trend(points[i:])
        if before is None or after is None:
            continue
        sb, sa = before["slope"], after["slope"]
        if abs(sb) <= min_slope and abs(sa) <= min_slope:
            continue
        if (sb <= min_slope and sa > min_slope) or \
           (sb >= -min_slope and sa < -min_slope) or (sb * sa < 0):
            change = abs(sa - sb)
            if best is None or change > best[0]:
                best = (change, points[i][0], sb, sa)
    if best is None:
        return None
    return {"t": best[1], "slope_before": best[2], "slope_after": best[3]}


def eta_to_threshold(points: Sequence[Point],
                     threshold: float) -> Optional[float]:
    """Seconds from the window's last timestamp until the fitted linear
    trend crosses ``threshold`` — the "time until this replica saturates"
    forecast.  0.0 when the fit already sits past the threshold in its
    direction of travel; None when the trend is flat or moving away."""
    fit = linear_trend(points)
    if fit is None or fit["slope"] == 0:
        return None
    crossed = (fit["value_at_end"] >= threshold if fit["slope"] > 0
               else fit["value_at_end"] <= threshold)
    if crossed:
        return 0.0
    eta = (threshold - fit["value_at_end"]) / fit["slope"]
    return eta if eta >= 0 else None


def trend_arrow(slope: Optional[float], flat_eps: float = 1e-9) -> str:
    """Console glyph for a slope: rising, falling, or flat."""
    if slope is None or abs(slope) <= flat_eps:
        return "→"
    return "↑" if slope > 0 else "↓"
