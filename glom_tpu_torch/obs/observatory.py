"""Fleet observatory: cross-replica trace stitching, tail-based sampling,
and correlated incident forensics — the port's copy of
``glom_tpu/obs/observatory.py`` (stdlib only, the same code).  A port
replica lists the bundles of its ``forensics_dir`` on ``/debug/forensics``
as a ``glom_tpu`` replica does, and the collector reads either.

The fleet router made the fleet serve as one unit; its observability stayed
process-local — per-replica trace rings, per-replica forensics bundles,
aggregate ``/metrics`` with no path back to the requests behind a p99
spike.  This module is the ONE pane over all of it:

  * **Pull topology** — every replica (and the router) exposes
    ``GET /debug/traces?since=<cursor>``: an incremental read of the
    tracer's bounded completed-trace ring.  The collector polls, so a
    replica never blocks on a slow observer and a dead collector costs
    the fleet nothing.
  * **Stitching** (:func:`stitch`) — segments sharing a trace id join
    into ONE cross-process trace.  Each process stamps spans on its own
    monotonic clock (incomparable epochs), so the engine segment is
    time-aligned into the router's base by centering its root ``request``
    span inside the router's ``proxy`` span that parented it (the
    forwarded traceparent carries the proxy span id — the join key was
    already on the wire).  :func:`span_coverage` then extends over the
    hop: one number says whether the stitched trace explains the whole
    router-to-device wall time.
  * **Tail-based sampling** (:class:`TailSampler`) — the keep/drop
    decision runs AFTER the trace completes, when its outcome is known:
    100% of error, SLO-violating, and rolling-p99-slow traces are kept; a
    seeded deterministic fraction of healthy ones rides along for
    baseline contrast.  Retention is bounded; the traces worth keeping
    never race the eviction clock.
  * **Exemplar resolution** — histogram families carry OpenMetrics
    ``# {trace_id="..."}`` exemplars (:mod:`glom_tpu_torch.obs.registry` /
    ``exporters``); :meth:`FleetObservatory.resolve_exemplar` maps one
    back to its stored stitched trace — p95 bucket to offending request
    in two hops.
  * **Correlated forensics** — when a replica trips ``slo_burn`` (its
    bundle appears in ``/debug/forensics``) or the router ejects a
    replica (``/debug/timeline``), the collector writes ONE cross-replica
    incident bundle: offending stitched traces, every healthy replica's
    registry snapshot and bundle manifests, and the router's
    rollout/ejection timeline.  ``python -m glom_tpu_torch.tools.observatory
    report`` renders it.
  * **Console** (:meth:`FleetObservatory.console`, served as ``/console``)
    — replica health/version/serving step, rollout position, per-bucket
    padding waste, SLO burn rates, slowest stitched traces, sampler and
    incident state.

Stdlib-only, like the rest of the pull plane.  Clocks and the sampling
rng are injectable, the ``resilience/`` pattern —
every decision is reproducible under a fake clock and a pinned seed.
"""

from __future__ import annotations

import json
import math
import random
import re
import threading
import time
import urllib.error
import urllib.request
import warnings
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from glom_tpu_torch.obs import attribution
from glom_tpu_torch.obs.forensics import is_bundle_dir, write_bundle
from glom_tpu_torch.obs.registry import MetricRegistry
from glom_tpu_torch.obs.timeseries import (SeriesStore, linear_trend, series_key,
                                     trend_arrow)
from glom_tpu_torch.obs.tracing import find_root, span_coverage

#: trace roots the collector stitches/samples; batch-level and reload
#: traces are process bookkeeping, not requests
REQUEST_ROOTS = ("router_request", "request")

#: container/overlap spans excluded from critical-path attribution: each
#: wraps the pipeline spans that explain the time (proxy wraps the whole
#: downstream hop; a non-root `request` is the engine segment's wrapper;
#: dispatch_wait exists for coverage, deliberately overlapping the
#: pipeline — summing any of them would double-count)
CONTAINER_SPANS = {"proxy", "request", "dispatch_wait"}

# one exemplar-annotated histogram bucket sample line:
#   name_bucket{...le="0.5"...} 12 # {trace_id="abc"} 0.43
_EXEMPLAR_LINE = re.compile(
    r'^([A-Za-z_:][A-Za-z0-9_:]*)_bucket\{([^}]*)\}\s+\S+'
    r'\s+#\s+\{trace_id="([^"]+)"\}\s+(\S+)\s*$')
_LE_ATTR = re.compile(r'le="([^"]+)"')


def _default_http(method: str, url: str, body: Optional[bytes],
                  headers: Dict[str, str], timeout: float
                  ) -> Tuple[int, Dict[str, str], bytes]:
    """Stdlib HTTP, injectable for deterministic tests — the router's
    contract: any HTTP status returns, only transport errors raise."""
    req = urllib.request.Request(url, data=body, headers=headers,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers.items()), r.read()
    except urllib.error.HTTPError as e:
        payload = e.read()
        return e.code, dict(e.headers.items()), payload


# ---------------------------------------------------------------------------
# stitching: cross-process trace join + clock alignment
# ---------------------------------------------------------------------------
def _align_offset(parent: Dict[str, Any], child: Dict[str, Any]) -> float:
    """Seconds to add to the child segment's timestamps so its root span
    sits inside the parent (proxy) span that forwarded to it.  Centering
    assumes symmetric network delay (the classic NTP estimate); the clamp
    keeps the child inside the parent even when the delay was lopsided —
    a child span leaking outside its parent would report negative queue
    time and >100% coverage."""
    offset = ((parent["start"] + parent["end"])
              - (child["start"] + child["end"])) / 2.0
    if child["start"] + offset < parent["start"]:
        offset = parent["start"] - child["start"]
    if child["end"] + offset > parent["end"]:
        offset = parent["end"] - child["end"]
    return offset


def _shift(spans: List[Dict[str, Any]], offset: float) -> None:
    for s in spans:
        s["start"] = s["start"] + offset
        if s.get("end") is not None:
            s["end"] = s["end"] + offset


def stitch(segments: Sequence[Tuple[str, Dict[str, Any]]]
           ) -> Optional[Dict[str, Any]]:
    """Join one trace's per-process segments — ``(source, record)`` pairs
    sharing a trace id — into a single stitched trace record.

    The segment whose local root has no remote parent anchors the time
    base (the router, for proxied traffic).  Every other segment's local
    root carries ``parent_id`` = the span id the forwarding hop put on
    the wire; the segment is shifted onto the anchor's clock by centering
    that root inside its parent span, transitively (a future two-hop
    topology aligns hop by hop).  Returns the merged record —
    ``trace_id`` / ``root`` / ``duration_ms`` / ``span_coverage`` /
    ``sources`` / ``clock_offset_ms`` per source / ``spans`` (each tagged
    ``source``) — or None for an empty group."""
    pending: List[Tuple[str, List[Dict[str, Any]], Dict[str, Any]]] = []
    trace_id = None
    for source, rec in segments:
        trace_id = trace_id or rec.get("trace_id")
        spans = [dict(s) for s in rec.get("spans", ())]
        if not spans:
            continue
        for s in spans:
            s["source"] = source
            # the emitting process's ORIGINAL edge survives the shift:
            # mirrored batch spans dedupe on (source, raw_start) — each
            # member trace gets its own alignment offset, so the shifted
            # start no longer identifies the one physical batch
            s.setdefault("raw_start", s["start"])
        local_root = find_root(spans)
        if local_root is None:
            local_root = spans[0]
        pending.append((source, spans, local_root))
    if not pending:
        return None

    # anchor: a segment whose root joined no remote parent; prefer the
    # router's (outermost) segment when several qualify
    def _anchor_rank(item):
        _, spans, root = item
        ids = {s.get("span_id") for s in spans}
        remote = root.get("parent_id") is not None and \
            root.get("parent_id") not in ids
        outer = root.get("name") == "router_request"
        return (remote, not outer, root.get("start", 0.0))

    pending.sort(key=_anchor_rank)
    anchor = pending.pop(0)
    placed: List[Dict[str, Any]] = list(anchor[1])
    by_id = {s["span_id"]: s for s in placed}
    offsets: Dict[str, float] = {anchor[0]: 0.0}
    sources = [anchor[0]]
    root = anchor[2]

    progress = True
    while pending and progress:
        progress = False
        for i, (source, spans, local_root) in enumerate(pending):
            parent = by_id.get(local_root.get("parent_id"))
            if parent is None or parent.get("end") is None \
                    or local_root.get("end") is None:
                continue
            offset = _align_offset(parent, local_root)
            _shift(spans, offset)
            # the segment's local root is a CHILD in the merged trace:
            # leaving its root flag set would let coverage (find_root's
            # first predicate) anchor on the wrong span
            local_root.pop("root_span", None)
            placed.extend(spans)
            by_id.update({s["span_id"]: s for s in spans})
            offsets[source] = offset
            sources.append(source)
            pending.pop(i)
            progress = True
            break
    for source, spans, local_root in pending:
        # no alignment anchor (the forwarding segment never arrived):
        # include unshifted — coverage clips foreign-epoch intervals to
        # the root window, so they cannot fake coverage
        local_root.pop("root_span", None)
        placed.extend(spans)
        offsets[source] = None
        sources.append(source)

    placed.sort(key=lambda s: s["start"])
    return {
        "trace_id": trace_id if trace_id is not None
        else root.get("trace_id"),
        "root": root.get("name"),
        "duration_ms": root.get("duration_ms"),
        "span_coverage": span_coverage(placed),
        "stitched": len(sources) > 1,
        "sources": sources,
        "clock_offset_ms": {
            src: (None if off is None else round(off * 1e3, 3))
            for src, off in offsets.items()
        },
        "spans": placed,
    }


def critical_path(spans: Sequence[Dict[str, Any]]
                  ) -> List[Tuple[str, float]]:
    """Per-span-name total milliseconds, largest first, excluding the
    root and container/overlap spans — "which phase ate this request"."""
    root = find_root(spans)
    out: Dict[str, float] = {}
    for s in spans:
        if (s is root or s.get("duration_ms") is None
                or s.get("name") in CONTAINER_SPANS):
            continue
        out[s["name"]] = out.get(s["name"], 0.0) + s["duration_ms"]
    return sorted(out.items(), key=lambda kv: -kv[1])


# ---------------------------------------------------------------------------
# tail-based sampling
# ---------------------------------------------------------------------------
class TailSampler:
    """Keep/drop decision over COMPLETED traces.

    Tail-based (decide after the outcome is known), with the policy the
    incident path needs: error traces (any span with status >= 500 or an
    ``error`` attr), SLO-violating traces (duration over ``slo_ms``), and
    rolling-p99-slow traces are ALWAYS kept — at any sampling rate,
    including 0.  Healthy traces are kept at ``keep_fraction`` by a
    seeded credit accumulator with rng-jittered phase: deterministic per
    seed and stream, and never more than ``ceil(fraction * n) + 1`` keeps
    over any n healthy traces (a Bernoulli coin would overshoot under
    exactly the burst you were rate-limiting).  ``decide`` returns the
    keep reason or None (drop)."""

    KEEP_ERROR = "error"
    KEEP_SLO = "slo_violation"
    KEEP_SLOW = "slow_p99"
    KEEP_SAMPLED = "sampled"

    def __init__(self, keep_fraction: float = 0.1, *, seed: int = 0,
                 rng=None, slo_ms: Optional[float] = None,
                 slow_percentile: float = 99.0, window: int = 256,
                 min_window: int = 30,
                 clock: Optional[Callable[[], float]] = None):
        if not 0.0 <= keep_fraction <= 1.0:
            raise ValueError(
                f"keep_fraction must be in [0, 1], got {keep_fraction}")
        if not 50.0 <= slow_percentile <= 100.0:
            raise ValueError(
                f"slow_percentile must be in [50, 100], got "
                f"{slow_percentile}")
        self.keep_fraction = keep_fraction
        self.slo_ms = slo_ms
        self.slow_percentile = slow_percentile
        self._durations: deque = deque(maxlen=max(8, window))
        self.min_window = min_window
        self._clock = clock if clock is not None else time.monotonic
        self._rng = rng if rng is not None else random.Random(seed)
        self._credit = 0.0
        self._pick = self._rng.random()
        self.decided = 0
        self.kept: Dict[str, int] = {}
        self.dropped = 0
        self.last_decision_at: Optional[float] = None

    @staticmethod
    def _is_error(trace: Dict[str, Any]) -> bool:
        for s in trace.get("spans", ()):
            attrs = s.get("attrs") or {}
            status = attrs.get("status")
            if isinstance(status, int) and status >= 500:
                return True
            if "error" in attrs:
                return True
        return False

    def _p_slow(self) -> Optional[float]:
        if len(self._durations) < self.min_window:
            return None
        ordered = sorted(self._durations)
        rank = min(len(ordered) - 1,
                   max(0, math.ceil(self.slow_percentile / 100.0
                                    * len(ordered)) - 1))
        return ordered[rank]

    def decide(self, trace: Dict[str, Any]) -> Optional[str]:
        """The keep reason for ``trace`` (a stitched record), or None to
        drop.  The rolling duration window advances on every decision —
        kept or dropped — so "slow" stays relative to ALL traffic."""
        self.decided += 1
        self.last_decision_at = self._clock()
        duration = trace.get("duration_ms")
        reason: Optional[str] = None
        if self._is_error(trace):
            reason = self.KEEP_ERROR
        elif (self.slo_ms is not None and duration is not None
                and duration > self.slo_ms):
            reason = self.KEEP_SLO
        else:
            # STRICTLY above the rolling p99: under uniform traffic every
            # duration equals the percentile, and >= would tail-keep the
            # entire healthy stream
            p_slow = self._p_slow()
            if (p_slow is not None and duration is not None
                    and duration > p_slow):
                reason = self.KEEP_SLOW
            else:
                # healthy: seeded stratified sampling — one keep per 1/f
                # healthy traces, at an rng-chosen phase inside each
                # stratum, so the kept baseline isn't phase-locked to a
                # periodic traffic pattern
                self._credit += self.keep_fraction
                if self._credit >= self._pick:
                    self._credit -= 1.0
                    self._pick = self._rng.random()
                    reason = self.KEEP_SAMPLED
        if duration is not None:
            self._durations.append(duration)
        if reason is None:
            self.dropped += 1
        else:
            self.kept[reason] = self.kept.get(reason, 0) + 1
        return reason

    def stats(self) -> Dict[str, Any]:
        return {
            "decided": self.decided,
            "kept": dict(self.kept),
            "kept_total": sum(self.kept.values()),
            "dropped": self.dropped,
            "keep_fraction": self.keep_fraction,
            "slo_ms": self.slo_ms,
            "slow_percentile": self.slow_percentile,
        }


def parse_exemplars(metrics_text: str) -> List[Dict[str, Any]]:
    """Extract OpenMetrics exemplars from an exposition-format scrape:
    one ``{family, le, trace_id, value}`` per annotated bucket line."""
    out = []
    for line in metrics_text.splitlines():
        m = _EXEMPLAR_LINE.match(line)
        if not m:
            continue
        family, labels, trace_id, value = m.groups()
        le = _LE_ATTR.search(labels)
        try:
            val = float(value)
        except ValueError:
            continue
        out.append({"family": family, "le": le.group(1) if le else None,
                    "trace_id": trace_id, "value": val})
    return out


# ---------------------------------------------------------------------------
# the collector
# ---------------------------------------------------------------------------
class FleetObservatory:
    """Poll-driven fleet collector: stitches, samples, correlates.

    Sources are the router (``router_url``) plus replicas — discovered
    from the router's ``/healthz`` replica list, or passed explicitly as
    ``{name: url}``.  ``poll_once()`` is the whole duty cycle: pull trace
    segments, finalize + stitch + sample, refresh fleet state, detect and
    bundle incidents.  ``start()`` runs it on a timer thread; tests call
    it directly under an injected clock/http/rng."""

    def __init__(self, router_url: Optional[str] = None, *,
                 replicas: Optional[Dict[str, str]] = None,
                 sampler: Optional[TailSampler] = None,
                 registry: Optional[MetricRegistry] = None,
                 clock: Optional[Callable[[], float]] = None,
                 http=None, poll_interval_s: float = 1.0,
                 linger_polls: int = 2, max_traces: int = 512,
                 incident_dir: Optional[str] = None,
                 incident_max: int = 8,
                 incident_debounce_polls: int = 60,
                 http_timeout_s: float = 5.0,
                 wall_clock: Optional[Callable[[], float]] = None):
        if router_url is None and not replicas:
            raise ValueError("need a router_url and/or explicit replicas")
        if linger_polls < 1:
            raise ValueError(f"linger_polls must be >= 1, got {linger_polls}")
        if max_traces < 1:
            raise ValueError(f"max_traces must be >= 1, got {max_traces}")
        self.router_url = router_url.rstrip("/") if router_url else None
        self.registry = registry if registry is not None else MetricRegistry()
        self.sampler = sampler if sampler is not None else TailSampler()
        self._clock = clock if clock is not None else time.monotonic
        # wall clock only stamps incident manifests (human-readable
        # created_unix); every decision runs on the injectable monotonic
        self._wall = wall_clock if wall_clock is not None else time.time
        self._http = http if http is not None else _default_http
        self.poll_interval_s = poll_interval_s
        self.linger_polls = linger_polls
        self.http_timeout_s = http_timeout_s
        self.incident_dir = incident_dir
        self.incident_max = incident_max
        self.incident_debounce_polls = incident_debounce_polls
        self._last_incident_poll: Dict[str, int] = {}

        # _lock guards collector STATE (sources/pending/traces/...); the
        # console and trace-resolution handlers take it for micro-reads.
        # _poll_lock serializes whole duty cycles — network pulls run
        # under it but NEVER under _lock, so one blackholed source stalls
        # the next poll, not the pane (the router /metrics lesson: the
        # observatory must stay readable exactly when the fleet is sick).
        self._lock = threading.Lock()
        self._poll_lock = threading.Lock()
        # source name -> {"url", "role", "cursor", "pinned"} — pinned
        # sources (ctor-provided) survive discovery; discovered replicas
        # are dropped when they leave the router's replica table
        self.sources: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        if self.router_url:
            self.sources["router"] = {"url": self.router_url,
                                      "role": "router", "cursor": 0,
                                      "pinned": True}
        for name, url in (replicas or {}).items():
            self.sources[name] = {"url": url.rstrip("/"),
                                  "role": "replica", "cursor": 0,
                                  "pinned": True}
        # trace_id -> {"first_poll": n, "segments": [(source, rec)]}
        self._pending: Dict[str, Dict[str, Any]] = {}
        # bounded memory of already-finalized trace ids: a straggler
        # segment of a finalized (kept-or-dropped) trace must not re-enter
        # as a partial group and take a SECOND sampling decision — the
        # TraceSink eviction-memory rule, one layer up
        self._finalized: "OrderedDict[str, None]" = OrderedDict()
        # kept stitched traces, bounded, newest last
        self.traces: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self.max_traces = max_traces
        self._poll_n = 0
        # fleet state caches refreshed each poll (console inputs)
        self._router_health: Optional[dict] = None
        self._timeline: List[dict] = []
        self._timeline_cursor = -1
        # events on the FIRST successful timeline pull are history the
        # collector never witnessed — absorbed, like pre-existing bundles
        self._timeline_attached = False
        self._forensics_by_replica: Dict[str, dict] = {}
        self._seen_bundles: Dict[str, set] = {}
        self._padding: Dict[Any, Dict[str, Any]] = {}
        # fleet TSDB-lite (glom_tpu_torch.obs.timeseries): each poll folds every
        # replica's capacity_* registry snapshot in — per-replica series
        # labeled {replica="name"}, fleet aggregates bare-named — so the
        # console's capacity pane reads trends, not point gauges.  Ring-
        # bounded by construction (the obs-unbounded-series contract).
        self.series = SeriesStore(clock=self._clock)
        self.incidents: List[str] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- transport ---------------------------------------------------------
    def _get_json(self, url: str) -> Optional[Any]:
        try:
            status, _, body = self._http("GET", url, None, {},
                                         self.http_timeout_s)
            if status != 200:
                return None
            return json.loads(body)
        except Exception:  # glomlint: disable=conc-broad-except -- any pull failure (refused, timeout, bad JSON) reads as "source unreachable this poll"; the console's per-source reachability row is the visibility
            return None

    def _get_text(self, url: str,
                  headers: Optional[Dict[str, str]] = None
                  ) -> Optional[str]:
        try:
            status, _, body = self._http("GET", url, None, headers or {},
                                         self.http_timeout_s)
            if status != 200:
                return None
            return body.decode(errors="replace")
        except Exception:  # glomlint: disable=conc-broad-except -- same contract as _get_json: an unreachable source skips this poll and stays visible in the console
            return None

    # -- discovery ---------------------------------------------------------
    def _apply_discovery(self, health) -> None:
        """Apply a fetched router ``/healthz`` to the source table (caller
        holds ``_lock``): discovered replicas are added/updated AND —
        unless pinned at construction — removed when they leave the
        router's replica table, so a scaled-down or replaced replica
        stops costing two timeouts per poll and the console stops
        reporting phantoms.  ``_seen_bundles`` is kept for dropped names:
        a replica that returns must not refire its old bundles."""
        if self.router_url is None:
            return
        if not isinstance(health, dict):
            self._router_health = None
            return
        self._router_health = health
        current = set()
        for rep in health.get("replicas", ()):
            name, url = rep.get("name"), rep.get("url")
            if not name or not url:
                continue
            current.add(name)
            src = self.sources.setdefault(
                name, {"url": url.rstrip("/"), "role": "replica",
                       "cursor": 0, "pinned": False})
            src["url"] = url.rstrip("/")
        for name in [n for n, s in self.sources.items()
                     if s["role"] == "replica" and not s.get("pinned")
                     and n not in current]:
            del self.sources[name]

    # -- network fan-out (no state lock held) ------------------------------
    def _fetch_all(self, sources: List[Tuple[str, Dict[str, Any]]]
                   ) -> Dict[str, Any]:
        """One poll's pulls — per-source ``/debug/traces`` cursor reads,
        per-replica ``/debug/forensics``, the router ``/debug/timeline``
        — fetched CONCURRENTLY with no collector lock held: a blackholed
        source costs one timeout of wall clock, never a serialized stack
        of them, and readers of ``/console`` are never blocked on it."""
        from concurrent.futures import ThreadPoolExecutor

        jobs: List[Tuple[str, str, str]] = []  # (kind, name, url)
        for name, src in sources:
            jobs.append(("traces", name,
                         f"{src['url']}/debug/traces?since={src['cursor']}"))
            if src["role"] == "replica":
                jobs.append(("forensics", name,
                             f"{src['url']}/debug/forensics"))
        if self.router_url is not None:
            jobs.append(("timeline", "router",
                         f"{self.router_url}/debug/timeline"))
        out: Dict[str, Any] = {"traces": {}, "forensics": {},
                               "timeline": None}
        if not jobs:
            return out
        with ThreadPoolExecutor(
            max_workers=min(8, max(1, len(jobs)))
        ) as pool:
            results = list(pool.map(
                lambda job: self._get_json(job[2]), jobs))
        for (kind, name, _url), payload in zip(jobs, results):
            if kind == "timeline":
                out["timeline"] = payload
            else:
                out[kind][name] = payload
        return out

    # -- trace ingestion ---------------------------------------------------
    def _apply_traces(self, payloads: Dict[str, Any]) -> int:
        """Fold fetched ``/debug/traces`` payloads into the pending
        groups (caller holds ``_lock``)."""
        pulled = 0
        for name, payload in payloads.items():
            src = self.sources.get(name)
            if src is None:
                continue
            src["reachable"] = payload is not None
            if not isinstance(payload, dict):
                continue
            src["cursor"] = int(payload.get("next", src["cursor"]))
            for rec in payload.get("traces", ()):
                if rec.get("root") not in REQUEST_ROOTS:
                    continue  # batch/reload bookkeeping traces
                tid = rec.get("trace_id")
                if not tid or tid in self._finalized:
                    continue
                group = self._pending.setdefault(
                    tid, {"first_poll": self._poll_n, "segments": []})
                group["segments"].append((name, rec))
                pulled += 1
        return pulled

    def _group_complete(self, segments) -> bool:
        """A group is stitchable now if every forwarding (proxy) span has
        a child segment and the outermost root is present; otherwise it
        lingers a few polls for stragglers."""
        span_ids = set()
        parent_ids = set()
        proxy_ids = set()
        has_anchor = False
        for _, rec in segments:
            spans = rec.get("spans", ())
            ids = {s.get("span_id") for s in spans}
            span_ids |= ids
            local_root = find_root(spans)
            if local_root is not None:
                pid = local_root.get("parent_id")
                if pid is None:
                    has_anchor = True
                else:
                    parent_ids.add(pid)
            for s in spans:
                if s.get("name") == "proxy":
                    proxy_ids.add(s.get("span_id"))
        if not has_anchor and not (parent_ids & span_ids):
            return False  # nothing to anchor the time base yet
        return proxy_ids <= parent_ids or not proxy_ids

    def _finalize_due(self) -> List[Dict[str, Any]]:
        done: List[Dict[str, Any]] = []
        expired = []
        for tid, group in self._pending.items():
            lingered = self._poll_n - group["first_poll"] >= self.linger_polls
            if self._group_complete(group["segments"]) or lingered:
                expired.append(tid)
        for tid in expired:
            group = self._pending.pop(tid)
            self._finalized[tid] = None
            while len(self._finalized) > 8 * self.max_traces:
                self._finalized.popitem(last=False)
            rec = stitch(group["segments"])
            if rec is not None:
                done.append(rec)
        return done

    def _ingest(self, stitched: Sequence[Dict[str, Any]]) -> None:
        reg = self.registry
        for rec in stitched:
            reg.counter(
                "observatory_traces_stitched_total",
                help="completed traces assembled by the collector",
            ).inc()
            cov = rec.get("span_coverage")
            if cov is not None:
                reg.histogram(
                    "observatory_stitch_coverage",
                    help="span coverage of stitched traces (fraction)",
                ).observe(cov)
            self._note_padding(rec)
            reason = self.sampler.decide(rec)
            if reason is None:
                reg.counter(
                    "observatory_traces_dropped_total",
                    help="healthy traces dropped by the tail sampler",
                ).inc()
                continue
            reg.counter(
                reg.labeled("observatory_traces_kept_", reason),
                help=f"traces kept by the tail sampler ({reason})",
            ).inc()
            rec["keep_reason"] = reason
            self.traces[rec["trace_id"]] = rec
            while len(self.traces) > self.max_traces:
                self.traces.popitem(last=False)

    def _note_padding(self, rec: Dict[str, Any]) -> None:
        """Per-bucket padding-waste aggregation over EVERY stitched trace
        (sampling must not bias the waste numbers), deduped per physical
        batch by (source, bucket, start)."""
        for s in rec.get("spans", ()):
            attrs = s.get("attrs") or {}
            if s.get("name") != "execute" or "bucket" not in attrs:
                continue
            key = (s.get("source"), attrs["bucket"],
                   s.get("raw_start", s.get("start")))
            agg = self._padding.setdefault(attrs["bucket"], {
                "batches": 0, "images": 0, "waste_sum": 0.0, "seen": set()})
            if key in agg["seen"]:
                continue
            agg["seen"].add(key)
            if len(agg["seen"]) > 4096:
                agg["seen"].clear()  # bounded memory; dedupe is advisory
            agg["batches"] += 1
            agg["images"] += attrs.get("images", 0)
            agg["waste_sum"] += attrs.get("padding_waste", 0.0)

    # -- capacity series ---------------------------------------------------
    #: capacity series whose fleet roll-up sums over replicas (throughput
    #: and queue depth add; everything else averages, latency takes max)
    _CAP_SUM = frozenset(("capacity_effective_imgs_per_sec",
                          "capacity_queue_depth",
                          "capacity_bulk_reclaimed",
                          "capacity_bulk_backlog"))
    _CAP_MAX = frozenset(("capacity_p95_ms",))

    def _ingest_capacity(self, forensics: Dict[str, dict]) -> None:
        """Fold every replica's ``capacity_*`` registry scalars into the
        fleet series store (caller holds ``_lock``): one labeled point per
        replica per poll, plus the bare-named fleet aggregate."""
        now = self._clock()
        fleet: Dict[str, List[float]] = {}
        for name, payload in forensics.items():
            reg = payload.get("registry") or {}
            caps = {k: v for k, v in reg.items()
                    if k.startswith("capacity_")
                    and isinstance(v, (int, float))}
            if not caps:
                continue
            self.series.record_snapshot(caps, t=now,
                                        labels={"replica": name})
            for k, v in caps.items():
                fleet.setdefault(k, []).append(float(v))
        agg = {}
        for k, vs in fleet.items():
            if k in self._CAP_SUM:
                agg[k] = sum(vs)
            elif k in self._CAP_MAX:
                agg[k] = max(vs)
            else:
                agg[k] = sum(vs) / len(vs)
        if agg:
            self.series.record_snapshot(agg, t=now)

    # -- quality series ----------------------------------------------------
    #: quality series whose fleet roll-up takes the max over replicas
    #: (drift anywhere is drift; counts sum; signal levels average)
    _QUAL_MAX = frozenset(("quality_drift",))
    _QUAL_SUM = frozenset(("quality_observed_total",))

    def _ingest_quality(self, forensics: Dict[str, dict]) -> None:
        """Fold every replica's ``quality_*`` registry scalars into the
        fleet series store (caller holds ``_lock``) — same shape as
        :meth:`_ingest_capacity`: one labeled point per replica per poll
        plus the bare-named fleet aggregate."""
        now = self._clock()
        fleet: Dict[str, List[float]] = {}
        for name, payload in forensics.items():
            reg = payload.get("registry") or {}
            quals = {k: v for k, v in reg.items()
                     if k.startswith("quality_")
                     and isinstance(v, (int, float))}
            if not quals:
                continue
            self.series.record_snapshot(quals, t=now,
                                        labels={"replica": name})
            for k, v in quals.items():
                fleet.setdefault(k, []).append(float(v))
        agg = {}
        for k, vs in fleet.items():
            if k in self._QUAL_MAX:
                agg[k] = max(vs)
            elif k in self._QUAL_SUM:
                agg[k] = sum(vs)
            else:
                agg[k] = sum(vs) / len(vs)
        if agg:
            self.series.record_snapshot(agg, t=now)

    # -- bulk-job series ---------------------------------------------------
    def _ingest_bulk(self, forensics: Dict[str, dict]) -> None:
        """Fold every replica's ``bulk_*`` registry scalars into the
        fleet series store (caller holds ``_lock``) — same shape as
        :meth:`_ingest_capacity`.  Every bulk scalar is additive across
        replicas (slot counters, backlogs, active-job counts), so the
        fleet aggregate is a plain sum."""
        now = self._clock()
        fleet: Dict[str, List[float]] = {}
        for name, payload in forensics.items():
            reg = payload.get("registry") or {}
            bulks = {k: v for k, v in reg.items()
                     if k.startswith("bulk_")
                     and isinstance(v, (int, float))}
            if not bulks:
                continue
            self.series.record_snapshot(bulks, t=now,
                                        labels={"replica": name})
            for k, v in bulks.items():
                fleet.setdefault(k, []).append(float(v))
        if fleet:
            self.series.record_snapshot(
                {k: sum(vs) for k, vs in fleet.items()}, t=now)

    # -- serving phase series (attribution evidence) -----------------------
    def _ingest_serving(self, forensics: Dict[str, dict]) -> None:
        """Fold the serving phase-timing scalars — the attribution
        plane's evidence: per-phase histogram ``_sum``/``_count`` pairs
        plus the request total — into the fleet series store (caller
        holds ``_lock``).  SUMS across replicas: histogram sums and
        counts are both additive, so the fleet aggregate stays a valid
        (sum, count) pair and windowed means stay request-weighted.  No
        per-replica labeled points (unlike the capacity/quality folds):
        the phase ladder x replicas would dominate the store's
        cardinality, and the "why" pane only needs the fleet roll-up."""
        now = self._clock()
        fleet: Dict[str, float] = {}
        for payload in forensics.values():
            reg = payload.get("registry") or {}
            for k, v in reg.items():
                if (isinstance(v, (int, float))
                        and attribution.is_phase_scalar(k)):
                    fleet[k] = fleet.get(k, 0.0) + float(v)
        if fleet:
            self.series.record_snapshot(fleet, t=now)

    def _why_pane(self) -> Optional[Dict[str, Any]]:
        """Console attribution verdict (caller holds ``_lock``): the
        always-on answer to "why did fleet latency move" — the same
        :func:`~glom_tpu_torch.obs.attribution.attribute` engine the forensics
        bundles and ``python -m glom_tpu_torch.tools.whyslow`` run, over the
        fleet-summed serving phase series and the router timeline.  None until the
        series show a knee — a healthy fleet has no verdict to show."""
        series: Dict[str, list] = {}
        for name in self.series.names("serving_"):
            pts = self.series.points(name)
            if pts:
                series[name] = [[t, v] for t, v in pts]
        if not series:
            return None
        verdict = attribution.attribute(
            {"series": series, "timeline": list(self._timeline)})
        if verdict.get("knee") is None:
            return None
        return {
            "verdict": verdict["verdict"],
            "confidence": verdict["confidence"],
            "knee": verdict["knee"],
            "regression": verdict["regression"],
            "top_phases": [p for p in verdict["phases"]
                           if p.get("share")][:3],
            "causes": verdict["causes"][:3],
        }

    def _jobs_pane(self) -> Dict[str, Any]:
        """Console bulk-jobs view (caller holds ``_lock``): fleet job
        progress from the router's health block, per-replica scavenge
        rates from the slope of the labeled ``bulk_slots_total`` series
        over the last two minutes, and the fleet ETA those two imply."""
        now = self._clock()
        replicas: Dict[str, Dict[str, Any]] = {}
        fleet_rate = 0.0
        backlog = 0.0
        for name, payload in sorted(self._forensics_by_replica.items()):
            reg = payload.get("registry") or {}
            total = reg.get("bulk_slots_total")
            if total is None and reg.get("bulk_backlog_slots") is None:
                continue
            pts = self.series.points(
                series_key("bulk_slots_total", {"replica": name}),
                since=now - 120.0)
            fit = linear_trend(pts)
            rate = max(0.0, fit["slope"]) if fit else 0.0
            fleet_rate += rate
            backlog += float(reg.get("bulk_backlog_slots") or 0)
            replicas[name] = {
                "slots_total": total,
                "scavenged": reg.get("bulk_scavenged_slots_total"),
                "idle": reg.get("bulk_idle_slots_total"),
                "backlog": reg.get("bulk_backlog_slots"),
                "slots_per_s": round(rate, 3),
            }
        health = self._router_health or {}
        return {
            "jobs": health.get("bulk_jobs") or {},
            "replicas": replicas,
            "backlog_slots": backlog,
            "scavenged_slots_per_s": round(fleet_rate, 3),
            "eta_s": (round(backlog / fleet_rate, 1)
                      if fleet_rate > 0 and backlog else None),
        }

    def _quality_pane(self) -> Dict[str, Any]:
        """Console quality view (caller holds ``_lock``): per-replica
        agreement / drift with a trend arrow from the last two minutes of
        the labeled drift series, plus the fleet-worst drift."""
        now = self._clock()
        replicas: Dict[str, Dict[str, Any]] = {}
        worst_drift = 0.0
        for name, payload in sorted(self._forensics_by_replica.items()):
            reg = payload.get("registry") or {}
            agreement = reg.get("quality_agreement")
            drift = reg.get("quality_drift")
            if agreement is None and drift is None:
                continue
            pts = self.series.points(
                series_key("quality_drift", {"replica": name}),
                since=now - 120.0)
            fit = linear_trend(pts)
            replicas[name] = {
                "agreement": (round(float(agreement), 4)
                              if agreement is not None else None),
                "entropy": reg.get("quality_entropy"),
                "residual": reg.get("quality_residual"),
                "drift": (round(float(drift), 4)
                          if drift is not None else None),
                "observed": reg.get("quality_observed_total"),
                "trend": trend_arrow(fit["slope"] if fit else 0.0),
            }
            if drift is not None:
                worst_drift = max(worst_drift, float(drift))
        return {"replicas": replicas,
                "worst_drift": round(worst_drift, 4)}

    def _capacity_pane(self) -> Dict[str, Any]:
        """Console capacity view (caller holds ``_lock``): per-replica
        duty cycle + utilization with a trend arrow from the last two
        minutes of the labeled duty series, and the most recent advisor
        recommendation witnessed on the router timeline."""
        now = self._clock()
        replicas: Dict[str, Dict[str, Any]] = {}
        for name, payload in sorted(self._forensics_by_replica.items()):
            reg = payload.get("registry") or {}
            duty = reg.get("capacity_duty_cycle")
            if duty is None:
                continue
            pts = self.series.points(
                series_key("capacity_duty_cycle", {"replica": name}),
                since=now - 120.0)
            fit = linear_trend(pts)
            replicas[name] = {
                "duty": round(float(duty), 4),
                "util": reg.get("capacity_utilization"),
                "p95_ms": reg.get("capacity_p95_ms"),
                "shed": reg.get("capacity_shed_ratio"),
                "trend": trend_arrow(fit["slope"] if fit else 0.0),
            }
        recommendation = next(
            (e for e in reversed(self._timeline)
             if e.get("event") == "capacity_recommendation"), None)
        return {"replicas": replicas, "recommendation": recommendation}

    # -- fleet state + incidents -------------------------------------------
    def _apply_timeline(self, payload) -> List[dict]:
        """Fold a fetched ``/debug/timeline`` into the cursor (caller
        holds ``_lock``); returns only the events the collector newly
        WITNESSED — everything on the first successful pull is history
        and is absorbed, exactly like pre-existing bundles."""
        if not isinstance(payload, dict):
            return []
        events = payload.get("events", [])
        self._timeline = events[-64:]
        first_pull = not self._timeline_attached
        self._timeline_attached = True
        fresh = ([] if first_pull else
                 [e for e in events
                  if int(e.get("seq", -1)) > self._timeline_cursor])
        if events:
            self._timeline_cursor = max(
                self._timeline_cursor,
                max(int(e.get("seq", -1)) for e in events))
        return fresh

    def _check_incidents(self, fresh_events: Sequence[dict],
                         forensics: Dict[str, dict]) -> List[str]:
        """Correlate this poll's signals into incident bundles.  Runs as
        a step of the ``poll_once`` duty cycle, under BOTH the poll lock
        and the state lock (it reads ``_poll_n`` and mutates incident
        bookkeeping) — private so no caller can reach it bare.  Triggers:
        a NEW ``slo_burn`` bundle on any replica, or a NEW ejection event
        on the router timeline.  Bundles already present the first time a
        replica is SIGHTED — at attach, or when a replica joins/returns
        mid-run — are absorbed silently: the observatory documents
        incidents it witnessed, not history (per-replica first-sighting,
        so a replica discovered on poll 50 cannot refire its backlog)."""
        written: List[str] = []
        for name, payload in forensics.items():
            if not isinstance(payload, dict):
                continue
            first_sighting = name not in self._seen_bundles
            seen = self._seen_bundles.setdefault(name, set())
            for bundle in payload.get("bundles", ()):
                bname = bundle.get("name")
                if not bname or bname in seen:
                    continue
                seen.add(bname)
                if first_sighting:
                    continue
                trigger = (bundle.get("manifest") or {}).get("trigger")
                # capacity_pressure and quality_drift ride the same path
                # as slo_burn: the replica-side TriggerEngine already
                # debounced them, so a new bundle IS a witnessed incident
                if trigger in ("slo_burn", "capacity_pressure",
                               "quality_drift"):
                    path = self._write_incident(
                        trigger, origin=name, origin_bundle=bundle,
                        forensics=forensics)
                    if path:
                        written.append(path)
        for event in fresh_events:
            if event.get("event") == "ejection":
                path = self._write_incident(
                    "replica_ejection", origin=event.get("replica"),
                    origin_event=event, forensics=forensics)
                if path:
                    written.append(path)
        return written

    def _offending_traces(self, origin_bundle: Optional[dict]
                          ) -> List[Dict[str, Any]]:
        """The evidence traces for an incident: the origin bundle's named
        offenders when the store still holds them, topped up with the
        slowest kept stitched traces."""
        out: List[Dict[str, Any]] = []
        wanted: List[str] = []
        if origin_bundle:
            detail = (origin_bundle.get("manifest") or {}).get("detail") or {}
            wanted = list(detail.get("trace_ids", ()))
        for tid in wanted:
            if tid in self.traces:
                out.append(self.traces[tid])
        have = {t["trace_id"] for t in out}
        slowest = sorted(
            (t for t in self.traces.values() if t["trace_id"] not in have),
            key=lambda t: -(t.get("duration_ms") or 0.0))
        out.extend(slowest[: max(0, 5 - len(out))])
        return [dict(t, critical_path=[
            {"span": n, "ms": round(ms, 3)}
            for n, ms in critical_path(t["spans"])]) for t in out]

    def _write_incident(self, trigger: str, *, origin: Optional[str],
                        origin_bundle: Optional[dict] = None,
                        origin_event: Optional[dict] = None,
                        forensics: Optional[Dict[str, dict]] = None
                        ) -> Optional[str]:
        if self.incident_dir is None:
            return None
        # per-trigger debounce: a fleet-wide burn fires slo_burn on EVERY
        # replica within one poll — that is ONE incident with N pieces of
        # evidence, not N incidents (the bundle already pulls every
        # replica's state regardless of which replica tripped first)
        last = self._last_incident_poll.get(trigger)
        if (last is not None
                and self._poll_n - last < self.incident_debounce_polls):
            self.registry.counter(
                "observatory_incidents_deduped_total",
                help="incident signals folded into an already-written "
                     "bundle (per-trigger debounce window)",
            ).inc()
            return None
        if len(self.incidents) >= self.incident_max:
            self.registry.counter(
                "observatory_incidents_suppressed_total",
                help="incident bundles skipped past the per-run budget",
            ).inc()
            return None
        files: Dict[str, Any] = {}
        replicas = sorted((forensics or {}).items())
        for name, payload in replicas:
            files[f"replica_{name}.json"] = {
                "bundles": payload.get("bundles", []),
                "registry": payload.get("registry", {}),
                "step": payload.get("step"),
                "slo_fired": payload.get("slo_fired", []),
            }
        files["timeline.json"] = {
            "events": self._timeline,
            "fleet": self._router_health,
        }
        files["traces.json"] = self._offending_traces(origin_bundle)
        files["console.json"] = self._console_locked()
        files["manifest.json"] = {
            "schema": 1,
            "kind": "fleet_incident",
            "trigger": trigger,
            "origin": origin,
            "origin_bundle": (origin_bundle or {}).get("name"),
            "origin_event": origin_event,
            "replicas": [name for name, _ in replicas],
            "created_unix": self._wall(),
            "poll": self._poll_n,
            "files": sorted(files) + [],
        }
        try:
            path = write_bundle(self.incident_dir,
                                f"incident-{trigger}-{self._poll_n}", files)
        except OSError as e:
            warnings.warn(
                f"incident bundle write failed ({e}); fleet evidence for "
                f"this {trigger} incident is lost", stacklevel=2)
            return None
        self.incidents.append(path)
        self._last_incident_poll[trigger] = self._poll_n
        self.registry.counter(
            "observatory_incidents_total",
            help="cross-replica incident bundles written",
        ).inc()
        return path

    # -- exemplars ---------------------------------------------------------
    def pull_exemplars(self) -> List[Dict[str, Any]]:
        """Scrape every source's ``/metrics`` and extract the OpenMetrics
        exemplars — each links a histogram bucket to a trace id."""
        out: List[Dict[str, Any]] = []
        with self._lock:  # snapshot: discover() mutates the source table
            sources = [(name, dict(src))
                       for name, src in self.sources.items()]
        for name, src in sources:
            # exemplars are OpenMetrics-only; /metrics negotiates on the
            # Accept header and serves plain 0.0.4 text otherwise
            text = self._get_text(
                f"{src['url']}/metrics",
                headers={"Accept":
                         "application/openmetrics-text; version=1.0.0"})
            if text is None:
                continue
            for ex in parse_exemplars(text):
                ex["source"] = name
                out.append(ex)
        return out

    def resolve_exemplar(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """An exemplar's trace id -> the stored stitched trace (with its
        critical path attached), or None when sampling dropped it."""
        with self._lock:
            rec = self.traces.get(trace_id)
            if rec is None:
                return None
            return dict(rec, critical_path=[
                {"span": n, "ms": round(ms, 3)}
                for n, ms in critical_path(rec["spans"])])

    # -- duty cycle --------------------------------------------------------
    def poll_once(self) -> Dict[str, Any]:
        """One collector duty cycle; returns a summary the CLI can log.

        Network I/O (healthz discovery, then the concurrent ``/debug/*``
        fan-out) runs under ``_poll_lock`` only; the state lock is taken
        twice, briefly — to apply discovery and snapshot the source
        table, then to fold the fetched payloads in.  ``/console`` and
        ``/trace`` readers are never parked behind a timing-out source."""
        with self._poll_lock:
            health = (self._get_json(f"{self.router_url}/healthz")
                      if self.router_url else None)
            with self._lock:
                self._poll_n += 1
                self._apply_discovery(health)
                sources = [(name, dict(src))
                           for name, src in self.sources.items()]
            fetched = self._fetch_all(sources)
            with self._lock:
                pulled = self._apply_traces(fetched["traces"])
                stitched = self._finalize_due()
                self._ingest(stitched)
                fresh_events = self._apply_timeline(fetched["timeline"])
                forensics = {name: payload
                             for name, payload in fetched["forensics"].items()
                             if isinstance(payload, dict)}
                self._forensics_by_replica = forensics
                self._ingest_capacity(forensics)
                self._ingest_quality(forensics)
                self._ingest_bulk(forensics)
                self._ingest_serving(forensics)
                incidents = self._check_incidents(fresh_events, forensics)
                return {
                    "poll": self._poll_n,
                    "pulled_segments": pulled,
                    "stitched": len(stitched),
                    "stored": len(self.traces),
                    "pending": len(self._pending),
                    "incidents_written": incidents,
                }

    def flush(self) -> None:
        """Force-finalize pending groups (tests / shutdown): every group
        is treated as lingered out."""
        with self._poll_lock:
            with self._lock:
                self._poll_n += self.linger_polls
                self._ingest(self._finalize_due())

    # -- console -----------------------------------------------------------
    def console(self) -> Dict[str, Any]:
        """The one-pane fleet view (served as ``/console``).  Reads only
        collector-local state refreshed by the last poll."""
        with self._lock:
            return self._console_locked()

    def _console_locked(self) -> Dict[str, Any]:
        health = self._router_health or {}
        slowest = sorted(self.traces.values(),
                         key=lambda t: -(t.get("duration_ms") or 0.0))[:5]
        burn_rates: Dict[str, Dict[str, float]] = {}
        for name, payload in self._forensics_by_replica.items():
            reg = payload.get("registry") or {}
            rates = {k: v for k, v in reg.items()
                     if k.startswith("slo_burn_rate_")}
            if rates:
                burn_rates[name] = rates
        return {
            "fleet": {
                "status": health.get("status"),
                "healthy_replicas": health.get("healthy_replicas"),
                "fleet_step": health.get("fleet_step"),
                "rollout_phase": health.get("rollout_phase", "idle"),
            },
            "replicas": [
                {"name": r.get("name"), "healthy": r.get("healthy"),
                 "step": r.get("step"), "inflight": r.get("inflight"),
                 "errors": r.get("errors"), "requests": r.get("requests")}
                for r in health.get("replicas", ())
            ],
            "sources": {
                name: {"role": src["role"], "url": src["url"],
                       "cursor": src["cursor"],
                       "reachable": src.get("reachable")}
                for name, src in self.sources.items()
            },
            "rollout_events": self._timeline[-10:],
            "slo_burn_rates": burn_rates,
            "capacity": self._capacity_pane(),
            "quality": self._quality_pane(),
            "jobs": self._jobs_pane(),
            "why": self._why_pane(),
            "padding_waste": {
                str(bucket): {
                    "batches": agg["batches"],
                    "images": agg["images"],
                    "mean_padding_waste": round(
                        agg["waste_sum"] / agg["batches"], 4)
                    if agg["batches"] else None,
                }
                for bucket, agg in sorted(self._padding.items(),
                                          key=lambda kv: str(kv[0]))
            },
            "slowest_traces": [
                {"trace_id": t["trace_id"],
                 "duration_ms": t.get("duration_ms"),
                 "span_coverage": t.get("span_coverage"),
                 "keep_reason": t.get("keep_reason"),
                 "sources": t.get("sources"),
                 "critical_path": [
                     {"span": n, "ms": round(ms, 3)}
                     for n, ms in critical_path(t["spans"])[:4]]}
                for t in slowest
            ],
            "sampler": self.sampler.stats(),
            "incidents": list(self.incidents),
        }

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="glom-observatory", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.poll_once()
            except Exception as e:  # the poll loop must outlive any one bad poll
                self.registry.counter(
                    "observatory_poll_errors_total",
                    help="collector polls that raised",
                ).inc()
                warnings.warn(
                    f"observatory poll raised ({type(e).__name__}: {e}); "
                    f"collector continues", stacklevel=2)

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# ---------------------------------------------------------------------------
# stdlib HTTP front: the collector's read-only pane
# ---------------------------------------------------------------------------
def make_observatory_server(observatory: FleetObservatory,
                            host: str = "127.0.0.1", port: int = 0, *,
                            quiet: bool = True):
    """Bind the collector's HTTP pane (port 0 = ephemeral):

      * ``GET /console``             — the full fleet console JSON;
      * ``GET /trace?id=<trace_id>`` — one stored stitched trace (with
        its critical path) — also the exemplar-resolution endpoint:
        feed it the trace id from a ``# {trace_id=...}`` exemplar;
      * ``GET /incidents``           — written incident bundle paths;
      * ``GET /healthz``             — collector liveness + source table.

    Caller runs ``serve_forever`` on its own thread (the router/server
    pattern)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    class _ObsServer(ThreadingHTTPServer):
        daemon_threads = True
        allow_reuse_address = True

    class _Handler(BaseHTTPRequestHandler):
        server_version = "glom-observatory"
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            if not quiet:
                super().log_message(fmt, *args)

        def _reply(self, code: int, payload) -> None:
            body = json.dumps(payload, default=repr).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server contract)
            parsed = urlparse(self.path)
            query = parse_qs(parsed.query)
            if parsed.path == "/console":
                self._reply(200, observatory.console())
            elif parsed.path == "/trace":
                tid = (query.get("id") or query.get("trace_id")
                       or [None])[0]
                rec = (observatory.resolve_exemplar(tid)
                       if tid else None)
                if rec is None:
                    self._reply(404, {
                        "error": "unknown_trace",
                        "detail": f"trace {tid!r} is not in the stitched "
                                  f"store (dropped by sampling, or "
                                  f"evicted)"})
                else:
                    self._reply(200, rec)
            elif parsed.path == "/incidents":
                self._reply(200, {"incidents": list(observatory.incidents)})
            elif parsed.path == "/healthz":
                with observatory._lock:
                    sources = {
                        name: {"role": s["role"],
                               "reachable": s.get("reachable")}
                        for name, s in observatory.sources.items()}
                self._reply(200, {
                    "status": "ok", "role": "observatory",
                    "sources": sources,
                    "stored_traces": len(observatory.traces),
                })
            else:
                self._reply(404, {"error": f"no route {parsed.path}"})

    return _ObsServer((host, port), _Handler)
