"""End-to-end tracing: spans, trace context, and Perfetto export.

The port's copy of ``glom_tpu/obs/tracing.py`` (stdlib only), the same code
so both packages export the same metrics, traces and alerts.

One slow request hides its cause across many layers — HTTP queue wait,
micro-batcher deadline, bucket padding, device execution — and aggregate
percentiles cannot attribute it.  This module gives every request (and
every train-step window) a causal trace:

  * :class:`Span` — one timed operation: ``trace_id`` / ``span_id`` /
    ``parent_id``, name, start/end (seconds on the tracer's clock), and a
    flat attribute dict.
  * :class:`Tracer` — span factory over an injectable clock, with a
    thread-safe bounded in-memory sink (:class:`TraceSink`).  Ending a
    span feeds per-span-kind duration histograms into an attached
    :class:`~glom_tpu_torch.obs.registry.MetricRegistry`
    (``serving_queue_wait_ms``, ``serving_execute_ms``, per-bucket
    ``serving_execute_ms_b<k>`` — the inputs the SLO burn-rate layer in
    :mod:`glom_tpu_torch.obs.slo` evaluates), and ending a ROOT span emits the
    whole trace as one JSONL record through any attached exporter (the
    existing :class:`~glom_tpu_torch.obs.exporters.JsonlExporter` shape — one
    JSON object per line).
  * Context propagation helpers: :func:`parse_traceparent` /
    :func:`format_traceparent` (W3C trace-context) and
    :func:`request_trace_id` (honors an inbound ``X-Request-Id``), so the
    serving path joins traces a client or proxy already started.
  * :func:`to_perfetto` / :class:`TraceExporter` — Chrome trace-event
    JSON, openable directly in ``ui.perfetto.dev`` (or
    ``chrome://tracing``).

Everything is host-side bookkeeping: no device syncs, no jax import.
``tools/trace_report.py`` consumes the JSONL feed offline.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence

# -- canonical serving span names (the taxonomy docs/OBSERVABILITY.md
# tables; trace_report.py groups by these) --------------------------------
SPAN_REQUEST = "request"            # server: whole HTTP handler
SPAN_PARSE = "parse"                # server: body read + validation
SPAN_QUEUE_WAIT = "queue_wait"      # batcher: submit -> batch take
SPAN_DISPATCH_WAIT = "dispatch_wait"  # server: parked on the result future
SPAN_BATCH_ASSEMBLY = "batch_assembly"  # engine: per-request concat window
SPAN_BUCKET_SELECT = "bucket_select"    # compile_cache: bucket decision
SPAN_PAD = "pad"                    # compile_cache: zero-pad to bucket
SPAN_EXECUTE = "execute"            # compile_cache: device execution
SPAN_RESPOND = "respond"            # server: result slice + JSON write
SPAN_BATCH = "batch"                # batch-level span (own trace, links)
SPAN_RELOAD = "reload_swap"         # engine: checkpoint hot-reload swap
# -- fleet tier (serving/router.py) --
SPAN_ROUTER_REQUEST = "router_request"  # router: whole front-door handler
SPAN_ROUTE = "route"                # router: replica pick (policy + choice)
SPAN_PROXY = "proxy"                # router: one upstream attempt; its span
#                                     id rides the forwarded traceparent, so
#                                     the engine's request span parents under
#                                     it and trace_report shows the full hop

# span kind -> registry histogram (milliseconds).  EXECUTE additionally
# feeds a per-bucket histogram when the span carries a "bucket" attribute.
SPAN_METRICS = {
    SPAN_REQUEST: "serving_request_ms",
    SPAN_PARSE: "serving_parse_ms",
    SPAN_QUEUE_WAIT: "serving_queue_wait_ms",
    SPAN_BATCH_ASSEMBLY: "serving_batch_assembly_ms",
    SPAN_PAD: "serving_pad_ms",
    SPAN_EXECUTE: "serving_execute_ms",
    SPAN_RESPOND: "serving_respond_ms",
    SPAN_RELOAD: "serving_reload_swap_ms",
    SPAN_ROUTER_REQUEST: "router_request_ms",
    SPAN_PROXY: "router_proxy_ms",
}


def new_id() -> str:
    """16-hex span/trace id (random; uniqueness, not cryptography)."""
    return uuid.uuid4().hex[:16]


def parse_traceparent(header: Optional[str]):
    """W3C trace-context ``traceparent``: ``00-<32hex>-<16hex>-<2hex>`` ->
    ``(trace_id, parent_span_id)``, or None on anything malformed (a bad
    header must start a fresh trace, never 500 the request)."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, parent_id, _flags = parts
    if len(trace_id) != 32 or len(parent_id) != 16 or len(version) != 2:
        return None
    try:
        int(trace_id, 16), int(parent_id, 16), int(version, 16)
    except ValueError:
        return None
    if int(trace_id, 16) == 0 or int(parent_id, 16) == 0:
        return None
    return trace_id, parent_id


def format_traceparent(trace_id: str, span_id: str) -> str:
    """Render a span context back into a ``traceparent`` header (padded to
    the W3C field widths)."""
    return f"00-{trace_id[:32].zfill(32)}-{span_id[:16].zfill(16)}-01"


_REQUEST_ID_MAX = 128


def request_trace_id(request_id: Optional[str]) -> Optional[str]:
    """Sanitize an inbound ``X-Request-Id`` into a usable trace id: any
    printable ASCII token up to 128 chars passes through verbatim
    (operators grep their own ids), anything else is rejected (-> fresh
    id).  ASCII because the id is echoed back as a response HEADER —
    http.server encodes headers latin-1 strict, so a non-ASCII id
    accepted here would crash the reply instead of serving it."""
    if not request_id:
        return None
    rid = request_id.strip()
    if (not rid or len(rid) > _REQUEST_ID_MAX or not rid.isprintable()
            or not rid.isascii()):
        return None
    return rid


class Span:
    """One timed operation.  ``end`` is None while open; attributes are a
    flat dict of JSON-encodable scalars.  ``root`` marks the trace's local
    root explicitly — a root joined from a remote ``traceparent`` carries
    the REMOTE span as ``parent_id``, so "parent is None" is not a root
    test."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start", "end",
                 "attrs", "root")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], start: float,
                 attrs: Optional[Dict[str, Any]] = None, root: bool = False):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end: Optional[float] = None
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.root = root

    @property
    def duration_ms(self) -> Optional[float]:
        return None if self.end is None else (self.end - self.start) * 1e3

    @property
    def context(self) -> "Span":
        """A span IS its own context (trace_id + span_id is all a child
        needs); kept as a property so call sites read as intent."""
        return self

    def to_dict(self) -> Dict[str, Any]:
        d = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": round(self.start, 6),
            "end": None if self.end is None else round(self.end, 6),
            "duration_ms": (None if self.duration_ms is None
                            else round(self.duration_ms, 3)),
        }
        if self.root:
            d["root_span"] = True
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class TraceSink:
    """Thread-safe in-memory span store with bounded retention.

    Spans group by ``trace_id``; when more than ``max_traces`` traces are
    resident the OLDEST trace is evicted whole (a trace with half its
    spans dropped would report a fake critical path).  Late spans of an
    evicted trace are DROPPED, not regrown into a fresh partial trace —
    eviction is remembered (bounded) so a slow in-flight request whose
    trace was evicted cannot re-enter the sink as only its tail and
    report a fake critical path.  ``max_spans`` caps any single trace —
    a runaway instrumentation loop must not hold the heap hostage;
    overflow spans are counted, not stored."""

    def __init__(self, max_traces: int = 256, max_spans: int = 512):
        if max_traces < 1 or max_spans < 1:
            raise ValueError(
                f"max_traces/max_spans must be >= 1, got "
                f"{max_traces}/{max_spans}"
            )
        self.max_traces = max_traces
        self.max_spans = max_spans
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, List[Span]]" = OrderedDict()
        # evicted trace ids, bounded FIFO (values unused) — membership
        # means "this trace already left whole; drop its stragglers"
        self._evicted: "OrderedDict[str, None]" = OrderedDict()
        self.dropped_spans = 0
        self.evicted_traces = 0

    def add(self, span: Span) -> None:
        with self._lock:
            if span.trace_id in self._evicted:
                self.dropped_spans += 1
                return
            spans = self._traces.get(span.trace_id)
            if spans is None:
                while len(self._traces) >= self.max_traces:
                    evicted_id, _ = self._traces.popitem(last=False)
                    self.evicted_traces += 1
                    self._evicted[evicted_id] = None
                    while len(self._evicted) > 4 * self.max_traces:
                        self._evicted.popitem(last=False)
                spans = self._traces[span.trace_id] = []
            if len(spans) >= self.max_spans:
                self.dropped_spans += 1
                return
            spans.append(span)

    def trace(self, trace_id: str) -> List[Span]:
        with self._lock:
            return list(self._traces.get(trace_id, ()))

    def trace_ids(self) -> List[str]:
        with self._lock:
            return list(self._traces)

    def all_spans(self) -> List[Span]:
        with self._lock:
            return [s for spans in self._traces.values() for s in spans]


class Tracer:
    """Span factory + sink + metric/export fanout.  One per process
    (serving engine, trainer); thread-safe throughout — handler threads,
    the batcher worker, and the reload watcher all record through it.

    ``clock`` is injectable (tests drive latency deterministically);
    ``registry`` receives span-duration histograms per SPAN_METRICS;
    ``exporter`` (anything with ``emit(dict)`` — a JsonlExporter) gets one
    record per COMPLETED trace, emitted when its root span ends."""

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 sink: Optional[TraceSink] = None, registry=None,
                 exporter=None, completed_max: int = 256):
        if completed_max < 1:
            raise ValueError(
                f"completed_max must be >= 1, got {completed_max}")
        self.clock = clock if clock is not None else time.monotonic
        self.sink = sink if sink is not None else TraceSink()
        self.registry = registry
        self.exporter = exporter
        # root spans end on whichever thread served the request; the
        # JSONL exporter underneath is not internally locked
        self._emit_lock = threading.Lock()
        # bounded ring of COMPLETED trace records (the per-trace JSONL
        # shape), each tagged with a monotone sequence number so a puller
        # (/debug/traces -> the fleet observatory) reads incrementally:
        # "give me everything since cursor N" costs one list slice, and a
        # slow puller loses the oldest records, never the newest
        self._completed: "OrderedDict[int, Dict[str, Any]]" = OrderedDict()
        self._completed_max = completed_max
        self._completed_seq = 0

    # -- span lifecycle ----------------------------------------------------
    def start_trace(self, name: str, trace_id: Optional[str] = None,
                    parent_id: Optional[str] = None,
                    attrs: Optional[Dict[str, Any]] = None) -> Span:
        """Open a ROOT span.  ``trace_id`` joins an inbound trace
        (X-Request-Id / traceparent); ``parent_id`` chains under a remote
        parent span when a traceparent supplied one."""
        span = Span(name, trace_id or new_id(), new_id(), parent_id,
                    self.clock(), attrs, root=True)
        self.sink.add(span)
        return span

    def start_span(self, name: str, parent: Span,
                   attrs: Optional[Dict[str, Any]] = None) -> Span:
        span = Span(name, parent.trace_id, new_id(), parent.span_id,
                    self.clock(), attrs)
        self.sink.add(span)
        return span

    def end(self, span: Span, attrs: Optional[Dict[str, Any]] = None,
            at: Optional[float] = None) -> Span:
        """Close a span (idempotent — a double end keeps the first edge),
        feed its duration histogram, and flush the trace record when this
        was the root.  ``at`` pins the end edge to a timestamp the caller
        already took — a root whose end should COINCIDE with its last
        child's edge must share it exactly, or a thread preemption
        between the two clock reads leaks uncovered wall time."""
        if span.end is None:
            span.end = at if at is not None else self.clock()
        if attrs:
            span.attrs.update(attrs)
        self._observe(span)
        if span.root:
            # always build the completed record (the /debug/traces pull
            # ring wants it even with no JSONL exporter attached)
            self.emit_trace(span.trace_id)
        return span

    def record(self, name: str, parent: Optional[Span], start: float,
               end: float, attrs: Optional[Dict[str, Any]] = None,
               observe: bool = True) -> Span:
        """Record a span from EXPLICIT timestamps — the fan-in form: one
        measured batch operation (pad, execute) mirrored into each member
        request's trace with identical edges.  ``observe=False`` skips the
        duration histogram: one physical operation mirrored into N member
        traces must feed the metric ONCE, not N times."""
        span = Span(name, parent.trace_id if parent else new_id(), new_id(),
                    parent.span_id if parent else None, start, attrs)
        span.end = end
        self.sink.add(span)
        if observe:
            self._observe(span)
        return span

    class _SpanCtx:
        __slots__ = ("_tracer", "span")

        def __init__(self, tracer, span):
            self._tracer, self.span = tracer, span

        def __enter__(self):
            return self.span

        def __exit__(self, *exc):
            self._tracer.end(self.span)

    def span(self, name: str, parent: Span,
             attrs: Optional[Dict[str, Any]] = None) -> "Tracer._SpanCtx":
        """Context-manager convenience over start_span/end."""
        return Tracer._SpanCtx(self, self.start_span(name, parent, attrs))

    # -- fanout ------------------------------------------------------------
    def _observe(self, span: Span) -> None:
        if self.registry is None or span.duration_ms is None:
            return
        metric = SPAN_METRICS.get(span.name)
        if metric is None:
            return
        # each observation carries its trace id as the bucket exemplar:
        # the /metrics scrape then links a p99 bucket straight to a trace
        # the sink (or the fleet observatory) can still resolve
        self.registry.histogram(
            metric, unit="ms", help=f"{span.name} span duration",
        ).observe(span.duration_ms, exemplar=span.trace_id)
        bucket = span.attrs.get("bucket")
        if span.name == SPAN_EXECUTE and bucket is not None:
            # per-bucket family minted through the cardinality guard: a
            # bucketless fallback path labeling raw batch sizes would
            # otherwise grow one histogram per distinct size
            name = self.registry.labeled(f"{metric}_b", int(bucket))
            self.registry.histogram(
                name, unit="ms",
                help=f"{span.name} span duration, batch bucket {int(bucket)}",
            ).observe(span.duration_ms, exemplar=span.trace_id)

    def emit_trace(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """Emit one per-trace JSONL record through the attached exporter
        (and return it): the whole trace, spans oldest-first — the feed
        ``tools/trace_report.py`` reads.  The record also lands in the
        bounded completed-trace ring served by ``/debug/traces``."""
        spans = self.sink.trace(trace_id)
        if not spans:
            return None
        spans = sorted(spans, key=lambda s: s.start)
        root = next((s for s in spans if s.root), spans[0])
        rec = {
            "trace_id": trace_id,
            "root": root.name,
            "duration_ms": root.duration_ms,
            "spans": [s.to_dict() for s in spans],
        }
        with self._emit_lock:
            self._completed[self._completed_seq] = rec
            self._completed_seq += 1
            while len(self._completed) > self._completed_max:
                self._completed.popitem(last=False)
            if self.exporter is not None:
                self.exporter.emit(rec)
        return rec

    def completed_since(self, cursor: int = 0):
        """Incremental pull of completed trace records: ``(next_cursor,
        records)`` for every record with sequence >= ``cursor`` still in
        the ring.  Feeding ``next_cursor`` back reads only what completed
        since — the ``/debug/traces`` contract the fleet observatory polls
        (a cursor older than the ring's tail silently skips the evicted
        records; the puller was too slow for them either way)."""
        with self._emit_lock:
            records = [rec for seq, rec in self._completed.items()
                       if seq >= cursor]
            return self._completed_seq, records


def debug_traces_payload(tracer: Tracer, query_string: str, **extra):
    """The ONE ``GET /debug/traces`` handler body, shared by the engine
    server and the router front so the two halves of the observatory's
    pull protocol can never drift: parses ``since=<cursor>`` from the
    query string and returns ``(status, payload)`` — 400 with an error
    payload on a malformed cursor, else 200 with ``{**extra, "next":
    cursor, "traces": [...]}``."""
    from urllib.parse import parse_qs

    try:
        since = int((parse_qs(query_string).get("since") or ["0"])[0])
    except ValueError:
        return 400, {"error": "since must be an integer"}
    next_cursor, traces = tracer.completed_since(since)
    return 200, {**extra, "next": next_cursor, "traces": traces}


# -- coverage (the acceptance math, shared with tools/trace_report.py) ----
def find_root(spans: Sequence[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The trace's local root among span DICTS: the ``root_span``-flagged
    span, else a parentless span, else one whose parent is not in the
    trace (a root joined from a remote traceparent in a pre-flag feed)."""
    ids = {s.get("span_id") for s in spans}
    for pred in (lambda s: s.get("root_span"),
                 lambda s: s.get("parent_id") is None,
                 lambda s: s.get("parent_id") not in ids):
        root = next((s for s in spans if pred(s)), None)
        if root is not None:
            return root
    return None


def span_coverage(spans: Sequence[Dict[str, Any]]) -> Optional[float]:
    """Fraction of the root span's wall time covered by the UNION of its
    descendant spans — the "did the trace explain the request?" number.
    Accepts span DICTS (the JSONL feed shape).  None without a closed
    root."""
    root = find_root(spans)
    if root is None or root.get("end") is None:
        return None
    t0, t1 = root["start"], root["end"]
    if t1 <= t0:
        return 1.0
    ivs = sorted(
        (max(s["start"], t0), min(s["end"], t1))
        for s in spans
        if s is not root and s.get("end") is not None and s["end"] > t0
        and s["start"] < t1
    )
    covered = 0.0
    cur_a = cur_b = None
    for a, b in ivs:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                covered += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        covered += cur_b - cur_a
    return covered / (t1 - t0)


# -- Perfetto / Chrome trace-event export ---------------------------------
def to_perfetto(spans: Sequence[Span], *, pid: int = 1) -> Dict[str, Any]:
    """Chrome trace-event JSON (the ``traceEvents`` array form) from
    spans.  Complete events (``ph: "X"``, microsecond ``ts``/``dur``);
    each trace gets its own ``tid`` lane so concurrent requests stack
    instead of overlapping.  Open spans are skipped — a viewer given a
    NaN duration renders nothing."""
    tids: Dict[str, int] = {}
    events = []
    for span in spans:
        if span.end is None:
            continue
        tid = tids.setdefault(span.trace_id, len(tids) + 1)
        events.append({
            "name": span.name,
            "cat": "glom",
            "ph": "X",
            "ts": round(span.start * 1e6, 3),
            "dur": round((span.end - span.start) * 1e6, 3),
            "pid": pid,
            "tid": tid,
            "args": {"trace_id": span.trace_id, "span_id": span.span_id,
                     "parent_id": span.parent_id, **span.attrs},
        })
    meta = [
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
         "args": {"name": f"trace {trace_id}"}}
        for trace_id, tid in tids.items()
    ]
    return {"displayTimeUnit": "ms", "traceEvents": meta + events}


class TraceExporter:
    """Write spans as a Perfetto-loadable JSON file (``ui.perfetto.dev``
    -> Open trace file).  ``write`` takes spans or defaults to everything
    a sink retains."""

    def __init__(self, sink: Optional[TraceSink] = None):
        self.sink = sink

    def write(self, path: str, spans: Optional[Sequence[Span]] = None) -> str:
        if spans is None:
            if self.sink is None:
                raise ValueError("TraceExporter needs spans or a sink")
            spans = self.sink.all_spans()
        doc = to_perfetto(spans)
        if self.sink is not None and (self.sink.dropped_spans
                                      or self.sink.evicted_traces):
            # loss must be visible in the artifact: a capped trace
            # otherwise reads as "the window ended early" (viewers ignore
            # unknown top-level keys)
            doc["otherData"] = {"dropped_spans": self.sink.dropped_spans,
                                "evicted_traces": self.sink.evicted_traces}
        with open(path, "w") as f:
            json.dump(doc, f)
        return path
