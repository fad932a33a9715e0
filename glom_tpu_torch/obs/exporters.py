"""Pluggable metric exporters.

The port's copy of ``glom_tpu/obs/exporters.py`` (stdlib only), the same code
so both packages export the same metrics, traces and alerts.

Every exporter consumes the same record shape the trainer logs — a flat
``{key: scalar-or-string}`` dict per logging boundary — plus (for the
Prometheus sink) the registry snapshot.  Adding a sink never touches the
instrumentation sites.

  * :class:`JsonlExporter` — the historical format, byte-compatible with
    every existing consumer (``tools/plateau_report.py``,
    ``tools/sweep_log.py``, ``docs/runs/*.jsonl``): one JSON object per
    line, floats rounded for log compactness.
  * :class:`CsvExporter` — spreadsheet-ready; the column set grows as new
    keys appear (the file is rewritten with the widened header — logs are
    a few KB, correctness beats cleverness here).
  * :class:`PrometheusTextfileExporter` — the node-exporter textfile
    collector contract: the CURRENT state of every metric, written
    atomically (tmp + rename) so a scraper never reads a torn file.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import IO, Dict, List, Optional


def normalize_scalar(v):
    """The one value-normalization rule for log records: bools and ints
    pass through (JSON has them), floats round to 6 SIGNIFICANT digits for
    log compactness (not absolute decimals — a 4e-7 loss must not collapse
    to 0.0), strings pass through, numpy/jax scalars coerce via float().
    Anything else is an error at the call site, not a silent str() later."""
    if isinstance(v, bool) or isinstance(v, int):
        return v
    if isinstance(v, str):
        return v
    f = float(v)  # numpy/jax scalars, python floats
    return float(f"{f:.6g}") if math.isfinite(f) else f


class JsonlExporter:
    """One JSON object per line to a stream and/or append-mode file.

    ``close()`` is deterministic and idempotent; a later ``emit`` lazily
    reopens the file in append mode, so a long-lived exporter survives the
    owner closing it between fit() calls."""

    def __init__(self, path: Optional[str] = None, stream: Optional[IO] = None):
        self.path = path
        self._stream = stream
        self._file = open(path, "a") if path else None

    def emit(self, record: Dict) -> None:
        line = json.dumps(record)
        if self._stream is not None:
            print(line, file=self._stream, flush=True)
        if self.path and self._file is None:
            self._file = open(self.path, "a")
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None


class CsvExporter:
    """CSV with a growing column set.

    Keys are ordered by first appearance; when a record introduces new
    keys the file is rewritten with the widened header (rows are retained
    in memory — one small dict per logging boundary).  Missing values are
    empty cells.  Strings are quoted per csv rules.

    An existing file at ``path`` is loaded on construction, so a resumed
    run (or a logger reopened after ``close``) keeps appending — a later
    header widening must rewrite the WHOLE history, never just the rows
    this process has seen."""

    def __init__(self, path: str):
        import csv

        self.path = path
        self._fields: List[str] = []
        self._rows: List[Dict] = []
        if os.path.exists(path) and os.path.getsize(path):
            with open(path, newline="") as f:
                reader = csv.DictReader(f)
                self._fields = list(reader.fieldnames or [])
                self._rows = [
                    {k: v for k, v in row.items() if v != ""} for row in reader
                ]

    def emit(self, record: Dict) -> None:
        new = [k for k in record if k not in self._fields]
        self._rows.append(dict(record))  # glomlint: disable=obs-unbounded-series -- rows ARE the file: a header widening must rewrite the full history (class docstring); one small dict per logging boundary, not per request
        if new:
            self._fields.extend(new)  # glomlint: disable=obs-unbounded-series -- bounded by the record key vocabulary, which the instrumentation sites fix
            self._rewrite()
        else:
            with open(self.path, "a", newline="") as f:
                self._writer(f).writerow(self._rows[-1])

    def _writer(self, f):
        import csv

        return csv.DictWriter(f, fieldnames=self._fields, restval="")

    def _rewrite(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w", newline="") as f:
            w = self._writer(f)
            w.writeheader()
            w.writerows(self._rows)
        os.replace(tmp, self.path)

    def close(self) -> None:
        # rows stay resident: a post-close emit that widens the header
        # must rewrite the full history, not just the rows seen since
        pass


_PROM_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
# exemplar ids rendered into the exposition must not be able to break the
# line: X-Request-Id admits any printable ASCII, so an id like `ab"} 9`
# would otherwise splice itself into the sample syntax and fail the whole
# scrape.  Ids outside this safe set simply lose their exemplar link (the
# metrics themselves must never be poisonable by one request header).
_EXEMPLAR_ID_OK = re.compile(r"[A-Za-z0-9_.:/+=\-]{1,128}")


def prom_name(name: str, prefix: str = "glom_") -> str:
    """Sanitize to the Prometheus metric-name charset."""
    name = _PROM_NAME_OK.sub("_", name)
    if not name or not (name[0].isalpha() or name[0] in "_:"):
        name = "_" + name
    return prefix + name


def registry_families(registry, prefix: str = "glom_"):
    """Flatten a :class:`~glom_tpu_torch.obs.registry.MetricRegistry` into the
    Prometheus family form ``(state, types, help, exemplars)`` — sanitized
    metric name to value, declared type, help string, and per-bucket-line
    exemplars (``{sample_name: (exemplar_id, value)}``, OpenMetrics
    rendering is the renderer's choice).  The ONE registry->Prometheus
    mapping, shared by :class:`PrometheusTextfileExporter` (node-exporter
    textfile contract) and the serving subsystem's live ``/metrics``
    endpoint so the two outputs can never drift."""
    from glom_tpu_torch.obs.registry import Counter, Gauge, Histogram, Timer

    state: Dict[str, float] = {}
    types: Dict[str, str] = {}
    help_: Dict[str, str] = {}
    exemplars: Dict[str, tuple] = {}
    for m in registry:
        hist = m.hist if isinstance(m, Timer) else m
        if isinstance(hist, Counter):
            suffix = "" if hist.name.endswith("_total") else "_total"
            name = prom_name(hist.name + suffix, prefix)
            state[name] = hist.value
            types[name] = "counter"
            if hist.help:
                help_[name] = hist.help
        elif isinstance(hist, Gauge):
            if hist.value is None:
                continue
            name = prom_name(hist.name, prefix)
            state[name] = hist.value
            types[name] = "gauge"
            if hist.help:
                help_[name] = hist.help
        elif isinstance(hist, Histogram):
            if not hist.count:
                continue
            base = prom_name(hist.name, prefix)
            # full histogram family: cumulative _bucket{le=...} lines plus
            # _sum/_count — the shape SLO burn-rate math needs from a
            # scrape (rate() over bucket counters; a reservoir percentile
            # cannot be aggregated across scrapes).  TYPE is declared once
            # on the family name; the renderer groups the samples.
            types[base] = "histogram"
            if hist.help:
                help_[base] = hist.help
            hist_exemplars = hist.exemplars()
            for bound, cum in zip(hist.bucket_bounds,
                                  hist.bucket_cumulative()):
                sample = f'{base}_bucket{{le="{_prom_fmt(bound)}"}}'
                state[sample] = float(cum)
                if bound in hist_exemplars:
                    exemplars[sample] = hist_exemplars[bound]
            inf_sample = f'{base}_bucket{{le="+Inf"}}'
            state[inf_sample] = float(hist.count)
            if math.inf in hist_exemplars:
                exemplars[inf_sample] = hist_exemplars[math.inf]
            state[base + "_sum"] = hist.sum
            state[base + "_count"] = float(hist.count)
    return state, types, help_, exemplars


def _prom_fmt(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v) if v != int(v) else str(int(v))


_BUCKET_SAMPLE = re.compile(r'^(.+)_bucket\{le="([^"]+)"\}$')


def _family_key(name: str, types: Dict[str, str]):
    """Map a sample name to ``(family, intra-order, le)``: histogram
    samples (``_bucket{le=...}``/``_sum``/``_count`` under a declared
    ``histogram`` family) group under their base name with buckets in
    ascending ``le``; everything else is its own family."""
    m = _BUCKET_SAMPLE.match(name)
    if m and types.get(m.group(1)) == "histogram":
        le = m.group(2)
        return m.group(1), 0, math.inf if le == "+Inf" else float(le)
    for suffix, order in (("_sum", 1), ("_count", 2)):
        if name.endswith(suffix) and types.get(name[: -len(suffix)]) == "histogram":
            return name[: -len(suffix)], order, 0.0
    return name, 0, 0.0


def _prom_render(state: Dict[str, float], types: Dict[str, str],
                 help_: Dict[str, str],
                 exemplars: Optional[Dict[str, tuple]] = None,
                 openmetrics: bool = False,
                 timestamp: Optional[float] = None) -> str:
    keys = {name: _family_key(name, types) for name in state}
    lines = []
    declared = set()
    for name in sorted(state, key=lambda n: (keys[n][0], keys[n][1], keys[n][2])):
        family = keys[name][0]
        if family not in declared:
            declared.add(family)
            # OpenMetrics reserves the `_total` suffix for counter SAMPLE
            # names: the metric family is declared without it (a strict
            # parser rejects `# TYPE x_total counter` + sample `x_total`)
            declared_as = family
            if (openmetrics and types.get(family) == "counter"
                    and family.endswith("_total")):
                declared_as = family[: -len("_total")]
            if family in help_:
                lines.append(f"# HELP {declared_as} {help_[family]}")
            lines.append(f"# TYPE {declared_as} {types.get(family, 'gauge')}")
        line = f"{name} {_prom_fmt(state[name])}"
        if timestamp is not None:
            # OpenMetrics sample timestamp: unix seconds AFTER the value,
            # BEFORE any exemplar clause.  Never rendered into the classic
            # 0.0.4 text format here — a plain-text scraper already treats
            # a trailing number as a MILLISECOND timestamp, so emitting
            # seconds blind would silently skew every series by 1000x;
            # callers gate on the OpenMetrics negotiation (see
            # :func:`prometheus_lines`).
            line += f" {_prom_fmt(float(timestamp))}"
        if exemplars and name in exemplars:
            # OpenMetrics exemplar syntax: `<sample> # {labels} <value>` —
            # the per-bucket link from a latency histogram to the trace id
            # that landed there (resolved by the fleet observatory into the
            # stored stitched trace).  Ids that could splice the line
            # (quotes, braces, spaces — any client-supplied X-Request-Id
            # reaches here) are dropped, not escaped: a malformed scrape
            # costs every metric, a missing exemplar costs one link.
            ex_id, ex_val = exemplars[name]
            if _EXEMPLAR_ID_OK.fullmatch(str(ex_id)):
                line += (f' # {{trace_id="{ex_id}"}} '
                         f'{_prom_fmt(float(ex_val))}')
        lines.append(line)
    return "\n".join(lines) + "\n"


#: content types a /metrics endpoint serves: exemplars are ONLY legal in
#: OpenMetrics — a classic text-format (0.0.4) parser reads the exemplar
#: suffix as a malformed timestamp and discards the whole scrape, so the
#: endpoint must negotiate via the Accept header, never emit them blind
PROM_TEXT_CONTENT_TYPE = "text/plain; version=0.0.4"
OPENMETRICS_CONTENT_TYPE = "application/openmetrics-text; version=1.0.0"


def wants_openmetrics(accept_header) -> bool:
    """Did the scraper's ``Accept`` header opt into OpenMetrics (and with
    it, exemplars)?"""
    return bool(accept_header) and "application/openmetrics-text" in accept_header


def prometheus_lines(registry, prefix: str = "glom_",
                     exemplars: bool = False,
                     timestamps: bool = False,
                     now: Optional[float] = None) -> str:
    """Render the registry's CURRENT state in Prometheus exposition format
    (the live-scrape companion to :class:`PrometheusTextfileExporter` —
    same families, no file).  ``exemplars=True`` renders the OpenMetrics
    dialect: ``# {trace_id="..."}`` exemplars on histogram bucket lines
    and spec counter-family naming — pass it ONLY when the response is
    served as ``OPENMETRICS_CONTENT_TYPE`` with a trailing ``# EOF``
    (see :func:`wants_openmetrics`); the classic text format has no
    exemplar syntax and a 0.0.4 parser rejects the whole scrape on the
    first annotated line.  ``timestamps=True`` stamps every sample with
    unix seconds (``now`` overrides the wall clock for tests) so scraped
    series align with the internal TSDB windows
    (:mod:`glom_tpu.obs.timeseries`); it rides the same negotiation rule
    as exemplars — the classic format reads a trailing number as
    MILLISECONDS, so timestamps without ``exemplars=True`` (i.e. outside
    an OpenMetrics-negotiated body) are a :class:`ValueError`, not a
    silently-skewed scrape."""
    if timestamps and not exemplars:
        raise ValueError(
            "timestamps=True requires exemplars=True (OpenMetrics bodies "
            "only — the classic 0.0.4 format parses a trailing number as "
            "milliseconds and would skew every series 1000x)")
    state, types, help_, ex = registry_families(registry, prefix)
    ts = None
    if timestamps:
        import time
        ts = time.time() if now is None else float(now)
    return _prom_render(state, types, help_, ex if exemplars else None,
                        openmetrics=exemplars, timestamp=ts)


def regroup_families(text: str) -> str:
    """Regroup a concatenated exposition text (several sources' families,
    possibly interleaved — the router's aggregate) so every family's
    metadata and samples are contiguous, which OpenMetrics requires and a
    strict parser enforces.  HELP/TYPE lines register their family;
    sample lines join their family by name (histogram ``_bucket``/
    ``_sum``/``_count`` suffixes fold onto the declared base; an
    OpenMetrics-stripped counter TYPE group sits directly before its
    ``_total`` sample group by first-seen adjacency).  Non-metadata
    comments are dropped — OpenMetrics has no free-form comments."""
    types: Dict[str, str] = {}
    order: list = []
    meta: Dict[str, list] = {}
    samples: Dict[str, list] = {}

    def group(key):
        if key not in meta:
            order.append(key)
            meta[key] = []
            samples[key] = []
        return key

    for line in text.splitlines():
        if not line.strip() or line.strip() == "# EOF":
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE", "UNIT"):
                fam = parts[2]
                if parts[1] == "TYPE" and len(parts) >= 4:
                    types[fam] = parts[3].strip()
                if line not in meta.get(fam, ()):  # dedupe across sources
                    meta[group(fam)].append(line)
            continue  # free-form comment: invalid in OpenMetrics, drop
        m = _SAMPLE_RE_EXPORT.match(line)
        if not m:
            continue
        name = m.group(1)
        fam = name
        base = None
        if name.endswith("_bucket"):
            base = name[: -len("_bucket")]
        else:
            for suffix in ("_sum", "_count"):
                if name.endswith(suffix):
                    base = name[: -len(suffix)]
        if base is not None and types.get(base) == "histogram":
            fam = base
        elif name.endswith("_total") and name[: -len("_total")] in types:
            # counter declared under the OpenMetrics-stripped family name
            fam = name[: -len("_total")]
        samples[group(fam)].append(line)

    out = []
    for fam in order:
        out.extend(meta[fam])
        out.extend(samples[fam])
    return "\n".join(out) + "\n"


# one exposition sample line: name[{labels}] value [rest] (shared with
# the router's relabeler, which keeps its own copy to stay import-light)
_SAMPLE_RE_EXPORT = re.compile(
    r"^([A-Za-z_:][A-Za-z0-9_:]*)(\{[^}]*\})?( .+)$")


class PrometheusTextfileExporter:
    """Textfile-collector output: the current value of every numeric
    metric, one family per line group, written atomically on each emit.

    Numeric record keys become gauges; the string ``event`` key becomes
    per-event counters (``glom_events_total{event="..."}`` can't be
    expressed without labels in the flat form, so we emit
    ``glom_event_<name>_total``).  A registry snapshot, when given,
    contributes its metrics with their declared types."""

    wants_registry = True  # MetricLogger passes its registry snapshot along

    def __init__(self, path: str, prefix: str = "glom_"):
        self.path = path
        self.prefix = prefix
        self._state: Dict[str, float] = {}
        self._types: Dict[str, str] = {}
        self._help: Dict[str, str] = {}
        self._event_counts: Dict[str, int] = {}

    def emit(self, record: Dict, registry=None) -> None:
        for k, v in record.items():
            if k == "event" and isinstance(v, str):
                self._event_counts[v] = self._event_counts.get(v, 0) + 1  # glomlint: disable=obs-unbounded-series -- keyed by the code-defined event vocabulary (EVENT_* constants), not by request input
                continue
            if isinstance(v, str):
                continue  # free-form strings have no textfile representation
            name = prom_name(k, self.prefix)
            self._state[name] = float(v)  # glomlint: disable=obs-unbounded-series -- last-value store keyed by metric name; cardinality is the registry's bound, not per-sample growth
            self._types.setdefault(name, "gauge")
        if registry is not None:
            # exemplars deliberately dropped: the textfile collector is
            # parsed as PLAIN Prometheus text, where an exemplar suffix is
            # a syntax error — the live /metrics endpoint carries them
            state, types, help_, _exemplars = registry_families(
                registry, self.prefix)
            self._state.update(state)
            self._types.update(types)
            self._help.update(help_)
        for ev, n in self._event_counts.items():
            name = prom_name(f"event_{ev}_total", self.prefix)
            self._state[name] = float(n)  # glomlint: disable=obs-unbounded-series -- same last-value store: one slot per event name, overwritten per emit
            self._types[name] = "counter"  # glomlint: disable=obs-unbounded-series -- parallel type table, same key set as _state
        self._write()

    def _write(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(_prom_render(self._state, self._types, self._help))
        os.replace(tmp, self.path)

    def close(self) -> None:
        pass
