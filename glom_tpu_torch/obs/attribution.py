"""Regression attribution: ranked causal verdicts from evidence planes.

The port's copy of ``glom_tpu/obs/attribution.py`` (stdlib only), the same
code, so one evidence dict gives both packages the same verdict, byte for
byte (:func:`canonical_json`).  The op-diff plane compares per-bucket
snapshots: on a port engine they are the graph caches' capture records
(``serving/compile_cache.py``), which carry ``glom_tpu``'s ``quant`` label
and an analytic ``cost_analysis`` (flops and bytes at the bucket), so a
quant change, a bucket-ladder change or a change of the flops or bytes
diffs as it does on ``glom_tpu``'s compile snapshots.  They carry no
``hlo``, so the fusion count never moves.

Every detector in the stack (SLO burn, bench gate, capacity pressure,
quality drift) ends at "something moved"; a human then diffs series,
timelines, and compile snapshots by hand.  This module automates that
join.  Given one *evidence* dict it produces one *verdict* dict:

evidence::

    {"window":    {"start": t0, "end": t1, "knee": tk?},   # knee optional
     "series":    {series_key: [[t, v], ...], ...},        # TSDB-lite dump
     "timeline":  [event dicts / TimelineEvent],           # any sources
     "snapshots": {"before": {bucket: snap}, "after": {bucket: snap}}?}

verdict (canonical order; see :func:`canonical_json`)::

    {"schema": "glom-attribution/v1",
     "window": {...}, "knee": {...} | None,
     "regression": {"metric", "before_ms", "after_ms", "delta_ms", ...},
     "phases": [{"phase", "bucket"?, "before_ms", "after_ms",
                 "delta_ms", "share"}...],      # share of explained delta
     "explained": {"fraction", "unexplained_ms"},
     "events": [{"event", "t", "seq", "score", "plane", ...}...],
     "op_diff": {...} | None,
     "causes": [{"kind", "confidence", "summary", ...}...],
     "verdict": "<top cause summary>" | "inconclusive",
     "confidence": float}

Three evidence planes feed ``causes``:

* **phase decomposition** — windowed per-request means from the
  ``serving_<phase>_ms_{sum,count}`` counter series (plus per-bucket
  ``serving_execute_ms_b<k>``), before vs after the knee; each phase's
  share of the summed positive deltas, with the unexplained remainder
  reported honestly (a canary's own in-request stall has no sub-span).
* **event correlation** — deploy / bulk / fleet / advisor events from
  the unified :class:`~glom_tpu_torch.obs.events.TimelineEvent` feed, scored
  by temporal alignment with the knee (events after the knee cannot
  have caused it; sampling granularity earns a small slack).
* **op-level diffing** — per-bucket compile-snapshot deltas (quant tier,
  bucket ladder, flops/bytes from the cost model, fusion count).

Honesty contract: when no candidate clears the confidence bar — no
knee, delta under the noise floor, or no aligned event/op delta — the
verdict is the literal string ``"inconclusive"`` with an empty cause
list.  A fabricated suspect is worse than no suspect.

Pure stdlib, no clock reads: ``attribute(evidence)`` is deterministic —
byte-identical canonical JSON for byte-identical evidence, independent
of dict/list ordering in the input (everything is sorted internally).
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from .events import (ADVISORY_EVENTS, BULK_EVENTS, DEPLOY_EVENTS,
                     FLEET_EVENTS, TimelineEvent, merge_events)
from .timeseries import trend_flip

SCHEMA = "glom-attribution/v1"

#: request-phase ladder: (phase name, series base). Order is the wire
#: order of the request path; ``h2d`` is accounted inside pad/execute
#: (device put happens under the pad span on this engine).
PHASE_BASES: Tuple[Tuple[str, str], ...] = (
    ("parse", "serving_parse_ms"),
    ("queue_wait", "serving_queue_wait_ms"),
    ("batch_assembly", "serving_batch_assembly_ms"),
    ("pad", "serving_pad_ms"),
    ("execute", "serving_execute_ms"),
    ("respond", "serving_respond_ms"),
)
TOTAL_BASE = "serving_request_ms"
_BUCKET_RE = re.compile(r"^serving_execute_ms_b(\d+)_sum$")
_PHASE_SCALAR_RE = re.compile(
    r"^serving_(request|parse|queue_wait|batch_assembly|pad|execute"
    r"|respond)_ms(_b\d+)?_(sum|count)$")


def is_phase_scalar(name: str) -> bool:
    """True for the flattened registry scalars the phase decomposition
    consumes (phase-histogram ``_sum``/``_count`` pairs, per-bucket
    execute included) — the filter remote collectors (the fleet
    observatory) use to decide which serving scalars to fold into their
    series store as attribution evidence."""
    return _PHASE_SCALAR_RE.match(name) is not None

#: deltas below BOTH floors are noise, not a regression
NOISE_FLOOR_MS = 2.0
NOISE_FLOOR_REL = 0.10
#: minimum top-cause confidence for a named verdict
MIN_CONFIDENCE = 0.5

_EVENT_PLANES = (
    ("deploy", DEPLOY_EVENTS, 1.0),
    ("bulk", BULK_EVENTS, 0.6),
    ("fleet", FLEET_EVENTS, 0.8),
    ("advisory", ADVISORY_EVENTS, 0.25),
)


def _r(v: Optional[float], nd: int = 4) -> Optional[float]:
    if v is None:
        return None
    return round(float(v), nd)


def _points_in(points: Iterable[Sequence[float]], t0: float,
               t1: float) -> List[Tuple[float, float]]:
    pts = [(float(p[0]), float(p[1])) for p in points or ()
           if p[1] is not None and t0 <= float(p[0]) <= t1]
    pts.sort(key=lambda p: p[0])
    return pts


def _counter_delta(pts: List[Tuple[float, float]]) -> Optional[float]:
    if len(pts) < 2:
        return None
    d = pts[-1][1] - pts[0][1]
    return d if d >= 0 else None  # counter reset: refuse, don't invent


def _window_mean_ms(series: Dict[str, Any], base: str, t0: float,
                    t1: float) -> Optional[float]:
    """Per-request mean of a duration histogram over [t0, t1], from the
    windowed deltas of its exported ``_sum``/``_count`` counters."""
    ds = _counter_delta(_points_in(series.get(base + "_sum", ()), t0, t1))
    dc = _counter_delta(_points_in(series.get(base + "_count", ()), t0, t1))
    if ds is None or dc is None or dc <= 0:
        return None
    return ds / dc


def latency_series(series: Dict[str, Any],
                   base: str = TOTAL_BASE) -> List[Tuple[float, float]]:
    """Derive a mean-latency-per-sample series from the exported
    ``_sum``/``_count`` counters via pairwise deltas — the series the
    knee detector runs on."""
    sums = _points_in(series.get(base + "_sum", ()), float("-inf"),
                      float("inf"))
    counts = {t: v for t, v in _points_in(series.get(base + "_count", ()),
                                          float("-inf"), float("inf"))}
    out: List[Tuple[float, float]] = []
    prev: Optional[Tuple[float, float, float]] = None  # (t, sum, count)
    for t, s in sums:
        c = counts.get(t)
        if c is None:
            continue
        if prev is not None:
            dc = c - prev[2]
            ds = s - prev[1]
            if dc > 0 and ds >= 0:
                out.append((t, ds / dc))
        prev = (t, s, c)
    return out


def _cadence(points: List[Tuple[float, float]]) -> float:
    """Median sample spacing of a series — the temporal resolution below
    which event-to-knee distances are quantization, not signal."""
    if len(points) < 2:
        return 0.0
    gaps = sorted(points[i][0] - points[i - 1][0]
                  for i in range(1, len(points)))
    return gaps[len(gaps) // 2]


def find_knee(points: List[Tuple[float, float]], *,
              min_slope: float = 0.0) -> Optional[Dict[str, float]]:
    """Locate the regression knee in a latency/throughput series.

    Primary detector is the largest single step, when it dominates the
    series' typical move — deploy- and config-shaped regressions flip a
    switch, so mean latency jumps rather than ramps, and on such a
    series :func:`~glom_tpu_torch.obs.timeseries.trend_flip` maximizes slope
    CHANGE (which peaks at a split strictly before the jump).  Gradual
    drifts have no dominant step, and there trend_flip's sign-change
    split is the right answer, so it is the fallback."""
    pts = [(float(t), float(v)) for t, v in points or ()]
    pts.sort(key=lambda p: p[0])
    if len(pts) >= 3:
        diffs = [abs(pts[i][1] - pts[i - 1][1]) for i in range(1, len(pts))]
        ranked = sorted(diffs)
        typical = ranked[len(ranked) // 2]
        best_i = max(range(1, len(pts)),
                     key=lambda i: (abs(pts[i][1] - pts[i - 1][1]), -i))
        best = abs(pts[best_i][1] - pts[best_i - 1][1])
        if best >= NOISE_FLOOR_MS and best >= 4.0 * max(typical, 1e-9):
            return {"t": _r(pts[best_i][0], 6), "kind": "step",
                    "step": _r(pts[best_i][1] - pts[best_i - 1][1])}
    flip = trend_flip(pts, min_slope=min_slope)
    if flip is not None:
        return {"t": _r(flip["t"], 6), "kind": "trend_flip",
                "slope_before": _r(flip["slope_before"]),
                "slope_after": _r(flip["slope_after"])}
    return None


def phase_deltas(series: Dict[str, Any], t0: float, tk: float,
                 t1: float) -> List[Dict[str, Any]]:
    """Decompose the before/after latency delta into request phases
    (and per-bucket execute).  Shared with ``forensics_report
    --compare``.  ``share`` is each phase's fraction of the summed
    POSITIVE phase deltas — phases that improved get share 0.0."""
    rows: List[Dict[str, Any]] = []
    bases = list(PHASE_BASES)
    for key in sorted(series):
        m = _BUCKET_RE.match(key)
        if m:
            bases.append((f"execute_b{m.group(1)}",
                          key[:-len("_sum")]))
    for phase, base in bases:
        before = _window_mean_ms(series, base, t0, tk)
        after = _window_mean_ms(series, base, tk, t1)
        if before is None and after is None:
            continue
        delta = None
        if before is not None and after is not None:
            delta = after - before
        row = {"phase": phase, "before_ms": _r(before),
               "after_ms": _r(after), "delta_ms": _r(delta)}
        m = re.match(r"^execute_b(\d+)$", phase)
        if m:
            row["bucket"] = int(m.group(1))
        rows.append(row)
    return _share_and_sort(rows)


def _share_and_sort(rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    # per-bucket execute rows refine the aggregate execute row; exclude
    # them from the share denominator so execute isn't counted twice
    total_pos = sum(r["delta_ms"] for r in rows
                    if r["delta_ms"] is not None and r["delta_ms"] > 0
                    and "bucket" not in r)
    for r in rows:
        if r["delta_ms"] is None or total_pos <= 0:
            r["share"] = None if r["delta_ms"] is None else 0.0
        else:
            r["share"] = _r(max(r["delta_ms"], 0.0) / total_pos)
    rows.sort(key=lambda r: (-(r["delta_ms"] or float("-inf")),
                             r["phase"]))
    return rows


def snapshot_phase_deltas(before_reg: Dict[str, Any],
                          after_reg: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Phase decomposition between two registry SNAPSHOTS (each forensics
    bundle carries one) — the ``forensics_report --compare`` cross-link.

    ``before_ms`` is the first snapshot's lifetime mean; ``after_ms`` is
    the mean over only the requests that landed BETWEEN the snapshots
    (windowed counter deltas — the same math :func:`phase_deltas` runs
    on a live series, with the snapshots as the window edges).  Rows,
    shares, and ordering match :func:`phase_deltas` exactly."""
    rows: List[Dict[str, Any]] = []
    bases = list(PHASE_BASES)
    for key in sorted(set(before_reg) | set(after_reg)):
        m = _BUCKET_RE.match(key)
        if m:
            bases.append((f"execute_b{m.group(1)}", key[:-len("_sum")]))

    def mean(reg, base):
        s, c = reg.get(base + "_sum"), reg.get(base + "_count")
        if isinstance(s, (int, float)) and isinstance(c, (int, float)) \
                and c > 0:
            return float(s), float(c), float(s) / float(c)
        return None, None, None

    for phase, base in bases:
        sb, cb, before = mean(before_reg, base)
        sa, ca, _ = mean(after_reg, base)
        after = None
        if sb is not None and sa is not None and ca > cb \
                and sa - sb >= 0:  # counter reset between bundles: refuse
            after = (sa - sb) / (ca - cb)
        if before is None and after is None:
            continue
        delta = after - before if before is not None \
            and after is not None else None
        row = {"phase": phase, "before_ms": _r(before),
               "after_ms": _r(after), "delta_ms": _r(delta)}
        m = re.match(r"^execute_b(\d+)$", phase)
        if m:
            row["bucket"] = int(m.group(1))
        rows.append(row)
    return _share_and_sort(rows)


def score_events(timeline: Iterable[Any], t0: float, tk: float,
                 t1: float, *, slack_s: float = 1.5,
                 resolution_s: float = 0.0) -> List[Dict[str, Any]]:
    """Score timeline events by temporal alignment with the knee.

    Causality filter: an event strictly after ``tk + slack`` cannot
    have caused the knee (the slack covers series sampling granularity).
    Alignment decays exponentially with distance from the knee; each
    plane carries a prior weight (a deploy transition is a stronger
    suspect than an advisory recommendation).  ``resolution_s`` is the
    latency series' sampling cadence: the knee's location quantizes to
    a sample boundary, so distances inside one cadence are
    indistinguishable from perfect alignment (subtracted before the
    decay) and the decay scale itself never drops below a few cadences
    — without this, short windows over coarse series tiers would read
    a one-sample quantization offset as a weak correlation."""
    span = max(t1 - t0, 1e-9)
    tau = max(1.0, 0.15 * span, 3.0 * resolution_s)
    slack = max(slack_s, resolution_s)
    out: List[Dict[str, Any]] = []
    for ev in merge_events(list(timeline or ())):
        if not (t0 <= ev.t <= t1) or ev.t > tk + slack:
            continue
        plane, weight = "other", 0.1
        for name, kinds, w in _EVENT_PLANES:
            if ev.event in kinds:
                plane, weight = name, w
                break
        dist = max(0.0, abs(ev.t - tk) - resolution_s)
        score = weight * pow(2.718281828459045, -dist / tau)
        rec = {"event": ev.event, "t": _r(ev.t, 6), "seq": ev.seq,
               "plane": plane, "score": _r(score), "dt_knee": _r(ev.t - tk)}
        for k in ("step", "version", "model", "name", "action", "reason",
                  "replica", "fraction", "endpoint"):
            if k in ev.fields:
                rec[k] = ev.fields[k]
        out.append(rec)
    out.sort(key=lambda r: (-r["score"], r["t"], r["seq"]))
    return out


def diff_snapshots(before: Optional[Dict[str, Any]],
                   after: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Op-level diff of per-bucket compile snapshots (quant tier change,
    bucket-ladder change, cost-model flops/bytes deltas, fusion count).
    Returns None when there is nothing to compare or nothing moved."""
    if not before or not after:
        return None

    def norm(snaps):
        out = {}
        for k, v in snaps.items():
            try:
                out[int(k)] = v or {}
            except (TypeError, ValueError):
                continue
        return out

    b, a = norm(before), norm(after)
    if not b or not a:
        return None
    diff: Dict[str, Any] = {}
    added = sorted(set(a) - set(b))
    removed = sorted(set(b) - set(a))
    if added or removed:
        diff["bucket_ladder"] = {"added": added, "removed": removed}
    buckets: List[Dict[str, Any]] = []
    for bucket in sorted(set(a) & set(b)):
        row: Dict[str, Any] = {"bucket": bucket}
        qb, qa = b[bucket].get("quant"), a[bucket].get("quant")
        if qb != qa and (qb is not None or qa is not None):
            row["quant"] = {"before": qb, "after": qa}
        cb = b[bucket].get("cost_analysis") or {}
        ca = a[bucket].get("cost_analysis") or {}
        for key in ("flops", "bytes accessed"):
            vb, va = cb.get(key), ca.get(key)
            if isinstance(vb, (int, float)) and isinstance(va, (int, float)) \
                    and va != vb:
                row[key.replace(" ", "_")] = {
                    "before": _r(vb), "after": _r(va),
                    "ratio": _r(va / vb) if vb else None}
        hb, ha = b[bucket].get("hlo") or "", a[bucket].get("hlo") or ""
        if hb and ha:
            fb, fa = hb.count("fusion"), ha.count("fusion")
            if fb != fa:
                row["fusions"] = {"before": fb, "after": fa}
        if len(row) > 1:
            buckets.append(row)
    if buckets:
        diff["buckets"] = buckets
    return diff or None


def _build_causes(knee, phases, events, op_diff, regression):
    causes: List[Dict[str, Any]] = []
    top_phase = next((p for p in phases
                      if p.get("share") and "bucket" not in p), None)
    phase_strength = (top_phase["share"] or 0.0) if top_phase else 0.0
    if events:
        top, runner = events[0], (events[1] if len(events) > 1 else None)
        margin = 1.0 if runner is None else \
            max(0.0, 1.0 - runner["score"] / max(top["score"], 1e-9))
        conf = top["score"] * (0.5 + 0.5 * margin)
        if top_phase is not None:
            conf = min(1.0, conf * (0.75 + 0.5 * phase_strength))
        summary = f"{top['plane']} event '{top['event']}'"
        if "step" in top:
            summary += f" (step {top['step']})"
        if top_phase is not None:
            summary += (f" shifting {top_phase['phase']} "
                        f"(+{top_phase['delta_ms']}ms, "
                        f"share {top_phase['share']})")
        causes.append({"kind": f"event:{top['plane']}",
                       "confidence": _r(min(conf, 1.0)),
                       "summary": summary, "event": top})
    if op_diff:
        bucket_rows = op_diff.get("buckets") or []
        bits = []
        for row in bucket_rows:
            if "quant" in row:
                bits.append(f"b{row['bucket']} quant "
                            f"{row['quant']['before']}→{row['quant']['after']}")
            if "fusions" in row:
                bits.append(f"b{row['bucket']} fusions "
                            f"{row['fusions']['before']}→"
                            f"{row['fusions']['after']}")
            if "flops" in row:
                bits.append(f"b{row['bucket']} flops ×"
                            f"{row['flops']['ratio']}")
        if "bucket_ladder" in op_diff:
            bits.append(f"bucket ladder {op_diff['bucket_ladder']}")
        conf = 0.7 if bits else 0.3
        causes.append({"kind": "op_diff", "confidence": _r(conf),
                       "summary": "compiled program changed: " +
                                  ("; ".join(bits) if bits else "cost delta"),
                       "op_diff": op_diff})
    if not causes and top_phase is not None and knee is not None \
            and phase_strength >= 0.5:
        # a phase moved decisively but no event/op evidence names an
        # actor — report the phase as a weak, honest lead
        causes.append({"kind": "phase_shift",
                       "confidence": _r(0.3 * phase_strength),
                       "summary": f"{top_phase['phase']} grew "
                                  f"+{top_phase['delta_ms']}ms "
                                  f"(share {top_phase['share']}) with no "
                                  f"correlated event",
                       "phase": top_phase})
    causes.sort(key=lambda c: (-(c["confidence"] or 0.0), c["kind"]))
    return causes


def attribute(evidence: Dict[str, Any], *,
              min_confidence: float = MIN_CONFIDENCE) -> Dict[str, Any]:
    """Produce the ranked causal verdict for one regression window."""
    series = dict(evidence.get("series") or {})
    window = dict(evidence.get("window") or {})
    timeline = evidence.get("timeline") or ()
    snapshots = evidence.get("snapshots") or {}

    lat = latency_series(series)
    if "start" in window and "end" in window:
        t0, t1 = float(window["start"]), float(window["end"])
    elif lat:
        t0, t1 = lat[0][0], lat[-1][0]
    else:
        t0 = t1 = 0.0
    lat = [(t, v) for t, v in lat if t0 <= t <= t1]

    knee = None
    if window.get("knee") is not None:
        knee = {"t": _r(float(window["knee"]), 6), "kind": "given"}
    else:
        knee = find_knee(lat)
    reasons: List[str] = []

    regression: Dict[str, Any] = {"metric": "request_mean_ms"}
    phases: List[Dict[str, Any]] = []
    events: List[Dict[str, Any]] = []
    explained = {"fraction": None, "unexplained_ms": None}
    if knee is None:
        reasons.append("no knee: latency series shows no trend flip "
                       "or dominant step inside the window")
    else:
        tk = float(knee["t"])
        before = _window_mean_ms(series, TOTAL_BASE, t0, tk)
        after = _window_mean_ms(series, TOTAL_BASE, tk, t1)
        delta = (after - before) if (before is not None and
                                     after is not None) else None
        regression.update({"before_ms": _r(before), "after_ms": _r(after),
                           "delta_ms": _r(delta)})
        if delta is not None and (abs(delta) < NOISE_FLOOR_MS or
                                  (before and abs(delta) <
                                   NOISE_FLOOR_REL * before)):
            reasons.append(f"delta {_r(delta)}ms is under the noise floor")
            knee = dict(knee, noise=True)
        phases = phase_deltas(series, t0, tk, t1)
        events = score_events(timeline, t0, tk, t1,
                              resolution_s=_cadence(lat))
        explained_ms = sum(p["delta_ms"] for p in phases
                           if p["delta_ms"] is not None and
                           p["delta_ms"] > 0 and "bucket" not in p)
        if delta is not None and delta > 0:
            explained = {"fraction": _r(min(explained_ms / delta, 1.0)),
                         "unexplained_ms": _r(max(delta - explained_ms,
                                                  0.0))}

    op_diff = diff_snapshots(snapshots.get("before"), snapshots.get("after"))
    causes = [] if (knee is None or knee.get("noise")) else \
        _build_causes(knee, phases, events, op_diff, regression)
    causes = [c for c in causes if (c["confidence"] or 0.0) > 0.0]

    if causes and causes[0]["confidence"] >= min_confidence:
        verdict_str = causes[0]["summary"]
        confidence = causes[0]["confidence"]
    else:
        if causes:
            reasons.append(
                f"top cause confidence {causes[0]['confidence']} below "
                f"bar {min_confidence}")
        elif knee is not None and not knee.get("noise"):
            reasons.append("no correlated event, op delta, or dominant "
                           "phase shift inside the window")
        verdict_str = "inconclusive"
        confidence = _r(causes[0]["confidence"]) if causes else 0.0
        causes = []

    return {
        "schema": SCHEMA,
        "window": {"start": _r(t0, 6), "end": _r(t1, 6)},
        "knee": knee,
        "regression": regression,
        "phases": phases,
        "explained": explained,
        "events": events[:8],
        "op_diff": op_diff,
        "causes": causes,
        "verdict": verdict_str,
        "confidence": confidence,
        "reasons": sorted(set(reasons)),
    }


def canonical_json(verdict: Dict[str, Any]) -> str:
    """The byte-stable encoding the golden tests and forensics bundles
    use: sorted keys, minimal separators, no NaN."""
    return json.dumps(verdict, sort_keys=True, separators=(",", ":"),
                      allow_nan=False)


def render_text(verdict: Dict[str, Any]) -> str:
    """Human-facing rendering for the whyslow CLI and bench_gate."""
    lines = [f"verdict: {verdict['verdict']} "
             f"(confidence {verdict['confidence']})"]
    knee = verdict.get("knee")
    reg = verdict.get("regression") or {}
    if knee:
        lines.append(f"  knee at t={knee['t']} ({knee['kind']})")
    if reg.get("delta_ms") is not None:
        lines.append(f"  request mean {reg['before_ms']}ms -> "
                     f"{reg['after_ms']}ms (delta {reg['delta_ms']}ms)")
    for p in (verdict.get("phases") or [])[:6]:
        if p.get("delta_ms") is None:
            continue
        lines.append(f"  phase {p['phase']:<14} {p['before_ms']}ms -> "
                     f"{p['after_ms']}ms  share={p['share']}")
    for c in verdict.get("causes") or []:
        lines.append(f"  cause [{c['kind']}] conf={c['confidence']}: "
                     f"{c['summary']}")
    for r in verdict.get("reasons") or []:
        lines.append(f"  note: {r}")
    return "\n".join(lines)


def collect_engine_evidence(engine, *, since_s: Optional[float] = None,
                            window: Optional[Dict[str, float]] = None
                            ) -> Dict[str, Any]:
    """Build an evidence dict from a live in-process engine: TSDB-lite
    series from the capacity plane's store, the unified engine timeline,
    and — when a deploy candidate is in flight — compile snapshots of
    primary vs candidate for the op-diff plane."""
    store = getattr(getattr(engine, "capacity", None), "store", None)
    series: Dict[str, Any] = {}
    if store is not None:
        for name in store.names():
            if not (name.startswith("serving_") or
                    name.startswith("capacity_")):
                continue
            for key, pts in store.query(name).items():
                series[key] = [[t, v] for t, v in pts]
    timeline = list(getattr(engine, "timeline").events()) \
        if getattr(engine, "timeline", None) is not None else []
    snapshots = None
    deploy = getattr(engine, "deploy", None)
    cand_step = getattr(deploy, "candidate_step", None) if deploy else None
    if cand_step is not None:
        try:
            before = {b: dict(s) for b, s in
                      _endpoint_snapshots(engine.caches).items()}
            cand_version = engine.models.get("default", cand_step) \
                if getattr(engine, "models", None) else None
            # a port version's caches are a ServingSet: its graph caches
            # are the set's own caches dict
            after = {b: dict(s) for b, s in _endpoint_snapshots(
                cand_version.caches.caches).items()} if cand_version else None
            if before and after:
                snapshots = {"before": before, "after": after}
        except Exception:  # glomlint: disable=conc-broad-except -- snapshots are best-effort evidence; a half-registered candidate must not block phase/event attribution
            snapshots = None
    evidence: Dict[str, Any] = {"series": series, "timeline": timeline}
    if snapshots:
        evidence["snapshots"] = snapshots
    if window:
        evidence["window"] = dict(window)
    elif since_s is not None and store is not None:
        now = store.now()
        evidence["window"] = {"start": now - since_s, "end": now}
    return evidence


def _endpoint_snapshots(caches) -> Dict[int, Dict[str, Any]]:
    """Flatten {endpoint: graph cache} to {bucket: snapshot}, preferring
    the default transform endpoint when buckets collide."""
    out: Dict[int, Dict[str, Any]] = {}
    for name in sorted(caches or {}):
        cache = caches[name]
        snaps = getattr(cache, "snapshots", None) or {}
        for bucket, snap in snaps.items():
            out.setdefault(int(bucket), snap)
    return out
