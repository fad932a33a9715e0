"""Summarize a serving trace feed: the port's copy of ``tools/trace_report.py``.

  python -m glom_tpu_torch.tools.trace_report traces.jsonl [--format json]
  python -m glom_tpu_torch.tools.trace_report traces.jsonl --slowest 10
  python -m glom_tpu_torch.tools.trace_report traces.jsonl --trace <request-id>
  python -m glom_tpu_torch.tools.trace_report traces.jsonl --suggest-buckets [--ladder-size 4]
  python -m glom_tpu_torch.tools.trace_report router.jsonl replica0.jsonl replica1.jsonl

Reads the per-trace JSONL the serving engine emits (``--trace-log``: one
JSON object per COMPLETED trace — ``trace_id``, root span name, duration,
and the span list) and prints:

  * per-span-kind p50 / p95 ms and share of request wall time — the
    critical-path breakdown ("where do slow requests spend their time:
    queue, padding, device?");
  * the slowest-N request traces with per-span breakdown and coverage
    (fraction of the root span explained by child spans — low coverage
    means the instrumentation is missing a stage);
  * per-bucket padding-waste table from ``execute`` span annotations
    (which captured batch shapes burn compute on zeros);
  * ``--trace <id>`` — one trace's spans, indented by parentage (the
    lookup target for the load generator's ``--slow-n`` output);
  * ``--suggest-buckets`` — a bucket ladder fitted to the MEASURED
    per-batch size distribution (exact DP minimizing padded image-slots),
    printed as JSON the server takes verbatim through ``--buckets-file`` —
    close the loop: measure waste, re-ladder, serve.

Several feeds (a router's ``--trace-log`` and its replicas' ``GET
/debug/traces?since=0`` rings, one JSON record per line) are JOINED: records
sharing a trace id become one cross-process trace, clock-aligned over the
router hop by the fleet observatory's ``stitch``
(:mod:`glom_tpu_torch.obs.observatory`), and the padding-waste dedupe is
per file (two replicas' clocks are independent).  One feed reads as before.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys


def _percentile(xs, q):
    """Nearest-rank percentile (the obs registry's rule)."""
    if not xs:
        return None
    ordered = sorted(xs)
    rank = min(len(ordered) - 1, max(0, math.ceil(q / 100.0 * len(ordered)) - 1))
    return ordered[rank]


def read_traces(path, source=None):
    """One dict per line; truncated/garbage lines are skipped (a killed
    server must not make its own evidence unreadable).  With ``source``
    set (several feeds), every record and span is tagged so the join and
    the per-batch dedupe know which process emitted what."""
    traces = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and rec.get("spans"):
                if source is not None:
                    rec["_src"] = source
                    for s in rec["spans"]:
                        s.setdefault("source", source)
                traces.append(rec)
    return traces


def read_many(paths):
    """Read several trace logs (router + N replicas) and JOIN records
    sharing a trace id into single cross-process traces, clock-aligned
    over the router hop by the fleet observatory's stitcher.  Single-file
    groups pass through untouched, so a one-log run reads as
    :func:`read_traces`."""
    labels = []
    for path in paths:
        base = os.path.basename(path)
        label = base
        k = 2
        while label in labels:
            label = f"{base}#{k}"
            k += 1
        labels.append(label)
    if len(paths) == 1:
        return read_traces(paths[0])
    from glom_tpu_torch.obs.observatory import stitch

    groups = {}
    order = []
    for path, label in zip(paths, labels):
        for rec in read_traces(path, source=label):
            tid = rec.get("trace_id")
            if tid not in groups:
                order.append(tid)
            groups.setdefault(tid, []).append(rec)
    out = []
    for tid in order:
        recs = groups[tid]
        if len(recs) == 1:
            out.append(recs[0])
            continue
        merged = stitch([(r["_src"], r) for r in recs])
        if merged is not None:
            out.append(merged)
    return out


def find_root(spans):
    """The trace's local root: the ``root_span``-flagged span, else a
    parentless span, else one whose parent is not in the trace (a root
    joined from a remote traceparent)."""
    ids = {s.get("span_id") for s in spans}
    for pred in (lambda s: s.get("root_span"),
                 lambda s: s.get("parent_id") is None,
                 lambda s: s.get("parent_id") not in ids):
        root = next((s for s in spans if pred(s)), None)
        if root is not None:
            return root
    return None


def coverage(spans):
    """Union of child-span intervals over the root span's wall time
    (mirrors glom_tpu_torch.obs.tracing.span_coverage, inlined: the tool
    imports nothing of the package)."""
    root = find_root(spans)
    if root is None or root.get("end") is None:
        return None
    t0, t1 = root["start"], root["end"]
    if t1 <= t0:
        return 1.0
    ivs = sorted(
        (max(s["start"], t0), min(s["end"], t1))
        for s in spans
        if s is not root and s.get("end") is not None
        and s["end"] > t0 and s["start"] < t1
    )
    covered, cur_a, cur_b = 0.0, None, None
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


# synthetic overlap span: dispatch_wait covers the handler's whole parked
# interval ON TOP of the pipeline spans (queue_wait/pad/execute) — it
# exists so union-based COVERAGE has no scheduling gaps, but summing it
# into a share-of-wall table would double-count the pipeline and always
# "win" the breakdown
_OVERLAP_SPANS = {"dispatch_wait"}
# container spans in a STITCHED trace: the router's proxy wraps the whole
# downstream hop and the engine's request wraps its pipeline — when their
# children are present in the same (joined) trace, the children carry the
# attribution; in a single-process feed they have no children here and
# keep reporting themselves
_CONTAINER_SPANS = {"proxy", "request"}


def _execute_label(span):
    """Split execute rows warm vs cold so the stateful session path's
    savings are visible in the breakdown: a warm (state-carrying) execute
    reports as ``execute_warm``, a session cold settle as
    ``execute_cold``; everything else — stateless executes and feeds
    recorded before the attrs existed — stays ``execute`` (golden feeds
    are byte-compatible)."""
    if span["name"] != "execute":
        return span["name"]
    attrs = span.get("attrs") or {}
    if attrs.get("stateful") is True:
        return "execute_warm"
    if attrs.get("endpoint") == "session_cold":
        return "execute_cold"
    return "execute"


def _breakdown(spans):
    """Per-span-name total ms within one trace (mirrored batch spans
    appear once per trace by construction; overlap spans excluded,
    containers excluded exactly when their children are in the trace)."""
    root = find_root(spans)
    parent_ids = {s.get("parent_id") for s in spans}
    out = {}
    for s in spans:
        if (s is root or s.get("duration_ms") is None
                or s["name"] in _OVERLAP_SPANS):
            continue
        if (s["name"] in _CONTAINER_SPANS
                and s.get("span_id") in parent_ids):
            continue
        label = _execute_label(s)
        out[label] = out.get(label, 0.0) + s["duration_ms"]
    return out


def summarize(traces, slowest=5):
    # "request" for an engine feed, "router_request" for a router feed or
    # a multi-file stitched join — either is one client-visible request
    requests = [t for t in traces
                if t.get("root") in ("request", "router_request")
                and t.get("duration_ms") is not None]
    durations = [t["duration_ms"] for t in requests]
    coverages = [c for t in requests
                 if (c := coverage(t["spans"])) is not None]

    span_ms = {}       # name -> [ms per request trace]
    for t in requests:
        for name, ms in _breakdown(t["spans"]).items():
            span_ms.setdefault(name, []).append(ms)
    wall = sum(durations)
    span_rows = [
        {
            "span": name,
            "count": len(xs),
            "p50_ms": round(_percentile(xs, 50), 3),
            "p95_ms": round(_percentile(xs, 95), 3),
            "share": round(sum(xs) / wall, 4) if wall else None,
        }
        for name, xs in sorted(span_ms.items(), key=lambda kv: -sum(kv[1]))
    ]

    slow_rows = [
        {
            "trace_id": t["trace_id"],
            "duration_ms": round(t["duration_ms"], 3),
            "coverage": (round(c, 4) if (c := coverage(t["spans"])) is not None
                         else None),
            "breakdown_ms": {k: round(v, 3)
                             for k, v in sorted(_breakdown(t["spans"]).items(),
                                                key=lambda kv: -kv[1])},
        }
        for t in sorted(requests, key=lambda t: -t["duration_ms"])[:slowest]
    ]

    # per-bucket padding waste, from execute-span annotations.  Every
    # member trace mirrors its batch's execute span, so per-REQUEST rows
    # would overcount batches; dedupe by span_id-free identity: count only
    # one execute span per (source, bucket, start) edge — the SOURCE file
    # is part of the key because two replicas' monotonic clocks are
    # independent: identical (bucket, start) across files are different
    # physical batches, and deduping them would undercount fleet batches.
    seen = set()
    buckets = {}
    for t in traces:
        for s in t["spans"]:
            if s["name"] != "execute":
                continue
            attrs = s.get("attrs") or {}
            if "bucket" not in attrs:
                continue
            key = (s.get("source"), attrs["bucket"],
                   s.get("raw_start", s["start"]))
            if key in seen:
                continue
            seen.add(key)
            b = buckets.setdefault(attrs["bucket"], {
                "batches": 0, "images": 0, "waste": [], "exec_ms": []})
            b["batches"] += 1
            b["images"] += attrs.get("images", 0)
            b["waste"].append(attrs.get("padding_waste", 0.0))
            if s.get("duration_ms") is not None:
                b["exec_ms"].append(s["duration_ms"])
    bucket_rows = [
        {
            "bucket": k,
            "batches": v["batches"],
            "images": v["images"],
            "mean_padding_waste": round(sum(v["waste"]) / len(v["waste"]), 4),
            "p95_execute_ms": (round(_percentile(v["exec_ms"], 95), 3)
                               if v["exec_ms"] else None),
        }
        for k, v in sorted(buckets.items())
    ]

    # warm vs cold execute split (stateful session serving): how much
    # device time warm-started frames actually cost vs full settles, in
    # the same (possibly stitched fleet) feed — deduped per physical
    # execute exactly like the bucket table.  None when the feed has no
    # session traffic (pre-session feeds are unchanged).
    seen_wc = set()
    wc = {"execute_warm": [], "execute_cold": []}
    for t in traces:
        for s in t["spans"]:
            label = _execute_label(s)
            if label not in wc or s.get("duration_ms") is None:
                continue
            key = (s.get("source"), s.get("raw_start", s["start"]))
            if key in seen_wc:
                continue
            seen_wc.add(key)
            wc[label].append(s["duration_ms"])

    def _wc_block(xs):
        return {
            "frames": len(xs),
            "total_ms": round(sum(xs), 3),
            "p50_ms": (round(_percentile(xs, 50), 3) if xs else None),
            "p95_ms": (round(_percentile(xs, 95), 3) if xs else None),
        }

    warm_cold = None
    if wc["execute_warm"] or wc["execute_cold"]:
        warm_b = _wc_block(wc["execute_warm"])
        cold_b = _wc_block(wc["execute_cold"])
        warm_cold = {
            "warm": warm_b,
            "cold": cold_b,
            "warm_over_cold_p50": (
                round(warm_b["p50_ms"] / cold_b["p50_ms"], 4)
                if warm_b["p50_ms"] and cold_b["p50_ms"] else None),
        }

    return {
        "traces": len(traces),
        "requests": len(requests),
        "request_ms_p50": _percentile(durations, 50),
        "request_ms_p95": _percentile(durations, 95),
        "request_ms_max": max(durations) if durations else None,
        "coverage_p50": (round(_percentile(coverages, 50), 4)
                         if coverages else None),
        "spans": span_rows,
        "slowest": slow_rows,
        "buckets": bucket_rows,
        "warm_cold": warm_cold,
    }


# ---------------------------------------------------------------------------
# bucket-ladder auto-tune (--suggest-buckets)
# ---------------------------------------------------------------------------


def observed_batch_sizes(traces):
    """Real images per EXECUTED batch, from the execute-span annotations
    (deduped across mirrored member traces exactly like the waste table)."""
    seen = set()
    sizes = []
    for t in traces:
        for s in t["spans"]:
            attrs = s.get("attrs") or {}
            if s["name"] != "execute" or "bucket" not in attrs:
                continue
            key = (s.get("source"), attrs["bucket"],
                   s.get("raw_start", s["start"]))
            if key in seen:
                continue
            seen.add(key)
            if attrs.get("images"):
                sizes.append(int(attrs["images"]))
    return sizes


def suggest_ladder(sizes, k):
    """The k-bucket ladder minimizing total padded image-slots over the
    observed per-batch sizes — exact DP over the unique sizes (an optimal
    ladder only ever needs bucket boundaries AT observed sizes; anything
    between two observed sizes pads strictly more).  Returns
    ``(ladder, padded_slots)``."""
    if not sizes:
        raise ValueError("no executed batches in the trace feed")
    from collections import Counter

    counts = Counter(sizes)
    uniq = sorted(counts)
    if k >= len(uniq):
        return uniq, 0
    # cost(i, j): every batch sized in uniq[i..j] padded up to uniq[j]
    pref_n = [0]
    pref_sum = [0]
    for u in uniq:
        pref_n.append(pref_n[-1] + counts[u])
        pref_sum.append(pref_sum[-1] + counts[u] * u)

    def cost(i, j):
        n = pref_n[j + 1] - pref_n[i]
        s = pref_sum[j + 1] - pref_sum[i]
        return uniq[j] * n - s

    INF = float("inf")
    u = len(uniq)
    # best[m][j]: min padded slots covering uniq[0..j] with m buckets, the
    # largest being uniq[j] (the top bucket must be an observed max cover)
    best = [[INF] * u for _ in range(k + 1)]
    back = [[None] * u for _ in range(k + 1)]
    for j in range(u):
        best[1][j] = cost(0, j)
    for m in range(2, k + 1):
        for j in range(m - 1, u):
            for i in range(m - 2, j):
                c = best[m - 1][i] + cost(i + 1, j)
                if c < best[m][j]:
                    best[m][j] = c
                    back[m][j] = i
    ladder = []
    j, m = u - 1, k
    while m >= 1:
        ladder.append(uniq[j])
        j, m = back[m][j], m - 1
        if j is None:
            break
    return sorted(ladder), best[k][u - 1]


def suggest_buckets(traces, ladder_size=None):
    """The ``--suggest-buckets`` payload: measured waste under the ladder
    the feed was recorded with, the fitted ladder, and its projected waste
    over the same batch distribution."""
    sizes = observed_batch_sizes(traces)
    if not sizes:
        return {"error": "no executed batches with bucket annotations"}
    current = sorted({
        (s.get("attrs") or {}).get("bucket")
        for t in traces for s in t["spans"]
        if s["name"] == "execute" and (s.get("attrs") or {}).get("bucket")
    })
    k = ladder_size if ladder_size else max(len(current), 1)
    ladder, padded = suggest_ladder(sizes, k)

    def mean_waste(buckets):
        total = 0.0
        for s in sizes:
            b = next((x for x in buckets if x >= s), max(buckets))
            total += (b - s) / b
        return round(total / len(sizes), 4)

    return {
        "observed_batches": len(sizes),
        "observed_sizes": {str(s): sizes.count(s) for s in sorted(set(sizes))},
        "current_buckets": current,
        "current_mean_padding_waste": mean_waste(current) if current else None,
        "suggested_buckets": ladder,
        "suggested_mean_padding_waste": mean_waste(ladder),
        "suggested_padded_slots": padded,
    }


def _fmt(v, spec=".2f"):
    return "—" if v is None else format(v, spec)


def print_report(s):
    print(f"traces: {s['traces']}   request traces: {s['requests']}")
    if s["request_ms_p50"] is not None:
        print(f"request wall: p50 {_fmt(s['request_ms_p50'])} ms   "
              f"p95 {_fmt(s['request_ms_p95'])} ms   "
              f"max {_fmt(s['request_ms_max'])} ms   "
              f"span coverage p50 {_fmt(s['coverage_p50'], '.1%')}")
    if s["spans"]:
        print("\n| span | count | p50 ms | p95 ms | share of wall |")
        print("|---|---|---|---|---|")
        for r in s["spans"]:
            share = "—" if r["share"] is None else f"{100 * r['share']:.1f}%"
            print(f"| {r['span']} | {r['count']} | {_fmt(r['p50_ms'])} | "
                  f"{_fmt(r['p95_ms'])} | {share} |")
    if s["slowest"]:
        print("\nslowest requests:")
        for r in s["slowest"]:
            parts = ", ".join(f"{k} {v:.2f}" for k, v in
                              list(r["breakdown_ms"].items())[:4])
            cov = "—" if r["coverage"] is None else f"{100 * r['coverage']:.0f}%"
            print(f"  {r['trace_id']}  {r['duration_ms']:.2f} ms  "
                  f"(coverage {cov}; {parts})")
    if s["buckets"]:
        print("\n| bucket | batches | images | mean padding waste | p95 execute ms |")
        print("|---|---|---|---|---|")
        for r in s["buckets"]:
            print(f"| {r['bucket']} | {r['batches']} | {r['images']} | "
                  f"{100 * r['mean_padding_waste']:.1f}% | "
                  f"{_fmt(r['p95_execute_ms'])} |")
    if s.get("warm_cold"):
        wc = s["warm_cold"]
        print("\nstateful sessions — warm vs cold execute:")
        for mode in ("warm", "cold"):
            r = wc[mode]
            print(f"  {mode}: {r['frames']} frames  "
                  f"p50 {_fmt(r['p50_ms'])} ms  p95 {_fmt(r['p95_ms'])} ms  "
                  f"total {_fmt(r['total_ms'])} ms")
        if wc["warm_over_cold_p50"] is not None:
            print(f"  warm/cold p50 ratio: {wc['warm_over_cold_p50']:.2f} "
                  f"(the measured warm-start saving)")


def print_trace(traces, trace_id) -> int:
    match = [t for t in traces if t["trace_id"] == trace_id]
    if not match:
        print(f"error: no trace {trace_id!r} in the feed", file=sys.stderr)
        return 1
    for t in match:
        spans = sorted(t["spans"], key=lambda s: s["start"])
        by_id = {s["span_id"]: s for s in spans}

        def depth(s):
            d = 0
            while s.get("parent_id") in by_id:
                s = by_id[s["parent_id"]]
                d += 1
            return d

        print(f"trace {t['trace_id']}  root={t.get('root')}  "
              f"{_fmt(t.get('duration_ms'))} ms")
        t0 = spans[0]["start"] if spans else 0.0
        for s in spans:
            indent = "  " * (1 + depth(s))
            attrs = s.get("attrs") or {}
            extra = " ".join(f"{k}={attrs[k]}" for k in
                             ("bucket", "padding_waste", "flush_reason",
                              "status") if k in attrs)
            print(f"{indent}{s['name']}  +{1e3 * (s['start'] - t0):.2f} ms  "
                  f"dur {_fmt(s.get('duration_ms'))} ms  {extra}".rstrip())
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("jsonl", nargs="+",
                   help="the per-trace JSONL feed (the server's --trace-log); several "
                        "feeds (a router's and its replicas') are joined by trace id")
    p.add_argument("--format", choices=["text", "json"], default="text")
    p.add_argument("--slowest", type=int, default=5,
                   help="how many slowest traces to list")
    p.add_argument("--trace", default=None, metavar="ID",
                   help="print one trace's spans (indented by parentage)")
    p.add_argument("--suggest-buckets", action="store_true",
                   help="emit a bucket ladder fitted to the measured batch "
                        "sizes (JSON; feed it to the server's --buckets-file)")
    p.add_argument("--ladder-size", type=int, default=None,
                   help="bucket count for --suggest-buckets (default: as "
                        "many as the feed's current ladder)")
    args = p.parse_args(argv)
    try:
        traces = read_many(args.jsonl)
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if not traces:
        print(f"error: no trace records in {args.jsonl}", file=sys.stderr)
        return 1
    if args.trace:
        return print_trace(traces, args.trace)
    if args.suggest_buckets:
        out = suggest_buckets(traces, ladder_size=args.ladder_size)
        print(json.dumps(out, indent=2))
        return 1 if "error" in out else 0
    s = summarize(traces, slowest=args.slowest)
    if args.format == "json":
        print(json.dumps(s))
    else:
        print_report(s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
