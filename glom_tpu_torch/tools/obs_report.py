"""Summarize a training run's phase-timed JSONL into one health report: the
port's copy of ``tools/obs_report.py`` (stdlib only).

  python -m glom_tpu_torch.tools.obs_report run.jsonl [--format json]

It reads the records either package's trainer writes, the same way.  One
difference: with no ``--bench`` it reads no ceiling, where ``glom_tpu``'s
falls back to the repository root's ``BENCH_*.json``: every such file in
this repository holds a TPU's rate, which is no ceiling for a card (as
``obs/capacity.py::read_bench_ceiling`` of the port does).

Reads the records the obs-instrumented Trainer emits (phase times
``t_<phase>`` per logging window, ``window_steps``, string ``event``
markers, window-aggregated numerics, GLOM diagnostics) and prints:

  * per-phase p50 / p95 / share-of-wall step time (ms/step, normalized by
    each window's ``window_steps``);
  * throughput (imgs/sec p50 / best);
  * a capacity summary — utilization and headroom against the measured
    ``BENCH_*.json`` ceiling (``--bench``) plus the throughput trend;
  * recompile count, NaN windows, grad-norm spike windows, resume /
    preemption events;
  * final island agreement / attention entropy when diagnostics ran.

Tolerates pre-obs logs (no ``t_*`` keys — phases section is skipped) and
legacy float event markers (1.0 resume / 2.0 stop), so it runs on every
JSONL under ``docs/runs/``.  ``--format json`` emits the summary as one
JSON object for machine consumers (CI gates); ``--json`` remains as a
deprecated alias.
"""

from __future__ import annotations

import argparse
import json
import sys


def _percentile(xs, q):
    """Nearest-rank percentile, q in [0, 100]."""
    if not xs:
        return None
    import math

    ordered = sorted(xs)
    rank = min(len(ordered) - 1, max(0, math.ceil(q / 100.0 * len(ordered)) - 1))
    return ordered[rank]


def read_records(path):
    recs = []
    with open(path) as f:
        for line in f:
            # truncated/garbage lines (timeout-killed runs) must not abort
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                recs.append(json.loads(line))
            except ValueError:
                continue
    return recs


# pre-obs logs used float markers; mirrors
# glom_tpu_torch.obs.registry.LEGACY_EVENT_FLOATS (inlined so this reader
# runs with the standard library alone)
LEGACY_EVENT_FLOATS = {1.0: "resume", 2.0: "preempt_stop"}


def _read_bench_ceiling(path=None):
    """Measured imgs/s ceiling from a ``BENCH_*.json`` (``parsed.
    last_measured.value``); mirrors the port's
    ``obs/capacity.py::read_bench_ceiling`` (inlined so this reader runs
    with the standard library alone).  ``path`` is a file or a directory of
    BENCH files (newest wins); None (and nothing parseable) is no ceiling."""
    import glob
    import os

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


def _trend_arrow(xs, rel=0.02):
    """↑ / ↓ / → from a least-squares slope over window index; flat when
    the end-to-end drift is under ``rel`` of the mean."""
    if len(xs) < 2:
        return "→"
    n = len(xs)
    mean_i = (n - 1) / 2.0
    mean_x = sum(xs) / n
    denom = sum((i - mean_i) ** 2 for i in range(n))
    slope = sum((i - mean_i) * (x - mean_x) for i, x in enumerate(xs)) / denom
    drift = slope * (n - 1)
    if mean_x and abs(drift) < rel * abs(mean_x):
        return "→"
    return "↑" if drift > 0 else "↓"


def summarize(recs, bench_ceiling=None):
    phases = {}          # name -> [ms/step per window]
    window_ms = []
    rates = []
    events = {}
    nan_steps = set()    # steps already counted (a nan EVENT and a window
                         # record at the same step describe one incident)
    spike_windows = 0
    nonfinite_total = 0.0
    compile_count = None
    final_diag = {}
    last_step = 0

    def count_nan(rec):
        nonlocal nonfinite_total
        step = rec.get("step", 0)
        if step in nan_steps:
            return
        nan_steps.add(step)
        nonfinite_total += rec.get("nonfinite_grads", 0) or 0

    for rec in recs:
        last_step = max(last_step, int(rec.get("step", 0)))
        ev = rec.get("event")
        if ev is not None:
            if isinstance(ev, float):
                ev = LEGACY_EVENT_FLOATS.get(ev, f"legacy_{ev}")
            events[ev] = events.get(ev, 0) + 1
            if ev == "recompile" and "compile_count" in rec:
                compile_count = rec["compile_count"]
            if ev == "nan":
                # logging-disabled runs carry numerics ONLY on the event
                # record — it must count even without a window record
                count_nan(rec)
            continue
        steps = rec.get("window_steps")
        if steps:
            for k, v in rec.items():
                if k.startswith("t_") and k != "t_window":
                    phases.setdefault(k[2:], []).append(1e3 * v / steps)
            if "t_window" in rec:
                window_ms.append(1e3 * rec["t_window"] / steps)
        if "imgs_per_sec" in rec:
            rates.append(rec["imgs_per_sec"])
        if rec.get("nonfinite_grads") or rec.get("loss_nonfinite_steps"):
            count_nan(rec)
        if rec.get("grad_norm_spike"):
            spike_windows += 1
        for k in rec:
            if k.startswith(("island_agreement", "attn_entropy", "contrib_share_")):
                final_diag[k] = rec[k]

    phase_rows = [
        {
            "phase": name,
            "p50_ms": _percentile(xs, 50),
            "p95_ms": _percentile(xs, 95),
            "share": (sum(xs) / sum(window_ms)) if window_ms and sum(window_ms) else None,
        }
        for name, xs in sorted(
            phases.items(), key=lambda kv: -sum(kv[1])
        )
    ]
    rate_p50 = _percentile(rates, 50)
    rate_best = max(rates) if rates else None
    capacity = {
        "ceiling_imgs_per_sec": bench_ceiling,
        "utilization_p50": (rate_p50 / bench_ceiling
                            if rate_p50 is not None and bench_ceiling else None),
        "utilization_best": (rate_best / bench_ceiling
                             if rate_best is not None and bench_ceiling else None),
        "headroom_imgs_per_sec": (bench_ceiling - rate_p50
                                  if rate_p50 is not None and bench_ceiling
                                  else None),
        "throughput_trend": _trend_arrow(rates),
    }
    return {
        "records": len(recs),
        "last_step": last_step,
        "capacity": capacity,
        "step_time_ms_p50": _percentile(window_ms, 50),
        "step_time_ms_p95": _percentile(window_ms, 95),
        "phases": phase_rows,
        "imgs_per_sec_p50": _percentile(rates, 50),
        "imgs_per_sec_best": max(rates) if rates else None,
        "events": events,
        "recompiles": events.get("recompile", 0),
        "compile_count": compile_count,
        "nan_windows": len(nan_steps),
        "nonfinite_grads_total": nonfinite_total,
        "grad_spike_windows": spike_windows,
        "final_island_agreement": final_diag.get("island_agreement"),
        "final_attn_entropy": final_diag.get("attn_entropy"),
    }


def _fmt(v, spec=".2f"):
    return "—" if v is None else format(v, spec)


def print_report(s):
    print(f"records: {s['records']}   last step: {s['last_step']}")
    if s["step_time_ms_p50"] is not None:
        print(f"step time: p50 {_fmt(s['step_time_ms_p50'])} ms   "
              f"p95 {_fmt(s['step_time_ms_p95'])} ms")
    if s["phases"]:
        print("\n| phase | p50 ms/step | p95 ms/step | share of wall |")
        print("|---|---|---|---|")
        for row in s["phases"]:
            share = "—" if row["share"] is None else f"{100 * row['share']:.1f}%"
            print(f"| {row['phase']} | {_fmt(row['p50_ms'])} | "
                  f"{_fmt(row['p95_ms'])} | {share} |")
    if s["imgs_per_sec_p50"] is not None:
        print(f"\nthroughput: p50 {_fmt(s['imgs_per_sec_p50'])} imgs/sec   "
              f"best {_fmt(s['imgs_per_sec_best'])}")
    cap = s.get("capacity", {})
    if cap.get("ceiling_imgs_per_sec") is not None:
        util = cap.get("utilization_p50")
        print(f"capacity: ceiling {_fmt(cap['ceiling_imgs_per_sec'])} imgs/sec"
              f"   utilization p50 "
              f"{'—' if util is None else f'{100 * util:.1f}%'}"
              f"   headroom {_fmt(cap.get('headroom_imgs_per_sec'))} imgs/sec"
              f"   trend {cap.get('throughput_trend', '—')}")
    print(f"\nhealth: recompiles={s['recompiles']}"
          + (f" (compile_count={s['compile_count']})" if s["compile_count"] else "")
          + f"   nan_windows={s['nan_windows']}"
          f" (nonfinite elements: {int(s['nonfinite_grads_total'])})"
          f"   grad_spike_windows={s['grad_spike_windows']}")
    if s["events"]:
        print("events: " + ", ".join(f"{k}x{v}" for k, v in sorted(s["events"].items())))
    if s["final_island_agreement"] is not None:
        print(f"final island agreement: {s['final_island_agreement']:.4f}   "
              f"attention entropy: {_fmt(s['final_attn_entropy'], '.3f')} nats")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("jsonl", help="phase-timed training log (MetricLogger JSONL)")
    p.add_argument("--format", choices=["text", "json"], default="text",
                   help="json = emit the summary as one machine-readable "
                        "JSON object (CI gates)")
    p.add_argument("--json", action="store_true",
                   help="deprecated alias for --format json")
    p.add_argument("--bench", default=None,
                   help="BENCH_*.json file or directory for the capacity "
                        "utilization ceiling (default: none)")
    args = p.parse_args(argv)
    try:
        recs = read_records(args.jsonl)
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if not recs:
        print(f"error: no JSON records in {args.jsonl}", file=sys.stderr)
        return 1
    s = summarize(recs, bench_ceiling=_read_bench_ceiling(args.bench))
    if args.json or args.format == "json":
        print(json.dumps(s))
    else:
        print_report(s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
