"""Summarize a forensics bundle: the port's copy of
``tools/forensics_report.py`` (glom_tpu_torch.obs.forensics).

  python -m glom_tpu_torch.tools.forensics_report forensics/nan-120 [--format json]
  python -m glom_tpu_torch.tools.forensics_report forensics     # latest bundle
  python -m glom_tpu_torch.tools.forensics_report A --compare B # cost deltas A vs B

It reads either package's bundles.  Where a ``glom_tpu`` bundle carries the
jitted step's ``hlo.txt``, a port bundle carries ``kernels.json``: the
launches of each kernel wrapper one step or one graph replay makes, which
this copy renders (and ``has_hlo`` stays in its JSON for ``glom_tpu``'s
bundles).  The environment line names torch, CUDA and the card for a port
bundle, jax and the backend for a ``glom_tpu`` one.

Reads the self-describing ``<trigger>-<step>/`` directory the trainer
writes on a trigger/crash/preemption and prints:

  * what fired (trigger, step, detail, when) and where it ran (env
    fingerprint: torch/CUDA, the card, capability and driver, or
    jax/jaxlib, backend, devices and mesh; the git SHA);
  * flight-recorder summary: records in the ring, event tally, and
    per-phase p50/p95 ms/step BEFORE the trigger vs the AT-trigger window
    (the "what changed" table of a step-time post-mortem);
  * the step snapshot: top cost-analysis entries (with deltas against a
    ``--compare`` bundle when given), the memory-analysis footprint and
    the kernel launches.

Stdlib-only on purpose (like obs_report.py): it must run on a machine
with no torch installed, straight off a bundle copied from the card's host.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

MANIFEST = "manifest.json"


def _percentile(xs, q):
    if not xs:
        return None
    ordered = sorted(xs)
    rank = min(len(ordered) - 1, max(0, math.ceil(q / 100.0 * len(ordered)) - 1))
    return ordered[rank]


def resolve_bundle(path):
    """Accept a bundle dir or a forensics root (picks the newest bundle).
    Staging leftovers (dot-prefixed) are never candidates."""
    if os.path.exists(os.path.join(path, MANIFEST)):
        return path
    candidates = []
    for name in os.listdir(path):
        if name.startswith("."):
            continue
        sub = os.path.join(path, name)
        mpath = os.path.join(sub, MANIFEST)
        if os.path.isdir(sub) and os.path.exists(mpath):
            try:
                with open(mpath) as f:
                    created = json.load(f).get("created_unix", 0)
            except (OSError, ValueError):
                continue
            candidates.append((created, sub))
    if not candidates:
        raise FileNotFoundError(f"no forensics bundle under {path}")
    return max(candidates)[1]


def _load_attribution():
    """The port's ``obs/attribution.py`` (stdlib only), loaded from its file
    so that no package ``__init__`` (and no torch) runs."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "obs", "attribution.py")
    pkg = "_glom_tpu_torch_obs"
    if pkg not in sys.modules:
        import types

        stub = types.ModuleType(pkg)
        stub.__path__ = [os.path.dirname(path)]
        sys.modules[pkg] = stub
    name = f"{pkg}.attribution"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _load_json(bundle, name):
    path = os.path.join(bundle, name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _load_ring(bundle):
    path = os.path.join(bundle, "flight_recorder.jsonl")
    if not os.path.exists(path):
        return []
    recs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                recs.append(json.loads(line))
            except ValueError:
                continue
    return recs


def phase_comparison(ring, trigger_step):
    """Per-phase ms/step: p50/p95 over the window records BEFORE the
    trigger step vs the last window at/just before it.  Returns
    ``(rows, n_before)``; rows are [] when the ring has no window records
    (log_every=0 runs)."""
    windows = [r for r in ring if r.get("window_steps")]
    if not windows:
        return [], 0
    at = None
    for r in windows:  # the latest window not past the trigger
        if r.get("step", 0) <= trigger_step:
            at = r
    if at is None:
        at = windows[-1]
    before = [r for r in windows if r is not at]

    def per_step(rec, key):
        return 1e3 * rec[key] / rec["window_steps"] if key in rec else None

    keys = sorted({k for r in windows for k in r
                   if k.startswith("t_") and k != "t_window"})
    rows = []
    for k in keys:
        xs = [v for v in (per_step(r, k) for r in before) if v is not None]
        at_v = per_step(at, k)
        row = {
            "phase": k[2:],
            "before_p50_ms": _percentile(xs, 50),
            "before_p95_ms": _percentile(xs, 95),
            "at_trigger_ms": at_v,
        }
        row["ratio"] = (
            at_v / row["before_p50_ms"]
            if at_v is not None and row["before_p50_ms"] else None
        )
        rows.append(row)
    rows.sort(key=lambda r: -(r["at_trigger_ms"] or 0))
    return rows, len(before)


def cost_rows(cost, other=None, top=8):
    """Largest cost-analysis entries; with ``other`` (a --compare bundle's
    dict) the rows carry deltas, sorted by relative change."""
    if not cost:
        return []
    numeric = {k: v for k, v in cost.items() if isinstance(v, (int, float))}
    rows = []
    for k, v in numeric.items():
        row = {"key": k, "value": v}
        if other is not None and isinstance(other.get(k), (int, float)):
            row["other"] = other[k]
            row["delta"] = v - other[k]
            row["rel"] = (v / other[k] - 1.0) if other[k] else None
        rows.append(row)
    if other is not None:
        rows.sort(key=lambda r: -abs(r.get("rel") or 0))
    else:
        rows.sort(key=lambda r: -abs(r["value"]))
    return rows[:top]


def summarize(bundle, compare=None):
    manifest = _load_json(bundle, MANIFEST)
    if manifest is None:
        raise FileNotFoundError(f"{bundle} has no {MANIFEST}")
    env = _load_json(bundle, "env.json") or {}
    cost = _load_json(bundle, "cost_analysis.json")
    mem = _load_json(bundle, "memory_analysis.json")
    ring = _load_ring(bundle)
    events = {}
    for r in ring:
        ev = r.get("event")
        if isinstance(ev, str):
            events[ev] = events.get(ev, 0) + 1
    phases, n_before = phase_comparison(ring, manifest.get("step", 0))
    other_cost = None
    serving_phase_deltas = None
    if compare is not None:
        other_cost = _load_json(compare, "cost_analysis.json")
        # serving bundles carry a metrics.json registry snapshot each;
        # two of them bound a window, and the attribution plane's
        # phase-delta math decomposes the latency move inside it
        # (--compare B is the BEFORE bundle, the positional one AFTER)
        mine = _load_json(bundle, "metrics.json")
        theirs = _load_json(compare, "metrics.json")
        if mine and theirs:
            attribution = _load_attribution()
            rows = attribution.snapshot_phase_deltas(theirs, mine)
            serving_phase_deltas = rows or None
    return {
        "bundle": os.path.abspath(bundle),
        "trigger": manifest.get("trigger"),
        "step": manifest.get("step"),
        "detail": manifest.get("detail"),
        "created_unix": manifest.get("created_unix"),
        "schema": manifest.get("schema"),
        "snapshot_error": manifest.get("snapshot_error"),
        "trace": manifest.get("trace"),
        "env": env,
        "ring_records": len(ring),
        "windows_before_trigger": n_before,
        "events": events,
        "phases": phases,
        "cost": cost_rows(cost, other_cost),
        "serving_phase_deltas": serving_phase_deltas,
        "attribution": _load_json(bundle, "attribution.json"),
        "compared_to": os.path.abspath(compare) if compare else None,
        "memory": mem or {},
        "has_hlo": os.path.exists(os.path.join(bundle, "hlo.txt")),
        "kernels": _load_json(bundle, "kernels.json"),
    }


def _fmt(v, spec=".2f"):
    return "—" if v is None else format(v, spec)


def print_report(s):
    print(f"bundle: {s['bundle']}")
    print(f"trigger: {s['trigger']}   step: {s['step']}")
    if s["detail"]:
        det = ", ".join(f"{k}={v}" for k, v in s["detail"].items()
                        if k != "traceback")
        if det:
            print(f"detail: {det}")
    env = s["env"]
    if env:
        mesh = env.get("mesh_shape")
        mesh_s = ("x".join(str(v) for v in mesh.values())
                  if isinstance(mesh, dict) else "—")
        sha = (env.get("git_sha") or "—")[:12]
        if "torch_version" in env:
            print(f"env: torch {env.get('torch_version')} / CUDA "
                  f"{env.get('cuda_version')}   backend {env.get('backend')} "
                  f"({env.get('device_count')} x {env.get('device_kind')}, "
                  f"sm {env.get('device_capability')}, driver "
                  f"{env.get('driver_version')})   git {sha}")
        else:
            print(f"env: jax {env.get('jax_version')} / jaxlib "
                  f"{env.get('jaxlib_version')}   backend {env.get('backend')} "
                  f"({env.get('device_count')} x {env.get('device_kind')}, "
                  f"mesh {mesh_s})   git {sha}")
    print(f"flight recorder: {s['ring_records']} records"
          + (f"   events: " + ", ".join(
              f"{k}x{v}" for k, v in sorted(s["events"].items()))
             if s["events"] else ""))
    if s["phases"]:
        print(f"\nphase ms/step — {s['windows_before_trigger']} windows "
              f"before the trigger vs the at-trigger window:")
        print("| phase | before p50 | before p95 | at trigger | ratio |")
        print("|---|---|---|---|---|")
        for row in s["phases"]:
            ratio = "—" if row["ratio"] is None else f"{row['ratio']:.2f}x"
            print(f"| {row['phase']} | {_fmt(row['before_p50_ms'])} | "
                  f"{_fmt(row['before_p95_ms'])} | "
                  f"{_fmt(row['at_trigger_ms'])} | {ratio} |")
    if s["cost"]:
        if s["compared_to"]:
            print(f"\ntop cost-analysis deltas vs {s['compared_to']}:")
            print("| key | this | other | delta | rel |")
            print("|---|---|---|---|---|")
            for row in s["cost"]:
                rel = "—" if row.get("rel") is None else f"{100 * row['rel']:+.1f}%"
                print(f"| {row['key']} | {row['value']:.4g} | "
                      f"{row.get('other', float('nan')):.4g} | "
                      f"{row.get('delta', float('nan')):+.4g} | {rel} |")
        else:
            print("\ntop cost-analysis entries:")
            for row in s["cost"]:
                print(f"  {row['key']}: {row['value']:.4g}")
    if s.get("attribution"):
        attr = s["attribution"]
        print(f"\nattribution: {attr.get('verdict')} "
              f"(confidence {_fmt(attr.get('confidence'))})")
    if s.get("serving_phase_deltas"):
        print(f"\nserving phase deltas vs {s['compared_to']} "
              f"(window = requests between the two bundles):")
        print("| phase | before | window | delta ms | share |")
        print("|---|---|---|---|---|")
        for row in s["serving_phase_deltas"][:8]:
            print(f"| {row['phase']} | {_fmt(row['before_ms'])} | "
                  f"{_fmt(row['after_ms'])} | {_fmt(row['delta_ms'])} | "
                  f"{_fmt(row['share'])} |")
    if s["memory"]:
        mem = ", ".join(f"{k}={v}" for k, v in sorted(s["memory"].items()))
        print(f"memory analysis: {mem}")
    if s.get("kernels"):
        print("kernel launches: " + ", ".join(
            f"{k} {v}" for k, v in sorted(s["kernels"].items())))
    print(f"hlo snapshot: {'hlo.txt' if s['has_hlo'] else 'absent'}"
          + (f"   snapshot error: {s['snapshot_error']}"
             if s["snapshot_error"] else "")
          + (f"   trace: {s['trace']}" if s["trace"] else ""))
    if s["detail"] and s["detail"].get("traceback"):
        print("\ntraceback (tail):")
        for line in str(s["detail"]["traceback"]).strip().splitlines()[-6:]:
            print(f"  {line}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("bundle",
                   help="bundle dir (forensics/<trigger>-<step>) or the "
                        "forensics root (the newest bundle is picked)")
    p.add_argument("--compare", default=None,
                   help="second bundle: report cost-analysis deltas "
                        "(this - other)")
    p.add_argument("--format", choices=["text", "json"], default="text",
                   help="json = one machine-readable JSON object")
    args = p.parse_args(argv)
    try:
        bundle = resolve_bundle(args.bundle)
        compare = resolve_bundle(args.compare) if args.compare else None
        s = summarize(bundle, compare=compare)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.format == "json":
        print(json.dumps(s))
    else:
        print_report(s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
