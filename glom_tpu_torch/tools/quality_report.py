"""Quality-plane CLI: the port's copy of ``tools/quality_report.py``.

    python -m glom_tpu_torch.tools.quality_report report --url http://127.0.0.1:8000
    python -m glom_tpu_torch.tools.quality_report report --url ... --format json
    python -m glom_tpu_torch.tools.quality_report freeze --url http://127.0.0.1:8000
    python -m glom_tpu_torch.tools.quality_report --smoke [--fleet] [--device cpu]

``report`` renders ``GET /quality`` — per-metric live-vs-reference sketch
stats (count / mean / p50 / p95), the PSI + KS drift scores, the latest
sampled signals, and the worst-N offending requests with their trace ids
and input fingerprints.  ``freeze`` POSTs ``/admin/quality/ref``: the
current live distributions become the reference profile
(``quality_ref.json`` next to the checkpoints).  Both speak plain stdlib
HTTP.

``--smoke`` is the engine's acceptance loop: a demo checkpoint (or
``--checkpoint-dir``) served in-process with a tight drift SLO, a clean
burst is frozen as the reference profile, then a burst of the bodies the
load generator's ``--corrupt`` sends must push the live KS drift over the
SLO and fire ``quality_drift`` exactly once, with the offending trace ids
and their input fingerprints (counted: the port writes no forensics bundle
yet) — while no request errors, no quality post-pass fails and the request
path captures no graph (``serving_graph_captures == 0``).  With ``--fleet`` a
fleet router (:mod:`glom_tpu_torch.serving.router`) then fronts the replica, as
``tools/quality_report.py``'s smoke does, and must merge the replica's
sketches from the ``/healthz`` its health loop fetches into its ``/quality``.
Without ``--device`` the smoke runs on ``cuda``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import urllib.request

# The smoke's drift SLO: the corrupt burst shifts norm/residual mass far
# outside the clean range, so the live-vs-reference KS gap approaches
# corrupt/(clean+corrupt) ~ 0.67 — a 0.2 bound is decisive for the
# plumbing without being a tuned model threshold real noise could graze.
SMOKE_DRIFT_SLO = "drift<0.2"
SMOKE_CLEAN = 8
SMOKE_CORRUPT = 16
# a flagship request's JSON body is megabytes: the smoke's HTTP timeout
TIMEOUT_S = 120.0


def _get_json(url: str, timeout: float = 10.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _post_json(url: str, timeout: float = 10.0) -> dict:
    req = urllib.request.Request(url, data=b"{}", method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


# ---------------------------------------------------------------------------
# report / freeze
# ---------------------------------------------------------------------------
def _fmt(v, spec=".4g"):
    return "—" if v is None else format(v, spec)


def _stats_row(stats):
    if not stats:
        return "—", "—", "—", "—"
    return (_fmt(stats.get("count"), "d"), _fmt(stats.get("mean")),
            _fmt(stats.get("p50")), _fmt(stats.get("p95")))


def cmd_report(args) -> int:
    doc = _get_json(f"{args.url.rstrip('/')}/quality", args.timeout)
    if args.format == "json":
        print(json.dumps(doc, indent=2))
        return 0
    if doc.get("role") == "router":
        fleet = doc.get("fleet", {})
        print(f"quality @ {args.url}   role=router   "
              f"replicas={fleet.get('replicas')}")
        metrics = fleet.get("metrics", {})
        drift = fleet.get("drift", {})
        print("\n| metric | n | mean | p50 | p95 | drift(ks) |")
        print("|---|---|---|---|---|---|")
        for m, stats in sorted(metrics.items()):
            n, mean, p50, p95 = _stats_row(stats)
            d = drift.get(m) if isinstance(drift.get(m), dict) else None
            print(f"| {m} | {n} | {mean} | {p50} | {p95} | "
                  f"{_fmt(d.get('ks') if d else None)} |")
        for name, rep in sorted((doc.get("replicas") or {}).items()):
            print(f"\nreplica {name}: observed={rep.get('observed')} "
                  f"sampled={rep.get('sampled')} "
                  f"drift={json.dumps(rep.get('drift'))}")
        return 0
    drift = doc.get("drift", {})
    print(f"quality @ {args.url}   observed={doc.get('observed')}   "
          f"sampled={doc.get('sampled')}/{doc.get('decided')}   "
          f"reference={'yes' if doc.get('reference') else 'NO (freeze one)'}"
          f"   drift(max_ks)={_fmt(drift.get('max_ks'))}")
    print("\n| metric | live n/mean/p50/p95 | ref n/mean/p50/p95 "
          "| ks | psi |")
    print("|---|---|---|---|---|")
    for m, row in sorted((doc.get("metrics") or {}).items()):
        ln, lmean, lp50, lp95 = _stats_row(row.get("live"))
        rn, rmean, rp50, rp95 = _stats_row(row.get("reference"))
        d = row.get("drift") or {}
        print(f"| {m} | {ln}/{lmean}/{lp50}/{lp95} "
              f"| {rn}/{rmean}/{rp50}/{rp95} "
              f"| {_fmt(d.get('ks'))} | {_fmt(d.get('psi'))} |")
    worst = doc.get("worst") or []
    if worst:
        print("\nworst offenders (lowest agreement):")
        for w in worst:
            print(f"  trace={w.get('trace_id')} "
                  f"agreement={_fmt(w.get('agreement'))} "
                  f"fingerprint={w.get('fingerprint')}")
    return 0


def cmd_freeze(args) -> int:
    out = _post_json(f"{args.url.rstrip('/')}/admin/quality/ref",
                     args.timeout)
    print(json.dumps(out, indent=2))
    return 0


# ---------------------------------------------------------------------------
# smoke
# ---------------------------------------------------------------------------
def run_smoke(device="cuda", checkpoint_dir=None, buckets=(1, 2), *, fleet=False) -> dict:
    """The acceptance loop; returns the report (``"smoke"`` is ``"ok"`` when
    every check holds); ``fleet`` adds the router leg.  ``checkpoint_dir``
    None serves a demo checkpoint written to a temporary directory; a given
    directory gets the
    frozen reference only for the run (a ``quality_ref.json`` it held before
    is refused: the smoke would replace it)."""
    import tempfile
    import threading

    from glom_tpu_torch.obs.quality import REFERENCE_FILE
    from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint
    from glom_tpu_torch.serving.server import make_server
    from glom_tpu_torch.tools import loadgen

    with tempfile.TemporaryDirectory() as d:
        ckpt = checkpoint_dir
        if ckpt is None:
            ckpt = os.path.join(d, "ckpt")
            make_demo_checkpoint(ckpt)
        ref_path = os.path.join(ckpt, REFERENCE_FILE)
        if os.path.exists(ref_path):
            raise FileExistsError(f"{ref_path} exists; the smoke freezes its own reference")
        engine = ServingEngine(
            ckpt, buckets=tuple(buckets), max_wait_ms=1.0, warmup=True,
            reload_poll_s=0, device=device,
            slos=[SMOKE_DRIFT_SLO, "p95<60000ms"],
            quality_sample=1.0,
        )
        engine.start()
        server = make_server(engine)
        host, port = server.server_address[:2]
        threading.Thread(target=server.serve_forever, daemon=True).start()
        target = f"http://{host}:{port}"
        router = router_server = None
        try:
            health = loadgen.fetch_health(target, timeout=TIMEOUT_S)
            payloads = loadgen.make_payloads(health, [1])
            corrupt = loadgen.make_corrupt_payloads(health, [1])
            results = loadgen.Results()
            t0 = time.monotonic()

            def burst(n, bodies, tag):
                for i in range(n):
                    loadgen.send(target, "embed", bodies[1], 1, TIMEOUT_S, results, t0,
                                 request_id=f"q-{tag}-{i}")

            # clean traffic first, then freeze it as the reference
            burst(SMOKE_CLEAN, payloads, "clean")
            frozen = _post_json(f"{target}/admin/quality/ref", TIMEOUT_S)
            drift_before = _get_json(f"{target}/quality", TIMEOUT_S)["drift"].get("max_ks", 0.0)

            # the corrupt burst: the bodies `loadgen --corrupt 1.0` sends —
            # well-formed requests, a shifted distribution
            burst(SMOKE_CORRUPT, corrupt, "corrupt")
            quality = _get_json(f"{target}/quality", TIMEOUT_S)
            drift_after = quality["drift"].get("max_ks", 0.0)

            snap = engine.registry.snapshot()
            captures = snap.get("serving_graph_captures", 0.0)
            failures = snap.get("quality_post_pass_failures", 0.0)
            # the detection must name the offending trace ids AND their input
            # fingerprints (what a forensics bundle would carry)
            fires = [f for f in engine._slo.fired if f.get("metric") == "drift"]
            detail = fires[0] if fires else {}
            checks = {
                "requests_ok": (results.ok == SMOKE_CLEAN + SMOKE_CORRUPT
                                and results.errors == 0),
                "reference_frozen": bool(frozen.get("written")),
                "drift_clean_low": drift_before < 0.2,
                "drift_crossed_slo": drift_after > 0.2,
                "one_quality_drift_fire": (
                    len(fires) == 1 and snap.get("quality_drift_events") == 1.0),
                "fire_has_trace_ids": bool(detail.get("trace_ids")),
                "fire_has_fingerprints": bool(detail.get("fingerprints")),
                "zero_request_path_captures": captures == 0,
                "zero_post_pass_failures": failures == 0,
                "quality_endpoint": quality.get("observed", 0) > 0,
            }
            fleet_doc = None
            if fleet:
                # the router leg: a router fronting the replica merges its
                # sketches from the same /healthz its health loop fetches
                from glom_tpu_torch.serving.router import FleetRouter, make_router_server

                router = FleetRouter([target], health_interval_s=0.2,
                                     health_timeout_s=TIMEOUT_S)
                router.start()
                router_server = make_router_server(router)
                threading.Thread(target=router_server.serve_forever, daemon=True).start()
                rtarget = "http://{}:{}".format(*router_server.server_address[:2])
                fleet_doc = loadgen.poll_until(
                    lambda: (lambda p: p if (p.get("fleet") or {}).get("replicas") else None)(
                        _get_json(f"{rtarget}/quality", TIMEOUT_S)), timeout_s=30.0)
                checks["fleet_merged"] = bool(fleet_doc) and bool(
                    (fleet_doc.get("fleet") or {}).get("metrics"))
            ok = all(checks.values())
            return {
                "smoke": "ok" if ok else "FAILED",
                "slo": SMOKE_DRIFT_SLO,
                "drift_before": drift_before,
                "drift_after": drift_after,
                "observed": quality.get("observed"),
                "quality_drift_fires": len(fires),
                "fire": {k: detail.get(k) for k in ("metric", "value", "threshold",
                                                    "trace_ids", "fingerprints")},
                "graph_captures": captures,
                "post_pass_failures": failures,
                "fleet_drift": (fleet_doc.get("fleet") or {}).get("drift") if fleet_doc
                else None,
                "checks": checks,
            }
        finally:
            if router_server is not None:
                router.shutdown()
                router_server.shutdown()
                router_server.server_close()
            server.shutdown()
            engine.shutdown()
            server.server_close()
            if checkpoint_dir is not None and os.path.exists(ref_path):
                os.remove(ref_path)


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--smoke", action="store_true",
                   help="in-process engine acceptance loop")
    p.add_argument("--device", default="cuda",
                   help="with --smoke: torch device; 'cpu' runs the plain PyTorch versions "
                        "of the kernels")
    p.add_argument("--checkpoint-dir", default=None,
                   help="with --smoke: serve this checkpoint (default: a demo one)")
    p.add_argument("--fleet", action="store_true",
                   help="with --smoke: then front the replica with a fleet router (the "
                        "router's sketch-merge leg)")
    sub = p.add_subparsers(dest="cmd")
    rep = sub.add_parser("report", help="render GET /quality")
    rep.add_argument("--url", default="http://127.0.0.1:8000")
    rep.add_argument("--timeout", type=float, default=10.0)
    rep.add_argument("--format", choices=["text", "json"], default="text")
    fr = sub.add_parser("freeze",
                        help="POST /admin/quality/ref: adopt the live "
                             "distributions as the drift reference")
    fr.add_argument("--url", default="http://127.0.0.1:8000")
    fr.add_argument("--timeout", type=float, default=10.0)
    args = p.parse_args(argv)
    if args.fleet and not args.smoke:
        p.error("--fleet goes with --smoke")
    if args.smoke:
        report = run_smoke(args.device, args.checkpoint_dir, fleet=args.fleet)
        print(json.dumps(report, indent=2))
        return 0 if report["smoke"] == "ok" else 1
    if args.cmd == "report":
        return cmd_report(args)
    if args.cmd == "freeze":
        return cmd_freeze(args)
    p.error("need --smoke, report, or freeze")
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
