"""Capacity-plane CLI: the port's copy of ``tools/capacity.py``.

    python -m glom_tpu_torch.tools.capacity report --url http://127.0.0.1:8000
    python -m glom_tpu_torch.tools.capacity query --url http://127.0.0.1:8000 \\
        --name capacity_duty_cycle --since -120 --step 1
    python -m glom_tpu_torch.tools.capacity --smoke [--fleet] [--device cpu]

``report`` renders ``GET /capacity`` — the policy, the current
recommendation (scale-up / scale-down / rebalance / hold, with the
violated bounds as reasons) and the per-rule trend/ETA forecasts.
``query`` is a thin front over ``GET /debug/series``: name/since/step pass
through, points print as ``t value`` rows (``--format json`` for the raw
body).  Both speak plain stdlib HTTP.

``--smoke`` is the engine's acceptance loop: a demo checkpoint (or
``--checkpoint-dir``) served in-process, a burst of requests drives the duty
cycle up, the advisor must recommend **scale-up** within the persist
threshold and fire ``capacity_pressure`` exactly once (counted: the port
writes no forensics bundle yet); after quiescence ages the burst out of the
window the recommendation must flip to **scale-down**; without a ceiling
there is no utilization; and the request path must never have captured a
graph (``serving_graph_captures == 0``).  Windows are driven by explicit
``tick(t)`` times, so pass/fail does not depend on the host's scheduling;
only the signal values come from real served requests.  With ``--fleet`` a
fleet router (:mod:`glom_tpu_torch.serving.router`) then fronts the replica, as
``tools/capacity.py``'s smoke does: it must ingest the replica's capacity
summary from the ``/healthz`` its health loop fetches (labeled per-replica
series on its ``/capacity``) and log a ``capacity_recommendation`` on its
timeline.  Without ``--device`` the smoke runs on ``cuda``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.parse
import urllib.request

# The smoke trips on ANY execute work inside the window (and scale-down
# on none): the smoke proves the plumbing — signals -> advisor ->
# trigger — not a tuned threshold, and a bound that real timings could
# straddle would make it flaky.
SMOKE_POLICY = "duty<0.000001"
SMOKE_WINDOW_S = 8.0
SMOKE_PERSIST = 3
SMOKE_BURST = 16
# a flagship request's JSON body is megabytes: the smoke's HTTP timeout
TIMEOUT_S = 120.0


def _get_json(url: str, timeout: float = 10.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


# ---------------------------------------------------------------------------
# report / query
# ---------------------------------------------------------------------------
def _fmt(v, spec=".4g"):
    return "—" if v is None else format(v, spec)


def cmd_report(args) -> int:
    doc = _get_json(f"{args.url.rstrip('/')}/capacity", args.timeout)
    if args.format == "json":
        print(json.dumps(doc, indent=2))
        return 0
    rec = doc.get("recommendation") or {}
    print(f"capacity @ {args.url}   role={doc.get('role')}   "
          f"policy={doc.get('policy')}")
    if rec:
        reasons = "; ".join(rec.get("reasons", [])) or "—"
        print(f"recommendation: {rec.get('action')} "
              f"(persisted {rec.get('persisted')}/"
              f"{doc.get('persist_windows')})   {reasons}")
    else:
        print("recommendation: — (no evaluation window yet)")
    forecasts = doc.get("forecasts", [])
    if forecasts:
        print("\n| rule | value | trend | slope/s | eta to bound (s) |")
        print("|---|---|---|---|---|")
        for f in forecasts:
            print(f"| {f.get('rule')} | {_fmt(f.get('value'))} | "
                  f"{f.get('arrow', '—')} | {_fmt(f.get('slope_per_s'))} | "
                  f"{_fmt(f.get('eta_s'), '.1f')} |")
    replicas = doc.get("replicas") or {}
    if replicas:
        print("\n| replica | duty | util | p95 ms | shed | queue |")
        print("|---|---|---|---|---|---|")
        for name in sorted(replicas):
            s = replicas[name]
            print(f"| {name} | {_fmt(s.get('duty'))} | {_fmt(s.get('util'))}"
                  f" | {_fmt(s.get('p95_ms'))} | {_fmt(s.get('shed'))}"
                  f" | {_fmt(s.get('queue'))} |")
    if doc.get("pressure_fired"):
        print(f"\ncapacity_pressure fired: {doc['pressure_fired']}")
    return 0


def cmd_query(args) -> int:
    params = {}
    if args.name:
        params["name"] = args.name
    if args.prefix:
        params["prefix"] = args.prefix
    if args.since is not None:
        params["since"] = args.since
    if args.step is not None:
        params["step"] = args.step
    qs = urllib.parse.urlencode(params)
    doc = _get_json(f"{args.url.rstrip('/')}/debug/series?{qs}", args.timeout)
    if args.format == "json":
        print(json.dumps(doc, indent=2))
        return 0
    if "error" in doc:
        print(f"error: {doc['error']}", file=sys.stderr)
        return 1
    if "names" in doc:  # no selector -> discovery listing
        for name in doc["names"]:
            print(name)
        return 0
    for key, pts in doc.get("series", {}).items():
        print(f"# {key} ({len(pts)} points)")
        for t, v in pts:
            print(f"{t} {v}")
    return 0


# ---------------------------------------------------------------------------
# the smoke
# ---------------------------------------------------------------------------
def run_smoke(device="cuda", checkpoint_dir=None, buckets=(1, 2), *, fleet=False) -> dict:
    """The acceptance loop; returns the report (``"smoke"`` is ``"ok"`` when
    every check holds).  ``checkpoint_dir`` None serves a demo checkpoint
    written to a temporary directory; ``fleet`` adds the router leg."""
    import tempfile
    import threading

    from glom_tpu_torch.obs.capacity import ACTION_SCALE_DOWN, ACTION_SCALE_UP
    from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint
    from glom_tpu_torch.serving.server import make_server
    from glom_tpu_torch.tools import loadgen

    with tempfile.TemporaryDirectory() as d:
        ckpt = checkpoint_dir
        if ckpt is None:
            ckpt = os.path.join(d, "ckpt")
            make_demo_checkpoint(ckpt)
        engine = ServingEngine(
            ckpt, buckets=tuple(buckets), max_wait_ms=1.0, warmup=True,
            reload_poll_s=0, device=device,
            capacity_policy=SMOKE_POLICY,
            capacity_window_s=SMOKE_WINDOW_S,
            capacity_persist_windows=SMOKE_PERSIST,
        )
        engine.start()
        # deliberately NOT engine.capacity.start(): windows are driven
        # below with explicit tick(t) times so the advisor's schedule is
        # deterministic however slowly the requests run
        server = make_server(engine)
        host, port = server.server_address[:2]
        threading.Thread(target=server.serve_forever, daemon=True).start()
        target = f"http://{host}:{port}"
        router = router_server = None
        try:
            health = loadgen.fetch_health(target, timeout=TIMEOUT_S)
            payloads = loadgen.make_payloads(health, [1])
            results = loadgen.Results()
            t_start = time.monotonic()

            def send_burst(n, tag):
                for i in range(n):
                    loadgen.send(target, "embed", payloads[1], 1, TIMEOUT_S, results,
                                 t_start, request_id=f"cap-{tag}-{i}")

            # one priming request BEFORE the baseline sample: the first
            # window needs a pre-burst serving_execute_ms_sum point to
            # take a delta against
            send_burst(1, "prime")
            t = 1000.0
            engine.capacity.tick(t)
            send_burst(SMOKE_BURST, "burst")
            actions = []
            for _ in range(6):  # the burst stays inside the signal window
                t += 1.0
                rec = engine.capacity.tick(t)
                actions.append(rec["action"] if rec else None)
            scale_up_window = next(
                (i + 1 for i, a in enumerate(actions) if a == ACTION_SCALE_UP), None)
            burst_signals = dict(engine.capacity.summary()["signals"])
            # quiescence: jump past the window so the burst ages out
            t += SMOKE_WINDOW_S
            quiesce = []
            for _ in range(3):
                t += 1.0
                rec = engine.capacity.tick(t)
                quiesce.append(rec["action"] if rec else None)
            snap = engine.registry.snapshot()
            captures = snap.get("serving_graph_captures", 0.0)

            # the HTTP faces of the same plane
            cap = _get_json(f"{target}/capacity", TIMEOUT_S)
            series = _get_json(f"{target}/debug/series?name=capacity_duty_cycle", TIMEOUT_S)
            listing = _get_json(f"{target}/debug/series", TIMEOUT_S)

            checks = {
                "requests_ok": results.ok == 1 + SMOKE_BURST and results.errors == 0,
                "scale_up_recommended": (
                    scale_up_window is not None and scale_up_window <= SMOKE_PERSIST),
                "scale_down_after_quiescence": quiesce[-1] == ACTION_SCALE_DOWN,
                "one_pressure_fire": engine.capacity.pressure_fired == 1,
                "zero_request_path_captures": captures == 0,
                # the advisor canonicalizes bounds (%g: 0.000001 ->
                # 1e-06), so match the parsed policy, not the spec string
                "capacity_endpoint": cap.get("role") == "replica"
                                     and cap.get("policy", "").startswith("duty<"),
                "series_endpoint": bool(series.get("series", {}).get("capacity_duty_cycle")),
                # no ceiling given: no utilization, ever
                "no_utilization_without_ceiling": (
                    burst_signals.get("util") is None
                    and "capacity_utilization" not in listing.get("names", [])
                    and "capacity_utilization" not in snap),
            }
            fleet_cap = rec_events = None
            if fleet:
                # the router leg: a router fronting the replica ingests the
                # capacity summary from /healthz and evaluates its own
                # (default-policy) fleet advisor each health pass
                from glom_tpu_torch.serving.router import FleetRouter, make_router_server

                router = FleetRouter([target], health_interval_s=0.2,
                                     health_timeout_s=TIMEOUT_S)
                router.start()
                router_server = make_router_server(router)
                threading.Thread(target=router_server.serve_forever, daemon=True).start()
                rtarget = "http://{}:{}".format(*router_server.server_address[:2])
                fleet_cap = loadgen.poll_until(
                    lambda: (lambda p: p if p.get("replicas") else None)(
                        _get_json(f"{rtarget}/capacity", TIMEOUT_S)), timeout_s=30.0)
                timeline = _get_json(f"{rtarget}/debug/timeline", TIMEOUT_S)
                rec_events = [e for e in timeline.get("events", [])
                              if e.get("event") == "capacity_recommendation"]
                checks.update({
                    "fleet_ingested": bool(fleet_cap) and fleet_cap.get("role") == "router",
                    "fleet_replica_series": bool(fleet_cap) and any(
                        n.startswith("capacity_duty_cycle{")
                        for n in fleet_cap.get("series_names", [])),
                    "fleet_recommendation_event": len(rec_events) >= 1,
                })
            ok = all(checks.values())
            return {
                "smoke": "ok" if ok else "FAILED",
                "policy": SMOKE_POLICY,
                "window_s": SMOKE_WINDOW_S,
                "persist_windows": SMOKE_PERSIST,
                "burst_actions": actions,
                "quiescence_actions": quiesce,
                "scale_up_window": scale_up_window,
                "burst_signals": burst_signals,
                "pressure_fired": engine.capacity.pressure_fired,
                "graph_captures": captures,
                "fleet_recommendation": rec_events[-1] if rec_events else None,
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
                        "router's capacity plane leg)")
    sub = p.add_subparsers(dest="cmd")
    rep = sub.add_parser("report", help="render GET /capacity")
    rep.add_argument("--url", default="http://127.0.0.1:8000")
    rep.add_argument("--timeout", type=float, default=10.0)
    rep.add_argument("--format", choices=["text", "json"], default="text")
    q = sub.add_parser("query", help="query GET /debug/series")
    q.add_argument("--url", default="http://127.0.0.1:8000")
    q.add_argument("--timeout", type=float, default=10.0)
    q.add_argument("--name", default=None,
                   help="series name (matches labeled variants too)")
    q.add_argument("--prefix", default=None, help="series key prefix")
    q.add_argument("--since", type=float, default=None,
                   help="window start; negative = relative to now")
    q.add_argument("--step", type=float, default=None,
                   help="desired resolution in seconds (selects the tier)")
    q.add_argument("--format", choices=["text", "json"], default="text")
    args = p.parse_args(argv)
    if args.fleet and not args.smoke:
        p.error("--fleet goes with --smoke")
    if args.smoke:
        report = run_smoke(args.device, args.checkpoint_dir, fleet=args.fleet)
        print(json.dumps(report, indent=2))
        return 0 if report["smoke"] == "ok" else 1
    if args.cmd == "report":
        return cmd_report(args)
    if args.cmd == "query":
        return cmd_query(args)
    p.error("need --smoke, report, or query")
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
