"""Fleet observatory CLI: the port's copy of ``tools/observatory.py``.

  python -m glom_tpu_torch.tools.observatory serve --router http://127.0.0.1:8800 \\
      --incident-dir /tmp/incidents --port 8900
  python -m glom_tpu_torch.tools.observatory watch --router http://127.0.0.1:8800
  python -m glom_tpu_torch.tools.observatory watch --collector http://127.0.0.1:8900
  python -m glom_tpu_torch.tools.observatory report /tmp/incidents/incident-replica_ejection-3
  python -m glom_tpu_torch.tools.observatory --smoke [--device cpu]

``serve`` runs the :class:`glom_tpu_torch.obs.observatory.FleetObservatory`
collector — polling the router's and every replica's ``/debug/*`` pull
endpoints, stitching cross-replica traces, tail-sampling them, and writing
cross-replica incident bundles — behind a small HTTP pane (``/console``,
``/trace?id=``, ``/incidents``, ``/healthz``).

``watch`` renders the console as text, either from a running collector
(``--collector``) or by running an inline collector against a router
(``--router``).  ``--once`` renders a single frame (scripts/tests).

``report`` summarizes ONE cross-replica incident bundle: trigger + origin,
the router's ejection/rollout timeline, the offending stitched traces with
their critical paths, and each replica's evidence.

``--smoke`` is the acceptance loop: an in-process router over two of the
port's replicas (``--device``, ``cuda`` by default), a short burst with one
induced slow request; the stitched trace is retained with the whole
cross-hop span chain and its parent links, a histogram exemplar resolves
through the collector to a stored stitched trace naming its hottest phase,
and — the one difference from ``tools/observatory.py``, whose incident
starts from its replicas' ``slo_burn`` bundles — one replica's HTTP server
is shut down, the router ejects it, and exactly one ``replica_ejection``
incident bundle lands with the surviving replica's evidence (the smoke's
replicas run without a forensics directory).  ``--min-coverage`` (default 0.95) gates the best stitched
trace's span coverage, a share of wall time the host's scheduling decides;
0 turns the gate off (the CPU tests, which hold the structure only).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from glom_tpu_torch.obs import observatory as obs_mod

#: the spans a stitched /embed trace holds, router and replica sides
STITCHED_SPANS = {"router_request", "route", "proxy", "request", "queue_wait", "execute",
                  "respond"}


# ---------------------------------------------------------------------------
# console rendering (watch)
# ---------------------------------------------------------------------------
def _fmt(v, spec=".2f"):
    return "—" if v is None else format(v, spec)


def render_console(con: dict) -> str:
    lines = []
    fleet = con.get("fleet", {})
    lines.append(
        f"fleet: {fleet.get('status', '?')}   "
        f"healthy {fleet.get('healthy_replicas', '?')}   "
        f"step {fleet.get('fleet_step')}   "
        f"rollout {fleet.get('rollout_phase', 'idle')}")
    replicas = con.get("replicas", [])
    if replicas:
        lines.append("\n| replica | healthy | step | inflight | requests | errors |")
        lines.append("|---|---|---|---|---|---|")
        for r in replicas:
            lines.append(
                f"| {r.get('name')} | {'up' if r.get('healthy') else 'DOWN'}"
                f" | {r.get('step')} | {r.get('inflight')}"
                f" | {r.get('requests')} | {r.get('errors')} |")
    waste = con.get("padding_waste", {})
    if waste:
        lines.append("\n| bucket | batches | images | mean padding waste |")
        lines.append("|---|---|---|---|")
        for bucket, row in waste.items():
            mw = row.get("mean_padding_waste")
            lines.append(
                f"| {bucket} | {row.get('batches')} | {row.get('images')} | "
                f"{'—' if mw is None else f'{100 * mw:.1f}%'} |")
    burn = con.get("slo_burn_rates", {})
    for name, rates in burn.items():
        for slo, rate in rates.items():
            lines.append(f"burn {name}: {slo} = {rate}")
    capacity = con.get("capacity", {})
    cap_replicas = capacity.get("replicas", {})
    if cap_replicas:
        lines.append("\n| replica | duty | util | p95 ms | shed | trend |")
        lines.append("|---|---|---|---|---|---|")
        for name in sorted(cap_replicas):
            row = cap_replicas[name]
            lines.append(
                f"| {name} | {_fmt(row.get('duty'))} | {_fmt(row.get('util'))}"
                f" | {_fmt(row.get('p95_ms'), '.1f')} | {_fmt(row.get('shed'))}"
                f" | {row.get('trend', '—')} |")
    rec = capacity.get("recommendation")
    if rec:
        reasons = ", ".join(rec.get("reasons", [])) or "—"
        lines.append(
            f"capacity: {rec.get('action', '?')} "
            f"(persisted {rec.get('persisted', 0)})  {reasons}")
    slowest = con.get("slowest_traces", [])
    if slowest:
        lines.append("\nslowest stitched traces:")
        for t in slowest:
            path = ", ".join(f"{e['span']} {e['ms']:.2f}"
                             for e in t.get("critical_path", [])[:3])
            cov = t.get("span_coverage")
            lines.append(
                f"  {t['trace_id']}  {_fmt(t.get('duration_ms'))} ms  "
                f"[{t.get('keep_reason')}] coverage "
                f"{'—' if cov is None else f'{100 * cov:.0f}%'}  ({path})")
    sampler = con.get("sampler", {})
    lines.append(
        f"\nsampler: {sampler.get('kept_total', 0)} kept / "
        f"{sampler.get('decided', 0)} decided "
        f"{dict(sampler.get('kept', {}))}   "
        f"fraction {sampler.get('keep_fraction')}")
    events = con.get("rollout_events", [])
    if events:
        lines.append("recent fleet events:")
        for e in events[-5:]:
            extra = {k: v for k, v in e.items()
                     if k not in ("seq", "t", "event")}
            lines.append(f"  [{e.get('seq')}] {e.get('event')} {extra}")
    incidents = con.get("incidents", [])
    if incidents:
        lines.append("incidents:")
        for path in incidents:
            lines.append(f"  {path}")
    return "\n".join(lines)


def _fetch_console(url: str, timeout: float = 10.0) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"{url}/console", timeout=timeout) as r:
        return json.loads(r.read())


# ---------------------------------------------------------------------------
# incident report
# ---------------------------------------------------------------------------
def render_report(bundle_dir: str) -> dict:
    """Load one incident bundle into the report dict ``report`` prints."""
    def load(name):
        path = os.path.join(bundle_dir, name)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    manifest = load("manifest.json")
    if manifest is None:
        raise FileNotFoundError(
            f"{bundle_dir!r} has no manifest.json — not an incident bundle")
    out = {
        "bundle": bundle_dir,
        "manifest": manifest,
        "timeline": load("timeline.json"),
        "traces": load("traces.json") or [],
        "replicas": {},
    }
    for name in manifest.get("replicas", []):
        rep = load(f"replica_{name}.json")
        if rep is not None:
            out["replicas"][name] = rep
    return out


def print_report(rep: dict) -> None:
    m = rep["manifest"]
    print(f"incident: {m.get('trigger')}  origin={m.get('origin')}  "
          f"bundle={rep['bundle']}")
    print(f"detected at poll {m.get('poll')}  "
          f"created_unix {m.get('created_unix')}  "
          f"replicas: {', '.join(m.get('replicas', []))}")
    timeline = (rep.get("timeline") or {}).get("events", [])
    if timeline:
        print("\nfleet timeline (newest last):")
        for e in timeline[-10:]:
            extra = {k: v for k, v in e.items()
                     if k not in ("seq", "t", "event")}
            print(f"  [{e.get('seq')}] t={e.get('t')} {e.get('event')} {extra}")
    traces = rep.get("traces", [])
    if traces:
        print("\noffending stitched traces:")
        for t in traces:
            path = ", ".join(f"{e['span']} {e['ms']:.2f} ms"
                             for e in t.get("critical_path", [])[:4])
            print(f"  {t.get('trace_id')}  "
                  f"{_fmt(t.get('duration_ms'))} ms  "
                  f"sources={t.get('sources')}  ({path})")
    for name, rep_data in rep.get("replicas", {}).items():
        bundles = rep_data.get("bundles", [])
        reg = rep_data.get("registry", {})
        print(f"\nreplica {name}: step={rep_data.get('step')}  "
              f"{len(bundles)} local bundle(s)  "
              f"requests={reg.get('serving_requests_total')}")
        for b in bundles[-3:]:
            man = b.get("manifest", {})
            print(f"  bundle {b.get('name')}: trigger={man.get('trigger')} "
                  f"step={man.get('step')}")


# ---------------------------------------------------------------------------
# the stitched trace's join
# ---------------------------------------------------------------------------
def hop_links(spans) -> dict:
    """The parent links the cross-process join needs, checked on one
    stitched trace's spans: the ``router_request`` root has no parent in
    the trace, every ``proxy`` span parents under it, and every replica
    ``request`` span parents under a ``proxy`` span (the forwarded
    traceparent's span id).  Returns the three verdicts and the link
    counts."""
    by_id = {s.get("span_id"): s for s in spans}
    roots = [s for s in spans if s.get("name") == "router_request"]
    proxies = [s for s in spans if s.get("name") == "proxy"]
    requests = [s for s in spans if s.get("name") == "request"]
    root_ids = {s.get("span_id") for s in roots}
    proxy_ids = {s.get("span_id") for s in proxies}
    return {
        "root_is_outermost": len(roots) == 1 and roots[0].get("parent_id") not in by_id,
        "proxy_under_root": bool(proxies) and all(
            s.get("parent_id") in root_ids for s in proxies),
        "request_under_proxy": bool(requests) and all(
            s.get("parent_id") in proxy_ids for s in requests),
        "proxies": len(proxies),
        "requests": len(requests),
    }


# ---------------------------------------------------------------------------
# smoke
# ---------------------------------------------------------------------------
def run_smoke(device: str = "cuda", checkpoint_dir=None, *, min_coverage: float = 0.95,
              buckets=(1, 4)) -> dict:
    """In-process fleet + collector acceptance; returns the summary
    (``"smoke"`` is ``"ok"`` when every check holds):

      1. the router over TWO replicas, a tail sampler that keeps every
         trace over 0.05 ms (all of them) and one induced slow request (a
         full-bucket batch among singles);
      2. the collector stitches router + replica segments into ONE trace
         with the whole cross-hop chain and its parent links; its best
         stitched coverage is at least ``min_coverage`` (0: not gated);
      3. a latency-histogram exemplar scraped from ``/metrics`` resolves
         through the collector to a stored stitched trace whose critical
         path names its hottest phase;
      4. one replica's HTTP server is shut down: the router ejects it and
         exactly ONE ``replica_ejection`` incident bundle lands, holding
         the surviving replica's evidence.

    ``checkpoint_dir`` None serves a demo checkpoint written to a temporary
    directory."""
    import tempfile
    import threading
    import urllib.request

    import numpy as np

    from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint
    from glom_tpu_torch.serving.router import FleetRouter, make_router_server
    from glom_tpu_torch.serving.server import make_server

    t_start = time.monotonic()
    with tempfile.TemporaryDirectory() as root:
        ckpt = checkpoint_dir
        if ckpt is None:
            ckpt = os.path.join(root, "ckpt")
            make_demo_checkpoint(ckpt)
        incident_dir = os.path.join(root, "incidents")
        members, urls = [], []
        router = router_server = None
        try:
            for _ in range(2):
                engine = ServingEngine(ckpt, buckets=tuple(buckets), max_wait_ms=1.0,
                                       reload_poll_s=0, device=device)
                members.append([engine, None])
                engine.start()
                server = make_server(engine)
                members[-1][1] = server
                threading.Thread(target=server.serve_forever, daemon=True).start()
                host, port = server.server_address[:2]
                urls.append(f"http://{host}:{port}")
            # the health loop is not started: the ejection below is driven
            # by explicit probes, so it lands between two collector polls
            router = FleetRouter(urls, health_interval_s=0.2, eject_after=2)
            router.check_health_once(force=True)
            router_server = make_router_server(router)
            threading.Thread(target=router_server.serve_forever, daemon=True).start()
            rhost, rport = router_server.server_address[:2]
            router_url = f"http://{rhost}:{rport}"
            observatory = obs_mod.FleetObservatory(
                router_url, sampler=obs_mod.TailSampler(keep_fraction=0.0, seed=0, slo_ms=0.05),
                incident_dir=incident_dir, linger_polls=1, http_timeout_s=60.0)

            health = json.loads(urllib.request.urlopen(f"{router_url}/healthz",
                                                       timeout=60).read())
            c, s = health["channels"], health["image_size"]
            rng = np.random.RandomState(0)

            def post(batch, rid):
                body = json.dumps({"images": rng.randn(batch, c, s, s).astype(
                    "float32").tolist()}).encode()
                req = urllib.request.Request(
                    f"{router_url}/embed", data=body,
                    headers={"Content-Type": "application/json", "X-Request-Id": rid})
                urllib.request.urlopen(req, timeout=120).read()

            # absorb pre-existing state, then the burst: singles plus ONE
            # induced slow request (a full bucket)
            observatory.poll_once()
            for i in range(12):
                post(1, f"smoke-{i}")
            post(max(buckets), "smoke-slow")
            time.sleep(0.3)
            observatory.poll_once()
            observatory.flush()
            observatory.poll_once()

            failures = []
            # -- 1, 2: the stitched trace and its chain ----------------------
            stitched = observatory.resolve_exemplar("smoke-slow")
            links = hop_links(stitched["spans"]) if stitched else None
            coverage = None
            if stitched is None:
                failures.append("induced slow trace was not retained")
            else:
                names = {sp["name"] for sp in stitched["spans"]}
                if not STITCHED_SPANS <= names:
                    failures.append(f"stitched chain incomplete: missing "
                                    f"{sorted(STITCHED_SPANS - names)}")
                if not stitched.get("stitched"):
                    failures.append("trace was not cross-process stitched")
                if not (links["root_is_outermost"] and links["proxy_under_root"]
                        and links["request_under_proxy"]):
                    failures.append(f"stitched parent links broken: {links}")
                coverage = max([t.get("span_coverage") or 0.0
                                for t in observatory.traces.values() if t.get("stitched")]
                               or [stitched.get("span_coverage") or 0.0])
                if coverage < min_coverage:
                    failures.append(f"best stitched coverage {coverage} < {min_coverage}")

            # -- 3: an exemplar resolves to a stored stitched trace -----------
            exemplars = [ex for ex in observatory.pull_exemplars()
                         if ex["family"].endswith("router_request_ms")]
            resolved = None
            for ex in sorted(exemplars, key=lambda e: -float(e["value"])):
                resolved = observatory.resolve_exemplar(ex["trace_id"])
                if resolved is not None:
                    break
            hot_phase = None
            if resolved is None:
                failures.append("no /metrics exemplar resolved to a stored stitched trace")
            else:
                path = resolved.get("critical_path") or []
                hot_phase = path[0]["span"] if path else None
                if hot_phase is None:
                    failures.append("resolved trace has no critical path")

            # -- 4: an ejection, one incident bundle --------------------------
            dead_engine, dead_server = members[1]
            dead_server.shutdown()
            dead_server.server_close()
            for _ in range(router.eject_after):
                router.check_health_once(force=True)
            observatory.poll_once()
            bundles = sorted(os.listdir(incident_dir)) if os.path.isdir(incident_dir) else []
            if len(bundles) != 1:
                failures.append(f"expected exactly 1 incident bundle, got {bundles}")
            replica_files = []
            trigger = None
            if bundles:
                bundle_path = os.path.join(incident_dir, bundles[0])
                replica_files = sorted(f for f in os.listdir(bundle_path)
                                       if f.startswith("replica_"))
                rep = render_report(bundle_path)
                trigger = rep["manifest"].get("trigger")
                if trigger != "replica_ejection" or rep["manifest"].get("origin") != "r1":
                    failures.append(f"incident is {trigger} of "
                                    f"{rep['manifest'].get('origin')}, not r1's ejection")
                if replica_files != ["replica_r0.json"]:
                    failures.append(f"incident evidence {replica_files}, want the "
                                    f"survivor's replica_r0.json")
            return {
                "smoke": "ok" if not failures else "FAILED",
                "failures": failures,
                "device": str(members[0][0].device),
                "wall_s": round(time.monotonic() - t_start, 2),
                "stitched_coverage": None if coverage is None else round(coverage, 4),
                "min_coverage": min_coverage,
                "hop_links": links,
                "hot_phase": hot_phase,
                "kept": observatory.sampler.stats()["kept"],
                "incidents": bundles,
                "incident_trigger": trigger,
                "replica_evidence_files": replica_files,
                "console_replicas": [
                    {k: r[k] for k in ("name", "healthy", "step")}
                    for r in observatory.console()["replicas"]],
            }
        finally:
            if router_server is not None:
                router.shutdown()
                router_server.shutdown()
                router_server.server_close()
            for engine, server in members:
                if server is not None:
                    # both return at once for the server the smoke shut down
                    server.shutdown()
                    server.server_close()
                engine.shutdown(drain=False)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="GLOM fleet observatory (the port's): cross-replica trace "
                    "stitching, tail sampling, incident correlation")
    p.add_argument("mode", nargs="?", default=None,
                   choices=["serve", "watch", "report"],
                   help="serve the collector, watch the console, or "
                        "render an incident bundle")
    p.add_argument("bundle", nargs="?", default=None,
                   help="report mode: incident bundle directory")
    p.add_argument("--router", default=None,
                   help="router base URL (source of replica discovery)")
    p.add_argument("--replica", action="append", default=None,
                   metavar="NAME=URL",
                   help="explicit replica source (repeatable; no router "
                        "needed)")
    p.add_argument("--collector", default=None,
                   help="watch mode: read /console from a running "
                        "collector instead of polling inline")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8900,
                   help="serve mode: collector HTTP port")
    p.add_argument("--poll-s", type=float, default=1.0,
                   help="collector poll period")
    p.add_argument("--interval", type=float, default=2.0,
                   help="watch mode: refresh period")
    p.add_argument("--once", action="store_true",
                   help="watch mode: render one frame and exit")
    p.add_argument("--sample", type=float, default=0.1,
                   help="tail sampler: fraction of healthy traces kept "
                        "(errors/SLO/slow are always kept)")
    p.add_argument("--seed", type=int, default=0,
                   help="tail sampler rng seed (decisions are "
                        "deterministic per seed)")
    p.add_argument("--slo-ms", type=float, default=None,
                   help="tail sampler: retain every trace slower than this")
    p.add_argument("--incident-dir", default=None,
                   help="write cross-replica incident bundles here")
    p.add_argument("--format", choices=["text", "json"], default="text")
    p.add_argument("--smoke", action="store_true",
                   help="in-process fleet+collector acceptance run "
                        "(exit status is the signal)")
    p.add_argument("--device", default="cuda",
                   help="with --smoke: torch device of the replicas; 'cpu' runs the plain "
                        "PyTorch versions of the kernels")
    p.add_argument("--min-coverage", type=float, default=0.95,
                   help="with --smoke: the best stitched trace's span coverage must reach "
                        "this (0: report it only)")
    args = p.parse_args(argv)

    if args.smoke:
        summary = run_smoke(args.device, min_coverage=args.min_coverage)
        print(json.dumps(summary, indent=2))
        return 0 if summary["smoke"] == "ok" else 1
    if args.mode == "report":
        if not args.bundle:
            p.error("report mode needs a bundle directory")
        try:
            rep = render_report(args.bundle)
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        if args.format == "json":
            print(json.dumps(rep))
        else:
            print_report(rep)
        return 0

    replicas = None
    if args.replica:
        replicas = {}
        for spec in args.replica:
            name, sep, url = spec.partition("=")
            if not sep or not name or not url:
                p.error(f"--replica wants NAME=URL, got {spec!r}")
            replicas[name] = url

    if args.mode == "watch":
        if args.collector:
            while True:
                con = _fetch_console(args.collector)
                print(render_console(con))
                if args.once:
                    return 0
                time.sleep(args.interval)
        if not (args.router or replicas):
            p.error("watch mode needs --collector, --router, or --replica")
        observatory = obs_mod.FleetObservatory(
            args.router, replicas=replicas,
            sampler=obs_mod.TailSampler(args.sample, seed=args.seed,
                                        slo_ms=args.slo_ms),
            poll_interval_s=args.poll_s, incident_dir=args.incident_dir)
        while True:
            observatory.poll_once()
            print(render_console(observatory.console()))
            if args.once:
                return 0
            time.sleep(args.interval)

    if args.mode != "serve":
        p.error("pick a mode: serve | watch | report (or --smoke)")
    if not (args.router or replicas):
        p.error("serve mode needs --router and/or --replica")
    observatory = obs_mod.FleetObservatory(
        args.router, replicas=replicas,
        sampler=obs_mod.TailSampler(args.sample, seed=args.seed,
                                    slo_ms=args.slo_ms),
        poll_interval_s=args.poll_s, incident_dir=args.incident_dir)
    observatory.start()
    server = obs_mod.make_observatory_server(observatory, args.host,
                                             args.port)
    host, port = server.server_address[:2]
    print(json.dumps({"event": "observing", "host": host, "port": port,
                      "router": args.router,
                      "incident_dir": args.incident_dir}), flush=True)
    try:
        server.serve_forever(poll_interval=0.2)
    except KeyboardInterrupt:
        pass
    finally:
        observatory.shutdown()
        server.server_close()
        print(json.dumps({"event": "observatory_stopped"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
