"""Why is it slow? — the regression-attribution CLI, the port's copy of
``tools/whyslow.py``.

Front end for :mod:`glom_tpu_torch.obs.attribution`: joins the series
store, the unified event timeline and (where recorded) compile snapshots
into one ranked causal verdict for a latency/throughput regression.

Modes::

  # a live engine: pull /debug/series + /debug/timeline, auto-detect the
  # knee, print the verdict
  python -m glom_tpu_torch.tools.whyslow --url http://127.0.0.1:8000 [--since 300]

  # recorded evidence (a dump made with --out-evidence, or either
  # package's fixture): attribute offline, byte-stable
  python -m glom_tpu_torch.tools.whyslow --evidence evidence.json

  # two loadgen reports (--timeline runs): where did p95/throughput move
  # between the before and after runs?
  python -m glom_tpu_torch.tools.whyslow --before base.json --after regressed.json

  # the acceptance loop: an induced deploy regression in-process; exactly
  # one verdict naming the deploy event and the right phase, no graph
  # captured on the request path, a byte-identical verdict on
  # re-attribution (without --device it runs on cuda)
  python -m glom_tpu_torch.tools.whyslow --smoke [--device cpu]

Exit status: 0 when a verdict (or an honest ``inconclusive``) was
produced; 1 on failed smoke checks or an unreachable target.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import urllib.request

from glom_tpu_torch.obs import attribution

#: the smoke's phases (seconds): healthy traffic, then the slow canary
SMOKE_BASELINE_S = 3.5
SMOKE_REGRESS_S = 4.5
#: the injected stall of every canary batch
SMOKE_DELAY_S = 0.15
SMOKE_WORKERS = 4
#: a flagship request's JSON body is megabytes: the smoke's HTTP timeout
TIMEOUT_S = 120.0


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="rank the causes of a serving regression")
    p.add_argument("--url", default=None,
                   help="live target: engine base URL "
                        "(/debug/series + /debug/timeline)")
    p.add_argument("--since", type=float, default=300.0,
                   help="with --url: seconds of history to attribute "
                        "over (default 300)")
    p.add_argument("--evidence", default=None, metavar="FILE",
                   help="recorded evidence JSON "
                        "({window, series, timeline, snapshots})")
    p.add_argument("--before", default=None, metavar="FILE",
                   help="loadgen report JSON for the baseline run "
                        "(pair with --after)")
    p.add_argument("--after", default=None, metavar="FILE",
                   help="loadgen report JSON for the regressed run")
    p.add_argument("--min-confidence", type=float,
                   default=attribution.MIN_CONFIDENCE,
                   help="confidence bar below which the verdict is "
                        "'inconclusive'")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--out", default=None, metavar="FILE",
                   help="also write the verdict JSON here")
    p.add_argument("--out-evidence", default=None, metavar="FILE",
                   help="with --url: dump the collected evidence (replay "
                        "later with --evidence)")
    p.add_argument("--timeout", type=float, default=10.0)
    p.add_argument("--smoke", action="store_true",
                   help="in-process induced-deploy-regression acceptance")
    p.add_argument("--device", default="cuda",
                   help="with --smoke: torch device; 'cpu' runs the plain PyTorch versions "
                        "of the kernels")
    return p.parse_args(argv)


def _get_json(url, timeout):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def collect_url_evidence(url, since_s, timeout):
    """Evidence from a live /debug plane (``/debug/series`` and
    ``/debug/timeline``, the shapes ``glom_tpu``'s engine and router also
    serve)."""
    url = url.rstrip("/")
    series = {}
    now = None
    for prefix in ("serving_", "capacity_"):
        body = _get_json(
            f"{url}/debug/series?prefix={prefix}&since={-abs(since_s)}",
            timeout)
        now = body.get("now", now)
        series.update(body.get("series") or {})
    try:
        timeline = _get_json(f"{url}/debug/timeline",
                             timeout).get("events", [])
    except Exception:  # a target without a timeline still gets phase attribution; event correlation just degrades
        timeline = []
    evidence = {"series": series, "timeline": timeline}
    if now is not None:
        evidence["window"] = {"start": float(now) - abs(since_s),
                              "end": float(now)}
    return evidence


def compare_reports(before, after):
    """The ``--before/--after`` verdict: loadgen reports carry end-state
    aggregates (and, with --timeline, windowed series), so this mode
    reports the top-line deltas and — when the after run has a windowed
    timeline — locates the knee inside it.  Phase decomposition needs
    the server-side series; point --url at the engine for that."""
    def block(rep):
        lat = rep.get("latency_ms") or {}
        return {"p95_ms": lat.get("p95"), "p50_ms": lat.get("p50"),
                "throughput_req_per_s": rep.get("throughput_req_per_s")}

    b, a = block(before), block(after)
    deltas = {}
    for k in b:
        if b[k] is not None and a[k] is not None:
            deltas[k] = round(a[k] - b[k], 3)
    knee = None
    windows = ((after.get("timeline") or {}).get("windows")) or []
    pts = [(w["t_s"], w["p95_ms"]) for w in windows
           if w.get("p95_ms") is not None]
    if pts:
        knee = attribution.find_knee(pts)
    out = {
        "schema": attribution.SCHEMA + "+report-compare",
        "before": b, "after": a, "delta": deltas,
        "knee_in_after_run": knee,
        "ground_truth_regress": after.get("regress"),
    }
    p95 = deltas.get("p95_ms")
    if p95 is not None and p95 > attribution.NOISE_FLOOR_MS:
        out["verdict"] = (f"p95 moved +{p95}ms between runs"
                          + (f"; knee at t={knee['t']}s into the after run"
                             if knee else ""))
    else:
        out["verdict"] = "inconclusive"
    return out


# ---------------------------------------------------------------------------
# --smoke: induced deploy regression -> exactly one deploy verdict
# ---------------------------------------------------------------------------
def run_smoke(device="cuda", checkpoint_dir=None, on_canary=None) -> dict:
    """The attribution acceptance: serve baseline traffic, deploy a
    deliberately slow canary (an injected candidate delay at fraction 1.0),
    keep serving, then attribute.  Must produce EXACTLY ONE cause naming
    the ``deploy_canary`` event (its step) with ``queue_wait`` carrying the
    majority phase share — the injected stall serializes the flush loop,
    so trailing requests pay it as queue time — with no graph captured on
    the request path and a byte-identical verdict on re-attribution of the
    same evidence.  Returns the report (``"smoke"`` is ``"ok"`` when every
    check holds); ``checkpoint_dir`` None serves a demo checkpoint written
    to a temporary directory (a directory given gains the candidate's
    step).  ``on_canary()``, when given, is called once the canary's graphs
    are captured, just before the regression window."""
    import tempfile
    import threading
    import time

    import numpy as np

    from glom_tpu_torch import checkpoint as ckpt_lib
    from glom_tpu_torch.resilience import faultinject
    from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint
    from glom_tpu_torch.serving.server import make_server

    with tempfile.TemporaryDirectory() as root:
        ckpt = checkpoint_dir
        if ckpt is None:
            ckpt = os.path.join(root, "ckpt")
            make_demo_checkpoint(ckpt)
        engine = ServingEngine(
            ckpt, buckets=(1, 2), max_wait_ms=1.0, warmup=True,
            reload_poll_s=0, capacity_interval_s=0.25, device=device,
        )
        engine.deploy.fault_delay_s = SMOKE_DELAY_S
        engine.start(watch=False)
        srv = make_server(engine)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = "http://{}:{}".format(*srv.server_address[:2])

        c = engine.config
        body = json.dumps({"images": np.zeros(
            (1, c.channels, c.image_size, c.image_size), np.float32).tolist()}).encode()
        stop = threading.Event()
        counts = {"ok": 0, "error": 0}
        lock = threading.Lock()

        def load(worker):
            i = 0
            while not stop.is_set():
                i += 1
                req = urllib.request.Request(
                    f"{url}/embed", data=body,
                    headers={"Content-Type": "application/json",
                             "X-Affinity-Key": f"key-{worker}-{i % 16}"})
                try:
                    with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
                        r.read()
                    with lock:
                        counts["ok"] += 1
                except Exception:  # the error count is the smoke's own acceptance signal
                    with lock:
                        counts["error"] += 1

        workers = [threading.Thread(target=load, args=(w,), daemon=True)
                   for w in range(SMOKE_WORKERS)]
        for w in workers:
            w.start()
        cand_step = int(engine.step) + 2
        try:
            # baseline phase: healthy traffic, sampler ticking
            deadline = time.monotonic() + SMOKE_BASELINE_S
            while time.monotonic() < deadline:
                engine.capacity.tick()
                time.sleep(0.1)
            # the regression: a slow candidate (the same weights as a newer
            # step) takes ALL keyed traffic
            ckpt_lib.save(ckpt, cand_step,
                          {"params": ckpt_lib.load_tree(ckpt, int(engine.step), "params")})
            step = engine.deploy.begin_canary(step=cand_step, fraction=1.0)
            if step != cand_step:
                raise RuntimeError(f"canary begin failed: {step}")
            if on_canary is not None:
                on_canary()
            with faultinject.injected("candidate:delay*1000000"):
                deadline = time.monotonic() + SMOKE_REGRESS_S
                while time.monotonic() < deadline:
                    engine.capacity.tick()
                    time.sleep(0.1)
                stop.set()
                for w in workers:
                    w.join(timeout=TIMEOUT_S)
        finally:
            stop.set()

        evidence = attribution.collect_engine_evidence(engine)
        verdict = attribution.attribute(evidence)
        rerun = attribution.attribute(json.loads(json.dumps(evidence)))
        snap = engine.registry.snapshot()

        srv.shutdown()
        srv.server_close()
        engine.shutdown(drain=False)

        top = (verdict["causes"] or [{}])[0]
        top_event = top.get("event") or {}
        top_phase = next((p for p in verdict["phases"]
                          if p.get("share") and "bucket" not in p), {})
        checks = {
            "requests_ok": counts["ok"] >= 20,
            "requests_error": counts["error"] == 0,
            "verdict_named": verdict["verdict"] != "inconclusive",
            "exactly_one_cause": len(verdict["causes"]) == 1,
            "cause_is_deploy": top.get("kind") == "event:deploy",
            "event_is_canary": top_event.get("event") == "deploy_canary",
            "event_names_step": top_event.get("step") == cand_step,
            "phase_is_queue_wait": top_phase.get("phase") == "queue_wait",
            "phase_share_majority": (top_phase.get("share") or 0) >= 0.5,
            "zero_captures": snap.get("serving_graph_captures", 0) == 0,
            "op_diff_none": verdict["op_diff"] is None,
            "bitwise_stable": (attribution.canonical_json(verdict)
                               == attribution.canonical_json(rerun)),
        }
        ok = all(checks.values())
        return {
            "smoke": "ok" if ok else "FAILED",
            "device": str(device),
            "checks": checks,
            "requests": counts,
            "verdict": verdict,
        }


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.smoke:
        report = run_smoke(args.device)
        print(json.dumps(report, indent=2))
        return 0 if report["smoke"] == "ok" else 1

    if args.before or args.after:
        if not (args.before and args.after):
            print("whyslow: --before and --after go together",
                  file=sys.stderr)
            return 1
        with open(args.before) as f:
            before = json.load(f)
        with open(args.after) as f:
            after = json.load(f)
        out = compare_reports(before, after)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=2, sort_keys=True)
        if args.format == "json":
            print(json.dumps(out, indent=2, sort_keys=True))
        else:
            print(f"verdict: {out['verdict']}")
            for k, v in sorted((out.get("delta") or {}).items()):
                print(f"  delta {k}: {v:+}")
            if out.get("knee_in_after_run"):
                print(f"  knee in after-run timeline: "
                      f"{out['knee_in_after_run']}")
        return 0

    if args.evidence:
        with open(args.evidence) as f:
            evidence = json.load(f)
    elif args.url:
        try:
            evidence = collect_url_evidence(args.url, args.since,
                                            args.timeout)
        except Exception as e:  # an unreachable target is this CLI's ordinary failure: report it, exit 1
            print(f"whyslow: cannot reach {args.url}: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            return 1
        if args.out_evidence:
            with open(args.out_evidence, "w") as f:
                json.dump(evidence, f, sort_keys=True)
    else:
        print("whyslow: need one of --url / --evidence / "
              "--before+--after / --smoke", file=sys.stderr)
        return 1

    verdict = attribution.attribute(evidence,
                                    min_confidence=args.min_confidence)
    if args.out:
        with open(args.out, "w") as f:
            f.write(attribution.canonical_json(verdict))
    if args.format == "json":
        print(json.dumps(verdict, indent=2, sort_keys=True))
    else:
        print(attribution.render_text(verdict))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
