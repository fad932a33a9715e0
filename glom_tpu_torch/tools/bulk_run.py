"""Bulk-tier CLI: the port's copy of ``tools/bulk_run.py``.

    python -m glom_tpu_torch.tools.bulk_run submit --url http://127.0.0.1:8000 \\
        --name embed-corpus --dataset synthetic:4096 --transform embed \\
        --sink /data/out/embed-corpus
    python -m glom_tpu_torch.tools.bulk_run status --url http://127.0.0.1:8000
    python -m glom_tpu_torch.tools.bulk_run watch --url http://127.0.0.1:8000 \\
        --name embed-corpus
    python -m glom_tpu_torch.tools.bulk_run cancel --url http://127.0.0.1:8000 \\
        --name embed-corpus
    python -m glom_tpu_torch.tools.bulk_run --smoke [--device cpu]

``submit``/``status``/``watch``/``cancel`` speak the ``/admin/jobs/*``
surface of a serving engine started with ``--bulk-dir`` (or of a fleet
router in front of such engines, which shards ``[0, total)`` across its
healthy replicas), over plain stdlib HTTP.  ``--format json`` prints raw
bodies.

``--smoke`` pins the exactly-once resume contract end to end: a control
engine runs a synthetic job uninterrupted; a second engine takes the same
job over HTTP and is KILLED mid-job (``shutdown(drain=False)``: staged
chunks die un-acknowledged); a third engine adopting the same job store
resumes from the durable cursor and finishes.  The interrupted and resumed
output must be **bitwise identical** to the uninterrupted control, and no
engine may capture a graph on the request path (``serving_graph_captures``
stays 0 after warm-up): bulk rows replay the graphs captured at start-up.
Without ``--device`` the smoke runs on ``cuda``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.error
import urllib.parse
import urllib.request

#: smoke job size: not a multiple of the largest smoke bucket (4), so the
#: tail chunk exercises the partial-fill path
SMOKE_TOTAL = 37
SMOKE_SEED = 7
SMOKE_BUCKETS = (1, 4)


def _get_json(url: str, timeout: float = 10.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _post_json(url: str, payload: dict, timeout: float = 10.0) -> dict:
    body = json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        doc = {}
        try:
            doc = json.loads(e.read())
        except (ValueError, OSError):
            pass  # non-JSON error body: fall back to the HTTP reason
        raise SystemExit(
            f"error: HTTP {e.code} from {url}: "
            f"{doc.get('error', e.reason)}")


# ---------------------------------------------------------------------------
# submit / status / watch / cancel
# ---------------------------------------------------------------------------
def _print_status(doc: dict) -> None:
    if "jobs" in doc:  # summary shape (no --name)
        jobs = doc.get("jobs", {})
        if not jobs:
            print("no jobs")
        else:
            print("| job | status | done | total |")
            print("|---|---|---|---|")
            for name in sorted(jobs):
                st = jobs[name]
                print(f"| {name} | {st.get('status')} | {st.get('done')}"
                      f" | {st.get('total')} |")
        print(f"backlog: {doc.get('backlog')} slots", end="")
        if doc.get("rate_slots_per_s") is not None:
            print(f"   scavenging {doc['rate_slots_per_s']} slots/s"
                  f"   eta {doc.get('eta_s')}s", end="")
        print()
        return
    print(f"{doc.get('name')}: {doc.get('status')}   "
          f"{doc.get('done')}/{doc.get('total')} slots")
    for s in doc.get("shards", []):
        print(f"  shard [{s['lo']}, {s['hi']})  cursor={s['cursor']}  "
              f"owner={s.get('owner')}")


def cmd_submit(args) -> int:
    payload = {"name": args.name, "dataset": args.dataset,
               "transform": args.transform, "sink": args.sink,
               "seed": args.seed}
    if args.total is not None:
        payload["total"] = args.total
    doc = _post_json(f"{args.url.rstrip('/')}/admin/jobs/submit",
                     payload, args.timeout)
    if args.format == "json":
        print(json.dumps(doc, indent=2))
    else:
        _print_status(doc)
    return 0


def cmd_status(args) -> int:
    url = f"{args.url.rstrip('/')}/admin/jobs/status"
    if args.name:
        url += "?" + urllib.parse.urlencode({"name": args.name})
    doc = _get_json(url, args.timeout)
    if args.format == "json":
        print(json.dumps(doc, indent=2))
    else:
        _print_status(doc)
    return 0


def cmd_watch(args) -> int:
    url = (f"{args.url.rstrip('/')}/admin/jobs/status?"
           + urllib.parse.urlencode({"name": args.name}))
    deadline = time.monotonic() + args.watch_timeout
    last = None
    while time.monotonic() < deadline:
        doc = _get_json(url, args.timeout)
        line = (doc.get("status"), doc.get("done"))
        if line != last:
            last = line
            if args.format == "json":
                print(json.dumps(doc))
            else:
                print(f"{doc.get('name')}: {doc.get('status')}   "
                      f"{doc.get('done')}/{doc.get('total')} slots")
        if doc.get("status") in ("done", "cancelled"):
            return 0 if doc["status"] == "done" else 1
        time.sleep(args.interval)
    print(f"watch timed out after {args.watch_timeout}s", file=sys.stderr)
    return 1


def cmd_cancel(args) -> int:
    doc = _post_json(f"{args.url.rstrip('/')}/admin/jobs/cancel",
                     {"name": args.name}, args.timeout)
    if args.format == "json":
        print(json.dumps(doc, indent=2))
    else:
        _print_status(doc) if "name" in doc else print(json.dumps(doc))
    return 0


# ---------------------------------------------------------------------------
# the smoke: kill mid-job -> resume -> bitwise-identical output
# ---------------------------------------------------------------------------
def _poll_until(fn, timeout_s: float = 120.0, interval_s: float = 0.005):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(interval_s)
    return None


def run_smoke(device="cuda", checkpoint_dir=None, buckets=SMOKE_BUCKETS,
              total: int = SMOKE_TOTAL, workdir=None) -> dict:
    """The kill-and-resume acceptance loop; returns the report (``"smoke"``
    is ``"ok"`` when every check holds).  ``checkpoint_dir`` None serves a
    demo checkpoint written to a temporary directory; the stores and sinks
    go under ``workdir`` (a temporary directory when None).  The assembled
    outputs are kept in the report's ``outputs`` (control, resumed) for a
    caller that holds them to more."""
    import tempfile
    import threading

    from glom_tpu_torch.bulk.jobs import ChunkSink, JobStore
    from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint
    from glom_tpu_torch.serving.server import make_server

    with tempfile.TemporaryDirectory(dir=workdir) as d:
        ckpt = checkpoint_dir
        if ckpt is None:
            ckpt = os.path.join(d, "ckpt")
            make_demo_checkpoint(ckpt)

        def payload(sink):
            return {"name": "smoke", "dataset": f"synthetic:{total}",
                    "transform": "embed", "sink": sink, "seed": SMOKE_SEED}

        def engine(store):
            return ServingEngine(ckpt, buckets=tuple(buckets), max_wait_ms=1.0,
                                 warmup=True, reload_poll_s=0, device=device,
                                 bulk_dir=store)

        def captures(eng):
            return eng.registry.snapshot().get("serving_graph_captures", 0.0)

        # -- control: the same job, never interrupted ------------------
        ctrl_sink = os.path.join(d, "ctrl_out")
        eng = engine(os.path.join(d, "ctrl_store"))
        eng.bulk.idle_poll_s = 0.001
        eng.start()
        t0 = time.perf_counter()
        eng.bulk.submit(payload(ctrl_sink))
        ctrl_done = _poll_until(
            lambda: eng.bulk.status("smoke")["status"] == "done")
        ctrl_s = time.perf_counter() - t0
        ctrl_captures = captures(eng)
        eng.shutdown()
        del eng
        ref = ChunkSink(ctrl_sink).assemble(total)

        # -- interrupted: submit over HTTP, kill the replica mid-job ---
        out_sink = os.path.join(d, "out")
        store = os.path.join(d, "store")
        eng1 = engine(store)
        # slow the idle loop down so the kill reliably lands mid-job
        # (one chunk per 250 ms leaves the whole teardown inside the
        # window between two commits)
        eng1.bulk.idle_poll_s = 0.25
        eng1.start()
        srv = make_server(eng1)
        host, port = srv.server_address[:2]
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        target = f"http://{host}:{port}"
        _post_json(f"{target}/admin/jobs/submit", payload(out_sink))
        mid = _poll_until(lambda: (lambda st:
                                   st if 0 < st["done"] < total
                                   else None)(
            _get_json(f"{target}/admin/jobs/status?name=smoke")),
            interval_s=0.001)
        captures1 = captures(eng1)
        # the kill: abrupt, no drain — staged chunks die un-acknowledged
        srv.shutdown()
        srv.server_close()
        eng1.shutdown(drain=False, timeout=5)
        del eng1
        durable_done = JobStore(store).status("smoke")["done"]

        # -- resume: a fresh engine adopts the same job store ----------
        eng2 = engine(store)
        eng2.bulk.idle_poll_s = 0.001
        eng2.start()
        resumed = _poll_until(
            lambda: eng2.bulk.status("smoke")["status"] == "done")
        captures2 = captures(eng2)
        eng2.shutdown()
        del eng2
        got = ChunkSink(out_sink).assemble(total)

        checks = {
            "control_completed": bool(ctrl_done),
            "killed_mid_job": bool(mid) and 0 < durable_done < total,
            "resumed_to_done": bool(resumed),
            "bitwise_identical": (got.shape == ref.shape
                                  and got.dtype == ref.dtype
                                  and got.tobytes() == ref.tobytes()),
            "zero_request_path_captures": (ctrl_captures == 0
                                           and captures1 == 0
                                           and captures2 == 0),
        }
        ok = all(checks.values())
        return {
            "smoke": "ok" if ok else "FAILED",
            "device": str(device),
            "buckets": list(buckets),
            "total_slots": total,
            "control_seconds": ctrl_s,
            "durable_done_at_kill": durable_done,
            "done_when_killed_observed": mid and mid["done"],
            "graph_captures": [ctrl_captures, captures1, captures2],
            "checks": checks,
            "outputs": (ref, got),
        }


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--smoke", action="store_true",
                   help="kill-resume exactly-once acceptance loop")
    p.add_argument("--device", default="cuda",
                   help="with --smoke: torch device; 'cpu' runs the plain PyTorch versions "
                        "of the kernels")
    sub = p.add_subparsers(dest="cmd")

    def common(sp, name_required=True):
        sp.add_argument("--url", default="http://127.0.0.1:8000")
        sp.add_argument("--timeout", type=float, default=10.0)
        sp.add_argument("--format", choices=["text", "json"],
                        default="text")
        if name_required is not None:
            sp.add_argument("--name", required=name_required,
                            default=None, help="job name")

    s = sub.add_parser("submit", help="POST /admin/jobs/submit")
    common(s)
    s.add_argument("--dataset", required=True,
                   help="'synthetic:<N>' or a .npy glob")
    s.add_argument("--transform", default="embed",
                   choices=["embed", "reconstruct", "index"],
                   help="index: the level index /similar reads (the sink is "
                        "the server's --index-dir)")
    s.add_argument("--sink", required=True,
                   help="output part-file directory")
    s.add_argument("--total", type=int, default=None,
                   help="slots to process (default: dataset length; "
                        "required for synthetic datasets on a router)")
    s.add_argument("--seed", type=int, default=0)
    st = sub.add_parser("status", help="GET /admin/jobs/status")
    common(st, name_required=False)
    w = sub.add_parser("watch", help="poll status until done/cancelled")
    common(w)
    w.add_argument("--interval", type=float, default=0.5)
    w.add_argument("--watch-timeout", type=float, default=3600.0)
    c = sub.add_parser("cancel", help="POST /admin/jobs/cancel")
    common(c)
    args = p.parse_args(argv)
    if args.smoke:
        report = run_smoke(args.device)
        report.pop("outputs")
        print(json.dumps(report, indent=2))
        return 0 if report["smoke"] == "ok" else 1
    handlers = {"submit": cmd_submit, "status": cmd_status,
                "watch": cmd_watch, "cancel": cmd_cancel}
    if args.cmd in handlers:
        return handlers[args.cmd](args)
    p.error("need --smoke or one of: submit, status, watch, cancel")
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
