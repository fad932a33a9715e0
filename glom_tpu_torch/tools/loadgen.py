"""Load generator for the port's server (stdlib HTTP, JSON report): the
port's copy of ``tools/loadgen.py``'s driving modes and report.

    python -m glom_tpu_torch.tools.loadgen --url http://127.0.0.1:8000 \\
        --duration 5 --concurrency 8 --batch-sizes 1,2,3,4,5,6,7,8
    python -m glom_tpu_torch.tools.loadgen --url http://127.0.0.1:8000 \\
        --rate 50 --duration 10

* **closed loop** (default): ``--concurrency`` workers each keep one request
  in flight, for ``--requests`` requests or, with ``--duration`` and no
  ``--rate``, for that many seconds: the server's sustainable throughput and
  the latency at it;
* **open loop** (``--rate R``): request ``i`` fires at ``i / R`` seconds
  whether or not earlier ones finished: latency under an offered load,
  queueing and shedding included.

Batch sizes cycle through ``--batch-sizes``; the image contract (size,
channels) is read from ``/healthz``.  Every request carries an
``X-Request-Id`` (``lg-<pid>-<seq>``) that the server must echo; a missing
echo counts in ``request_id_mismatches``.  The report is one JSON object
with ``tools/loadgen.py``'s keys: p50/p95/p99/mean/max latency (ms), the
achieved request and image rates, and the ok, shed and error counts.  Below
:data:`MIN_TAIL_SAMPLES` answered requests p95 and p99 are null: on fewer
samples they are the slowest request or two, not a tail.  The
session, tenant, parse and router scenarios of ``tools/loadgen.py`` wait for
their modules in the port.  Exit 0 when no request failed and every id was
echoed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import threading
import time
import urllib.error
import urllib.request

# answered requests below which the report's p95 and p99 are null
MIN_TAIL_SAMPLES = 100


def percentile(xs, q):
    """Nearest-rank percentile (the obs registry's rule)."""
    if not xs:
        return None
    ordered = sorted(xs)
    rank = min(len(ordered) - 1, max(0, math.ceil(q / 100.0 * len(ordered)) - 1))
    return ordered[rank]


def fetch_health(url, timeout):
    with urllib.request.urlopen(f"{url}/healthz", timeout=timeout) as r:
        return json.loads(r.read())


def make_payloads(health, batch_sizes, seed=0):
    """One JSON body per batch size, built once (the load generator's time
    goes to the network path, not to ``json.dumps``)."""
    import numpy as np

    c, s = health["channels"], health["image_size"]
    rng = np.random.RandomState(seed)
    return {b: json.dumps({"images": rng.randn(b, c, s, s).astype("float32").tolist()}).encode()
            for b in batch_sizes}


class Results:
    """What the requests came back with, recorded from many threads.
    ``corrupted`` and ``regressed`` stay 0 here (their scenarios are not
    ported) and are reported so the report keeps ``tools/loadgen.py``'s keys."""

    def __init__(self):
        self.lock = threading.Lock()
        self.latencies_ms = []
        self.samples = []        # (latency_ms, request_id) for --slow-n
        self.images_ok = 0
        self.ok = 0
        self.shed = 0
        self.errors = 0
        self.corrupted = 0
        self.regressed = 0
        self.id_mismatches = 0   # X-Request-Id failed to round-trip
        self.replicas = {}       # per target URL when several are sprayed
        self.endpoints = {}      # per endpoint with a comma mix

    def _rec(self, table, key):
        rec = table.get(key)
        if rec is None:
            rec = table[key] = {"latencies_ms": [], "ok": 0, "shed": 0, "errors": 0}
            if table is self.replicas:
                rec["images_ok"] = 0
        return rec

    def record(self, latency_ms=None, images=0, shed=False, error=False, request_id=None,
               id_mismatch=False, replica=None, endpoint=None):
        with self.lock:
            recs = [self._rec(self.replicas, replica) if replica is not None else None,
                    self._rec(self.endpoints, endpoint) if endpoint is not None else None]
            recs = [r for r in recs if r is not None]
            if id_mismatch:
                self.id_mismatches += 1
            if shed:
                self.shed += 1
                for r in recs:
                    r["shed"] += 1
            elif error:
                self.errors += 1
                for r in recs:
                    r["errors"] += 1
            else:
                self.ok += 1
                self.images_ok += images
                self.latencies_ms.append(latency_ms)
                if request_id is not None:
                    self.samples.append((latency_ms, request_id))
                for r in recs:
                    r["ok"] += 1
                    r["latencies_ms"].append(latency_ms)
                    if "images_ok" in r:
                        r["images_ok"] += images

    def slowest(self, n):
        with self.lock:
            return sorted(self.samples, reverse=True)[:n]


def run_closed(urls, endpoints, payloads, batch_sizes, n_requests, concurrency, timeout,
               results, duration=None):
    """``concurrency`` workers, one request in flight each, until
    ``n_requests`` were sent or ``duration`` seconds passed (whichever is
    given; both: whichever comes first).  Returns the wall seconds."""
    idx_lock = threading.Lock()
    counter = [0]
    t_start = time.monotonic()
    stop_at = None if duration is None else t_start + duration

    def worker():
        while True:
            with idx_lock:
                i = counter[0]
                if (n_requests is not None and i >= n_requests) or (
                        stop_at is not None and time.monotonic() >= stop_at):
                    return
                counter[0] += 1
            # the batch size advances once per round of targets, so every
            # target sees every size
            b = batch_sizes[(i // len(urls)) % len(batch_sizes)]
            send(urls[i % len(urls)], endpoints[i % len(endpoints)], payloads[b], b, timeout,
                 results, time.monotonic(), request_id=f"lg-{os.getpid()}-{i}",
                 multi_target=len(urls) > 1)

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.monotonic() - t_start


def run_open(urls, endpoints, payloads, batch_sizes, rate, duration, timeout, results):
    """Fixed arrival schedule: request ``i`` fires at ``i / rate`` seconds
    whether or not earlier ones finished (one thread per in-flight
    request).  Returns the wall seconds."""
    n = max(1, int(rate * duration))
    threads = []
    t_start = time.monotonic()
    for i in range(n):
        delay = t_start + i / rate - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        b = batch_sizes[(i // len(urls)) % len(batch_sizes)]
        t = threading.Thread(
            target=send,
            args=(urls[i % len(urls)], endpoints[i % len(endpoints)], payloads[b], b, timeout,
                  results, time.monotonic()),
            kwargs={"request_id": f"lg-{os.getpid()}-{i}", "multi_target": len(urls) > 1},
            daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=timeout)
    return time.monotonic() - t_start


def send(url, endpoint, body, n_images, timeout, results, t0, request_id=None,
         multi_target=False):
    """One request; its outcome recorded in ``results`` (503: shed; any other
    failure: an error)."""
    headers = {"Content-Type": "application/json"}
    if request_id is not None:
        headers["X-Request-Id"] = request_id
    req = urllib.request.Request(f"{url}/{endpoint}", data=body, headers=headers)
    replica = url if multi_target else None
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            echoed = r.headers.get("X-Request-Id")
            json.loads(r.read())
    except urllib.error.HTTPError as e:
        echoed = e.headers.get("X-Request-Id")
        e.read()
        results.record(shed=(e.code == 503), error=(e.code != 503),
                       id_mismatch=(request_id is not None and echoed != request_id),
                       replica=replica, endpoint=endpoint)
        return
    except Exception:  # a load generator keeps offering load through any one failure
        results.record(error=True, replica=replica, endpoint=endpoint)
        return
    results.record(latency_ms=(time.monotonic() - t0) * 1e3, images=n_images,
                   request_id=request_id,
                   id_mismatch=(request_id is not None and echoed != request_id),
                   replica=replica, endpoint=endpoint)


def _latency(xs, keys=("p50", "p95", "p99"), min_tail=0):
    return {k: round(percentile(xs, int(k[1:])), 3)
            if xs and (k == "p50" or len(xs) >= min_tail) else None for k in keys}


def report(results, wall_s, mode, slow_n=0, min_tail=0):
    """The run as one JSON-ready dict, ``tools/loadgen.py``'s report (which
    it equals with ``min_tail=0``).  With fewer than ``min_tail`` latencies,
    p95 and p99 are None and ``latency_samples`` says how many there were."""
    lat = results.latencies_ms
    out = {
        "mode": mode,
        "requests_ok": results.ok,
        "requests_shed": results.shed,
        "requests_error": results.errors,
        "requests_corrupted": results.corrupted,
        "requests_regressed": results.regressed,
        "request_id_mismatches": results.id_mismatches,
        "images_ok": results.images_ok,
        "wall_seconds": round(wall_s, 3),
        "throughput_req_per_s": round(results.ok / wall_s, 2) if wall_s else None,
        "throughput_imgs_per_s": round(results.images_ok / wall_s, 2) if wall_s else None,
        "latency_ms": {
            **_latency(lat, min_tail=min_tail),
            "mean": round(sum(lat) / len(lat), 3) if lat else None,
            "max": round(max(lat), 3) if lat else None,
        },
    }
    if len(lat) < min_tail:
        out["latency_samples"] = len(lat)
    if slow_n:
        out["slowest"] = [{"request_id": rid, "latency_ms": round(ms, 3)}
                          for ms, rid in results.slowest(slow_n)]
    if len(results.endpoints) > 1:
        out["per_endpoint"] = {
            key: {"requests_ok": rec["ok"], "requests_shed": rec["shed"],
                  "requests_error": rec["errors"],
                  "latency_ms": _latency(rec["latencies_ms"], ("p50", "p95"), min_tail)}
            for key, rec in sorted(results.endpoints.items())}
    if results.replicas:
        out["per_replica"] = {
            key: {"requests_ok": rec["ok"], "requests_shed": rec["shed"],
                  "requests_error": rec["errors"], "images_ok": rec["images_ok"],
                  "throughput_req_per_s": round(rec["ok"] / wall_s, 2) if wall_s else None,
                  "latency_ms": _latency(rec["latencies_ms"], min_tail=min_tail)}
            for key, rec in sorted(results.replicas.items())}
    return out


def run(url, *, endpoints=("embed",), batch_sizes=(1, 2, 3), concurrency=4, requests=None,
        rate=0.0, duration=None, timeout=60.0, targets=None, slow_n=0, health=None) -> dict:
    """Drive a server (or several ``targets``) and return the report:
    an open loop at ``rate`` for ``duration`` seconds when ``rate > 0``,
    else a closed loop of ``concurrency`` for ``requests`` requests or
    ``duration`` seconds."""
    urls = [u.rstrip("/") for u in (targets or [url])]
    endpoints, batch_sizes = list(endpoints), list(batch_sizes)
    health = health if health is not None else fetch_health(urls[0], timeout)
    payloads = make_payloads(health, batch_sizes)
    results = Results()
    if rate > 0:
        wall = run_open(urls, endpoints, payloads, batch_sizes, rate,
                        duration if duration is not None else 5.0, timeout, results)
        mode = f"open({rate}/s)"
    else:
        if requests is None and duration is None:
            requests = 100
        wall = run_closed(urls, endpoints, payloads, batch_sizes, requests, concurrency,
                          timeout, results, duration=duration)
        mode = f"closed(c={concurrency})"
    if len(endpoints) > 1:
        mode += f" endpoints({','.join(endpoints)})"
    if len(urls) > 1:
        mode += f" x{len(urls)} targets"
    return report(results, wall, mode, slow_n=slow_n, min_tail=MIN_TAIL_SAMPLES)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="GLOM serving load generator (the port's)")
    p.add_argument("--url", default="http://127.0.0.1:8000")
    p.add_argument("--target", action="append", default=None, metavar="URL",
                   help="repeatable: spray requests across several servers; overrides --url")
    p.add_argument("--endpoint", default="embed",
                   help="comma-cycled endpoint mix from {embed,reconstruct}")
    p.add_argument("--requests", type=int, default=None,
                   help="closed loop: total requests (default 100 without --duration)")
    p.add_argument("--concurrency", type=int, default=4, help="closed loop: in-flight requests")
    p.add_argument("--rate", type=float, default=0.0,
                   help="open loop: requests/s arrival rate (0 = closed loop)")
    p.add_argument("--duration", type=float, default=None,
                   help="seconds to run: the open loop's length (default 5), or a closed "
                        "loop's time limit")
    p.add_argument("--batch-sizes", default="1,2,3", help="per-request image counts, cycled")
    p.add_argument("--timeout", type=float, default=60.0,
                   help="per-request HTTP timeout (seconds)")
    p.add_argument("--slow-n", type=int, default=0, help="list the N slowest request ids")
    args = p.parse_args(argv)
    endpoints = [e.strip() for e in args.endpoint.split(",") if e.strip()]
    if not endpoints or any(e not in ("embed", "reconstruct") for e in endpoints):
        print(f"loadgen: bad --endpoint {args.endpoint!r} (want a comma mix of "
              f"embed,reconstruct)", file=sys.stderr)
        return 2
    out = run(args.url, endpoints=endpoints,
              batch_sizes=[int(b) for b in args.batch_sizes.split(",")],
              concurrency=args.concurrency, requests=args.requests, rate=args.rate,
              duration=args.duration, timeout=args.timeout, targets=args.target,
              slow_n=args.slow_n)
    print(json.dumps(out, indent=2))
    return 0 if out["requests_error"] == 0 and out["request_id_mismatches"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
