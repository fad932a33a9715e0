"""Load generator for the port's server (stdlib HTTP, JSON report): the
port's copy of ``tools/loadgen.py``'s driving modes and report.

    python -m glom_tpu_torch.tools.loadgen --url http://127.0.0.1:8000 \\
        --duration 5 --concurrency 8 --batch-sizes 1,2,3,4,5,6,7,8
    python -m glom_tpu_torch.tools.loadgen --url http://127.0.0.1:8000 \\
        --rate 50 --duration 10
    python -m glom_tpu_torch.tools.loadgen --url http://127.0.0.1:8000 \\
        --sessions 4 --frames 16
    python -m glom_tpu_torch.tools.loadgen --url http://127.0.0.1:8000 \\
        --tenant a:3 --tenant b:1 --requests 100

* **closed loop** (default): ``--concurrency`` workers each keep one request
  in flight, for ``--requests`` requests or, with ``--duration`` and no
  ``--rate``, for that many seconds: the server's sustainable throughput and
  the latency at it;
* **open loop** (``--rate R``): request ``i`` fires at ``i / R`` seconds
  whether or not earlier ones finished: latency under an offered load,
  queueing and shedding included;
* **sessions** (``--sessions N --frames F``): N concurrent stateful streams,
  each sending F frames one after another through ``/session/embed`` with
  its session id as ``X-Affinity-Key``; the report's ``session`` block
  splits cold from warm frame latency and checks affinity (every session's
  frames on one replica; with one target it holds trivially);
* **tenants** (``--tenant NAME:WEIGHT``, repeatable): requests carry
  ``X-Tenant``, cycling the tenants by integer weight; the report gains a
  ``per_tenant`` section, and a tenant's quota sheds (503
  ``tenant_overloaded``) count as sheds, not errors;
* **corrupt** (``--corrupt FRAC``): a deterministic FRAC of the requests carry
  the same images plus seeded heavy noise and the top half blanked: a shift of
  the quality plane's distributions with no latency or error signal (the
  report's ``requests_corrupted``);
* **regress** (``--regress-at FRAC``): from FRAC of the run on, every request
  is sent at the largest batch size, a step at a known request index (the
  report's ``regress``);
* **timeline** (``--timeline [--timeline-step-s S]``): the run windowed into
  S-second buckets of throughput, p50/p95, sheds and errors (the report's
  ``timeline``).

Batch sizes cycle through ``--batch-sizes``; the image contract (size,
channels) is read from ``/healthz``.  Every request carries an
``X-Request-Id`` (``lg-<pid>-<seq>``) that the server must echo; a missing
echo counts in ``request_id_mismatches``.  The report is one JSON object
with ``tools/loadgen.py``'s keys: p50/p95/p99/mean/max latency (ms), the
achieved request and image rates, and the ok, shed and error counts.  Below
:data:`MIN_TAIL_SAMPLES` answered requests p95 and p99 are null: on fewer
samples they are the slowest request or two, not a tail.  Pointed at a
router (``python -m glom_tpu_torch.serving.router``), the report gains a
``per_replica`` section keyed by the router's ``X-Served-By``.  Exit 0 when no
request failed, every id was echoed and no session split across replicas.

``--smoke [--fleet] [--device cpu]`` needs no server: it serves a demo
checkpoint in-process and checks one request's trace (with ``--fleet``, the
trace stitched across a router's hop) and ``/parse`` through a router
(:func:`run_smoke`).
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


def make_image_lists(health, batch_sizes, seed=0):
    """Nested image lists per batch size (``tools/loadgen.py``'s seed and
    draws), shared by the stateless and the session bodies."""
    import numpy as np

    c, s = health["channels"], health["image_size"]
    rng = np.random.RandomState(seed)
    return {b: rng.randn(b, c, s, s).astype("float32").tolist() for b in batch_sizes}


def make_payloads(health, batch_sizes, seed=0):
    """One JSON body per batch size, built once (the load generator's time
    goes to the network path, not to ``json.dumps``)."""
    return {b: json.dumps({"images": images}).encode()
            for b, images in make_image_lists(health, batch_sizes, seed).items()}


def make_corrupt_payloads(health, batch_sizes, seed=1):
    """``--corrupt`` bodies: the same base images (seed 0) plus seeded heavy
    noise and the top half blanked, ``tools/loadgen.py``'s draws: a shift
    the quality plane's drift sketches must catch, in a request that stays
    well formed (no latency or error signal)."""
    import numpy as np

    c, s = health["channels"], health["image_size"]
    base = np.random.RandomState(0)
    noise = np.random.RandomState(seed)
    out = {}
    for b in batch_sizes:
        imgs = base.randn(b, c, s, s).astype("float32")
        imgs = imgs + 2.5 * noise.randn(b, c, s, s).astype("float32")
        imgs[..., : s // 2, :] = 0.0  # occlude the top half
        out[b] = json.dumps({"images": imgs.tolist()}).encode()
    return out


def corrupt_this(i, frac):
    """Stratified deterministic pick: request ``i`` is corrupted iff the
    integer part of the running credit ``(i + 1) * frac`` advanced — exactly
    ``floor(n * frac)`` picks over any prefix of n requests, evenly spread,
    the same picks for the same frac every run."""
    return frac > 0 and int((i + 1) * frac) > int(i * frac)


class Results:
    """What the requests came back with, recorded from many threads.  With
    ``timeline``, one ``(completion time, latency_ms or None, kind)`` sample
    a request for :func:`timeline_report`."""

    def __init__(self, timeline=False):
        self.lock = threading.Lock()
        self.timeline_samples = [] if timeline else None
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
        self.tenants = {}        # per X-Tenant with --tenant
        # session mode: cold/warm frame latency, and per session the
        # replicas that served its frames (the affinity evidence)
        self.cold_ms = []
        self.warm_ms = []
        self.sessions = {}

    def _rec(self, table, key):
        rec = table.get(key)
        if rec is None:
            rec = table[key] = {"latencies_ms": [], "ok": 0, "shed": 0, "errors": 0}
            if table is self.replicas:
                rec["images_ok"] = 0
        return rec

    def record(self, latency_ms=None, images=0, shed=False, error=False, request_id=None,
               id_mismatch=False, replica=None, endpoint=None, tenant=None):
        with self.lock:
            recs = [self._rec(self.replicas, replica) if replica is not None else None,
                    self._rec(self.endpoints, endpoint) if endpoint is not None else None,
                    self._rec(self.tenants, tenant) if tenant is not None else None]
            recs = [r for r in recs if r is not None]
            if self.timeline_samples is not None:
                kind = "shed" if shed else ("error" if error else "ok")
                self.timeline_samples.append((time.monotonic(), latency_ms, kind))
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

    def note_session(self, sid, *, cold=None, latency_ms=None, replica=None):
        with self.lock:
            rec = self.sessions.setdefault(sid, {"replicas": [], "colds": 0, "frames": 0})
            rec["frames"] += 1
            if replica is not None:
                rec["replicas"].append(replica)
            if cold is not None and latency_ms is not None:
                if cold:
                    rec["colds"] += 1
                    self.cold_ms.append(latency_ms)
                else:
                    self.warm_ms.append(latency_ms)

    def slowest(self, n):
        with self.lock:
            return sorted(self.samples, reverse=True)[:n]


def parse_tenants(specs):
    """``["a:3", "b:1"]`` -> the request -> tenant cycle ``[a, a, a, b]``
    (integer weights; a bare ``NAME`` weighs 1)."""
    schedule = []
    for spec in specs:
        name, _, weight = spec.partition(":")
        if not name:
            raise ValueError(f"bad --tenant spec {spec!r}")
        schedule.extend([name] * max(1, int(weight or 1)))
    return schedule


def _pick_body(i, b, payloads, batch_sizes, results, corrupt_payloads, corrupt_frac,
               regress_from):
    """Request ``i``'s batch size and body: past ``regress_from`` the largest
    size, and a corrupt body where :func:`corrupt_this` picks it (both
    counted)."""
    if regress_from is not None and i >= regress_from:
        b = max(batch_sizes)
        with results.lock:
            results.regressed += 1
    body = payloads[b]
    if corrupt_payloads is not None and corrupt_this(i, corrupt_frac):
        body = corrupt_payloads[b]
        with results.lock:
            results.corrupted += 1
    return b, body


def run_closed(urls, endpoints, payloads, batch_sizes, n_requests, concurrency, timeout,
               results, duration=None, tenants=None, corrupt_payloads=None, corrupt_frac=0.0,
               regress_from=None):
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
            b, body = _pick_body(i, b, payloads, batch_sizes, results, corrupt_payloads,
                                 corrupt_frac, regress_from)
            send(urls[i % len(urls)], endpoints[i % len(endpoints)], body, b, timeout,
                 results, time.monotonic(), request_id=f"lg-{os.getpid()}-{i}",
                 multi_target=len(urls) > 1,
                 tenant=tenants[i % len(tenants)] if tenants else None)

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.monotonic() - t_start


def run_open(urls, endpoints, payloads, batch_sizes, rate, duration, timeout, results,
             tenants=None, corrupt_payloads=None, corrupt_frac=0.0, regress_from=None):
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
        b, body = _pick_body(i, b, payloads, batch_sizes, results, corrupt_payloads,
                             corrupt_frac, regress_from)
        t = threading.Thread(
            target=send,
            args=(urls[i % len(urls)], endpoints[i % len(endpoints)], body, b, timeout,
                  results, time.monotonic()),
            kwargs={"request_id": f"lg-{os.getpid()}-{i}", "multi_target": len(urls) > 1,
                    "tenant": tenants[i % len(tenants)] if tenants else None},
            daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=timeout)
    return time.monotonic() - t_start


def send(url, endpoint, body, n_images, timeout, results, t0, request_id=None,
         multi_target=False, tenant=None):
    """One request; its outcome recorded in ``results`` (503: shed; any other
    failure: an error).  The replica it is recorded under is the router's
    ``X-Served-By`` when there is one, else the target URL when several are
    sprayed."""
    headers = {"Content-Type": "application/json"}
    if request_id is not None:
        headers["X-Request-Id"] = request_id
    if tenant is not None:
        headers["X-Tenant"] = tenant
    req = urllib.request.Request(f"{url}/{endpoint}", data=body, headers=headers)

    def replica_key(resp_headers):
        served_by = resp_headers.get("X-Served-By") if resp_headers else None
        return served_by or (url if multi_target else None)

    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            echoed = r.headers.get("X-Request-Id")
            replica = replica_key(r.headers)
            json.loads(r.read())
    except urllib.error.HTTPError as e:
        echoed = e.headers.get("X-Request-Id")
        e.read()
        results.record(shed=(e.code == 503), error=(e.code != 503),
                       id_mismatch=(request_id is not None and echoed != request_id),
                       replica=replica_key(e.headers), endpoint=endpoint, tenant=tenant)
        return
    except Exception:  # a load generator keeps offering load through any one failure
        results.record(error=True, replica=url if multi_target else None, endpoint=endpoint,
                       tenant=tenant)
        return
    results.record(latency_ms=(time.monotonic() - t0) * 1e3, images=n_images,
                   request_id=request_id,
                   id_mismatch=(request_id is not None and echoed != request_id),
                   replica=replica, endpoint=endpoint, tenant=tenant)


# -- session mode --------------------------------------------------------------

def send_session(url, body, n_images, sid, timeout, results, request_id):
    """One frame of one session: the session id rides the body (the
    engine's state key) and ``X-Affinity-Key`` (a router's pin)."""
    headers = {"Content-Type": "application/json", "X-Affinity-Key": sid,
               "X-Request-Id": request_id}
    req = urllib.request.Request(f"{url}/session/embed", data=body, headers=headers)
    t0 = time.monotonic()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            echoed = r.headers.get("X-Request-Id")
            served = r.headers.get("X-Served-By")
            resp = json.loads(r.read())
    except urllib.error.HTTPError as e:
        e.read()
        served = e.headers.get("X-Served-By") if e.headers else None
        results.record(shed=(e.code == 503), error=(e.code != 503),
                       id_mismatch=(e.headers.get("X-Request-Id") != request_id
                                    if e.headers else True), replica=served)
        results.note_session(sid, replica=served)
        return
    except Exception:  # a load generator keeps offering load through any one failure
        results.record(error=True)
        results.note_session(sid)
        return
    lat = (time.monotonic() - t0) * 1e3
    results.record(latency_ms=lat, images=n_images, request_id=request_id,
                   id_mismatch=(echoed != request_id), replica=served)
    results.note_session(sid, cold=bool(resp.get("cold")), latency_ms=lat, replica=served)


def run_sessions(urls, image_lists, batch_sizes, n_sessions, n_frames, timeout, results):
    """``n_sessions`` streams in parallel threads, each sending its
    ``n_frames`` frames one after another (frame k+1 takes frame k's
    state).  Returns the wall seconds."""
    def worker(si):
        sid = f"lg-sess-{os.getpid()}-{si}"
        url = urls[si % len(urls)]
        b = batch_sizes[si % len(batch_sizes)]
        body = json.dumps({"session": sid, "images": image_lists[b]}).encode()
        for fi in range(n_frames):
            send_session(url, body, b, sid, timeout, results,
                         request_id=f"lg-{os.getpid()}-s{si}f{fi}")

    threads = [threading.Thread(target=worker, args=(si,), daemon=True)
               for si in range(n_sessions)]
    t_start = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.monotonic() - t_start


def check_session_affinity(urls, results, timeout, after_seq=-1):
    """Every session's frames should land on one replica.  A session that
    saw more than one is legitimate only when a target's timeline shows an
    ejection or readmission of one of its replicas after ``after_seq``;
    otherwise it is a violation.  Targets that name no replica
    (``X-Served-By``) make the check vacuous."""
    from collections import Counter

    with results.lock:
        sessions = {sid: list(rec["replicas"]) for sid, rec in results.sessions.items()}
    served = {sid: [r for r in reps if r] for sid, reps in sessions.items()}
    total = sum(len(reps) for reps in served.values())
    modal = sum(max(Counter(reps).values()) for reps in served.values() if reps)
    split = {sid: sorted(set(reps)) for sid, reps in served.items() if len(set(reps)) > 1}
    ejections, ejected, checked = 0, set(), False
    if split:
        for url in urls:
            try:
                with urllib.request.urlopen(f"{url}/debug/timeline", timeout=timeout) as r:
                    events = json.loads(r.read()).get("events", [])
            except Exception:  # a target without a timeline: no verdict from it
                continue
            checked = True
            for e in events:
                if (e.get("event") in ("ejection", "readmission")
                        and int(e.get("seq", -1)) > after_seq):
                    ejections += 1
                    if e.get("replica"):
                        ejected.add(e["replica"])
    violations = (sorted(sid for sid, reps in split.items() if not ejected.intersection(reps))
                  if checked else [])
    return {"hit_rate": round(modal / total, 4) if total else None, "split_sessions": split,
            "ejection_events": ejections if checked else None, "timeline_checked": checked,
            "violations": violations}


def _lat_block(xs):
    return {"count": len(xs),
            "p50": round(percentile(xs, 50), 3) if xs else None,
            "p95": round(percentile(xs, 95), 3) if xs else None,
            "mean": round(sum(xs) / len(xs), 3) if xs else None}


def session_report(results, urls, timeout, after_seq=-1):
    """The ``session`` block: cold and warm frame latency and affinity."""
    with results.lock:
        cold, warm = list(results.cold_ms), list(results.warm_ms)
        n_sessions = len(results.sessions)
    cold_b, warm_b = _lat_block(cold), _lat_block(warm)
    return {"sessions": n_sessions, "cold_ms": cold_b, "warm_ms": warm_b,
            "warm_over_cold_p50": (round(warm_b["p50"] / cold_b["p50"], 4)
                                   if warm_b["p50"] and cold_b["p50"] else None),
            "affinity": check_session_affinity(urls, results, timeout, after_seq=after_seq)}


def timeline_report(results, step_s=1.0):
    """The run's completions in fixed ``step_s`` windows: per window the
    throughput, p50/p95, shed and error counts, window starts relative to
    the first completion (``tools/loadgen.py``'s ``timeline`` block: a
    mid-run latency step shows as a trend flip in the windowed p95)."""
    with results.lock:
        samples = list(results.timeline_samples or ())
    if not samples:
        return None
    t0 = min(t for t, _, _ in samples)
    windows = {}
    for t, lat, kind in samples:
        w = int((t - t0) / step_s)
        rec = windows.setdefault(w, {"ok": 0, "shed": 0, "errors": 0, "latencies": []})
        if kind == "ok":
            rec["ok"] += 1
            if lat is not None:
                rec["latencies"].append(lat)
        elif kind == "shed":
            rec["shed"] += 1
        else:
            rec["errors"] += 1
    out = []
    for w in sorted(windows):
        rec = windows[w]
        lats = rec["latencies"]
        out.append({
            "t_s": round(w * step_s, 3),
            "requests_ok": rec["ok"],
            "requests_shed": rec["shed"],
            "requests_error": rec["errors"],
            "throughput_req_per_s": round(rec["ok"] / step_s, 2),
            "p50_ms": round(percentile(lats, 50), 3) if lats else None,
            "p95_ms": round(percentile(lats, 95), 3) if lats else None,
        })
    return {"step_s": step_s, "windows": out}


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
    if results.tenants:
        per_tenant = {}
        for key, rec in sorted(results.tenants.items()):
            total = rec["ok"] + rec["shed"] + rec["errors"]
            per_tenant[key] = {
                "requests_ok": rec["ok"], "requests_shed": rec["shed"],
                "requests_error": rec["errors"],
                # the share of this tenant's offered load its quota turned away
                "shed_rate": round(rec["shed"] / total, 4) if total else None,
                "error_rate": round(rec["errors"] / total, 4) if total else None,
                "latency_ms": _latency(rec["latencies_ms"], ("p50", "p95"), min_tail)}
        out["per_tenant"] = per_tenant
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
        rate=0.0, duration=None, timeout=60.0, targets=None, slow_n=0, health=None,
        sessions=0, frames=16, tenants=None, corrupt=0.0, regress_at=0.0, timeline=False,
        timeline_step_s=1.0) -> dict:
    """Drive a server (or several ``targets``) and return the report:
    ``sessions`` streams of ``frames`` frames when ``sessions > 0``; else an
    open loop at ``rate`` for ``duration`` seconds when ``rate > 0``, else a
    closed loop of ``concurrency`` for ``requests`` requests or
    ``duration`` seconds.  ``tenants`` (``["a:3", "b:1"]``) labels the
    requests of either loop with ``X-Tenant``; ``corrupt`` sends that
    fraction perturbed, ``regress_at`` steps to the largest batch size from
    that fraction of the run on (it needs a count: ``requests`` or ``rate``),
    and ``timeline`` adds the windowed ``timeline`` block."""
    urls = [u.rstrip("/") for u in (targets or [url])]
    endpoints, batch_sizes = list(endpoints), list(batch_sizes)
    health = health if health is not None else fetch_health(urls[0], timeout)
    results = Results(timeline=timeline)
    if sessions > 0:
        image_lists = make_image_lists(health, batch_sizes)
        # the timelines' cursor before the run: only an ejection during it
        # may excuse a split session
        start_seq = _timeline_max_seq(urls, timeout)
        wall = run_sessions(urls, image_lists, batch_sizes, sessions, frames, timeout, results)
        out = report(results, wall, f"sessions(n={sessions},frames={frames})", slow_n=slow_n,
                     min_tail=MIN_TAIL_SAMPLES)
        out["session"] = session_report(results, urls, timeout, after_seq=start_seq)
        if timeline:
            out["timeline"] = timeline_report(results, timeline_step_s)
        return out
    payloads = make_payloads(health, batch_sizes)
    corrupt_payloads = make_corrupt_payloads(health, batch_sizes) if corrupt > 0 else None
    schedule = parse_tenants(tenants) if tenants else None
    open_duration = duration if duration is not None else 5.0
    if rate <= 0 and requests is None and duration is None:
        requests = 100
    regress_from = None
    if regress_at > 0:
        n = max(1, int(rate * open_duration)) if rate > 0 else requests
        if n is None:
            raise ValueError("regress_at needs a request count: requests= or rate=")
        regress_from = math.ceil(n * min(regress_at, 1.0))
    shape = dict(corrupt_payloads=corrupt_payloads, corrupt_frac=corrupt,
                 regress_from=regress_from)
    if rate > 0:
        wall = run_open(urls, endpoints, payloads, batch_sizes, rate, open_duration, timeout,
                        results, tenants=schedule, **shape)
        mode = f"open({rate}/s)"
    else:
        wall = run_closed(urls, endpoints, payloads, batch_sizes, requests, concurrency,
                          timeout, results, duration=duration, tenants=schedule, **shape)
        mode = f"closed(c={concurrency})"
    if len(endpoints) > 1:
        mode += f" endpoints({','.join(endpoints)})"
    if corrupt > 0:
        mode += f" corrupt({corrupt})"
    if regress_from is not None:
        mode += f" regress(at={regress_at})"
    if schedule:
        mode += f" tenants({','.join(sorted(set(schedule)))})"
    if len(urls) > 1:
        mode += f" x{len(urls)} targets"
    out = report(results, wall, mode, slow_n=slow_n, min_tail=MIN_TAIL_SAMPLES)
    if regress_from is not None:
        # the ground truth a knee detector is held to: the request index
        # where the step began
        out["regress"] = {"frac": regress_at, "from_request": regress_from,
                          "batch_size": max(batch_sizes)}
    if timeline:
        out["timeline"] = timeline_report(results, timeline_step_s)
    return out


def _timeline_max_seq(urls, timeout):
    """The newest timeline sequence number on any target, -1 when none
    serves a timeline."""
    seq = -1
    for url in urls:
        try:
            with urllib.request.urlopen(f"{url}/debug/timeline", timeout=timeout) as r:
                events = json.loads(r.read()).get("events", [])
        except Exception:  # a target without a timeline
            continue
        for e in events:
            seq = max(seq, int(e.get("seq", -1)))
    return seq


# -- the smoke -------------------------------------------------------------------

def poll_until(fn, timeout_s=10.0, interval_s=0.01):
    """``fn()`` until it returns something truthy or the time is up (then
    its last value)."""
    deadline = time.monotonic() + timeout_s
    while True:
        out = fn()
        if out or time.monotonic() >= deadline:
            return out
        time.sleep(interval_s)


def _smoke_parse_router(engine_url, timeout) -> dict:
    """The part-whole leg of ``--smoke``: ``/parse`` THROUGH a router at
    mixed batch sizes comes back with well-formed per-level islands, with
    no graph captured on the request path (``serving_graph_captures``
    absent from the replica's ``/metrics``).  Raises AssertionError on a
    breach."""
    from glom_tpu_torch.serving.router import FleetRouter, make_router_server

    router = FleetRouter([engine_url], health_interval_s=0.2)
    router.start()
    router_server = make_router_server(router)
    threading.Thread(target=router_server.serve_forever, daemon=True).start()
    front = "http://{}:{}".format(*router_server.server_address[:2])
    try:
        health = fetch_health(front, timeout)
        payloads = make_payloads(health, [1, 2])
        results = Results()
        for i, b in enumerate([1, 2, 1, 2]):
            send(front, "parse", payloads[b], b, timeout, results, time.monotonic(),
                 request_id=f"lg-parse-{i}")
        assert results.ok == 4 and results.errors == 0, vars(results)
        side = health["image_size"] // health["patch_size"]
        req = urllib.request.Request(f"{front}/parse", data=payloads[2],
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as r:
            islands = json.loads(r.read())["islands"]
        assert len(islands) == 2, len(islands)
        for per_level in islands:
            assert len(per_level) == health["levels"]
            for lv in per_level:
                assert len(lv["labels"]) == side
                assert len(lv["sizes"]) == lv["num_islands"]
                assert len(lv["means"]) == lv["num_islands"]
        with urllib.request.urlopen(f"{engine_url}/metrics", timeout=timeout) as r:
            metrics = r.read().decode()
        captures = [line for line in metrics.splitlines()
                    if line.startswith("glom_serving_graph_captures ")]
        assert not captures, f"/parse captured a graph on the request path: {captures}"
        return {"requests_ok": results.ok, "levels": health["levels"],
                "islands_l0": islands[0][0]["num_islands"], "graph_captures": 0}
    finally:
        router.shutdown()
        router_server.shutdown()
        router_server.server_close()


def run_smoke(device="cuda", *, fleet=False, checkpoint_dir=None, min_coverage=0.95,
              timeout=120.0) -> dict:
    """The in-process round trip: a checkpoint (a demo one by default) ->
    engine -> HTTP server -> one ``/embed`` with an ``X-Request-Id``, then
    the tracing checks: one trace under that id whose spans hold the
    request's pipeline and explain at least ``min_coverage`` of its wall
    time (0: reported, not gated: a share of wall time the host's
    scheduling decides), and a Perfetto-loadable export.  With ``fleet`` a
    router fronts the replica and the checks run on the STITCHED
    cross-process trace (router + replica segments, clock-aligned over the
    hop): its spans add ``router_request`` and ``proxy``, and its parent
    links (root -> proxy -> the replica's ``request``) must hold.  Then the
    ``/parse``-through-a-router leg.  ``tools/loadgen.py``'s tenant-bulkhead
    leg is not run: its verdict compares two p95s of wall time on the
    host (the port's tenancy tests hold the bulkhead).  Returns the report
    (``"smoke"`` is ``"ok"`` when every check holds)."""
    import tempfile

    from glom_tpu_torch.obs.tracing import TraceExporter, span_coverage
    from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint
    from glom_tpu_torch.serving.server import make_server

    with tempfile.TemporaryDirectory() as d:
        ckpt = checkpoint_dir
        if ckpt is None:
            ckpt = os.path.join(d, "ckpt")
            make_demo_checkpoint(ckpt)
        engine = ServingEngine(ckpt, buckets=(1, 2), max_wait_ms=1.0, warmup=True,
                               reload_poll_s=0, device=device)
        engine.start()
        server = make_server(engine)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        engine_url = "http://{}:{}".format(*server.server_address[:2])
        target = engine_url
        router = router_server = None
        if fleet:
            from glom_tpu_torch.serving.router import FleetRouter, make_router_server

            router = FleetRouter([engine_url], health_interval_s=0.2)
            router.start()
            router_server = make_router_server(router)
            threading.Thread(target=router_server.serve_forever, daemon=True).start()
            target = "http://{}:{}".format(*router_server.server_address[:2])
        request_id = f"smoke-{os.getpid()}"
        try:
            health = fetch_health(target, timeout)
            payloads = make_payloads(health, [1])
            results = Results()
            t0 = time.monotonic()
            send(target, "embed", payloads[1], 1, timeout, results, t0, request_id=request_id)
            wall = time.monotonic() - t0

            # the server closes the root span AFTER writing the reply: poll
            # for it instead of racing the handler thread
            def closed_root_spans():
                spans = [sp.to_dict() for sp in engine.tracer.sink.trace(request_id)]
                root = next((sp for sp in spans if sp.get("root_span")), None)
                return spans if root is not None and root.get("end") is not None else None

            spans = poll_until(closed_root_spans) or [
                sp.to_dict() for sp in engine.tracer.sink.trace(request_id)]
            links = None
            if fleet:
                from glom_tpu_torch.obs.observatory import stitch
                from glom_tpu_torch.tools.observatory import hop_links

                def both_segments():
                    segments = []
                    for src, tracer in (("router", router.tracer), ("replica", engine.tracer)):
                        _, recs = tracer.completed_since(0)
                        segments.extend((src, r) for r in recs
                                        if r.get("trace_id") == request_id)
                    return segments if len(segments) >= 2 else None

                segments = poll_until(both_segments)
                if segments:
                    spans = stitch(segments)["spans"]
                links = hop_links(spans)
            coverage = span_coverage(spans)
            perfetto_path = os.path.join(d, "smoke_trace.json")
            TraceExporter(engine.tracer.sink).write(perfetto_path)
            with open(perfetto_path) as f:
                perfetto = json.load(f)
            perfetto_ok = (isinstance(perfetto.get("traceEvents"), list)
                           and any(e.get("ph") == "X" for e in perfetto["traceEvents"]))
            span_names = {sp["name"] for sp in spans}
            want_names = {"request", "queue_wait", "batch_assembly", "pad", "execute", "respond"}
            if fleet:
                want_names |= {"router_request", "route", "proxy"}
            checks = {
                "request_ok": results.ok == 1 and results.errors == 0,
                "request_id_echoed": results.id_mismatches == 0,
                "spans": want_names <= span_names,
                "coverage": coverage is not None and coverage >= min_coverage,
                "perfetto": perfetto_ok,
            }
            if fleet:
                checks["hop_links"] = bool(links and links["root_is_outermost"]
                                           and links["proxy_under_root"]
                                           and links["request_under_proxy"])
            parse_leg = _smoke_parse_router(engine_url, timeout) if all(
                checks.values()) else None
            return {
                "smoke": "ok" if all(checks.values()) and parse_leg else "FAILED",
                "smoke_mode": "fleet-stitched" if fleet else "engine",
                "device": str(engine.device),
                "checks": checks,
                "request_id": request_id,
                "trace_span_names": sorted(span_names),
                "trace_coverage": None if coverage is None else round(coverage, 4),
                "min_coverage": min_coverage,
                "hop_links": links,
                "perfetto_events": len(perfetto.get("traceEvents", [])),
                "parse_router": parse_leg,
                **report(results, wall, "smoke"),
            }
        finally:
            if router_server is not None:
                router.shutdown()
                router_server.shutdown()
                router_server.server_close()
            server.shutdown()
            engine.shutdown()
            server.server_close()


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
    p.add_argument("--sessions", type=int, default=0, metavar="N",
                   help="session mode: N concurrent stateful sessions of --frames frames "
                        "each through /session/embed")
    p.add_argument("--frames", type=int, default=16, help="session mode: frames a session")
    p.add_argument("--tenant", action="append", default=None, metavar="NAME:WEIGHT",
                   help="repeatable: requests carry X-Tenant, cycling tenants by integer "
                        "weight; the report gains per_tenant")
    p.add_argument("--corrupt", type=float, default=0.0, metavar="FRAC",
                   help="send this fraction of the requests perturbed (seeded heavy noise, "
                        "the top half blanked; the same requests every run): a shift of the "
                        "quality plane's drift with no latency or error signal")
    p.add_argument("--regress-at", type=float, default=0.0, metavar="FRAC",
                   help="from FRAC of the run on, send every request at the largest "
                        "--batch-sizes size: a step at a known request index (the report's "
                        "'regress'); needs --requests or --rate")
    p.add_argument("--timeline", action="store_true",
                   help="window the run into per-step throughput/p95/shed/error buckets in "
                        "the report")
    p.add_argument("--timeline-step-s", type=float, default=1.0,
                   help="with --timeline: the window width in seconds")
    p.add_argument("--smoke", action="store_true",
                   help="in-process round trip through a served engine (no --url needed); "
                        "exit status is the signal")
    p.add_argument("--fleet", action="store_true",
                   help="with --smoke: put a router in front of the replica and check the "
                        "STITCHED cross-process trace (the replica's spans alone overstate "
                        "coverage: the router hop is invisible to them)")
    p.add_argument("--device", default="cuda",
                   help="with --smoke: torch device; 'cpu' runs the plain PyTorch versions "
                        "of the kernels")
    p.add_argument("--min-coverage", type=float, default=0.95,
                   help="with --smoke: the trace's span coverage must reach this (0: report "
                        "it only)")
    args = p.parse_args(argv)
    if args.fleet and not args.smoke:
        p.error("--fleet goes with --smoke (point --url at a router to load a fleet)")
    if args.smoke:
        out = run_smoke(args.device, fleet=args.fleet, min_coverage=args.min_coverage,
                        timeout=args.timeout)
        print(json.dumps(out, indent=2))
        return 0 if out["smoke"] == "ok" else 1
    if args.regress_at > 0 and args.rate <= 0 and args.requests is None and args.duration:
        p.error("--regress-at needs a request count: --requests, or --rate")
    endpoints = [e.strip() for e in args.endpoint.split(",") if e.strip()]
    if not endpoints or any(e not in ("embed", "reconstruct") for e in endpoints):
        print(f"loadgen: bad --endpoint {args.endpoint!r} (want a comma mix of "
              f"embed,reconstruct)", file=sys.stderr)
        return 2
    out = run(args.url, endpoints=endpoints,
              batch_sizes=[int(b) for b in args.batch_sizes.split(",")],
              concurrency=args.concurrency, requests=args.requests, rate=args.rate,
              duration=args.duration, timeout=args.timeout, targets=args.target,
              slow_n=args.slow_n, sessions=args.sessions, frames=args.frames,
              tenants=args.tenant, corrupt=args.corrupt, regress_at=args.regress_at,
              timeline=args.timeline, timeline_step_s=args.timeline_step_s)
    print(json.dumps(out, indent=2))
    violations = out.get("session", {}).get("affinity", {}).get("violations")
    if violations:
        print(f"loadgen: AFFINITY VIOLATION — sessions {violations} split across replicas "
              f"with no ejection in the timeline", file=sys.stderr)
    return 0 if (out["requests_error"] == 0 and out["request_id_mismatches"] == 0
                 and not violations) else 1


if __name__ == "__main__":
    raise SystemExit(main())
