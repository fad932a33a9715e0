"""Replica fleet router: one front door over N serving engines — the port's
copy of ``glom_tpu/serving/router.py`` (stdlib only), the same code but for
its command line: ``--spawn`` builds the port's engines on ``--device``
(``cuda`` unless the caller asks for ``cpu``: with no card it fails, it never
moves to the CPU on its own), and ``--platform`` is refused by name, as the
port's server refuses it.  The router forwards request bodies unparsed, so a
router of either package fronts replicas of either.

    python -m glom_tpu_torch.serving.router --spawn 2 --checkpoint-dir D \
        --demo [--device cuda] [--port 8800]
    python -m glom_tpu_torch.serving.router --replica http://127.0.0.1:8001 \
        --replica http://127.0.0.1:8002

Within a replica a device mesh would scale the MODEL (not in the port yet:
ROADMAP queue 1, item 6b); this module scales THROUGHPUT: a stdlib HTTP front
that dispatches ``/embed`` / ``/reconstruct`` / ``/session/*`` across N
independent engine replicas: shard within a device for size, replicate
across devices (or processes) for load.

**Dispatch** is least-loaded (fewest in-flight proxied requests, ties
rotated round-robin) unless the request carries an ``X-Affinity-Key``
header, which routes on a consistent-hash ring (64 vnodes/replica) so a
client's related requests land on one replica (warm session state, stable
tail latency) while the ring redistributes only the failed replica's keys
on ejection.

**Health**: a probe loop GETs each replica's ``/healthz`` every
``health_interval_s``.  ``eject_after`` consecutive failures — probe
failures and request-path connection errors count alike — ejects the
replica from dispatch; probes continue at exponentially backed-off
intervals and a passing probe re-admits it (after a version catch-up when
the fleet rolled forward while it was gone).  A request that hits a dead
replica fails over to the next healthy one; only a fleet with zero
healthy replicas answers 503.

**Coordinated rollout** (no half-old/half-new fleet): hot reload across
replicas is a staged two-phase swap driven through the engines'
``/admin/reload/*`` API —

  1. *prepare*: every healthy replica loads + places the SAME pinned
     checkpoint step off its request path; any failure aborts the
     rollout with every replica still serving the old step;
  2. *commit*: the router briefly gates dispatch (in-flight requests
     finish on old params; new arrivals queue), then commits every
     replica's one-reference swap; a commit failure rolls the already-
     committed replicas back before the gate reopens.

The gate gives the observable guarantee: ordered by dispatch time,
responses never go
new-step -> old-step — a client can never read version N and then be
served version N-1 by a later request.

**Observability**: the router runs the same tracing/metrics stack as the
engine.  Every request gets a ``router_request`` root span with ``route``
and per-attempt ``proxy`` children; the forwarded ``traceparent`` carries
the proxy span's id, so the engine's ``request`` span parents under it
and ``python -m glom_tpu_torch.tools.trace_report`` shows the whole
hop.  ``/metrics`` serves the router's own families plus every replica's
families relabeled with ``replica="<name>"``; ``/healthz`` aggregates
per-replica state and the model's input contract (the load generator reads the router exactly
like a single engine).  ``/debug/traces`` (completed-trace ring) and
``/debug/timeline`` (bounded ejection/re-admission/rollout event ring +
rollout state-machine position) are the pull plane the fleet observatory
(:mod:`glom_tpu_torch.obs.observatory`) stitches and correlates.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import os
import re
import threading
import time
import urllib.error
import urllib.request
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple

from glom_tpu_torch.obs import MetricRegistry
from glom_tpu_torch.obs.events import Timeline
from glom_tpu_torch.obs.exporters import (
    OPENMETRICS_CONTENT_TYPE,
    PROM_TEXT_CONTENT_TYPE,
    prometheus_lines,
    wants_openmetrics,
)
from glom_tpu_torch.obs.tracing import (
    SPAN_PARSE,
    SPAN_PROXY,
    SPAN_RESPOND,
    SPAN_ROUTE,
    SPAN_ROUTER_REQUEST,
    TraceSink,
    Tracer,
    debug_traces_payload,
    format_traceparent,
    parse_traceparent,
    request_trace_id,
)

ENDPOINTS = ("embed", "reconstruct", "parse")
# proxied POST routes: the stateless pair plus the stateful session
# endpoints.  Session requests SHOULD carry ``X-Affinity-Key: <session
# id>`` — the consistent-hash ring then pins the whole stream to one
# replica, where its column state is resident (the router never parses
# request bodies to recover the id: body parsing on the proxy hot path
# would tax every request for the session feature).  Without the header a
# session still WORKS — least-loaded dispatch just scatters its frames,
# and each replica that sees one cold-settles (correct, but the warm-
# start savings are lost).  On ejection the ring moves only the dead
# replica's keys: those sessions cold-restart on their new replica — the
# documented cold-restart contract.
#
# /parse rides the same single-replica proxy as the stateless pair and
# /session/parse the same affinity rules as /session/embed.  /similar is
# the odd one out: it FANS OUT to every healthy replica (each may hold a
# different index shard family) and merges the per-image top-k here —
# see similar_fanout for the deterministic merge rule.
ROUTED_PATHS = ("/embed", "/reconstruct", "/parse", "/similar",
                "/session/embed", "/session/parse", "/session/reset")
_VNODES = 64
_HEX_ID = re.compile(r"[0-9a-f]{1,32}")
# one Prometheus sample line: name[{labels}] value [timestamp]
_SAMPLE_RE = re.compile(r"^([A-Za-z_:][A-Za-z0-9_:]*)(\{[^}]*\})?( .+)$")


class NoHealthyReplica(RuntimeError):
    """Every replica is ejected (or the dispatch gate timed out)."""


def _default_http(method: str, url: str, body: Optional[bytes],
                  headers: Dict[str, str], timeout: float
                  ) -> Tuple[int, Dict[str, str], bytes]:
    """The one HTTP client (stdlib), injectable for deterministic tests.
    Returns ``(status, headers, body)`` for ANY HTTP status — a replica's
    4xx/5xx is a valid answer to pass through, not a transport failure;
    only connection-level errors raise (URLError/OSError)."""
    req = urllib.request.Request(url, data=body, headers=headers,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers.items()), r.read()
    except urllib.error.HTTPError as e:
        payload = e.read()
        return e.code, dict(e.headers.items()), payload


class Replica:
    """One engine replica's routing state (mutated under the router lock)."""

    __slots__ = ("name", "url", "healthy", "inflight", "fail_streak",
                 "next_probe_at", "step", "requests", "errors", "ejections",
                 "last_health")

    def __init__(self, name: str, url: str):
        self.name = name
        self.url = url.rstrip("/")
        self.healthy = True       # optimistic: first probe/request corrects
        self.inflight = 0
        self.fail_streak = 0
        self.next_probe_at = 0.0  # monotonic deadline for the next probe
        self.step: Optional[int] = None
        self.requests = 0
        self.errors = 0
        self.ejections = 0
        self.last_health: Optional[dict] = None

    def to_dict(self) -> dict:
        return {
            "name": self.name, "url": self.url, "healthy": self.healthy,
            "inflight": self.inflight, "step": self.step,
            "fail_streak": self.fail_streak, "requests": self.requests,
            "errors": self.errors, "ejections": self.ejections,
        }


class FleetRouter:
    """Dispatch + health + coordinated-rollout brain (transport-agnostic:
    the HTTP front below is one thin consumer; tests drive the methods
    directly with an injected clock and http fn)."""

    def __init__(
        self,
        replica_urls: Sequence[str],
        *,
        names: Optional[Sequence[str]] = None,
        health_interval_s: float = 1.0,
        health_timeout_s: float = 5.0,
        eject_after: int = 2,
        probe_backoff_max: int = 8,
        request_timeout_s: float = 60.0,
        admin_timeout_s: float = 120.0,
        commit_timeout_s: float = 10.0,
        gate_timeout_s: float = 30.0,
        rollout_poll_s: float = 0.0,
        drain_timeout_s: float = 10.0,
        registry: Optional[MetricRegistry] = None,
        clock=None,
        sleep=None,
        http=None,
        trace_log: Optional[str] = None,
        trace_max_traces: int = 256,
        capacity_policy: Optional[str] = None,
        capacity_persist_windows: int = 5,
    ):
        if not replica_urls:
            raise ValueError("need at least one replica URL")
        names = list(names) if names else [
            f"r{i}" for i in range(len(replica_urls))]
        if len(names) != len(replica_urls):
            raise ValueError("names and replica_urls must align")
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique, got {names}")
        if eject_after < 1:
            raise ValueError(f"eject_after must be >= 1, got {eject_after}")
        self.replicas: List[Replica] = [
            Replica(n, u) for n, u in zip(names, replica_urls)
        ]
        self.health_interval_s = health_interval_s
        self.health_timeout_s = health_timeout_s
        self.eject_after = eject_after
        self.probe_backoff_max = max(1, probe_backoff_max)
        self.request_timeout_s = request_timeout_s
        self.admin_timeout_s = admin_timeout_s
        # the GATED phase's per-call bound: while the dispatch gate is
        # closed every client is waiting, so a hung replica's commit must
        # fail fast (<< gate_timeout_s) instead of riding the generous
        # prepare-phase admin timeout into a fleet-wide 503
        self.commit_timeout_s = commit_timeout_s
        self.gate_timeout_s = gate_timeout_s
        self.rollout_poll_s = rollout_poll_s
        self.drain_timeout_s = drain_timeout_s
        self.registry = registry if registry is not None else MetricRegistry()
        self._clock = clock if clock is not None else time.monotonic
        self._sleep = sleep if sleep is not None else time.sleep
        self._http = http if http is not None else _default_http
        self._lock = threading.Lock()          # replica state + rr counter
        self._rollout_lock = threading.Lock()  # one rollout at a time
        self._rr = 0
        self.fleet_step: Optional[int] = None  # last coordinated commit
        # -- event timeline (pulled via /debug/timeline) -------------------
        # bounded ring of the fleet's state transitions — ejections,
        # re-admissions, rollout phase outcomes — each with a monotone
        # seq so the observatory reads incrementally and correlates them
        # with replica-side forensics into one incident bundle.  The ring
        # is the shared typed Timeline (obs.events): its own leaf lock,
        # so note_event never acquires another lock and is safely
        # callable from under _lock or _rollout_lock.
        self._timeline = Timeline(maxlen=256, clock=self._clock)
        # coarse rollout-state-machine position for the fleet console
        # (plain str store/load — no lock needed for a telemetry read)
        self.rollout_phase = "idle"
        # the commit gate: cleared only for the (short) commit phase of a
        # rollout; handler threads wait on it before picking a replica
        self._dispatch_open = threading.Event()
        self._dispatch_open.set()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

        trace_exporter = None
        if trace_log:
            from glom_tpu_torch.obs.exporters import JsonlExporter

            trace_exporter = JsonlExporter(path=trace_log)
        self.tracer = Tracer(
            clock=self._clock, sink=TraceSink(max_traces=trace_max_traces),
            registry=self.registry, exporter=trace_exporter,
        )

        # fleet capacity plane: per-replica signal series ingested from
        # the /healthz capacity summaries the health loop ALREADY fetches
        # (zero extra HTTP), rolled up into fleet aggregates the dry-run
        # advisor judges.  Recommendation changes land on the timeline.
        from glom_tpu_torch.obs.capacity import DEFAULT_POLICY, FleetCapacityPlane

        self.capacity = FleetCapacityPlane(
            policy=capacity_policy or DEFAULT_POLICY,
            persist_windows=capacity_persist_windows,
            clock=self._clock,
            registry=self.registry,
            on_recommend=lambda rec: self.note_event(
                "capacity_recommendation", action=rec["action"],
                reasons=rec.get("reasons", []),
                persisted=rec.get("persisted", 0)),
        )

        # fleet quality plane: replica sketch summaries ride the SAME
        # /healthz fetch; merge is exact (fixed-discretization sketches,
        # associative bin-wise adds), so fleet p95s are true percentiles
        # over every replica's observations, not averages of averages
        from glom_tpu_torch.obs.quality import FleetQualityPlane

        self.quality = FleetQualityPlane(
            store=self.capacity.store, registry=self.registry,
            clock=self._clock,
        )

        # -- fleet bulk-job sharding (glom_tpu_torch.serving.bulk) ---------------
        # the router owns the slot-range partition: submit cuts
        # [0, total) across healthy replicas, the health loop witnesses
        # per-shard durable cursors riding /healthz["bulk"], and a dead
        # owner's remaining ranges are re-cut onto survivors from the
        # last witnessed cursor (stale is safe: re-execution into the
        # range-keyed sink is idempotent)
        self._jobs: Dict[str, dict] = {}
        self._jobs_lock = threading.Lock()

        # consistent-hash ring over ALL replicas (ejection skips forward at
        # lookup time, so only the dead replica's keys move)
        self._ring: List[Tuple[int, Replica]] = sorted(
            (int(hashlib.sha1(f"{r.name}#{v}".encode()).hexdigest()[:16], 16),
             r)
            for r in self.replicas for v in range(_VNODES)
        )
        self._ring_keys = [h for h, _ in self._ring]
        self._gauge_replicas()

    # -- event timeline -----------------------------------------------------
    def note_event(self, event: str, **fields) -> None:
        """Append one fleet state transition to the bounded timeline
        (``/debug/timeline``) as a typed TimelineEvent.  Leaf operation:
        takes only the timeline's own lock, callable from anywhere
        including under the dispatch lock."""
        self._timeline.note(event, **fields)

    def timeline(self) -> List[dict]:
        return self._timeline.events()

    # -- metrics helpers ----------------------------------------------------
    def _gauge_replicas(self) -> None:
        healthy = sum(r.healthy for r in self.replicas)
        self.registry.gauge(
            "router_replicas_total", help="replicas configured",
        ).set(len(self.replicas))
        self.registry.gauge(
            "router_replicas_healthy", help="replicas in dispatch rotation",
        ).set(healthy)

    # -- health: probe loop, ejection, re-admission -------------------------
    def _probe(self, replica: Replica) -> Optional[dict]:
        try:
            status, _, body = self._http(
                "GET", f"{replica.url}/healthz", None, {},
                self.health_timeout_s,
            )
            if status != 200:
                return None
            health = json.loads(body)
            return health if health.get("status") == "ok" else None
        except Exception:  # glomlint: disable=conc-broad-except -- any probe failure (refused, timeout, bad JSON, injected test fault) means unhealthy; the caller counts the streak and ejection makes it visible
            return None

    def _note_failure(self, replica: Replica) -> None:
        """One observed failure (probe or request path); ejects at the
        ``eject_after`` streak.  Caller holds the lock."""
        replica.fail_streak += 1
        if replica.healthy and replica.fail_streak >= self.eject_after:
            replica.healthy = False
            replica.ejections += 1
            self.registry.counter(
                "router_ejections_total",
                help="replicas removed from dispatch after failures",
            ).inc()
            self._gauge_replicas()
            self.note_event("ejection", replica=replica.name,
                            fail_streak=replica.fail_streak)
        # backoff: probes of a persistently-dead replica stretch out
        # (doubling per failure past ejection, capped), so a downed box
        # costs one cheap probe per backoff window, not per interval
        over = max(0, replica.fail_streak - self.eject_after)
        factor = min(2 ** over, self.probe_backoff_max)
        replica.next_probe_at = self._clock() + self.health_interval_s * factor

    def _catch_up(self, replica: Replica) -> bool:
        """A re-admission candidate that missed a coordinated rollout must
        reach the fleet step BEFORE taking traffic, or the fleet would mix
        versions.  Drives the same prepare/commit pair, singly."""
        try:
            status, _, body = self._http(
                "POST", f"{replica.url}/admin/reload/prepare",
                json.dumps({"step": self.fleet_step}).encode(),
                {"Content-Type": "application/json"}, self.admin_timeout_s,
            )
            if status != 200:
                return False
            staged = json.loads(body)
            if (staged.get("staged_step") is None
                    and staged.get("serving_step") != self.fleet_step):
                return False
            status, _, body = self._http(
                "POST", f"{replica.url}/admin/reload/commit", b"", {},
                self.admin_timeout_s,
            )
            if status != 200 or json.loads(body).get(
                    "step") != self.fleet_step:
                return False
            # free the displaced tree — this replica's catch-up is not a
            # rollout anyone will roll back
            self._admin(replica, "finalize", timeout=self.commit_timeout_s)
            return True
        except Exception:  # glomlint: disable=conc-broad-except -- a failed catch-up keeps the replica ejected (False); the next health pass retries and the fail streak stays observable
            return False

    def check_health_once(self, *, force: bool = False) -> None:
        """One pass over every replica whose probe is due (``force`` probes
        all).  The health loop calls this each interval; tests call it
        directly against an injected clock."""
        now = self._clock()
        for replica in self.replicas:
            with self._lock:
                due = force or now >= replica.next_probe_at
            if not due:
                continue
            health = self._probe(replica)
            if health is None:
                with self._lock:
                    self._note_failure(replica)
                continue
            # fold the replica's capacity summary into the fleet series
            # BEFORE any dispatch-lock work: ingest takes only the
            # capacity plane's own lock, and a held-out replica's signal
            # is still a live probe worth recording
            self.capacity.ingest(replica.name, health.get("capacity"),
                                 t=now)
            self.quality.ingest(replica.name, health.get("quality"),
                                t=now)
            self._ingest_bulk(replica.name, health.get("bulk"))
            with self._lock:
                was_down = not replica.healthy
                if not was_down:
                    replica.last_health = health
                    replica.step = health.get("step")
                    self._admit(replica, False)
                    continue
            # -- re-admission: serialized with rollouts.  A replica
            # re-admitted mid-rollout would be invisible to the commit
            # (the rollout snapshotted the fleet before it came back)
            # AND pass the catch-up check against the STALE fleet_step —
            # then serve the old version after everyone else flipped.
            # Holding the replica out one more probe round is cheap;
            # mixing versions is not.
            if not self._rollout_lock.acquire(blocking=False):
                with self._lock:
                    replica.next_probe_at = (
                        self._clock() + self.health_interval_s)
                continue
            try:
                with self._lock:
                    replica.last_health = health
                    replica.step = health.get("step")
                    needs_catch_up = (
                        self.fleet_step is not None
                        and replica.step != self.fleet_step)
                    if not needs_catch_up:
                        self._admit(replica, True)
                        continue
                # catch-up runs OUTSIDE the dispatch lock (two HTTP
                # calls) but INSIDE the rollout lock: no rollout can
                # change fleet_step mid-catch-up
                if self._catch_up(replica):
                    with self._lock:
                        replica.step = self.fleet_step
                        self._admit(replica, True)
                else:
                    with self._lock:
                        self._note_failure(replica)
            finally:
                self._rollout_lock.release()
        # one advisor window per health pass: aggregate the freshest
        # per-replica signals and (maybe) emit a recommendation
        self.capacity.evaluate(now)
        # fleet quality rollup rides the same cadence: exact sketch merge
        # across replicas, fleet-aggregate series into the shared store
        self.quality.rollup(now)
        # bulk-job re-partition rides the health pass too: it needs the
        # ejection verdicts this pass just rendered, and it POSTs
        # submits, so it must run outside the dispatch lock
        self._repartition_jobs()

    def _admit(self, replica: Replica, was_down: bool) -> None:
        """Caller holds the lock."""
        replica.fail_streak = 0
        replica.next_probe_at = self._clock() + self.health_interval_s
        if was_down:
            replica.healthy = True
            self.registry.counter(
                "router_readmissions_total",
                help="ejected replicas restored to dispatch",
            ).inc()
            self._gauge_replicas()
            self.note_event("readmission", replica=replica.name,
                            step=replica.step)

    def _health_loop(self) -> None:
        while not self._stop.wait(self.health_interval_s):
            self.check_health_once()

    # -- fleet bulk-job sharding ---------------------------------------------
    def _jobs_post(self, replica: Replica, action: str, payload: dict
                   ) -> Tuple[int, dict]:
        try:
            status, _, raw = self._http(
                "POST", f"{replica.url}/admin/jobs/{action}",
                json.dumps(payload).encode(),
                {"Content-Type": "application/json"}, self.admin_timeout_s)
        except Exception:  # glomlint: disable=conc-broad-except -- a dead replica answers nothing; the caller records a failed assignment and the health loop's ejection + re-partition recover the range
            return 0, {}
        try:
            return status, json.loads(raw)
        except ValueError:
            return status, {}

    def _assign(self, name: str, base: dict, replica: Replica,
                lo: int, hi: int) -> bool:
        """Land one ``[lo, hi)`` shard of a job on a replica; records the
        ownership on success."""
        status, _ = self._jobs_post(
            replica, "submit",
            {**base, "shard": [lo, hi], "owner": replica.name})
        if status != 200:
            return False
        with self._jobs_lock:
            rec = self._jobs.get(name)
            if rec is not None:
                rec["owners"].setdefault(replica.name, []).append((lo, hi))
        return True

    def submit_job(self, payload: dict) -> dict:
        """Fleet submit: cut ``[0, total)`` across the healthy replicas
        (``partition_range`` — the ElasticBatches contiguity contract
        generalized) and land one shard per replica via its
        ``/admin/jobs/submit``.  Every replica writes into the SAME sink
        directory (shared filesystem), so the finished parts assemble
        into one output regardless of which replica ran which range."""
        from glom_tpu_torch.bulk.jobs import partition_range

        name = payload.get("name")
        if not name:
            raise ValueError("fleet submit needs a job name")
        total = payload.get("total")
        if total is None:
            m = re.match(r"^synthetic:([1-9]\d*)$",
                         str(payload.get("dataset", "")))
            if m is None:
                raise ValueError(
                    "fleet submit needs an explicit total (a file-glob "
                    "dataset may list differently per host)")
            total = int(m.group(1))
        total = int(total)
        base = {k: v for k, v in payload.items()
                if k not in ("shard", "owner")}
        base["total"] = total
        with self._lock:
            healthy = [r for r in self.replicas if r.healthy]
        if not healthy:
            raise NoHealthyReplica("no healthy replica to take the job")
        with self._jobs_lock:
            if name in self._jobs:
                raise ValueError(f"job {name!r} already submitted to "
                                 f"the fleet")
            self._jobs[name] = {
                "payload": base, "total": total, "status": "running",
                "owners": {}, "witnessed": {}, "revoked": [],
            }
        failed = []
        for i, (lo, hi) in enumerate(partition_range(0, total,
                                                     len(healthy))):
            # first choice by position; a refusal (bulk disabled, dead
            # mid-submit) falls through the rest of the rotation
            order = healthy[i % len(healthy):] + healthy[:i % len(healthy)]
            if not any(self._assign(name, base, r, lo, hi)
                       for r in order):
                failed.append((lo, hi))
        with self._jobs_lock:
            rec = self._jobs[name]
            owners = {o: [list(r) for r in rs]
                      for o, rs in rec["owners"].items()}
            if failed and not rec["owners"]:
                del self._jobs[name]  # nobody took anything: clean slate
        if failed:
            raise RuntimeError(
                f"job {name!r}: no replica accepted ranges {failed}")
        self.note_event("bulk_submit", job=name, total=total,
                        owners=owners)
        return self.job_status(name)

    def job_status(self, name: Optional[str] = None) -> dict:
        """One job's fleet progress (``name``), else every job plus the
        aggregate backlog — built from the cursors the health loop
        witnessed, so it costs no extra HTTP."""
        with self._jobs_lock:
            names = [name] if name is not None else sorted(self._jobs)
            jobs = {}
            backlog = 0
            for n in names:
                rec = self._jobs.get(n)
                if rec is None:
                    raise KeyError(f"no fleet job {n!r}")
                shards = []
                done = 0
                for owner, w in sorted(rec["witnessed"].items()):
                    for s in sorted(w.get("shards", {}).values(),
                                    key=lambda s: s["lo"]):
                        shards.append({**s, "owner": owner})
                        done += s["cursor"] - s["lo"]
                total = rec["total"]
                done = min(done, total)
                if rec["status"] not in ("cancelled", "paused") \
                        and done >= total:
                    rec["status"] = "done"
                jobs[n] = {
                    "name": n, "status": rec["status"], "total": total,
                    "done": done, "remaining": total - done,
                    "owners": {o: [list(r) for r in rs]
                               for o, rs in rec["owners"].items()},
                    "shards": shards,
                }
                if rec["status"] in ("running", "paused"):
                    backlog += total - done
        if name is not None:
            return jobs[name]
        return {"jobs": jobs, "backlog": backlog}

    def job_admin(self, action: str, name: str) -> dict:
        """Fan a pause/resume/cancel out to every owning replica."""
        if action not in ("pause", "resume", "cancel"):
            raise ValueError(f"no fleet jobs action {action!r}")
        with self._jobs_lock:
            rec = self._jobs.get(name)
            if rec is None:
                raise KeyError(f"no fleet job {name!r}")
            owner_names = sorted(rec["owners"])
        with self._lock:
            targets = [r for r in self.replicas if r.name in owner_names]
        acks = {}
        for replica in targets:
            status, _ = self._jobs_post(replica, action, {"name": name})
            acks[replica.name] = status == 200
        with self._jobs_lock:
            rec = self._jobs.get(name)
            if rec is not None:
                rec["status"] = {"pause": "paused", "resume": "running",
                                 "cancel": "cancelled"}[action]
        self.note_event(f"bulk_{action}", job=name, acks=acks)
        return {"action": action, "acks": acks, **self.job_status(name)}

    def _ingest_bulk(self, replica_name: str,
                     bulk: Optional[dict]) -> None:
        """Fold a replica's ``/healthz`` bulk summary into the fleet job
        registry.  The per-shard durable cursors witnessed here are the
        resume points a re-partition cuts from when the replica dies —
        at worst one health interval stale, which only means a survivor
        re-executes a little of what the dead replica finished (the
        range-keyed sink makes that rewrite byte-identical)."""
        if not bulk:
            return
        with self._jobs_lock:
            for jname, jst in (bulk.get("jobs") or {}).items():
                rec = self._jobs.get(jname)
                if rec is None:
                    continue  # locally-submitted job, not fleet-managed
                w = rec["witnessed"].setdefault(
                    replica_name, {"status": None, "shards": {}})
                w["status"] = jst.get("status")
                for s in jst.get("shards", ()):
                    w["shards"][str(s["lo"])] = {
                        "lo": int(s["lo"]), "hi": int(s["hi"]),
                        "cursor": int(s["cursor"]),
                    }

    def _repartition_jobs(self) -> None:
        """Re-cut every dead owner's unfinished ranges onto healthy
        survivors, each resuming from its last WITNESSED durable cursor.
        Also revokes (cancels) the job on any moved-away owner that came
        back, so a re-admitted replica doesn't duplicate work a survivor
        now owns.  Runs in the health pass, outside the dispatch lock —
        it POSTs submits."""
        with self._lock:
            healthy = [r for r in self.replicas if r.healthy]
            healthy_names = {r.name for r in healthy}
        if not healthy:
            return  # nobody to move work to; retry next pass
        moves, revokes = [], []
        with self._jobs_lock:
            for jname, rec in self._jobs.items():
                if rec["status"] in ("cancelled", "done"):
                    continue
                for owner in [o for o in rec["owners"]
                              if o not in healthy_names]:
                    w = rec["witnessed"].get(owner, {}).get("shards", {})
                    remaining = []
                    for lo, hi in rec["owners"].pop(owner):
                        cur = int(w.get(str(lo), {}).get("cursor", lo))
                        if cur < hi:
                            remaining.append((cur, hi))
                    if owner not in rec["revoked"]:
                        rec["revoked"].append(owner)
                    if remaining:
                        moves.append((jname, dict(rec["payload"]),
                                      owner, remaining))
                for owner in rec["revoked"]:
                    if owner in healthy_names:
                        revokes.append((jname, owner))
        from glom_tpu_torch.bulk.jobs import partition_range

        for jname, base, dead, remaining in moves:
            blocks = []
            for c, hi in remaining:
                blocks.extend(partition_range(c, hi, len(healthy)))
            unassigned = []
            for i, (lo, hi) in enumerate(blocks):
                order = (healthy[i % len(healthy):]
                         + healthy[:i % len(healthy)])
                if not any(self._assign(jname, base, r, lo, hi)
                           for r in order):
                    unassigned.append((lo, hi))
            if unassigned:
                # nobody took these now: park them back on the dead
                # owner so the next health pass retries the re-partition
                with self._jobs_lock:
                    rec = self._jobs.get(jname)
                    if rec is not None:
                        rec["owners"].setdefault(
                            dead, []).extend(unassigned)
                        if dead in rec["revoked"]:
                            rec["revoked"].remove(dead)
            self.note_event(
                "bulk_repartition", job=jname, dead=dead,
                moved=[list(b) for b in blocks if b not in unassigned],
                survivors=sorted(r.name for r in healthy))
        for jname, owner in revokes:
            with self._lock:
                replica = next((r for r in self.replicas
                                if r.name == owner), None)
            if replica is None:
                continue
            status, _ = self._jobs_post(replica, "cancel", {"name": jname})
            if status in (200, 404):
                with self._jobs_lock:
                    rec = self._jobs.get(jname)
                    if rec is not None and owner in rec["revoked"]:
                        rec["revoked"].remove(owner)
                self.note_event("bulk_revoke", job=jname, replica=owner)

    # -- dispatch -----------------------------------------------------------
    def _hash_pick(self, key: str) -> Optional[Replica]:
        """Consistent-hash lookup: first HEALTHY replica clockwise from the
        key's point.  Caller holds the lock."""
        h = int(hashlib.sha1(key.encode()).hexdigest()[:16], 16)
        start = bisect.bisect_left(self._ring_keys, h)
        for i in range(len(self._ring)):
            _, replica = self._ring[(start + i) % len(self._ring)]
            if replica.healthy:
                return replica
        return None

    def pick(self, affinity_key: Optional[str] = None,
             exclude: Sequence[Replica] = ()) -> Replica:
        """Choose a replica: consistent-hash with an affinity key,
        least-loaded (ties rotated) otherwise.  ``exclude`` holds replicas
        already tried this request (failover never retries the same box).

        The commit gate is checked INSIDE the lock that also increments
        ``inflight``: the rollout closes the gate under the same lock, so
        after ``coordinated_reload`` clears it, every request is either
        already counted in-flight (the drain sees it) or will re-wait —
        no request can slip between a gate check and its accounting and
        land on a half-committed fleet."""
        while True:
            if not self._dispatch_open.wait(timeout=self.gate_timeout_s):
                self.registry.counter(
                    "router_no_replica_total",
                    help="requests that found no healthy replica",
                ).inc()
                raise NoHealthyReplica(
                    "dispatch gated longer than gate_timeout_s")
            with self._lock:
                if not self._dispatch_open.is_set():
                    continue  # gate closed between wait and lock: re-wait
                return self._pick_locked(affinity_key, exclude)

    def _pick_locked(self, affinity_key, exclude) -> Replica:
        """Caller holds the lock and has passed the gate."""
        if affinity_key:
            replica = self._hash_pick(affinity_key)
            if replica is not None and replica not in exclude:
                replica.inflight += 1
                return replica
            # the hashed replica was just tried (or everything on the
            # ring is down): fail over to least-loaded
        candidates = [r for r in self.replicas
                      if r.healthy and r not in exclude]
        if not candidates:
            self.registry.counter(
                "router_no_replica_total",
                help="requests that found no healthy replica",
            ).inc()
            raise NoHealthyReplica(
                f"0 of {len(self.replicas)} replicas available"
            )
        least = min(r.inflight for r in candidates)
        tied = [r for r in candidates if r.inflight == least]
        replica = tied[self._rr % len(tied)]
        self._rr += 1
        replica.inflight += 1
        return replica

    def dispatch(self, endpoint: str, body: bytes, headers: Dict[str, str],
                 root_span=None, affinity_key: Optional[str] = None,
                 ) -> Tuple[int, Dict[str, str], bytes, Replica]:
        """Proxy one request: pick (which gates — a commit in progress
        holds new arrivals), forward; connection-level failure fails over
        to the next healthy replica.  Returns ``(status, headers, body,
        replica)``; raises :class:`NoHealthyReplica` when the fleet is
        dry."""
        tracer = self.tracer
        t_route0 = tracer.clock()
        tried: List[Replica] = []
        last_exc: Optional[Exception] = None
        while len(tried) < len(self.replicas):
            replica = self.pick(affinity_key, exclude=tried)
            if root_span is not None and not tried:
                tracer.record(
                    SPAN_ROUTE, root_span, t_route0, tracer.clock(),
                    attrs={"replica": replica.name,
                           "policy": "hash" if affinity_key else
                           "least_loaded"},
                )
            tried.append(replica)
            proxy_span = None
            fwd = dict(headers)
            if root_span is not None:
                proxy_span = tracer.start_span(
                    SPAN_PROXY, root_span,
                    attrs={"replica": replica.name, "endpoint": endpoint},
                )
                # the engine's request span will parent under THIS
                # attempt's proxy span — retries re-parent cleanly
                if _HEX_ID.fullmatch(root_span.trace_id):
                    fwd["traceparent"] = format_traceparent(
                        root_span.trace_id, proxy_span.span_id)
                elif "X-Request-Id" in fwd:
                    # non-hex operator id: the engine adopts the forwarded
                    # X-Request-Id as its trace id (it wins over the
                    # traceparent's trace field), so the header is purely
                    # the parent-span carrier — pad the span id into the
                    # trace field to keep the W3C shape valid
                    fwd["traceparent"] = format_traceparent(
                        proxy_span.span_id, proxy_span.span_id)
            try:
                status, resp_headers, resp_body = self._http(
                    "POST", f"{replica.url}/{endpoint}", body, fwd,
                    self.request_timeout_s,
                )
            except Exception as e:  # connection-level: fail over
                last_exc = e
                with self._lock:
                    replica.inflight -= 1
                    replica.errors += 1
                    self._note_failure(replica)
                if proxy_span is not None:
                    tracer.end(proxy_span, attrs={"error": repr(e)})
                self.registry.counter(
                    "router_failovers_total",
                    help="proxy attempts retried on another replica after "
                         "a connection failure",
                ).inc()
                continue
            with self._lock:
                replica.inflight -= 1
                replica.requests += 1
                replica.fail_streak = 0
                if status >= 500:
                    replica.errors += 1
            if proxy_span is not None:
                tracer.end(proxy_span, attrs={"status": status})
            return status, resp_headers, resp_body, replica
        raise NoHealthyReplica(
            f"all {len(tried)} replicas failed: {last_exc!r}")

    def similar_fanout(self, body: bytes, headers: Dict[str, str],
                       root_span=None) -> Tuple[int, dict, str]:
        """POST /similar to EVERY healthy replica and merge the answers.

        Unlike ``dispatch`` (one replica serves the request), a similarity
        query must see the whole index: replicas may each hold a different
        shard family (a fleet bulk job shards the slot range, so replica A
        indexed slots [0,N) while B indexed [N,2N)).  The merge is
        deterministic regardless of reply order: per image, candidates
        from all replicas are deduped by slot keeping the best score
        (shared-index deployments answer identically everywhere, so
        duplicates are exact), then sorted by ``(-score, slot)`` and cut
        to k.  Replicas without an index (404) just don't contribute.

        Returns ``(status, payload_dict, served_by)``; raises
        :class:`NoHealthyReplica` when nothing answered at all.
        """
        tracer = self.tracer
        with self._lock:
            fleet = [r for r in self.replicas if r.healthy]
        if not fleet:
            raise NoHealthyReplica("no healthy replicas for /similar")
        merged: Optional[List[Dict[int, float]]] = None
        level = k = None
        shard_stats: Dict[str, dict] = {}
        answered: List[str] = []
        last_err: Optional[Tuple[int, dict]] = None
        last_exc: Optional[Exception] = None
        for replica in fleet:
            proxy_span = None
            if root_span is not None:
                proxy_span = tracer.start_span(
                    SPAN_PROXY, root_span,
                    attrs={"replica": replica.name, "endpoint": "similar"})
            try:
                status, _, resp_body = self._http(
                    "POST", f"{replica.url}/similar", body, dict(headers),
                    self.request_timeout_s)
            except Exception as e:  # connection-level: skip this shard
                last_exc = e
                with self._lock:
                    replica.errors += 1
                    self._note_failure(replica)
                if proxy_span is not None:
                    tracer.end(proxy_span, attrs={"error": repr(e)})
                continue
            with self._lock:
                replica.requests += 1
                replica.fail_streak = 0
                if status >= 500:
                    replica.errors += 1
            if proxy_span is not None:
                tracer.end(proxy_span, attrs={"status": status})
            if status != 200:
                # 404 = no index on that replica (fine: it holds no
                # shard).  Anything else is remembered so an all-error
                # fan-out surfaces a real diagnosis, not a bare 503.
                if status != 404:
                    try:
                        last_err = (status, json.loads(resp_body))
                    except ValueError:
                        last_err = (status, {"error": resp_body.decode(
                            "utf-8", "replace")})
                continue
            try:
                payload = json.loads(resp_body)
                results = payload["results"]
            except (ValueError, KeyError, TypeError):
                last_err = (502, {"error": f"unparseable /similar reply "
                                           f"from {replica.name}"})
                continue
            answered.append(replica.name)
            if payload.get("index") is not None:
                shard_stats[replica.name] = payload["index"]
            if level is None:
                level, k = payload.get("level"), payload.get("k")
            if merged is None:
                merged = [dict() for _ in results]
            for best, hits in zip(merged, results):
                for hit in hits:
                    slot = int(hit["slot"])
                    score = float(hit["score"])
                    if slot not in best or score > best[slot]:
                        best[slot] = score
        if merged is None:
            if last_err is not None:
                return last_err[0], last_err[1], ""
            raise NoHealthyReplica(
                f"no replica answered /similar: {last_exc!r}")
        want = int(k) if k else 5
        results = []
        for best in merged:
            ranked = sorted(best.items(), key=lambda kv: (-kv[1], kv[0]))
            results.append([{"slot": slot, "score": score}
                            for slot, score in ranked[:want]])
        self.registry.counter(
            "router_similar_fanouts_total",
            help="similarity queries fanned across the fleet's shards",
        ).inc()
        return 200, {"results": results, "level": level, "k": k,
                     "replicas": answered, "shards": shard_stats}, \
            ",".join(answered)

    # -- coordinated rollout ------------------------------------------------
    def _admin(self, replica: Replica, action: str,
               payload: Optional[dict] = None,
               timeout: Optional[float] = None) -> Optional[dict]:
        try:
            status, _, body = self._http(
                "POST", f"{replica.url}/admin/reload/{action}",
                json.dumps(payload).encode() if payload is not None else b"",
                {"Content-Type": "application/json"} if payload is not None
                else {},
                timeout if timeout is not None else self.admin_timeout_s,
            )
            return json.loads(body) if status == 200 else None
        except Exception:  # glomlint: disable=conc-broad-except -- admin helper contract: None for any failure; each rollout phase decides (abort/rollback/eject) and counts its own outcome
            return None

    def coordinated_reload(self, step: Optional[int] = None) -> dict:
        """Roll the whole healthy fleet to one checkpoint step; see module
        docstring for the two-phase protocol.  Returns a report dict with
        ``status`` in {"noop", "no_replicas", "aborted", "committed",
        "rolled_back"}.  The rollout's state-machine position is published
        as ``rollout_phase`` (healthz/console) and each outcome lands on
        the event timeline."""
        with self._rollout_lock:
            self.rollout_phase = "prepare"
            try:
                report = self._coordinated_reload_locked(step)
            finally:
                self.rollout_phase = "idle"
        if report["status"] != "noop":
            self.note_event(
                "rollout_" + report["status"],
                **{k: v for k, v in report.items()
                   if k in ("step", "replica", "phase", "detail",
                            "replicas")})
        return report

    def _coordinated_reload_locked(self, step: Optional[int] = None) -> dict:
        with self._lock:
            fleet = [r for r in self.replicas if r.healthy]
        if not fleet:
            return {"status": "no_replicas"}

        # -- phase 1: stage the SAME step everywhere ------------------
        # With no pinned step, DISCOVER the target first: walk the
        # fleet until some replica stages something newer than what it
        # serves.  One replica saying "nothing newer" is NOT a fleet
        # noop — a replica started earlier may serve an older step,
        # and the rollout is also the convergence mechanism for a
        # mixed fleet: if nobody stages but serving steps disagree,
        # the newest serving step becomes the target.
        target = step
        # the CONSERVATIVE pre-rollout version: the MINIMUM serving
        # step seen in phase 1.  It is only used to pin fleet_step on
        # a rolled-back rollout (so a suspect replica's re-admission
        # catch-up can never be steered to the new target) — on a
        # mixed fleet the first response's step could BE the target,
        # which would defeat the pin entirely.
        old_step: Optional[int] = None

        def note_serving(resp) -> None:
            nonlocal old_step
            s = resp.get("serving_step")
            if s is not None and (old_step is None or s < old_step):
                old_step = int(s)

        prepared: List[Replica] = []
        trivial: List[Replica] = []  # already serving the target
        # the replica whose prepare response is mid-validation: its
        # engine may have staged server-side before our validation
        # raised, so the except below must abort it alongside `prepared`
        inflight_prep: Optional[Replica] = None
        try:
            if target is None:
                serving: Dict[str, Optional[int]] = {}
                for replica in fleet:
                    inflight_prep = replica
                    # a prepare that stages nothing leaves nothing to
                    # settle; every path that lands a replica in
                    # `prepared` commits, rolls back, or aborts it below
                    resp = self._admin(replica, "prepare", {})  # glomlint: disable=proto-paired-call -- the noop return (nothing staged fleet-wide) has nothing to settle; the except below aborts every other early exit
                    if resp is None:
                        # the failed replica gets an abort too: a router-
                        # side timeout with engine-side success would
                        # strand a full staged param tree there
                        self._abort(prepared + [replica])
                        return {"status": "aborted", "phase": "prepare",
                                "replica": replica.name,
                                "detail": "prepare failed"}
                    note_serving(resp)
                    serving[replica.name] = resp.get("serving_step")
                    staged = resp.get("staged_step")
                    if staged is not None:
                        target = int(staged)
                        prepared.append(replica)
                        break  # pin the rest to this step below
                if target is None:
                    distinct = {v for v in serving.values()}
                    if len(distinct) <= 1:
                        return {"status": "noop",
                                "step": next(iter(distinct), None)}
                    target = max(v for v in distinct if v is not None)

            for replica in fleet:
                if replica in prepared:
                    continue
                inflight_prep = replica
                resp = self._admin(replica, "prepare", {"step": target})  # glomlint: disable=proto-paired-call -- the noop return below is only reachable with `prepared` empty; every other early exit aborts (loop bodies + the except below)
                if resp is None:
                    self._abort(prepared + [replica])
                    return {"status": "aborted", "phase": "prepare",
                            "replica": replica.name,
                            "detail": "prepare failed"}
                note_serving(resp)
                staged = resp.get("staged_step")
                if staged is None:
                    if resp.get("serving_step") == target:
                        trivial.append(replica)
                        continue
                    self._abort(prepared + [replica])
                    return {"status": "aborted", "phase": "prepare",
                            "replica": replica.name,
                            "detail": f"could not stage step {target}"}
                if int(staged) != target:
                    self._abort(prepared + [replica])
                    return {"status": "aborted", "phase": "prepare",
                            "replica": replica.name,
                            "detail": f"staged {staged} != target {target}"}
                prepared.append(replica)
        except Exception:
            # an unexpected failure mid-prepare (a malformed replica
            # response feeding int(), a raising transport) must not
            # strand staged param trees — neither on the replicas
            # already prepared NOR on the one whose response we were
            # validating (its engine may have staged before the
            # validation raised; an abort with nothing staged is a
            # no-op engine-side)
            extra = ([inflight_prep] if inflight_prep is not None
                     and inflight_prep not in prepared else [])
            self._abort(prepared + extra)
            raise
        if not prepared and not trivial:
            return {"status": "noop", "step": target}

        # -- phase 2: gate dispatch, drain, commit everywhere ---------
        # the gate closes UNDER the dispatch lock: _pick_locked checks
        # it in the same critical section that increments inflight, so
        # once clear() returns, every admitted request is visible to
        # the drain below and every unadmitted one re-waits
        with self._lock:
            self._dispatch_open.clear()
        self.rollout_phase = "drain"
        try:
            # drain in-flight work before the first commit: a response
            # computed DURING the commit window would expose a half-
            # committed fleet — or, worse, a dirty read of the new
            # step that a later rollback retracts.  With the gate
            # closed and in-flight at zero, every response completes
            # strictly before (all-old) or strictly after (all-new,
            # or all-old on rollback) the swap.
            drain_deadline = self._clock() + self.drain_timeout_s
            while True:
                with self._lock:
                    if all(r.inflight == 0 for r in self.replicas):
                        break
                if self._clock() >= drain_deadline:
                    # proceeding with stragglers in flight weakens the
                    # ordering guarantee for exactly those requests —
                    # never silently: the counter + warning make an
                    # undersized drain_timeout_s visible
                    self.registry.counter(
                        "router_drain_timeouts_total",
                        help="rollouts that committed with requests "
                             "still in flight (drain deadline hit)",
                    ).inc()
                    warnings.warn(
                        f"rollout drain did not reach zero in-flight "
                        f"within {self.drain_timeout_s}s; committing "
                        f"anyway — in-flight responses may interleave "
                        f"with the version flip", stacklevel=2,
                    )
                    self.note_event("drain_timeout")
                    break
                self._sleep(0.005)
            self.rollout_phase = "commit"
            committed: List[Replica] = []
            for replica in prepared:
                resp = self._admin(replica, "commit",
                                   timeout=self.commit_timeout_s)
                if resp is None or resp.get("step") != target:
                    # roll the fleet back BEFORE the gate reopens: no
                    # post-gate dispatch may ever see the new step.
                    # The failed replica gets an abort too — an HTTP-
                    # level commit failure may have left it staged.
                    for done in committed:
                        if self._admin(done, "rollback",
                                       timeout=self.commit_timeout_s
                                       ) is None:
                            # the rollback itself failed: this replica
                            # may still serve the NEW step in a fleet
                            # that reverted — eject it; re-admission
                            # catch-up (fleet_step pinned below) rolls
                            # it back before it takes traffic again
                            with self._lock:
                                done.fail_streak = max(
                                    done.fail_streak,
                                    self.eject_after - 1)
                                self._note_failure(done)
                            self.registry.counter(
                                "router_rollback_failures_total",
                                help="replicas whose rollback call "
                                     "failed (ejected until catch-up)",
                            ).inc()
                    self._abort([r for r in prepared
                                 if r not in committed])
                    # the failed replica may have committed server-side
                    # with the response lost: eject it, and pin the
                    # fleet step to the OLD version so re-admission
                    # catch-up forces it back into agreement before it
                    # takes traffic again
                    with self._lock:
                        replica.fail_streak = max(
                            replica.fail_streak, self.eject_after - 1)
                        self._note_failure(replica)
                    if old_step is not None:
                        self.fleet_step = int(old_step)
                    self.registry.counter(
                        "router_rollbacks_total",
                        help="coordinated rollouts reverted after a "
                             "commit failure",
                    ).inc()
                    return {"status": "rolled_back",
                            "replica": replica.name,
                            "step": target,
                            "detail": "commit failed; fleet reverted"}
                committed.append(replica)
            self.fleet_step = target
            with self._lock:
                for replica in prepared + trivial:
                    replica.step = target
            self.registry.counter(
                "router_rollouts_total",
                help="coordinated fleet reloads committed",
            ).inc()
            self.registry.gauge(
                "router_fleet_step",
                help="checkpoint step the fleet serves",
            ).set(target)
        finally:
            self._dispatch_open.set()
        # the rollout landed everywhere: release each replica's
        # rollback point (a full second device param tree) AFTER the
        # gate reopened — memory hygiene must not extend the gated
        # window, and the rollback window is over by definition here.
        # A failed finalize only delays the release to the next
        # rollout; never worth failing the rollout over.
        for replica in prepared:
            self._admin(replica, "finalize",
                        timeout=self.commit_timeout_s)
        return {"status": "committed", "step": target,
                "replicas": [r.name for r in prepared + trivial]}

    def _abort(self, prepared: Sequence[Replica]) -> None:
        for replica in prepared:
            self._admin(replica, "abort")

    def _rollout_loop(self) -> None:
        while not self._stop.wait(self.rollout_poll_s):
            try:
                self.coordinated_reload()
            except Exception as e:  # the poll loop must outlive any rollout bug
                self.registry.counter(
                    "router_rollout_errors_total",
                    help="rollout poll iterations that raised",
                ).inc()
                warnings.warn(
                    f"rollout poll iteration raised "
                    f"({type(e).__name__}: {e}); router continues",
                    stacklevel=2,
                )

    # -- aggregate views ----------------------------------------------------
    def health(self) -> dict:
        with self._lock:
            replicas = [r.to_dict() for r in self.replicas]
            healthy = [r for r in self.replicas if r.healthy]
            model = next(
                (r.last_health for r in healthy if r.last_health), None)
        n = len(healthy)
        status = "ok" if n == len(self.replicas) else (
            "degraded" if n else "down")
        out = {
            "status": status,
            "role": "router",
            "healthy_replicas": n,
            "fleet_step": self.fleet_step,
            # glomlint: disable=conc-unguarded-attr -- live phase indicator: /healthz must answer while a rollout holds _rollout_lock for its whole prepare/drain/commit cycle; a stale phase string is the display contract
            "rollout_phase": self.rollout_phase,
            "replicas": replicas,
        }
        with self._jobs_lock:
            if self._jobs:
                out["bulk_jobs"] = {
                    n: rec["status"] for n, rec in self._jobs.items()}
        if model:
            # surface the model's input contract so loadgen (and any other
            # client) reads the router exactly like a single engine
            for key in ("image_size", "patch_size", "channels", "levels",
                        "dim", "step", "buckets", "quant", "mesh",
                        "param_sharding", "hierarchy"):
                if key in model:
                    out[key] = model[key]
        return out

    def metrics_text(self, *, openmetrics: bool = False) -> str:
        """Router families verbatim + every reachable replica's families
        relabeled with ``replica="<name>"`` (HELP/TYPE deduped across
        replicas — Prometheus rejects repeated metadata).  Replica
        scrapes run CONCURRENTLY: serial fetches would stack one
        ``health_timeout_s`` per blackholed replica and blow a typical
        Prometheus scrape_timeout exactly when replicas are unhealthy.
        ``openmetrics=True`` (the front negotiated it via Accept)
        forwards the negotiation to each replica scrape and renders the
        router's own exemplars; a plain 0.0.4 client gets (and causes the
        replicas to emit) exemplar-free text."""
        from concurrent.futures import ThreadPoolExecutor

        replicas = list(self.replicas)
        fetch_headers = ({"Accept": OPENMETRICS_CONTENT_TYPE}
                         if openmetrics else {})

        def fetch(replica):
            try:
                return self._http("GET", f"{replica.url}/metrics", None,
                                  fetch_headers, self.health_timeout_s)
            except Exception:  # glomlint: disable=conc-broad-except -- a dead replica's scrape is skipped from the aggregate; ejecting it is the health loop's job, not the scrape's
                return None

        with ThreadPoolExecutor(
            max_workers=min(8, max(1, len(replicas)))
        ) as pool:
            fetched = list(pool.map(fetch, replicas))

        parts = [prometheus_lines(self.registry, exemplars=openmetrics)]
        seen_meta = set()
        for replica, result in zip(replicas, fetched):
            if result is None:
                parts.append(f"# replica {replica.name} unreachable\n")
                continue
            status, _, body = result
            if status != 200:
                parts.append(f"# replica {replica.name} /metrics -> "
                             f"{status}\n")
                continue
            out = []
            for line in body.decode(errors="replace").splitlines():
                if line.startswith("#"):
                    # replica EOF terminators must not land mid-aggregate
                    if line.strip() != "# EOF" and line not in seen_meta:
                        seen_meta.add(line)
                        out.append(line)
                    continue
                m = _SAMPLE_RE.match(line)
                if not m:
                    continue
                name, labels, rest = m.groups()
                inner = labels[1:-1] if labels else ""
                label = f'replica="{replica.name}"' + (
                    f",{inner}" if inner else "")
                out.append(f"{name}{{{label}}}{rest}")
            parts.append("\n".join(out) + "\n")
        text = "".join(parts)
        if openmetrics:
            # strict OpenMetrics forbids interleaved metric families: the
            # per-replica blocks repeat family names (and the router now
            # shares serving-span families with its replicas), so the
            # aggregate is regrouped family-contiguous and terminated
            from glom_tpu_torch.obs.exporters import regroup_families

            text = regroup_families(text) + "# EOF\n"
        return text

    # -- lifecycle ----------------------------------------------------------
    def start(self, *, health: bool = True) -> None:
        """Probe every replica once synchronously (a dead replica must be
        ejected before the first request, not an interval later), then run
        the probe loop — and the rollout poll when configured."""
        self.check_health_once(force=True)
        if health and self.health_interval_s > 0:
            t = threading.Thread(target=self._health_loop,
                                 name="glom-router-health", daemon=True)
            t.start()
            self._threads.append(t)
        if self.rollout_poll_s > 0:
            t = threading.Thread(target=self._rollout_loop,
                                 name="glom-router-rollout", daemon=True)
            t.start()
            self._threads.append(t)

    def shutdown(self) -> None:
        self._stop.set()
        self._dispatch_open.set()  # release any gated handler threads
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
        if self.tracer.exporter is not None:
            self.tracer.exporter.close()


# ---------------------------------------------------------------------------
# stdlib HTTP front
# ---------------------------------------------------------------------------
class RouterHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    # stdlib default backlog is 5: a burst of fresh connections (clients
    # without keep-alive, a loadgen wave) overflows it and the dropped
    # SYNs retransmit on second-scale timers — a 300ms+ latency cliff
    # that looks like router overhead but is just the listen queue
    request_queue_size = 128

    def __init__(self, addr, handler, router: FleetRouter, *,
                 quiet: bool = True):
        super().__init__(addr, handler)
        self.router = router
        self.quiet = quiet


class _RouterHandler(BaseHTTPRequestHandler):
    server_version = "glom-router"
    protocol_version = "HTTP/1.1"
    # headers and body are separate writes; without TCP_NODELAY Nagle can
    # hold the body segment against a delayed ACK — 40ms quanta on a
    # reply that took 2ms to compute
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):
        if not getattr(self.server, "quiet", True):
            super().log_message(fmt, *args)

    def _reply(self, code: int, payload, content_type="application/json",
               extra_headers: Optional[Dict[str, str]] = None) -> None:
        if code >= 400:
            self.server.router.registry.counter(
                f"router_errors_{code // 100}xx",
                help=f"router replies with a {code // 100}xx status",
            ).inc()
        body = (json.dumps(payload) if isinstance(payload, (dict, list))
                else payload)
        body = body.encode() if isinstance(body, str) else body
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        rid = getattr(self, "_request_id", None)
        if rid is not None:
            self.send_header("X-Request-Id", rid)
            tid = self._trace_root.trace_id
            if _HEX_ID.fullmatch(tid):
                self.send_header("traceparent", format_traceparent(
                    tid, self._trace_root.span_id))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        self._request_id = None
        router = self.server.router
        from urllib.parse import urlparse

        parsed = urlparse(self.path)
        if parsed.path == "/healthz":
            self._reply(200, router.health())
        elif parsed.path == "/metrics":
            # see server.py: exemplars only under negotiated OpenMetrics
            om = wants_openmetrics(self.headers.get("Accept"))
            self._reply(200, router.metrics_text(openmetrics=om),
                        content_type=(OPENMETRICS_CONTENT_TYPE if om
                                      else PROM_TEXT_CONTENT_TYPE))
        # -- debug plane: the fleet observatory's pull endpoints -----------
        elif parsed.path == "/debug/traces":
            status, payload = debug_traces_payload(
                router.tracer, parsed.query, role="router")
            self._reply(status, payload)
        elif parsed.path == "/debug/timeline":
            self._reply(200, {
                "role": "router",
                "fleet_step": router.fleet_step,
                "rollout_phase": router.rollout_phase,
                "events": router.timeline(),
            })
        elif parsed.path == "/debug/series":
            # fleet TSDB-lite pull plane: per-replica (labeled) and
            # fleet-aggregate capacity series (glom_tpu_torch.obs.timeseries)
            self._reply(200, router.capacity.series_payload(parsed.query))
        elif parsed.path == "/capacity":
            self._reply(200, router.capacity.payload())
        elif parsed.path == "/quality":
            # fleet quality rollup: exactly-merged replica sketches plus
            # the per-replica summaries they were merged from
            self._reply(200, router.quality.payload())
        elif parsed.path == "/admin/jobs/status":
            # fleet bulk-job progress: built from health-loop-witnessed
            # cursors, so the read costs no replica HTTP
            from urllib.parse import parse_qs

            q = parse_qs(parsed.query)
            try:
                self._reply(200, router.job_status(q.get("name",
                                                         [None])[0]))
            except KeyError as e:
                self._reply(404, {"error": str(e)})
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self):  # noqa: N802
        self._request_id = None
        router = self.server.router
        if self.path == "/rollout":
            length = int(self.headers.get("Content-Length") or 0)
            payload = {}
            if length:
                try:
                    payload = json.loads(self.rfile.read(length))
                except ValueError as e:
                    self._reply(400, {"error": f"invalid JSON: {e}"})
                    return
            if not isinstance(payload, dict):
                self._reply(400, {"error": "body must be a JSON object"})
                return
            step = payload.get("step")
            report = router.coordinated_reload(
                step=int(step) if step is not None else None)
            code = 200 if report["status"] in ("committed", "noop") else 502
            self._reply(code, report)
            return
        if self.path.startswith("/admin/jobs/"):
            # fleet bulk-job admin: submit shards the range across the
            # healthy replicas; pause/resume/cancel fan out to owners
            action = self.path[len("/admin/jobs/"):]
            length = int(self.headers.get("Content-Length") or 0)
            payload = {}
            if length:
                try:
                    payload = json.loads(self.rfile.read(length))
                except ValueError as e:
                    self._reply(400, {"error": f"invalid JSON: {e}"})
                    return
            if not isinstance(payload, dict):
                self._reply(400, {"error": "body must be a JSON object"})
                return
            try:
                if action == "submit":
                    self._reply(200, router.submit_job(payload))
                elif action == "status":
                    self._reply(200,
                                router.job_status(payload.get("name")))
                elif action in ("pause", "resume", "cancel"):
                    name = payload.get("name")
                    if not name:
                        self._reply(400, {"error": f"{action} needs a "
                                                   f"job name"})
                        return
                    self._reply(200, router.job_admin(action, name))
                else:
                    self._reply(404,
                                {"error": f"no jobs action {action!r}"})
            except KeyError as e:
                self._reply(404, {"error": str(e)})
            except NoHealthyReplica as e:
                self._reply(503, {"error": str(e)})
            except (RuntimeError, ValueError) as e:
                self._reply(409, {"error": str(e)})
            return
        if self.path not in ROUTED_PATHS:
            self._reply(404, {"error": f"no route {self.path}"})
            return
        endpoint = self.path[1:]
        tracer = router.tracer

        rid_header = request_trace_id(self.headers.get("X-Request-Id"))
        remote = parse_traceparent(self.headers.get("traceparent"))
        root = tracer.start_trace(
            SPAN_ROUTER_REQUEST,
            trace_id=rid_header or (remote[0] if remote else None),
            parent_id=remote[1] if remote else None,
            attrs={"endpoint": endpoint},
        )
        self._trace_root = root
        self._request_id = rid_header or root.trace_id

        length = int(self.headers.get("Content-Length") or 0)
        if length <= 0:
            self._reply(400, {"error": f"bad Content-Length {length}"})
            tracer.end(root, attrs={"status": 400})
            return
        body = self.rfile.read(length)
        # tile the router handler exactly like the engine handler: parse
        # (headers + body read) and respond (reply write) recorded with
        # SHARED edges around the dispatch window, so the stitched trace's
        # coverage has no router-side instrumentation gap — the reply
        # write scales with the response body and was the uncovered tail
        # that dragged big-batch traces under the coverage bar
        t_read = tracer.clock()
        tracer.record(SPAN_PARSE, root, root.start, t_read)
        fwd = {"Content-Type": self.headers.get("Content-Type",
                                                "application/json")}
        if rid_header:
            fwd["X-Request-Id"] = rid_header
        affinity = self.headers.get("X-Affinity-Key")
        if affinity:
            fwd["X-Affinity-Key"] = affinity
        # the tenant identity must survive the hop or the engine-side
        # bulkheads (admission quota, per-tenant SLOs/metrics) are
        # silently inert in the router-fronted topology
        tenant = self.headers.get("X-Tenant")
        if tenant:
            fwd["X-Tenant"] = tenant
        if endpoint == "similar":
            # shard fan-out, not single-replica proxy: every healthy
            # replica answers from its index shards; merged top-k here
            try:
                status, payload, served = router.similar_fanout(
                    body, fwd, root_span=root)
            except NoHealthyReplica as e:
                self._reply(503, {"error": "no_replica", "detail": str(e)})
                tracer.end(root, attrs={"status": 503})
                return
            router.registry.counter(
                "router_requests_total",
                help="requests proxied to replicas",
            ).inc()
            t_done = tracer.clock()
            self._reply(status, payload,
                        extra_headers=({"X-Served-By": served}
                                       if served else None))
            t_end = tracer.clock()
            tracer.record(SPAN_RESPOND, root, t_done, t_end)
            tracer.end(root, attrs={"status": status}, at=t_end)
            return
        try:
            status, _resp_headers, resp_body, replica = router.dispatch(
                endpoint, body, fwd, root_span=root, affinity_key=affinity,
            )
        except NoHealthyReplica as e:
            self._reply(503, {"error": "no_replica", "detail": str(e)})
            tracer.end(root, attrs={"status": 503})
            return
        router.registry.counter(
            "router_requests_total", help="requests proxied to replicas",
        ).inc()
        t_done = tracer.clock()
        self._reply(status, resp_body,
                    extra_headers={"X-Served-By": replica.name})
        t_end = tracer.clock()
        tracer.record(SPAN_RESPOND, root, t_done, t_end)
        tracer.end(root, attrs={"status": status, "replica": replica.name},
                   at=t_end)


def make_router_server(router: FleetRouter, host: str = "127.0.0.1",
                       port: int = 0, *, quiet: bool = True
                       ) -> RouterHTTPServer:
    """Bind (port 0 = ephemeral); caller runs ``serve_forever``."""
    return RouterHTTPServer((host, port), _RouterHandler, router, quiet=quiet)


# ---------------------------------------------------------------------------
# CLI: route existing replicas, or --spawn an in-process fleet
# ---------------------------------------------------------------------------
def _spawn_fleet(n: int, args) -> Tuple[List[str], list]:
    """--spawn mode: N of the port's engines + servers in this process, on
    ``args.device`` (each replica owns its batcher, its graph sets and its
    parameters).  Returns (urls, [(engine, server), ...])."""
    from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint
    from glom_tpu_torch.serving.server import make_server
    from glom_tpu_torch import checkpoint as ckpt_lib

    if args.demo and ckpt_lib.latest_step(args.checkpoint_dir) is None:
        make_demo_checkpoint(args.checkpoint_dir)
    urls, members = [], []
    for i in range(n):
        engine = ServingEngine(
            args.checkpoint_dir,
            buckets=tuple(int(b) for b in args.buckets.split(",")),
            max_wait_ms=args.max_wait_ms,
            device=args.device,
            # replicas NEVER self-reload: the router's coordinated
            # rollout is the only param-swap path in a fleet
            reload_poll_s=0,
            quant=args.quant,
            # passed through raw: the engine normalizes None/'auto'/int
            warm_iters=args.warm_iters,
            # per-replica job store; the shared sink lives in the specs
            bulk_dir=(os.path.join(args.bulk_dir, f"r{i}")
                      if getattr(args, "bulk_dir", None) else None),
            # one shared index root is fine: the router's /similar merge
            # dedupes by slot, so full-copy and sharded layouts coexist
            index_dir=getattr(args, "index_dir", None),
            parse_thresholds=getattr(args, "parse_thresholds", None),
        )
        engine.start(watch=False)
        # per-replica capacity sampler: its /healthz summary feeds the
        # router's fleet capacity plane
        engine.capacity.start()
        server = make_server(engine, args.host, 0)
        threading.Thread(target=server.serve_forever, daemon=True,
                         name=f"glom-replica-{i}").start()
        host, port = server.server_address[:2]
        urls.append(f"http://{host}:{port}")
        members.append((engine, server))
    return urls, members


def main(argv=None) -> int:
    import argparse
    import signal

    p = argparse.ArgumentParser(
        description="GLOM replica fleet router: least-loaded/consistent-"
                    "hash dispatch, health-aware ejection, coordinated "
                    "hot-reload",
    )
    p.add_argument("--replica", action="append", default=None, metavar="URL",
                   help="engine replica base URL (repeatable)")
    p.add_argument("--spawn", type=int, default=0, metavar="N",
                   help="spawn N in-process engine replicas from "
                        "--checkpoint-dir instead of routing external URLs")
    p.add_argument("--checkpoint-dir", default=None,
                   help="checkpoint dir for --spawn replicas")
    p.add_argument("--demo", action="store_true",
                   help="with --spawn: write a demo checkpoint if the dir "
                        "has none")
    p.add_argument("--buckets", default="1,2,4,8",
                   help="with --spawn: per-replica batch buckets")
    p.add_argument("--quant", default="f32", choices=["f32", "bf16", "int8"],
                   help="with --spawn: per-replica serving precision")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="with --spawn: per-replica micro-batch deadline")
    p.add_argument("--warm-iters", default=None, metavar="N|auto",
                   help="with --spawn: enable stateful sessions on every "
                        "replica (clients pin a session with "
                        "X-Affinity-Key: <session id>)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8800)
    p.add_argument("--health-interval-s", type=float, default=1.0,
                   help="replica /healthz probe period")
    p.add_argument("--eject-after", type=int, default=2,
                   help="consecutive failures before a replica is ejected")
    p.add_argument("--rollout-poll-s", type=float, default=0.0,
                   help="poll for new checkpoints and roll the fleet "
                        "forward every this many seconds; 0 = POST "
                        "/rollout only")
    p.add_argument("--trace-log", default=None,
                   help="JSONL file receiving one record per completed "
                        "router trace")
    p.add_argument("--capacity-policy", default=None, metavar="SPEC",
                   help="fleet dry-run autoscale policy, e.g. "
                        "'p95_ms<250,duty<0.8,shed<0.01' — evaluated over "
                        "fleet-aggregate series each health pass; emits "
                        "scale-up/down/rebalance RECOMMENDATIONS to the "
                        "timeline and GET /capacity, never acts")
    p.add_argument("--capacity-persist-windows", type=int, default=5,
                   help="consecutive scale-up windows before a replica-"
                        "side capacity_pressure incident is expected")
    p.add_argument("--bulk-dir", default=None, metavar="DIR",
                   help="--spawn mode: enable the bulk inference tier "
                        "with a per-replica job store under DIR/<name>; "
                        "the router shards /admin/jobs/* "
                        "submits across the fleet")
    p.add_argument("--index-dir", default=None, metavar="DIR",
                   help="--spawn mode: similarity-index root handed to "
                        "every replica (POST /similar fans across the "
                        "fleet and merges top-k)")
    p.add_argument("--parse-thresholds", default=None, metavar="T|T0,T1,..",
                   help="--spawn mode: per-level agreement thresholds for "
                        "POST /parse islanding (default 0.9)")
    p.add_argument("--device", default="cuda",
                   help="with --spawn: torch device of every replica; 'cpu' runs the "
                        "plain PyTorch versions of the kernels")
    p.add_argument("--platform", default=argparse.SUPPRESS, help=argparse.SUPPRESS)
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    if hasattr(args, "platform"):
        p.error("--platform is not in the port's router (the port picks its device "
                "with --device)")

    members = []
    if args.spawn:
        if not args.checkpoint_dir:
            p.error("--spawn needs --checkpoint-dir")
        urls, members = _spawn_fleet(args.spawn, args)
    else:
        urls = args.replica or []
        if not urls:
            p.error("need --replica URL(s) or --spawn N")

    router = FleetRouter(
        urls,
        health_interval_s=args.health_interval_s,
        eject_after=args.eject_after,
        rollout_poll_s=args.rollout_poll_s,
        trace_log=args.trace_log,
        capacity_policy=args.capacity_policy,
        capacity_persist_windows=args.capacity_persist_windows,
    )
    router.start()
    server = make_router_server(router, args.host, args.port,
                                quiet=not args.verbose)

    stop_once = threading.Event()

    def _graceful(signum, frame):
        if stop_once.is_set():
            return
        stop_once.set()
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)

    host, port = server.server_address[:2]
    print(json.dumps({
        "event": "routing", "host": host, "port": port,
        "replicas": urls,
        "healthy": router.health()["healthy_replicas"],
    }), flush=True)
    try:
        server.serve_forever(poll_interval=0.2)
    finally:
        router.shutdown()
        server.server_close()
        for engine, eng_server in members:
            eng_server.shutdown()
            engine.shutdown(drain=True)
            eng_server.server_close()
        print(json.dumps({"event": "router_drained"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
