"""Elastic multi-host training (``glom_tpu/resilience/elastic.py``): fault
domains, coordinator election, re-planning on a change of host count.

The port's copy of ``glom_tpu``'s module, on the port's
:mod:`~glom_tpu_torch.resilience.faultinject`, ``integrity``, ``supervisor``
and ``obs/triggers``: the same classes, the same decisions from the same
fault spec, seed and clock.

  * **Per-host fault domains** (:class:`FaultDomain`): every host carries
    its own sliding-window failure accounting and backoff.  One host
    crash-looping exhausts its domain (it is marked dead and the job
    re-plans without it); the survivors' counters never move, and the job
    never dies for it while ``min_hosts`` remain.
  * **Heartbeat-based coordinator-loss detection**
    (:class:`HeartbeatTracker`) with **deterministic successor election**
    (:func:`elect_coordinator`: the lowest live host id, the lost
    coordinator excluded).
  * **Re-planning on a change of host count**: the mesh is re-derived by
    :func:`glom_tpu_torch.parallel.mesh.elastic_mesh_shape` (the data axis
    absorbs the change, model and seq are kept), the params reshard from
    the newest checkpoint that verifies (``integrity.latest_valid_step``),
    the exactly-once data cursor re-partitions (it is a host-count-free
    global position, :class:`glom_tpu_torch.training.data.ElasticBatches`),
    and training resumes instead of giving up.

Every decision point is driven through the seeded fault sites
(``host_preempt``, ``coordinator_loss``, ``heartbeat_delay``,
``shrink_restart``) and every timestamp through an injected clock
(:class:`SimClock` for tests and chaos), so recovery replays bit for bit.
The module imports no numerics; the mesh arithmetic import is lazy.

On a mesh of ``torch.distributed`` ranks, a host is a rank (times
``devices_per_host``) and a plan's mesh covers the world's first
``host_count * devices_per_host`` ranks
(:func:`~glom_tpu_torch.parallel.mesh.make_elastic_mesh`).  Every rank runs
the same seeded supervisor: its decisions are a function of the spec, the
seed, the clock and the ticks, so every rank makes them alike without a
message, as long as every rank ticks the same steps and reads the
checkpoint directory at the same point (the driver waits for every rank at
the end of each attempt).  A rank a plan leaves out still ticks the
attempt's steps, with no trainer, from the step and cursor rank 0 resumed
from and announces (``tools/chaos.py::elastic_run``).

The driver contract: ``attempt_fn(plan, ctx)`` runs one training attempt
for an :class:`ElasticPlan` and must call ``ctx.tick()`` once per global
step (or iterate a ``ctx.wrap(...)``-wrapped batch stream, which does it):
the tick is where preemptions strike, heartbeats land, and staleness is
judged.

Where the port differs: a job-level failure that
:func:`~glom_tpu_torch.resilience.supervisor.classify_failure` names
``cuda_fatal`` (a sticky CUDA error poisons the process's context) gives up
at once, as the port's :class:`~glom_tpu_torch.resilience.supervisor.Supervisor`
does.
"""

from __future__ import annotations

import random
import time
import traceback
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from glom_tpu_torch.obs.triggers import (
    TRIGGER_COORDINATOR_LOSS,
    TRIGGER_ELASTIC_REPLAN,
    TRIGGER_HOST_PREEMPT,
)
from glom_tpu_torch.resilience import faultinject, integrity
from glom_tpu_torch.resilience.supervisor import (
    REASON_CUDA_FATAL,
    GiveUp,
    PreemptionError,
    RestartPolicy,
    classify_failure,
)


class HostPreemptedError(PreemptionError):
    """One fault domain died (scheduler reclaim, silent worker): the job
    re-plans; only the named host's domain is charged."""

    def __init__(self, host_id: int, step: int = 0, detail: str = ""):
        self.host_id = int(host_id)
        self.step = int(step)
        super().__init__(
            f"host {host_id} preempted at elastic tick {step}"
            + (f" ({detail})" if detail else "")
        )


class CoordinatorLostError(RuntimeError):
    """The coordinator's heartbeat went stale: a successor must be
    elected before the job can continue."""

    def __init__(self, host_id: int, step: int = 0):
        self.host_id = int(host_id)
        self.step = int(step)
        super().__init__(
            f"coordinator host {host_id} heartbeat stale at elastic "
            f"tick {step}"
        )


class SimClock:
    """Deterministic simulation clock for chaos runs and tests: reading
    never advances time; ``advance``/``sleep`` move it explicitly.  Passed
    as ``clock=``/``sleep=``/``advance=`` so heartbeat-timeout and backoff
    arithmetic replay exactly."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)

    def sleep(self, s: float) -> None:  # an injected sleep IS a time jump
        self.t += float(s)


def elect_coordinator(hosts: Sequence[int],
                      exclude: Sequence[int] = ()) -> int:
    """Deterministic successor election: the LOWEST live host id not in
    ``exclude`` wins.  No quorum protocol — host liveness is already
    agreed through the fault-domain bookkeeping, so the election only has
    to be a pure function every survivor computes identically."""
    candidates = sorted(set(hosts) - set(exclude))
    if not candidates:
        raise GiveUp("no live host eligible for coordinator election")
    return candidates[0]


@dataclass(frozen=True)
class ElasticPlan:
    """One attempt's topology: which hosts run, who coordinates, and the
    mesh the params reshard onto.  ``resume_step`` is the newest
    checkpoint step that verified at plan time (None = fresh start)."""

    generation: int
    hosts: Tuple[int, ...]
    coordinator: int
    devices_per_host: int
    mesh_shape: Tuple[int, ...]
    resume_step: Optional[int] = None

    @property
    def host_count(self) -> int:
        return len(self.hosts)

    def to_json_dict(self) -> dict:
        return {
            "generation": self.generation,
            "hosts": list(self.hosts),
            "coordinator": self.coordinator,
            "devices_per_host": self.devices_per_host,
            "mesh_shape": list(self.mesh_shape),
            "resume_step": self.resume_step,
        }


class FaultDomain:
    """Per-host failure accounting: ITS sliding window, ITS backoff, ITS
    giveup — the isolation that lets one crash-looping host degrade the
    fleet by exactly one domain instead of taking the job down."""

    def __init__(self, host_id: int, policy: RestartPolicy,
                 rng: random.Random):
        self.host_id = int(host_id)
        self.policy = policy
        self._rng = rng
        self._failures: deque = deque()
        self.failures_total = 0
        self.restarts = 0
        self.steps = 0            # elastic ticks this domain participated in
        self.dead = False         # crash-loop giveup or shrink: never returns
        self.down_until = 0.0     # backoff gate (injected-clock timestamps)
        self.last_reason = ""

    def record_failure(self, now: float, reason: str) -> str:
        """Charge one failure to THIS domain; returns ``"giveup"`` when the
        domain's crash-loop policy exhausts (the domain is marked dead) or
        ``"backoff"`` with ``down_until`` advanced."""
        self._failures.append(now)
        while self._failures and now - self._failures[0] > self.policy.window_s:
            self._failures.popleft()
        self.failures_total += 1
        self.last_reason = reason
        if len(self._failures) >= self.policy.max_failures:
            self.dead = True
            return "giveup"
        delay = self.policy.backoff_s(self.restarts, self._rng)
        self.restarts += 1
        self.down_until = now + delay
        return "backoff"

    def available(self, now: float) -> bool:
        return not self.dead and now >= self.down_until


class HeartbeatTracker:
    """Last-beat table under an injected clock.  ``stale`` is the ONLY
    judgment: a host that misses beats for longer than ``timeout_s`` is
    presumed dead — delayed beats inside the window (the
    ``heartbeat_delay`` fault) must never eject anyone."""

    def __init__(self, timeout_s: float, clock: Callable[[], float]):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self._clock = clock
        self._last: Dict[int, float] = {}

    def reset(self, hosts: Sequence[int]) -> None:
        """(Re)arm the table for an attempt's host set: every host is
        credited a beat NOW, so backoff time never counts as staleness."""
        now = self._clock()
        self._last = {int(h): now for h in hosts}

    def beat(self, host: int) -> None:
        self._last[int(host)] = self._clock()

    def age(self, host: int) -> float:
        return self._clock() - self._last[int(host)]

    def stale(self, host: int) -> bool:
        return self.age(host) > self.timeout_s


class ElasticContext:
    """Per-attempt handle: ``tick()`` once per global step is where the
    simulation's physics happen — fault sites fire, surviving hosts beat,
    staleness is judged, per-domain step cadence advances, and the first
    tick after a failure closes the MTTR measurement."""

    def __init__(self, supervisor: "ElasticSupervisor", plan: ElasticPlan):
        self._sup = supervisor
        self.plan = plan
        self.ticks = 0
        self._silenced: set = set()
        self._mttr_closed = False
        supervisor._tracker.reset(plan.hosts)

    # -- victim selection (deterministic, documented) ----------------------
    def _victim(self) -> int:
        """The highest-id live non-coordinator host; the coordinator only
        when it is the sole survivor.  A fixed rule, so a ``*COUNT`` spec
        hits the SAME host repeatedly — exactly the crash-loop shape the
        per-domain policy exists for."""
        workers = [h for h in self.plan.hosts
                   if h != self.plan.coordinator and h not in self._silenced]
        if workers:
            return max(workers)
        return self.plan.coordinator

    def tick(self, step: Optional[int] = None) -> None:
        sup = self._sup
        self.ticks += 1
        sup.ticks_total += 1
        tick_id = step if step is not None else sup.ticks_total
        if sup._advance is not None and sup.step_dt:
            sup._advance(sup.step_dt)
        now = sup._clock()

        delayed: set = set()
        if faultinject.fire("heartbeat_delay") is not None:
            delayed.add(self._victim())
        if faultinject.fire("coordinator_loss") is not None:
            # the coordinator goes SILENT (not a clean crash): nothing is
            # raised here — detection must come from heartbeat staleness
            self._silenced.add(self.plan.coordinator)
        if faultinject.fire("host_preempt") is not None:
            victim = self._victim()
            self._silenced.add(victim)
            raise HostPreemptedError(victim, step=tick_id,
                                     detail="injected preemption")

        for h in self.plan.hosts:
            if h in self._silenced:
                continue  # a silent host neither beats nor steps
            if h not in delayed:
                sup._tracker.beat(h)
            sup.domains[h].steps += 1
        for h in self.plan.hosts:
            if sup._tracker.stale(h):
                if h == self.plan.coordinator:
                    raise CoordinatorLostError(h, step=tick_id)
                raise HostPreemptedError(
                    h, step=tick_id, detail="heartbeat stale"
                )
        if not self._mttr_closed and sup._last_failure_t is not None:
            # the attempt's first tick COMPLETED (fault sites fired clean,
            # beats landed, nobody stale): service is restored — close the
            # MTTR measurement.  Deliberately at the END of the tick: an
            # attempt that dies again on its very first tick has restored
            # nothing and must extend the same outage.
            mttr = max(now - sup._last_failure_t, 0.0)
            sup.mttr_s.append(mttr)
            sup._last_failure_t = None
            if sup.registry is not None:
                sup.registry.gauge(
                    "elastic_mttr_s",
                    help="injected-clock seconds from the last failure to "
                         "the first completed post-restart step",
                    unit="seconds",
                ).set(mttr)
        self._mttr_closed = True

    def wrap(self, stream, record: Optional[list] = None):
        """Wrap a batch iterator so every draw ticks this context first
        (a preemption therefore strikes BEFORE the batch is consumed and
        the cursor never advances past it).  ``record`` collects the
        global sample slots actually CONSUMED (from the stream's
        consumer-exact cursor deltas) — the exactly-once evidence the
        acceptance tests audit."""
        return _TickedStream(self, stream, record)


class _TickedStream:
    """Iterator shim: tick-then-draw, cursor forwarding, consumed-slot
    recording.  State methods delegate to the inner stream so the trainer
    checkpoints the cursor exactly as if the shim were not there."""

    def __init__(self, ctx: ElasticContext, inner, record: Optional[list]):
        self._ctx = ctx
        self._inner = inner
        self._record = record
        self._stateful = hasattr(inner, "state_dict")
        self._prev = self._cursor()

    def _cursor(self) -> Optional[int]:
        if not self._stateful:
            return None
        state = self._inner.state_dict()
        consumed = state.get("consumed")
        return int(consumed) if consumed is not None else None

    def __iter__(self):
        return self

    def __next__(self):
        self._ctx.tick()
        item = next(self._inner)
        if self._record is not None:
            cur = self._cursor()
            if cur is not None and self._prev is not None:
                self._record.extend(range(self._prev, cur))
            self._prev = cur
        return item

    def state_dict(self):
        return self._inner.state_dict()

    def load_state_dict(self, state):
        self._inner.load_state_dict(state)
        self._prev = self._cursor()  # a restored cursor is a new baseline

    def close(self):
        close = getattr(self._inner, "close", None)
        if callable(close):
            close()


class ElasticSupervisor:
    """Coordinator/worker supervisor with per-host fault domains.

    ``attempt_fn(plan, ctx)`` runs one training attempt and must tick the
    context once per global step.  The run loop converts failures into
    re-plans:

    * :class:`HostPreemptedError` — the named domain is charged (its own
      window/backoff); a domain whose crash-loop policy exhausts is marked
      dead and the job re-plans WITHOUT it (degraded, not dead).  A
      preempted domain whose backoff fits inside ``rejoin_grace_s`` is
      waited for (full-fleet restart); otherwise the restart proceeds
      degraded and the host rejoins at the next re-plan it is up for.
    * :class:`CoordinatorLostError` — a successor is elected
      (:func:`elect_coordinator`, the lost coordinator excluded) and the
      lost host is charged like a preemption.
    * any other exception — a JOB-level failure (code/data bug: no single
      domain to blame) under its own sliding-window ``job_policy``; a
      sticky CUDA error gives up at once.

    Every re-plan fires the ``shrink_restart`` fault site (a seeded plan
    can make the failed host never return, or a new host appear), derives
    the mesh from the surviving host count, anchors ``resume_step`` on
    ``integrity.latest_valid_step``, and — when the host count changed —
    writes a ``elastic_replan`` forensics bundle with the before/after
    plans and the checkpointed data cursor.  ``GiveUp`` when fewer than
    ``min_hosts`` domains remain.  All clocks/sleeps/jitter are
    injectable; with :class:`SimClock` the whole recovery history is a
    deterministic function of (spec, seed).
    """

    def __init__(
        self,
        attempt_fn: Callable[[ElasticPlan, ElasticContext], Any],
        *,
        hosts: int = 2,
        devices_per_host: int = 1,
        policy: Optional[RestartPolicy] = None,
        job_policy: Optional[RestartPolicy] = None,
        min_hosts: int = 1,
        heartbeat_timeout_s: float = 5.0,
        rejoin_grace_s: float = 1.0,
        step_dt: float = 0.0,
        checkpoint_dir: Optional[str] = None,
        registry=None,
        forensics=None,
        observer: Optional[integrity.IntegrityObserver] = None,
        mesh_shape_fn: Optional[Callable[[int, int], tuple]] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        advance: Optional[Callable[[float], None]] = None,
        seed: int = 0,
    ):
        if hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {hosts}")
        if min_hosts < 1 or min_hosts > hosts:
            raise ValueError(
                f"min_hosts must be in [1, {hosts}], got {min_hosts}"
            )
        self.attempt_fn = attempt_fn
        self.policy = policy if policy is not None else RestartPolicy()
        self.job_policy = (job_policy if job_policy is not None
                           else self.policy)
        self.devices_per_host = int(devices_per_host)
        self.min_hosts = int(min_hosts)
        self.rejoin_grace_s = float(rejoin_grace_s)
        self.step_dt = float(step_dt)
        self.checkpoint_dir = checkpoint_dir
        self.registry = registry
        self.forensics = forensics
        self.observer = observer if observer is not None else (
            integrity.IntegrityObserver(registry=registry,
                                        forensics=forensics)
        )
        self._clock = clock
        self._sleep = sleep
        self._advance = advance
        self._rng = random.Random(seed)
        self._mesh_shape_fn = mesh_shape_fn
        self._tracker = HeartbeatTracker(heartbeat_timeout_s, clock)
        self.domains: Dict[int, FaultDomain] = {
            h: FaultDomain(h, self.policy,
                           random.Random((seed << 8) ^ (h + 1)))
            for h in range(hosts)
        }
        self._job_failures: deque = deque()
        self.plan: Optional[ElasticPlan] = None
        self.context: Optional[ElasticContext] = None
        self.generation = 0
        self.restarts = 0
        self.elections = 0
        self.replans = 0           # re-plans where the host count CHANGED
        self.ticks_total = 0
        self.mttr_s: List[float] = []
        self._last_failure_t: Optional[float] = None

    # -- telemetry ---------------------------------------------------------
    def _count(self, name: str, help: str) -> None:
        if self.registry is not None:
            self.registry.counter(name, help=help).inc()

    def _gauge(self, name: str, value: float, help: str = "") -> None:
        if self.registry is not None:
            self.registry.gauge(name, help=help).set(value)

    def _bundle(self, trigger: str, step: int, detail: dict) -> None:
        """Direct forensics capture (no debounce): every elastic incident
        is a distinct event and the domain policies bound the count."""
        if self.forensics is not None:
            self.forensics.capture(trigger, step, detail, trace=False)

    # -- planning ----------------------------------------------------------
    def _mesh_shape(self, host_count: int) -> tuple:
        if self._mesh_shape_fn is not None:
            return tuple(self._mesh_shape_fn(host_count,
                                             self.devices_per_host))
        from glom_tpu_torch.parallel.mesh import elastic_mesh_shape

        return elastic_mesh_shape(host_count, self.devices_per_host)

    def _cursor_detail(self, resume_step: Optional[int]) -> Optional[dict]:
        """Best-effort read of the checkpointed data cursor for the
        re-plan evidence (the bundle must show the position the restarted
        stream will resume from)."""
        if self.checkpoint_dir is None or resume_step is None:
            return None
        from glom_tpu_torch import checkpoint as ckpt_lib

        try:
            tree = ckpt_lib.load_tree(self.checkpoint_dir, resume_step,
                                      "data")
        except (OSError, KeyError, ValueError):
            return None  # no cursor in this checkpoint: stateless stream
        return {k: int(v) for k, v in tree.items()}

    def _replan(self, *, reason: str, failed: Optional[int],
                exclude_coordinator: Sequence[int] = ()) -> ElasticPlan:
        prev = self.plan
        # the shrink/grow site models "the restart after a HOST failure
        # came back with a different fleet": it only fires when a failed
        # host is named — the initial plan and job-level-failure replans
        # must not consume an occurrence with no effect (a spec's shrink
        # would silently vanish into e.g. an earlier data:crash restart)
        kind = (faultinject.fire("shrink_restart")
                if prev is not None and failed is not None else None)
        if kind == "shrink" and failed is not None:
            # the restart comes back with FEWER hosts: the failed one is
            # gone for good (its capacity was reclaimed, not rebooted)
            self.domains[failed].dead = True
        elif kind == "grow":
            new_id = max(self.domains) + 1
            self.domains[new_id] = FaultDomain(
                new_id, self.policy,
                random.Random((self._rng.randrange(1 << 30) << 8)
                              ^ (new_id + 1)))
        now = self._clock()
        # wait out backoffs short enough to be worth a full-fleet restart;
        # longer ones restart degraded (elasticity over completeness)
        waitable = [d.down_until - now for d in self.domains.values()
                    if not d.dead and now < d.down_until
                    and d.down_until - now <= self.rejoin_grace_s]
        if waitable:
            self._sleep(max(waitable))
            now = self._clock()
        live = sorted(h for h, d in self.domains.items() if d.available(now))
        if len(live) < self.min_hosts:
            raise GiveUp(
                f"{len(live)} live fault domain(s) < min_hosts="
                f"{self.min_hosts} after {reason!r} (dead: "
                f"{sorted(h for h, d in self.domains.items() if d.dead)})"
            )
        if (prev is not None and prev.coordinator in live
                and prev.coordinator not in exclude_coordinator):
            coordinator = prev.coordinator  # sticky: elections are churn
        else:
            coordinator = elect_coordinator(live,
                                            exclude=exclude_coordinator)
            if prev is not None and coordinator != prev.coordinator:
                self.elections += 1
                self._count("elastic_elections_total",
                            "coordinator successor elections")
        resume_step = None
        if self.checkpoint_dir is not None:
            resume_step = integrity.latest_valid_step(
                self.checkpoint_dir, observer=self.observer
            )
        self.generation += 1
        plan = ElasticPlan(
            generation=self.generation,
            hosts=tuple(live),
            coordinator=coordinator,
            devices_per_host=self.devices_per_host,
            mesh_shape=self._mesh_shape(len(live)),
            resume_step=resume_step,
        )
        self._gauge("elastic_hosts", len(live),
                    help="live fault domains in the current plan")
        self._gauge("elastic_generation", self.generation,
                    help="elastic plan generation")
        if prev is not None and plan.host_count != prev.host_count:
            self.replans += 1
            self._count("elastic_replans_total",
                        "re-plans where the host count changed (mesh "
                        "re-derived, params resharded, cursor "
                        "re-partitioned)")
            self._bundle(TRIGGER_ELASTIC_REPLAN, self.ticks_total, {
                "reason": reason,
                "previous_plan": prev.to_json_dict(),
                "new_plan": plan.to_json_dict(),
                "data_cursor": self._cursor_detail(resume_step),
            })
        self.plan = plan
        return plan

    # -- failure bookkeeping ----------------------------------------------
    def _on_domain_failure(self, host_id: int, reason: str,
                           exc: BaseException, trigger: str) -> None:
        now = self._clock()
        self._last_failure_t = now
        domain = self.domains[host_id]
        outcome = domain.record_failure(now, reason)
        self.restarts += 1
        self._count("elastic_restarts_total",
                    "elastic attempt restarts (any reason)")
        if self.registry is not None:
            self.registry.counter(
                self.registry.labeled("elastic_restarts_", reason),
                help="elastic restarts split by failure reason",
            ).inc()
            self.registry.counter(
                self.registry.labeled("elastic_domain_failures_h", host_id),
                help="failures charged to one fault domain",
            ).inc()
        if reason == "preempt":
            self._count("elastic_preemptions_total",
                        "fault-domain preemptions survived")
        if outcome == "giveup":
            self._count("elastic_domain_giveups_total",
                        "fault domains marked dead by their own "
                        "crash-loop policy")
        self._bundle(trigger, self.ticks_total, {
            "host": host_id,
            "reason": reason,
            "outcome": outcome,
            "error": f"{type(exc).__name__}: {exc}",
            "traceback": "".join(traceback.format_exception(
                type(exc), exc, exc.__traceback__)),
            "domain_failures_in_window": len(domain._failures),
            "domain_restarts": domain.restarts,
            "plan": self.plan.to_json_dict() if self.plan else None,
        })

    def _on_job_failure(self, exc: BaseException) -> str:
        now = self._clock()
        self._last_failure_t = now
        self._job_failures.append(now)
        while (self._job_failures
               and now - self._job_failures[0] > self.job_policy.window_s):
            self._job_failures.popleft()
        reason = classify_failure(exc)
        self.restarts += 1
        self._count("elastic_restarts_total",
                    "elastic attempt restarts (any reason)")
        if self.registry is not None:
            self.registry.counter(
                self.registry.labeled("elastic_restarts_", reason),
                help="elastic restarts split by failure reason",
            ).inc()
        if reason == REASON_CUDA_FATAL:
            raise GiveUp(
                f"giving up: {type(exc).__name__}: {exc} is a sticky CUDA error "
                f"({reason}); no restart inside this process can succeed") from exc
        if len(self._job_failures) >= self.job_policy.max_failures:
            raise GiveUp(
                f"giving up after {len(self._job_failures)} job-level "
                f"failures within {self.job_policy.window_s:.0f}s (last: "
                f"{type(exc).__name__}: {exc})"
            ) from exc
        self._sleep(self.job_policy.backoff_s(
            len(self._job_failures) - 1, self._rng))
        return reason

    # -- the loop ----------------------------------------------------------
    def run(self) -> Any:
        plan = self._replan(reason="initial", failed=None)
        while True:
            ctx = ElasticContext(self, plan)
            self.context = ctx
            try:
                result = self.attempt_fn(plan, ctx)
            except (KeyboardInterrupt, SystemExit):
                raise  # operator intent, never a restartable failure
            except CoordinatorLostError as e:
                self._on_domain_failure(e.host_id, "coordinator_loss", e,
                                        TRIGGER_COORDINATOR_LOSS)
                plan = self._replan(reason="coordinator_loss",
                                    failed=e.host_id,
                                    exclude_coordinator=(e.host_id,))
            except PreemptionError as e:
                host_id = getattr(e, "host_id", None)
                if host_id is None:
                    # a bare PreemptionError carries no host attribution
                    # (production code raising the exported base directly,
                    # e.g. a SIGTERM handler): charging any single domain —
                    # least of all the coordinator — would mark a healthy
                    # host dead; it is a JOB-level event
                    reason = self._on_job_failure(e)
                    plan = self._replan(reason=reason, failed=None)
                else:
                    self._on_domain_failure(host_id, "preempt", e,
                                            TRIGGER_HOST_PREEMPT)
                    plan = self._replan(reason="preempt", failed=host_id)
            except Exception as e:
                reason = self._on_job_failure(e)  # raises GiveUp at limit
                plan = self._replan(reason=reason, failed=None)
            else:
                self._gauge("elastic_hosts", plan.host_count,
                            help="live fault domains in the current plan")
                return result
