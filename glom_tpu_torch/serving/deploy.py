"""Safe deploys on one replica: shadow -> canary -> promote | rollback, the
port's counterpart of ``glom_tpu/serving/deploy.py``.

A new checkpoint never takes all of the traffic in one step:

  * **shadow** (:meth:`DeployController.begin_shadow`) -- the candidate step
    is loaded resident, a second
    :class:`~glom_tpu_torch.serving.registry.ModelVersion` of the default
    model.  Its parameters are placed and its graphs captured against them
    off the request path, one bucket a hold of the engine's device lock, so
    live replays run between the captures (a graph holds its parameters'
    addresses: the candidate cannot replay the primary's graphs; see
    :mod:`.registry` for what ``aliased`` means here).  Live batches are
    mirrored onto a bounded, lossy queue and replayed from the candidate's
    graphs on a shadow thread; the answers are compared with the primary's
    and discarded, and the outcomes feed the CANDIDATE's burn-rate
    evaluators only (a full queue drops the mirror, counted);
  * **canary** (:meth:`begin_canary`) -- a deterministic fraction of live
    traffic replays the candidate's graphs: :meth:`assign` hashes the
    request's affinity key salted with the candidate step, so one key stays
    on one side for the whole deploy (the engine also pins a session with
    state to the version that computed it);
  * **auto-promote** -- after ``promote_after`` consecutive clean burn-rate
    windows in canary, the candidate's set becomes the engine's serving set
    by one reference swap (no restore, no capture), or through the router's
    two-phase rollout when ``pin_url`` is set (the replica then adopts the
    resident set instead of restoring the step again);
  * **auto-rollback** -- the moment any candidate evaluator's short-window
    burn crosses its threshold, the candidate is retired (its graphs and
    pools are freed with its set) and ``pin_url`` is re-pinned to the old
    step.

The controller is transport-agnostic (``http`` injectable) and runs on the
engine's injectable clock; every transition is serialized under one lock,
with the fleet pin's HTTP after the flip.  The shadow judges a mirrored
batch by its divergence from the primary's answer and, when the engine
samples quality, by the candidate's own agreement and residual: the
candidate's set carries its own ``quality`` graph family (captured against
its parameters with the rest of its set), which the shadow replays on the
same batch.  A rollback fires the ``deploy_rollback`` forensics bundle when
the engine has a forensics directory: the reason, the before/after pins,
the offending trace ids (with their spans while the tracer keeps them) and
the candidate's burn rates at the moment of retreat.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
import warnings
from collections import deque
from typing import Dict, List, Optional

from glom_tpu_torch.obs.slo import SLO, BurnRateEvaluator, parse_slo
from glom_tpu_torch.obs.triggers import TRIGGER_DEPLOY_ROLLBACK
from glom_tpu_torch.resilience import faultinject

PHASES = ("idle", "shadow", "canary")


def _cosine_divergence(a, b, eps: float = 1e-8):
    """``(1 - mean cosine, per-level list)`` between two output arrays
    of identical shape.  Embedding outputs ``(b, L, d)`` compare per
    (image, level) vector — the per-level view shows WHICH level of the
    part-whole hierarchy a candidate disagrees at; any other shape
    (reconstructions ``(b, c, H, W)``) flattens per image.  Host-side
    NumPy on already-fetched outputs: no device work, no compiles."""
    import numpy as np

    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    if a.ndim == 3:                       # (b, L, d): per-level vectors
        a2, b2 = a, b
    else:                                 # flatten per image
        a2 = a.reshape(a.shape[0], 1, -1)
        b2 = b.reshape(b.shape[0], 1, -1)
    dot = (a2 * b2).sum(axis=-1)
    denom = (np.linalg.norm(a2, axis=-1) * np.linalg.norm(b2, axis=-1))
    cos = dot / np.maximum(denom, eps)    # (b, L)
    per_level = [float(1.0 - c) for c in cos.mean(axis=0)]
    return float(1.0 - cos.mean()), per_level

#: candidate guardrails when the engine has no SLOs configured: a deploy
#: with no declared objectives still rolls back on a plainly-broken
#: candidate (error storm) — guarded exposure must not be opt-in
DEFAULT_CANDIDATE_SLOS = ("errors<2%",)

#: the quality guardrail every deploy gets (unless the operator declared
#: their own ``divergence`` objective): shadow-mirrored batches run on
#: BOTH versions, and a candidate whose outputs diverge from the
#: primary's on the same inputs burns this budget and rolls back —
#: a fast-but-wrong candidate is a regression even with perfect latency
DEFAULT_QUALITY_SLOS = ("divergence<0.2",)


class _Candidate:
    """One immutable-ish active-deploy record: readers (assign, the
    request path) take ONE reference read; all mutation replaces the
    reference under the controller lock."""

    def __init__(self, step: int, version, phase: str, fraction: float):
        self.step = int(step)
        self.version = version            # registry.ModelVersion
        self.phase = phase                # "shadow" | "canary"
        self.fraction = float(fraction)


class DeployController:
    """Shadow/canary lifecycle for the engine's ``default`` model: ``glom_tpu``'s
    state machine, metrics and timeline events, under the same names."""

    def __init__(self, engine, *, promote_after: int = 3,
                 window_s: Optional[float] = None,
                 min_events: Optional[int] = None,
                 canary_fraction: float = 0.1,
                 shadow_queue: int = 8,
                 pin_url: Optional[str] = None,
                 pin_timeout_s: float = 120.0,
                 http=None):
        self.engine = engine
        self.metrics = engine.registry
        self._clock = engine.tracer.clock
        if promote_after < 1:
            raise ValueError(f"promote_after must be >= 1, got "
                             f"{promote_after}")
        if not 0.0 < canary_fraction <= 1.0:
            raise ValueError(f"canary_fraction must be in (0, 1], got "
                             f"{canary_fraction}")
        self.promote_after = promote_after
        self.default_fraction = canary_fraction
        self.pin_url = pin_url.rstrip("/") if pin_url else None
        self.pin_timeout_s = pin_timeout_s
        self._http = http
        # candidate objectives: the engine's declared SLOs when present
        # (same promises, applied to the candidate's outcomes), the
        # error-storm guardrail otherwise
        base = [ev.slo for ev in engine._slo.evaluators] if (
            engine._slo is not None) else [
            parse_slo(s) for s in DEFAULT_CANDIDATE_SLOS]
        self._slos: List[SLO] = list(base)
        self.window_s = float(window_s) if window_s is not None else max(
            s.short_window_s for s in self._slos)
        self.min_events = int(min_events) if min_events is not None else min(
            s.min_events for s in self._slos)
        # the quality guardrail rides the candidate's own cadence
        # (windows/min_events resolved above), so shadow traffic can
        # burn it as fast as it can burn a latency objective
        if not any(s.kind == "quality" and s.metric == "divergence"
                   for s in self._slos):
            self._slos.extend(
                parse_slo(spec, short_window_s=self.window_s,
                          long_window_s=max(
                              [self.window_s]
                              + [s.long_window_s for s in self._slos]),
                          min_events=self.min_events,
                          burn_threshold=min(
                              s.burn_threshold for s in self._slos))
                for spec in DEFAULT_QUALITY_SLOS)

        self._lock = threading.Lock()
        # serializes whole begin_* calls INCLUDING the candidate load (a
        # slow restore): two concurrent begins must not both load — the
        # loser's param tree would stay resident with nothing to retire
        # it.  Ordered strictly before _lock; never taken by the hot
        # paths (assign/mirror/observe) or the settle verbs.
        self._begin_lock = threading.Lock()
        self._cand: Optional[_Candidate] = None
        # candidate steps retired by rollback/abort: a session whose
        # resident state one of them computed must cold-restart rather
        # than warm-iterate a retired version's equilibrium on primary
        # params (bounded; a re-deploy of the step clears it)
        self._retired_steps: "deque" = deque(maxlen=8)
        self._evaluators: List[BurnRateEvaluator] = []
        # clean-window accounting (guarded by _lock)
        self._window_start = 0.0
        self._window_events = 0
        self._window_breached = False
        self._clean_windows = 0
        # offender ring: trace ids of recent BAD candidate outcomes (the
        # rollback bundle's evidence, kept even when an SLO's own short
        # window has rotated them out)
        self._offenders: "deque" = deque(maxlen=20)
        self.last_report: Optional[dict] = None
        # -- shadow executor ------------------------------------------------
        self._shadow_q: "deque" = deque(maxlen=shadow_queue)
        self._shadow_cv = threading.Condition()
        self._shadow_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- introspection -----------------------------------------------------
    @property
    def phase(self) -> str:
        cand = self._cand  # one reference read: _cand is only ever replaced under _lock
        return cand.phase if cand is not None else "idle"

    @property
    def active(self) -> bool:
        return self._cand is not None  # one reference read: _cand is only ever replaced under _lock

    @property
    def candidate_step(self) -> Optional[int]:
        cand = self._cand  # one reference read: _cand is only ever replaced under _lock
        return cand.step if cand is not None else None

    def candidate(self, step: Optional[int] = None):
        """The candidate's registry record (its set in ``caches``) for the
        engine's partitioned execute — or None when retired (in-flight canary items then
        finish on the primary: safe, and exactly the post-rollback
        contract).  A ``step`` pins the lookup (an item tagged for a
        candidate that was since replaced must not run on the new one)."""
        cand = self._cand  # one reference read: _cand is only ever replaced under _lock
        if cand is None or (step is not None and cand.step != step):
            return None
        return cand.version

    def status(self) -> dict:
        """The ``/healthz`` ``deploy`` block + ``/admin/deploy/status``."""
        cand = self._cand  # one reference read: _cand is only ever replaced under _lock
        with self._lock:
            clean = self._clean_windows
        return {
            "phase": "idle" if cand is None else cand.phase,
            "candidate_step": None if cand is None else cand.step,
            "canary_fraction": None if cand is None else cand.fraction,
            "clean_windows": clean,
            "promote_after": self.promote_after,
            "window_s": self.window_s,
            "min_events": self.min_events,
            "pin_url": self.pin_url,
            "last": self.last_report,
        }

    # -- lifecycle ---------------------------------------------------------
    def begin_shadow(self, step: Optional[int] = None) -> Optional[int]:
        """Load the candidate resident and start mirroring.  ``step=None``
        targets the newest checkpoint that verifies and is newer than the
        serving step.  Returns the candidate step, or None when there is
        nothing (or nothing loadable) to deploy — a corrupt candidate is
        quarantined by the load path and never becomes resident, so a bad
        artifact aborts the deploy before any traffic touches it."""
        return self._begin("shadow", step, self.default_fraction)

    def begin_canary(self, fraction: Optional[float] = None,
                     step: Optional[int] = None) -> Optional[int]:
        """Route ``fraction`` of live traffic to the candidate.  Usable
        straight from idle (shadow is the recommended first phase, not a
        hard precondition) or to advance an active shadow; window
        accounting restarts either way — promotion needs ``promote_after``
        clean windows of CANARY exposure."""
        if fraction is not None and not 0.0 < fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {fraction}")
        return self._begin("canary", step,
                           fraction if fraction is not None
                           else self.default_fraction)

    def _begin(self, phase: str, step: Optional[int],
               fraction: float) -> Optional[int]:
        # a mesh's dispatch does not carry a candidate's set yet
        self.engine.refuse_on_mesh("deploy")
        # _begin_lock spans check + load + install: without it, two
        # concurrent begins both pass the no-active-candidate check and
        # both load — the overwritten loser's device tree would stay
        # registered with no settle verb ever able to retire it
        with self._begin_lock:
            with self._lock:
                cand = self._cand
                if cand is not None and (step is None or step == cand.step):
                    # phase advance of the existing candidate
                    self._cand = _Candidate(cand.step, cand.version, phase,
                                            fraction)
                    self._reset_windows()
                    self._note_phase(phase, cand.step)
                    return cand.step
                if cand is not None:
                    # a DIFFERENT step while one is active: explicit abort
                    # first — two candidates at once is two extra param
                    # trees and an ambiguous assign()
                    raise RuntimeError(
                        f"deploy of step {cand.step} is active "
                        f"({cand.phase}); promote/rollback/abort it before "
                        f"deploying step {step}")
            version = self._load_candidate(step)
            if version is None:
                return None
            with self._lock:
                self._cand = _Candidate(version.step, version, phase,
                                        fraction)
                # a re-deployed step is no longer "retired": sessions it
                # serves from here on are current, not stale
                if version.step in self._retired_steps:
                    self._retired_steps.remove(version.step)
                self._reset_windows()
                self._evaluators = [
                    BurnRateEvaluator(s, clock=self._clock)
                    for s in self._slos]
                self._note_phase(phase, version.step)
        self._ensure_shadow_thread()
        return version.step

    def _load_candidate(self, step: Optional[int]):
        """Load the candidate resident through the engine's restore path (its
        quant mode, CRC verification, quarantine on corruption), capture its
        graphs from the engine's program (the same graph functions as the
        primary: ``aliased``) against its own parameters, and register it.
        A load or a capture that fails aborts the deploy: counted, warned,
        the primary untouched; the candidate never serves eagerly."""
        from glom_tpu_torch import checkpoint as ckpt_lib
        from glom_tpu_torch.models.glom import tree_map
        from glom_tpu_torch.resilience import integrity
        from glom_tpu_torch.serving.registry import DEFAULT_MODEL

        engine = self.engine
        if step is None:
            step = integrity.latest_valid_step(engine.checkpoint_dir, newer_than=engine.step,
                                               observer=engine._integrity_obs)
            if step is None or step <= engine.step:
                return None
        step = int(step)
        existing = engine.models.get(DEFAULT_MODEL, step)
        if existing is not None and existing.role == "candidate":
            return existing
        if existing is not None:
            # pinned to what already serves: nothing to deploy, as a
            # staged reload of the serving step stages nothing
            return None
        try:
            serving = engine._restore_set(step)
        except ckpt_lib.CorruptCheckpointError as e:
            integrity.quarantine(engine.checkpoint_dir, step, observer=engine._integrity_obs,
                                 reason=str(e))
            self._load_failure(step, e)
            return None
        except Exception as e:
            self._load_failure(step, e)
            return None
        # chaos seam: weights corrupted AFTER the integrity check, on the
        # restored and placed tree (in place, before the capture): the
        # candidate loads clean, serves fast, and is wrong; only the shadow
        # lane's comparison catches it
        if faultinject.fire("candidate_load") == "bitflip":
            tree_map(lambda leaf: leaf.neg_(), serving.params)
        try:
            if engine._warm:
                engine._warm_set(serving)
        except Exception as e:
            self._load_failure(step, e)
            return None
        primary = engine.models.get(DEFAULT_MODEL)
        return engine.models.register(
            DEFAULT_MODEL, step, caches=serving, config=primary.config,
            train_cfg=primary.train_cfg, signature=primary.signature,
            source_dir=engine.checkpoint_dir, quant=engine.quant, role="candidate",
            aliased=True, program=primary.program)

    def _load_failure(self, step: int, e: Exception) -> None:
        self.metrics.counter(
            "deploy_candidate_load_failures",
            help="deploys aborted because the candidate checkpoint "
                 "would not load/verify",
        ).inc()
        warnings.warn(
            f"deploy candidate step {step} failed to load "
            f"({type(e).__name__}: {e}); deploy aborted, primary "
            f"untouched", stacklevel=3)

    def promote(self) -> Optional[dict]:
        """Candidate -> primary.  With ``pin_url``, the flip runs through
        the router's two-phase rollout (`POST /rollout {"step": N}`):
        every replica stages then commits the same step behind the
        dispatch gate, so the fleet is never half-old/half-new (this
        replica stages the resident candidate set: nothing is restored or
        captured).  Without one, the local engine swaps its serving set
        (keeping the displaced set as its staged-API rollback point)."""
        with self._lock:
            cand = self._cand
            if cand is None:
                return None
            self._cand = None
            self._stop_evaluating()
        self._note_idle()
        old_step = int(self.engine.step)
        pin = self._pin_fleet(cand.step)
        if int(self.engine.step) != cand.step:
            # no router, a pin that could not commit, or a router whose
            # fleet does not include this engine: the local atomic swap
            # is the fallback so a promote never half-applies.  (A
            # successful pin already flipped this engine through its own
            # /admin/reload staged commit, which re-anchored the
            # registry's primary record.)
            self.engine.promote_candidate(cand.step)
        report = {
            "action": "promoted", "step": cand.step,
            "from_step": old_step, "fleet_pin": pin,
            "t": round(self._clock(), 3),
        }
        self.metrics.counter(
            "deploy_promotes_total",
            help="candidates promoted to primary after clean burn windows",
        ).inc()
        self._note_event("deploy_promote", step=int(cand.step),
                         from_step=old_step)
        self.last_report = report
        return report

    def rollback(self, reason: str = "operator",
                 detail: Optional[dict] = None) -> Optional[dict]:
        """Retire the candidate (its set, graphs and pools freed with the
        registry record) and converge the fleet back onto the old pin.  The
        report names the reason, the before/after pins and the phase; the
        ``deploy_rollback`` forensics bundle adds the offending trace ids and
        the candidate's burn rates."""
        with self._lock:
            cand = self._cand
            if cand is None:
                return None
            self._cand = None
            if cand.step not in self._retired_steps:
                self._retired_steps.append(cand.step)
            offenders = list(self._offenders)
            rates = {ev.slo.name: ev.burn_rates() for ev in self._evaluators}
            self._stop_evaluating()
        self._note_idle()
        old_step = int(self.engine.step)
        self.engine.models.remove("default", cand.step)
        pin = self._pin_fleet(old_step)
        report = {
            "action": "rolled_back", "reason": reason,
            "step": old_step, "candidate_step": cand.step,
            "pins": {"before": cand.step, "after": old_step},
            "phase_at_rollback": cand.phase,
            "fleet_pin": pin, "t": round(self._clock(), 3),
        }
        if detail:
            report.update(detail)
        self.metrics.counter(
            "deploy_rollbacks_total",
            help="candidate deploys auto/operator-rolled-back",
        ).inc()
        self._note_event("deploy_rollback", step=old_step,
                         candidate_step=int(cand.step), reason=reason)
        self._capture_rollback(report, offenders, rates)
        self.last_report = report
        return report

    def abort(self) -> bool:
        """Drop the candidate with no forensics (operator changed their
        mind / a failed begin elsewhere) — nothing burned, nothing to
        document.  Returns True when a candidate was resident."""
        with self._lock:
            cand = self._cand
            if cand is None:
                return False
            self._cand = None
            if cand.step not in self._retired_steps:
                self._retired_steps.append(cand.step)
            self._stop_evaluating()
        self._note_idle()
        self.engine.models.remove("default", cand.step)
        self._note_event("deploy_abort", candidate_step=int(cand.step))
        self.last_report = {"action": "aborted",
                            "candidate_step": cand.step,
                            "t": round(self._clock(), 3)}
        return True

    def close(self) -> None:
        """Engine shutdown: stop the shadow thread."""
        self._stop.set()
        with self._shadow_cv:
            self._shadow_cv.notify_all()
        t = self._shadow_thread
        if t is not None:
            t.join(timeout=5.0)
        self._shadow_thread = None

    def _stop_evaluating(self) -> None:
        # caller holds _lock
        self._evaluators = []
        self._reset_windows()
        with self._shadow_cv:
            self._shadow_q.clear()

    def _reset_windows(self) -> None:
        self._window_start = self._clock()
        self._window_events = 0
        self._window_breached = False
        self._clean_windows = 0
        self._offenders.clear()

    def retired(self, step: int) -> bool:
        """Whether ``step`` is a candidate a rollback/abort retired — a
        session whose resident state it computed must cold-restart
        instead of warm-iterating a retired version's equilibrium."""
        with self._lock:
            return step in self._retired_steps

    def _note_idle(self) -> None:
        """Terminal transition: the gauges must not report a phantom
        deploy forever (phase/candidate stick at their begin-time values
        otherwise — exactly what a dashboard alert would page on)."""
        self.metrics.gauge(
            "deploy_phase",
            help="deploy state machine: 0 idle, 1 shadow, 2 canary",
        ).set(0)
        self.metrics.gauge(
            "deploy_candidate_step",
            help="checkpoint step of the active deploy candidate",
        ).set(-1)
        self.metrics.gauge(
            "deploy_clean_windows",
            help="consecutive clean candidate burn windows",
        ).set(0)

    def _note_phase(self, phase: str, step: int) -> None:
        self.metrics.gauge(
            "deploy_phase",
            help="deploy state machine: 0 idle, 1 shadow, 2 canary",
        ).set(PHASES.index(phase))
        self.metrics.counter(
            self.metrics.labeled("deploy_phase_enters_", phase),
            help="deploy phase transitions",
        ).inc()
        self.metrics.gauge(
            "deploy_candidate_step",
            help="checkpoint step of the active deploy candidate",
        ).set(step)
        # unified timeline record (obs.events): the attribution plane
        # correlates these transitions with the regression knee.  Leaf
        # lock only, so safe under _lock.
        self._note_event(f"deploy_{phase}", step=int(step))

    def _note_event(self, event: str, **fields) -> None:
        timeline = getattr(self.engine, "timeline", None)
        if timeline is not None:
            timeline.note(event, **fields)

    # -- canary assignment -------------------------------------------------
    def assign(self, key: Optional[str]) -> Optional[int]:
        """The canary routing decision for one request: the candidate
        step when ``key`` hashes into the canary fraction, else None
        (primary).  Deterministic in (candidate step, key): the same
        affinity key always lands on the same side for the whole deploy,
        on every replica running the same controller — a session or a
        sticky client never flaps between versions."""
        cand = self._cand  # one reference read: _cand is only ever replaced under _lock
        if cand is None or cand.phase != "canary" or not key:
            return None
        h = int(hashlib.sha1(
            f"{cand.step}:{key}".encode()).hexdigest()[:8], 16)
        return cand.step if (h / 0xFFFFFFFF) < cand.fraction else None

    # -- shadow mirroring --------------------------------------------------
    def mirror(self, endpoint: str, imgs, primary_out=None) -> None:
        """Offer one primary batch to the shadow executor, together with
        the PRIMARY's outputs for the same batch (the quality-comparison
        baseline — both sides then ran identical inputs).  Non-blocking
        and lossy by design: the mirror must never add latency to the
        primary path, so a backed-up shadow queue DROPS (counted) — the
        shadow is a measurement sample, not a delivery guarantee."""
        cand = self._cand  # one reference read: _cand is only ever replaced under _lock
        if cand is None or cand.phase != "shadow":
            return
        with self._shadow_cv:
            if len(self._shadow_q) == self._shadow_q.maxlen:
                self.metrics.counter(
                    "deploy_shadow_dropped",
                    help="mirrored batches dropped at the shadow queue "
                         "bound (primary path stays unblocked)",
                ).inc()
                return
            self._shadow_q.append((endpoint, imgs, cand.step, primary_out))
            self._shadow_cv.notify()

    def _ensure_shadow_thread(self) -> None:
        if self._shadow_thread is not None and self._shadow_thread.is_alive():
            return
        t = threading.Thread(target=self._shadow_loop,
                             name="glom-deploy-shadow", daemon=True)
        t.start()
        self._shadow_thread = t

    def _shadow_loop(self) -> None:
        while not self._stop.is_set():
            with self._shadow_cv:
                while not self._shadow_q and not self._stop.is_set():
                    self._shadow_cv.wait(timeout=0.25)
                if self._stop.is_set():
                    return
                endpoint, imgs, step, primary_out = self._shadow_q.popleft()
            self.process_shadow(endpoint, imgs, step, primary_out)

    def process_shadow(self, endpoint: str, imgs, step: int,
                       primary_out=None) -> bool:
        """Replay one mirrored batch from the candidate's graphs and judge
        the answer against the primary's outputs for the same inputs
        (per-level cosine divergence).  The outcome (latency incl. any injected
        candidate fault, error, quality signals) feeds ONLY the
        candidate evaluators — shadow responses never reach a client.
        Public so tests can pump the shadow path deterministically
        without the thread."""
        version = self.candidate(step)
        if version is None:
            return False
        tracer = self.engine.tracer
        span = tracer.start_trace("shadow_execute", attrs={
            "endpoint": endpoint, "candidate_step": int(step)})
        t0 = self._clock()
        error = False
        quality = None
        try:
            kind = faultinject.fire("candidate")
            if kind == "error":
                raise faultinject.FaultError("injected candidate error")
            # the cache copies the answer to the host under its own hold,
            # before another replay of the family can overwrite its output
            out = version.caches.caches[endpoint](version.params, imgs)
            quality = self._shadow_quality(endpoint, version, imgs, out, primary_out)
            del out  # compared, never delivered: shadow stays invisible
            if kind == "delay":
                # a deliberate wall-clock stall: a genuinely slow candidate
                time.sleep(self.fault_delay_s)
        except Exception as e:
            error = True
            span.attrs["error"] = repr(e)
        latency_ms = (self._clock() - t0) * 1e3
        tracer.end(span)
        self.metrics.counter(
            "deploy_shadow_requests",
            help="mirrored batches executed against the candidate",
        ).inc()
        self.observe_candidate(endpoint, None if error else latency_ms,
                               error, trace_id=span.trace_id,
                               quality=quality)
        return True

    def _shadow_quality(self, endpoint: str, version, imgs, out,
                        primary_out) -> Optional[Dict[str, float]]:
        """Quality signals for one shadow comparison: ``divergence`` =
        1 - mean per-level cosine between primary and candidate outputs
        on the SAME batch (the direct is-it-the-same-model measure), and
        the candidate's own ``agreement``/``residual`` from the quality
        post-pass (does the candidate still PARSE — a candidate can
        diverge because it is better, but a collapsed parse is not).
        Best-effort: a missing primary baseline omits ``divergence``, a set
        without a ``quality`` family (an engine with ``quality_sample=0``)
        omits ``agreement``/``residual``.  The candidate's own family replays
        here, never the primary's: a graph holds the parameters it was
        captured with."""
        import numpy as np

        signals: Dict[str, float] = {}
        if primary_out is not None:
            div, per_level = _cosine_divergence(
                np.asarray(primary_out), np.asarray(out))
            signals["divergence"] = div
            self.metrics.gauge(
                "deploy_shadow_divergence",
                help="1 - mean cosine(primary, candidate) on mirrored "
                     "batches",
            ).set(round(div, 6))
            for i, d in enumerate(per_level):
                self.metrics.gauge(
                    f"deploy_shadow_divergence_l{i}",
                    help="per-level primary-vs-candidate cosine "
                         "divergence",
                ).set(round(d, 6))
            self.metrics.counter(
                "deploy_shadow_compared",
                help="mirrored batches judged primary-vs-candidate",
            ).inc()
        engine = self.engine
        qc = version.caches.caches.get("quality")
        if qc is not None and getattr(imgs, "ndim", 0) == 4:
            try:
                mat = np.asarray(qc(version.params, imgs))
                levels = engine.config.levels
                signals["agreement"] = float(mat[:, :levels].mean())
                signals["residual"] = float(mat[:, 3 * levels].mean())
                engine.poll_quality_compiles(version.caches)
                self.metrics.gauge(
                    "deploy_shadow_agreement",
                    help="candidate island agreement on mirrored batches",
                ).set(round(signals["agreement"], 6))
            except Exception:  # the comparison is evidence, not a dependency: a failed post-pass must not fail the mirror
                pass
        return signals or None

    #: wall-seconds one injected ``candidate:delay`` fault adds (the
    #: chaos scenario's "latency-injected checkpoint")
    fault_delay_s = 0.25

    def injected_fault(self) -> Optional[str]:
        """The canary-path injection point (the engine calls this around
        a candidate group's execute): returns the armed fault kind —
        ``delay`` stalls the candidate batch (client-visible latency,
        never an error), ``error`` fails it (deliberately client-visible;
        the chaos suite uses ``delay``)."""
        return faultinject.fire("candidate")

    # -- burn-rate evaluation ---------------------------------------------
    def observe_candidate(self, endpoint: str,
                          latency_ms: Optional[float], error: bool,
                          trace_id: Optional[str] = None,
                          tenant: Optional[str] = None,
                          quality: Optional[Dict[str, float]] = None,
                          ) -> None:
        """One candidate outcome (shadow execute or live canary request).
        Feeds the candidate evaluators and runs the auto-action logic:
        short-window burn -> rollback; ``promote_after`` clean windows
        in canary -> promote.  ``quality`` carries the shadow
        comparison's signals (``divergence``/``agreement``/…), judged by
        the quality-kind evaluators with the same burn math — a
        fast-but-wrong candidate rolls back exactly like a slow one.  A
        tenant-scoped SLO judges only that tenant's outcomes, exactly
        like the primary-side ``SloManager.observe`` (tenantless shadow
        mirrors are skipped by tenant-scoped targets — they cannot be
        attributed)."""
        action = None
        with self._lock:
            cand = self._cand
            if cand is None:
                return
            now = self._clock()
            breach = None
            for ev in self._evaluators:
                slo = ev.slo
                if slo.endpoint is not None and slo.endpoint != endpoint:
                    continue
                if slo.tenant is not None and slo.tenant != tenant:
                    continue
                if slo.kind == "latency":
                    if latency_ms is None:
                        continue
                    bad = latency_ms > slo.threshold_ms
                elif slo.kind == "quality":
                    value = None if quality is None else \
                        quality.get(slo.metric)
                    if value is None:
                        continue  # no quality evidence this outcome
                    bad = (value < slo.threshold if slo.bad_below
                           else value > slo.threshold)
                else:
                    bad = error
                if bad and trace_id is not None:
                    self._offenders.append(trace_id)
                ev.observe(bad, trace_id)
                rates = ev.burn_rates()
                short = rates.get("short")
                if short is not None:
                    self.metrics.gauge(
                        self.metrics.labeled("deploy_candidate_burn_",
                                             _slug(slo.name)),
                        help="candidate short-window burn rate",
                    ).set(round(short, 3))
                if short is not None and short >= slo.burn_threshold:
                    breach = {"slo": slo.name, "burn_rate_short":
                              round(short, 3),
                              "burn_threshold": slo.burn_threshold}
            self._window_events += 1
            if breach is not None:
                self._window_breached = True
                action = ("rollback", breach)
            elif now - self._window_start >= self.window_s:
                if (self._window_events >= self.min_events
                        and not self._window_breached):
                    self._clean_windows += 1
                elif self._window_breached:
                    self._clean_windows = 0
                # a low-traffic window neither counts nor resets: clean
                # means "enough evidence and none of it bad"
                self._window_start = now
                self._window_events = 0
                self._window_breached = False
                self.metrics.gauge(
                    "deploy_clean_windows",
                    help="consecutive clean candidate burn windows",
                ).set(self._clean_windows)
                if (cand.phase == "canary"
                        and self._clean_windows >= self.promote_after):
                    action = ("promote", None)
        # auto actions run OUTSIDE the lock: they do the fleet pin's HTTP
        if action is not None and action[0] == "rollback":
            self.rollback(reason="burn_rate", detail=action[1])
        elif action is not None:
            self.promote()

    # -- fleet pin -----------------------------------------------------------
    # -- rollback evidence / fleet pin ------------------------------------
    def _capture_rollback(self, report: dict, offenders: List[str],
                          rates: Dict[str, dict]) -> None:
        engine = self.engine
        detail = dict(report)
        detail["trace_ids"] = offenders[-20:][::-1]
        detail["burn_rates"] = rates
        if engine._forensics is None:
            return
        if not engine._triggers.fire(TRIGGER_DEPLOY_ROLLBACK, engine.request_count):
            return
        extra = None
        if offenders:
            traces = {tid: [s.to_dict() for s in engine.tracer.sink.trace(tid)]
                      for tid in detail["trace_ids"]}
            extra = {"deploy_traces.json": {k: v for k, v in traces.items() if v}}
        path = engine._forensics.capture(TRIGGER_DEPLOY_ROLLBACK, engine.request_count, detail,
                                         trace=False, extra_files=extra)
        if path is None:
            engine._triggers.refund(TRIGGER_DEPLOY_ROLLBACK, engine.request_count)

    def _pin_fleet(self, step: int) -> dict:
        """Converge every replica onto ``step`` through the router's
        two-phase rollout (stage everywhere, gate, drain,
        commit — or all-revert).  A fleet already serving ``step``
        reports ``noop``, which is success for a pin."""
        if self.pin_url is None:
            return {"ok": True, "skipped": "no pin_url"}
        http = self._http if self._http is not None else _default_pin_http
        try:
            status, body = http(
                f"{self.pin_url}/rollout",
                json.dumps({"step": int(step)}).encode(),
                self.pin_timeout_s,
            )
            payload = json.loads(body) if body else {}
            ok = status == 200 and payload.get("status") in (
                "committed", "noop")
            if not ok:
                self.metrics.counter(
                    "deploy_pin_failures",
                    help="fleet pin rollouts that did not commit",
                ).inc()
            return {"ok": ok, "status": payload.get("status"),
                    "http_status": status, "step": int(step)}
        except Exception as e:  # recorded in the report: a transport error never loses the flip
            self.metrics.counter(
                "deploy_pin_failures",
                help="fleet pin rollouts that did not commit",
            ).inc()
            return {"ok": False, "error": f"{type(e).__name__}: {e}",
                    "step": int(step)}


def _default_pin_http(url: str, body: bytes, timeout: float):
    import urllib.request

    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _slug(name: str) -> str:
    import re

    return re.sub(r"[^a-zA-Z0-9_]", "_", name)
