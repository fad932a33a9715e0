"""The scavenger execution class: bulk jobs on residual online capacity
(``glom_tpu/serving/bulk.py``, ported onto the engine's CUDA graphs).

Online serving pads every batch up to its bucket; those padding rows
execute anyway and their results are thrown away.  The
:class:`BulkRunner` turns them into throughput: when the engine's execute
loop assembles an online group of ``n`` images against bucket ``b``, it
asks the runner for up to ``b - n`` bulk samples and runs the FULL bucket
through the same cache call — one replay of the bucket's captured graph, so
the bulk rows ride device work that was already paid for, through the same
hand kernels (K1 and K4 on ``"pallas"``, K8 on ``"fused"``).  Idle windows
(no online image queued) run whole bulk buckets the same way.

The host work of a bulk chunk stays off the online worker and out of the
replays' way: a host thread draws the slots the next fills take ahead of
time (a synthetic slot's draw costs milliseconds), so a fill only stacks
them, and commits every scavenged chunk after its online futures resolved
(the part write and the cursor's fsync).  An idle chunk is committed on the
idle thread, which needs its shard back before it can cut the next chunk.

Priority rules:

  * **Online always wins.**  Bulk never enters a batcher, never takes
    admission, and the idle loop refuses to start a bucket while ANY
    batcher holds a queued image or an online batch ran within the last
    ``idle_grace_s``: every endpoint shares the one card, so ``glom_tpu``'s
    per-endpoint depth gate (which lets an ``embed`` job run while
    ``/reconstruct`` requests wait, and starts a bucket in the moment between
    two requests of a closed loop) is tightened here.  Preemption is at the
    admission boundary, so the worst case an online request waits behind
    bulk is one in-flight bucket replay; steady online traffic meets none.
  * **No new graphs.**  Bulk replays the graphs captured at start-up
    through :class:`~glom_tpu_torch.serving.compile_cache.BucketedGraphCache`'s
    own call (its output copied to the host under the family's lock, as for
    online rows); an idle replay holds the
    :class:`~glom_tpu_torch.serving.compile_cache.DeviceLock` shared like any
    replay.  A capture on the bulk path is folded into
    ``serving_graph_captures``, which must stay 0 after warm-up.
  * **Invisible to online accounting.**  Bulk slots never touch
    ``serving_requests_total``, tenant quotas, SLO evaluators, shadow
    mirroring, or quality sampling; they mint their own ``bulk_*``
    family.  A bulk-only (idle) bucket replays no quality post-pass.

Exactly-once rides the job store's sink-then-cursor order
(:mod:`glom_tpu_torch.bulk.jobs`): ``fill()`` stages slots in memory only;
``complete()`` writes the part file then durably advances the cursor;
``abandon()`` (failed batch, shutdown) rewinds the stage.  A kill at ANY
point re-executes at most the staged chunk, rewriting identical bytes when
its slots run again at the buckets they ran at before: always true of idle
fills, which cut chunks of the largest bucket from the cursor.  A slot's
bits do not depend on its row offset in a bucket, but they may on the
bucket (``ROADMAP.md`` queue 3), so a resume that moves a scavenged slot to
another bucket rewrites it within float32 rounding, not bitwise.

A job pinned to a ``(model, version)`` resolves that version's
:class:`~glom_tpu_torch.serving.engine.ServingSet` once per bucket and keeps
the reference for the whole replay, as the engine's execute groups do
(``engine.py::_resolve_group``): a rollback that retires the version
between two buckets parks the job (it waits, the slots stay queued), and
one that lands mid-replay cannot free the graphs under it.
"""

from __future__ import annotations

import queue
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

from glom_tpu_torch.bulk.jobs import BulkJobSpec, ChunkSink, JobStore, SlotDataset

#: idle-loop poll cadence while there is nothing runnable
DEFAULT_IDLE_POLL_S = 0.002
#: an idle bucket starts only once no online batch has run for this long:
#: about two b=8 replays at flagship on the H100, so online traffic whose
#: batches come closer than that (a closed loop) meets no idle replay, and a
#: request after a longer gap waits behind at most one
DEFAULT_IDLE_GRACE_S = 0.05


@dataclass
class _FillToken:
    """One staged chunk: handed out by :meth:`BulkRunner.fill`, settled
    by exactly one of ``complete``/``abandon``."""

    job: str
    shard_lo: int
    lo: int
    hi: int
    imgs: np.ndarray
    source: str  # "scavenged" | "idle"


class _ActiveJob:
    """In-memory face of one store job: dataset + sink handles and the
    per-shard staging pointers.  ``staged`` runs ahead of the durable
    cursor by at most one in-flight chunk per shard (``busy`` enforces
    it), which is what keeps cursor advances strictly sequential."""

    def __init__(self, spec: BulkJobSpec, doc: dict):
        self.spec = spec
        self.dataset = SlotDataset(spec)
        self.sink = ChunkSink(spec.sink)
        self.total = int(doc["total"])
        self.paused = doc["status"] == "paused"
        # shard_lo -> {"cursor", "hi", "staged", "busy"}
        self.shards: Dict[int, Dict[str, Any]] = {}
        # slot -> image drawn ahead by the host thread, for upcoming() slots
        # (None: the draw raised, the fill reads the slot itself)
        self.ahead: Dict[int, Optional[np.ndarray]] = {}
        self.sync_shards(doc)

    def sync_shards(self, doc: dict) -> None:
        for s in doc["shards"]:
            have = self.shards.get(s["lo"])
            if have is None:
                self.shards[s["lo"]] = {
                    "cursor": int(s["cursor"]), "hi": int(s["hi"]),
                    "staged": int(s["cursor"]), "busy": False,
                }
            else:
                have["hi"] = int(s["hi"])

    @property
    def remaining(self) -> int:
        return sum(s["hi"] - s["cursor"] for s in self.shards.values())

    def upcoming(self, n: int) -> list:
        """The first ``n`` slots the next fills stage, shard by shard;
        caller holds the runner lock."""
        out = []
        for _, s in sorted(self.shards.items()):
            out.extend(range(s["staged"], min(s["hi"], s["staged"] + n - len(out))))
            if len(out) >= n:
                break
        return out

    def next_chunk(self, k: int) -> Optional[Dict[str, Any]]:
        """Reserve up to ``k`` slots from the first shard with staged
        headroom; caller holds the runner lock."""
        if self.paused or k < 1:
            return None
        for lo, s in sorted(self.shards.items()):
            if s["busy"] or s["staged"] >= s["hi"]:
                continue
            hi = min(s["staged"] + k, s["hi"])
            chunk = {"shard_lo": lo, "lo": s["staged"], "hi": hi}
            s["busy"] = True
            s["staged"] = hi
            return chunk
        return None


class BulkRunner:
    """Scavenger-class bulk executor attached to one
    :class:`~glom_tpu_torch.serving.engine.ServingEngine`.

    Owns the replica's :class:`~glom_tpu_torch.bulk.jobs.JobStore` (adopting
    unfinished jobs on construction — THAT is resume-after-kill: a fresh
    engine over the same store directory picks up every durable cursor
    with zero operator action) and the idle-window thread.  The engine's
    execute loop calls :meth:`fill`/:meth:`complete` around its primary
    group to scavenge residual bucket padding."""

    def __init__(self, engine, store_root: str, *,
                 idle_poll_s: float = DEFAULT_IDLE_POLL_S,
                 clock=None):
        self.engine = engine
        self.store = JobStore(store_root)
        self.registry = engine.registry
        self.idle_poll_s = idle_poll_s
        self.idle_grace_s = DEFAULT_IDLE_GRACE_S
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        # notified whenever a staged chunk is settled (committed or rewound)
        self._settled = threading.Condition(self._lock)
        self._jobs: Dict[str, _ActiveJob] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the host thread: scavenged commits (None stops it) and draws ahead
        self._commits: "queue.Queue" = queue.Queue()
        self._commit_lock = threading.Lock()
        self._host: Optional[threading.Thread] = None
        #: slots drawn ahead per job: one chunk of the largest bucket
        self.ahead_slots = int(engine.buckets[-1])
        # (t, slots_done) samples for the scavenged-slots/s + ETA view;
        # bounded ring — the runner must not grow with job size
        self._progress: deque = deque(maxlen=64)
        self._slots_done = 0
        for name in self.store.names():
            doc = self.store.load(name)
            if doc["status"] in ("pending", "running", "paused"):
                try:
                    self._activate(name, doc)
                except ValueError as e:
                    # adopt-on-resume must not fail engine startup: a job
                    # pinned to a (model, version) that is not resident
                    # yet parks in the store; `resume` re-activates it
                    # once the pin is resident
                    warnings.warn(
                        f"bulk job {name!r} not adopted ({e}); parked "
                        f"until resumed", stacklevel=2)
                    self.registry.counter(
                        "bulk_jobs_parked_total",
                        help="store jobs skipped at adoption (pinned "
                             "version not resident / stale spec)",
                    ).inc()
        self._gauge_backlog()

    # -- model/version resolution -------------------------------------------
    def _resolve_version(self, spec: BulkJobSpec):
        """``(serving set, config)`` a job executes against.

        Unpinned specs (``model="default"``, no version) ride the LIVE
        primary — re-read per bucket, so promotions apply to bulk too.  A
        pinned (model, version) must be resident in the model registry;
        its set's graphs keep the zero-capture invariant, and the
        attribution plane can then blame device time on that exact
        version instead of lumping it in with online traffic.  The caller
        keeps the returned set for the whole replay: a retired version's
        set lives until the last reference to it goes."""
        engine = self.engine
        if spec.model == "default" and spec.version is None:
            return engine.serving, engine.config
        version = engine.models.get(
            spec.model, None if spec.version is None else int(spec.version))
        if version is None:
            raise ValueError(
                f"pin ({spec.model!r}, {spec.version!r}) is not resident "
                f"in the model registry; load it first")
        return version.caches, version.config

    def _pinned(self, spec: BulkJobSpec) -> bool:
        return spec.model != "default" or spec.version is not None

    # -- job admin (the /admin/jobs/* verbs) -------------------------------
    def _activate(self, name: str, doc: dict) -> None:
        spec = BulkJobSpec.from_json_dict(doc["spec"])
        serving, cfg = self._resolve_version(spec)
        if spec.transform not in serving.caches:
            raise ValueError(
                f"job {name!r} transform {spec.transform!r} not served "
                f"by this engine")
        if (spec.image_size != cfg.image_size
                or spec.channels != cfg.channels):
            raise ValueError(
                f"job {name!r} geometry ({spec.channels}, "
                f"{spec.image_size}) does not match the served model "
                f"({cfg.channels}, {cfg.image_size})")
        with self._lock:
            job = self._jobs.get(name)
            if job is None:
                self._jobs[name] = _ActiveJob(spec, doc)
            else:
                job.sync_shards(doc)
                job.paused = doc["status"] == "paused"

    def submit(self, payload: dict) -> dict:
        """Create/extend a job from an ``/admin/jobs/submit`` body and
        activate it.  ``shard`` (``[lo, hi]``) scopes this replica to a
        fleet partition; ``total`` defaults to the dataset length."""
        fields = {k: payload[k] for k in (
            "name", "dataset", "transform", "sink", "model", "version",
            "seed", "image_size", "channels") if k in payload}
        cfg = self.engine.config
        fields.setdefault("image_size", int(cfg.image_size))
        fields.setdefault("channels", int(cfg.channels))
        spec = BulkJobSpec(**fields)
        # resolve the pin BEFORE anything durable is written: a job
        # against a version that is not resident must fail the submit,
        # not park a half-created store entry
        vserving, vcfg = self._resolve_version(spec)
        if spec.transform not in vserving.caches:
            raise ValueError(
                f"transform {spec.transform!r} not served by pin "
                f"({spec.model!r}, {spec.version!r})")
        if (spec.image_size != vcfg.image_size
                or spec.channels != vcfg.channels):
            raise ValueError(
                f"job geometry ({spec.channels}, {spec.image_size}) does "
                f"not match the served model "
                f"({vcfg.channels}, {vcfg.image_size})")
        probe = SlotDataset(spec)  # validates the dataset spec eagerly
        total = int(payload.get("total", len(probe)))
        if total > len(probe):
            raise ValueError(
                f"total {total} exceeds dataset length {len(probe)}")
        shard = payload.get("shard")
        shards = [tuple(int(v) for v in shard)] if shard else None
        doc = self.store.submit(spec, total=total, shards=shards,
                                owner=str(payload.get("owner", "local")))
        self._activate(spec.name, doc)
        self._note("bulk_submit", name=spec.name, model=spec.model,
                   version=spec.version, endpoint=spec.transform,
                   total=total)
        self._gauge_backlog()
        return self.status(spec.name)

    def pause(self, name: str, wait: bool = False, timeout: float = 60.0) -> dict:
        """Stop staging chunks of ``name``; with ``wait``, also wait until
        each chunk already staged is committed or rewound."""
        self.store.set_status(name, "paused")
        with self._lock:
            job = self._jobs.get(name)
            if job is not None:
                job.paused = True
                job.ahead.clear()
                if wait and not self._settled.wait_for(
                        lambda: not any(s["busy"] for s in job.shards.values()), timeout):
                    raise TimeoutError(f"bulk job {name!r}: a chunk stayed in flight "
                                       f"for {timeout} s")
        return self.status(name)

    def resume(self, name: str) -> dict:
        doc = self.store.set_status(name, "running")
        self._activate(name, doc)
        with self._lock:
            self._jobs[name].paused = False
        self._note("bulk_resume", name=name)
        return self.status(name)

    def _note(self, event: str, **fields) -> None:
        """Unified timeline record (obs.events): bulk activity carries
        its (model, version) pin so attribution can tell a bulk job on a
        pinned version apart from online traffic."""
        timeline = getattr(self.engine, "timeline", None)
        if timeline is not None:
            timeline.note(event, **fields)

    def cancel(self, name: str) -> dict:
        self.store.set_status(name, "cancelled")
        with self._lock:
            self._jobs.pop(name, None)
        self._gauge_backlog()
        return self.status(name)

    def status(self, name: Optional[str] = None) -> dict:
        if name is not None:
            return self.store.status(name)
        return self.summary()

    # -- the scavenger fill/complete/abandon cycle --------------------------
    def fill(self, endpoint: str, k: int, source: str = "scavenged",
             job_name: Optional[str] = None) -> Optional[_FillToken]:
        """Stage up to ``k`` slots of some runnable job whose transform
        is ``endpoint``.  Returns None when nothing is runnable — the
        overwhelmingly common case, kept to a dict scan.  The staged
        chunk is NOT durable: only :meth:`complete` commits it.

        Scavenged fills ride the ONLINE batch's graph — i.e. the live
        primary — so jobs pinned to another (model, version) are never
        scavenged; they only run in idle windows, where the idle loop
        names the job (``job_name``) and replays the pin's own graphs."""
        if k < 1:
            return None
        with self._lock:
            for name, job in self._jobs.items():
                if job.spec.transform != endpoint:
                    continue
                if job_name is not None and name != job_name:
                    continue
                if source == "scavenged" and self._pinned(job.spec):
                    continue
                chunk = job.next_chunk(k)
                if chunk is not None:
                    break
            else:
                return None
            dataset = job.dataset
            slots = range(chunk["lo"], chunk["hi"])
            drawn = [job.ahead.pop(slot, None) for slot in slots]
        # materialize OUTSIDE the lock: the shard's busy flag protects
        # the range, and dataset reads are pure functions of the slots (a
        # slot drawn ahead holds the bytes read() gives it)
        imgs = np.stack([img if img is not None else dataset.read(slot, slot + 1)[0]
                         for slot, img in zip(slots, drawn)])
        return _FillToken(job=name, shard_lo=chunk["shard_lo"],
                          lo=chunk["lo"], hi=chunk["hi"], imgs=imgs,
                          source=source)

    def complete(self, token: _FillToken, out: np.ndarray) -> None:
        """Commit one executed chunk: part file first, cursor second
        (the exactly-once order), then release the shard."""
        with self._lock:
            job = self._jobs.get(token.job)
        if job is None:  # cancelled while in flight: drop the output
            return
        if job.spec.transform == "index":
            # the similarity-index build publishes PER-LEVEL part
            # families (same tmp+rename + orphan-overlap idempotence,
            # same sink directory) instead of the flat ChunkSink layout
            from glom_tpu_torch.hierarchy.index import write_index_parts

            write_index_parts(job.sink.root, token.lo, token.hi,
                              np.asarray(out))
        else:
            job.sink.write(token.lo, token.hi, np.asarray(out))
        doc = self.store.advance(token.job, token.shard_lo, token.hi)
        n = token.hi - token.lo
        with self._lock:
            shard = job.shards[token.shard_lo]
            shard["cursor"] = token.hi
            shard["busy"] = False
            self._settled.notify_all()
            self._slots_done += n
            self._progress.append((self._clock(), self._slots_done))
            if doc["status"] == "done":
                self._jobs.pop(token.job, None)
        reg = self.registry
        reg.counter("bulk_slots_total",
                    help="bulk samples executed (all sources)").inc(n)
        reg.counter(
            f"bulk_{token.source}_slots_total",
            help=("bulk samples run in residual bucket padding"
                  if token.source == "scavenged"
                  else "bulk samples run in idle flush windows"),
        ).inc(n)
        reg.counter("bulk_parts_written_total",
                    help="sink part files durably written").inc()
        self._gauge_backlog()

    def abandon(self, token: _FillToken) -> None:
        """Rewind a staged chunk (failed batch, shutdown mid-flight):
        the slots return to the pool and will re-execute — exactly-once
        is preserved because nothing was committed."""
        with self._lock:
            job = self._jobs.get(token.job)
            if job is None:
                return
            shard = job.shards.get(token.shard_lo)
            if shard is not None and shard["busy"]:
                shard["staged"] = token.lo
                shard["busy"] = False
                self._settled.notify_all()

    def commit(self, token: _FillToken, out: np.ndarray) -> None:
        """Settle a scavenged chunk whose online futures resolved: on the
        host thread while the runner runs, so the part write and the
        cursor's fsync never hold the online worker; here otherwise."""
        with self._commit_lock:
            if self._host is not None:
                self._commits.put((token, out))
                return
        self._settle(token, out)

    def _settle(self, token: _FillToken, out: np.ndarray) -> None:
        """:meth:`complete`; a commit that fails rewinds the chunk, so its
        slots run again, and never fails its caller."""
        try:
            self.complete(token, out)
        except Exception as e:  # counted, warned; the slots are rewound, never dropped
            self.abandon(token)
            self.count_error()
            warnings.warn(f"bulk commit of slots [{token.lo}, {token.hi}) failed "
                          f"({type(e).__name__}: {e}); they run again", stacklevel=2)

    def draw_ahead(self) -> int:
        """Draw every slot the next fills take that is not drawn yet;
        returns the slots drawn.  The host thread draws them one at a time
        between commits."""
        n = 0
        while self._draw_one():
            n += 1
        return n

    def _draw_one(self) -> bool:
        """Draw one upcoming slot of some unpaused job (dropping the drawn
        slots no fill will take); False when every job's window is full."""
        with self._lock:
            for job in self._jobs.values():
                if job.paused:
                    continue
                upcoming = job.upcoming(self.ahead_slots)
                for slot in set(job.ahead) - set(upcoming):
                    del job.ahead[slot]
                slot = next((s for s in upcoming if s not in job.ahead), None)
                if slot is not None:
                    break
            else:
                return False
        try:
            img = job.dataset.read(slot, slot + 1)[0]
        except Exception:  # kept as None: the fill that stages the slot reads it and meets the error
            img = None
        with self._lock:
            # a fill may have staged the slot (and read it itself) meanwhile
            if not job.paused and slot in job.upcoming(self.ahead_slots):
                job.ahead[slot] = img
        return True

    def count_error(self) -> None:
        self.registry.counter(
            "bulk_batch_errors_total",
            help="bulk bucket executions that raised "
                 "(slots were rewound, never dropped)",
        ).inc()

    # -- idle-window execution ----------------------------------------------
    def run_idle_once(self) -> int:
        """Replay ONE pure-bulk bucket if (and only if) no online image is
        queued and no online batch ran within ``idle_grace_s`` (the engine's
        ``online_at``) — the instant-preemption gate: a bulk bucket never
        starts while an online image waits.  Returns slots executed."""
        with self._lock:
            candidates = [(name, job.spec)
                          for name, job in self._jobs.items()
                          if not job.paused]
        for name, spec in candidates:
            if (any(b.depth > 0 for b in self.engine.batchers.values())
                    or self._clock() - self.engine.online_at < self.idle_grace_s):
                # online admission preempts before we start; every endpoint
                # shares the card, so any queued image does, and so does
                # recent online work: its next request is likely on the way
                return 0
            try:
                serving, _ = self._resolve_version(spec)
            except ValueError:
                continue  # pin retired since activation: job waits
            cache = serving.caches[spec.transform]
            token = self.fill(spec.transform, cache.max_bucket,
                              source="idle", job_name=name)
            if token is None:
                continue
            try:
                out = cache(serving.params, token.imgs)
            except Exception:
                self.abandon(token)
                self.count_error()
                raise
            self.poll_captures(cache)
            self.complete(token, out)
            return token.hi - token.lo
        return 0

    def poll_captures(self, cache) -> None:
        """Bulk replays captured graphs only: fold any capture into the
        shared request-path budget so the zero-after-warm-up acceptance
        covers the scavenger too."""
        new = cache.poll_captures()
        if new:
            self.registry.counter(
                "serving_graph_captures",
                help="request-path CUDA graph captures after warm-up (must stay 0)",
            ).inc(new)

    def _host_loop(self) -> None:
        while True:
            try:
                item = self._commits.get_nowait()
            except queue.Empty:
                if self._draw_one():
                    continue
                try:
                    item = self._commits.get(timeout=self.idle_poll_s)
                except queue.Empty:
                    continue
            if item is None:
                return
            self._settle(*item)

    def _idle_loop(self) -> None:
        while not self._stop.wait(self.idle_poll_s):
            try:
                self.run_idle_once()
            except Exception:  # counted in run_idle_once; a bad bucket must not kill the scavenger thread (its slots were rewound)
                continue

    # -- views ---------------------------------------------------------------
    def backlog(self) -> int:
        with self._lock:
            return sum(job.remaining for job in self._jobs.values())

    def _gauge_backlog(self) -> None:
        with self._lock:
            backlog = sum(job.remaining for job in self._jobs.values())
            active = len(self._jobs)
        self.registry.gauge(
            "bulk_backlog_slots",
            help="bulk slots queued but not yet durably finished",
        ).set(backlog)
        self.registry.gauge(
            "bulk_jobs_active", help="bulk jobs pending/running locally",
        ).set(active)

    def rate_slots_per_s(self) -> Optional[float]:
        with self._lock:
            if len(self._progress) < 2:
                return None
            (t0, n0), (t1, n1) = self._progress[0], self._progress[-1]
        if t1 <= t0:
            return None
        return (n1 - n0) / (t1 - t0)

    def summary(self) -> Dict[str, Any]:
        """The ``/healthz`` ``bulk`` block (and ``/admin/jobs/status``
        with no name): store summary + live rate/ETA.  A fleet router's
        health loop ingests this — including per-shard cursors, which is
        what lets it re-partition a DEAD replica's range from its last
        witnessed durable cursor."""
        doc = self.store.summary()
        rate = self.rate_slots_per_s()
        doc["rate_slots_per_s"] = None if rate is None else round(rate, 3)
        doc["eta_s"] = (round(doc["backlog"] / rate, 3)
                        if rate and doc["backlog"] else None)
        with self._lock:
            doc["slots_done_session"] = self._slots_done
        return doc

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._idle_loop, name="glom-torch-bulk-idle", daemon=True)
        with self._commit_lock:
            self._host = threading.Thread(
                target=self._host_loop, name="glom-torch-bulk-host", daemon=True)
            self._host.start()
        self._thread.start()

    def stop(self) -> None:
        """Stop the idle thread, then the host thread once it committed the
        chunks handed to it; later commits run on their caller."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        with self._commit_lock:
            host, self._host = self._host, None
            if host is not None:
                self._commits.put(None)
        if host is not None:
            host.join(timeout=30.0)
