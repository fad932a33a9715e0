"""Per-session column-state store for stateful (video, streaming) serving
(``glom_tpu/serving/sessions.py``).

GLOM's stateful recipe carries the column ``levels`` across consecutive
frames (``models/video.py``).  Serving it means the state lives somewhere
between two requests; this module is that place:

  * one :class:`SessionEntry` per session, holding its settled ``(bucket,
    n, L, d)`` levels as a tensor on the card: between frames the state
    never crosses to the host.  It is shaped at the graph cache's bucket,
    not the request's batch, so the next frame copies it straight into the
    bucket's captured graph;
  * TTL and LRU eviction bounded in bytes (``numel() * element_size()``):
    idle sessions age out after ``ttl_s``, and past ``max_bytes`` the
    least recently used go; the entry just written always stays, so one
    session over the budget degrades to a cold frame each time instead of
    an error;
  * per-session locks: frame k+1 depends on frame k, so two requests of one
    session serialize while other sessions go on;
  * spill and restore in the checkpoint npz layout (``sessions.npz`` and a
    ``sessions.json`` manifest, each written tmp + rename), so a drained
    replica's warm state survives a restart.  The spill writes float32
    whatever the state's dtype (npz has no bfloat16); restore hands each
    array to the engine's ``place``, which casts it back to the serving
    dtype, and a spill written by either package restores in the other.

The ``serving_session_count`` / ``serving_session_bytes`` gauges and the
``serving_session_*`` counters go to the shared registry.  The clock is
injectable (tests drive the TTL); ``time.monotonic`` by default.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import threading
import time
import zipfile
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

# the session-id contract, checked at the HTTP boundary and again here: ids
# become npz keys and affinity-hash inputs, so a hostile id must not reach
# a path or the spill manifest
SESSION_ID_RE = re.compile(r"^[A-Za-z0-9._:-]{1,128}$")

SPILL_NPZ = "sessions.npz"
SPILL_MANIFEST = "sessions.json"
_SPILL_FORMAT = 1


def valid_session_id(session_id: str) -> bool:
    return isinstance(session_id, str) and bool(SESSION_ID_RE.match(session_id))


@dataclass
class SessionEntry:
    """One session's carried state.  ``levels`` is bucket-shaped (the
    graph's input); ``batch`` is the session's real images a frame, to which
    the answers are sliced."""

    levels: Any                 # (bucket, n, L, d) tensor on the card
    batch: int                  # real images a frame
    bucket: int                 # the bucket the state is shaped for
    step: int                   # checkpoint step of the last update
    frames: int = 0             # frames served so far
    last_used: float = 0.0      # store clock at the last touch
    nbytes: int = 0

    def meta(self) -> dict:
        return {"batch": int(self.batch), "bucket": int(self.bucket),
                "step": int(self.step), "frames": int(self.frames)}


@dataclass
class SessionStats:
    hits: int = 0
    misses: int = 0
    resets: int = 0
    evicted_ttl: int = 0
    evicted_lru: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock)


def state_nbytes(levels) -> int:
    """Bytes a state holds: ``numel() * element_size()`` of a tensor."""
    if isinstance(levels, torch.Tensor):
        return levels.numel() * levels.element_size()
    return int(np.asarray(levels).nbytes)


def _host_f32(levels) -> np.ndarray:
    if isinstance(levels, torch.Tensor):
        return levels.detach().to("cpu", torch.float32).numpy()
    return np.asarray(levels, np.float32)


class SessionStore:
    """TTL + LRU map ``session_id -> SessionEntry`` bounded in bytes.

    The map lock covers only the dict bookkeeping; the engine holds a
    session's own lock (:meth:`locked`) across a frame's get, execute and
    put."""

    def __init__(self, *, max_bytes: int = 256 * 2 ** 20, ttl_s: float = 600.0,
                 registry=None, clock=None):
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        if ttl_s <= 0:
            raise ValueError(f"ttl_s must be > 0, got {ttl_s}")
        self.max_bytes = int(max_bytes)
        self.ttl_s = float(ttl_s)
        self.registry = registry
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, SessionEntry]" = OrderedDict()
        self._locks: Dict[str, threading.Lock] = {}
        self._bytes = 0
        self._last_sweep = self._clock()
        self.stats = SessionStats()

    # -- registry ----------------------------------------------------------
    def _counter(self, name: str, help: str) -> None:
        if self.registry is not None:
            self.registry.counter(name, help=help).inc()

    def _export_gauges(self) -> None:
        if self.registry is None:
            return
        self.registry.gauge("serving_session_count",
                            help="resident session states").set(len(self._entries))
        self.registry.gauge("serving_session_bytes", help="bytes of resident session state",
                            unit="bytes").set(self._bytes)

    def _miss(self) -> None:
        with self.stats._lock:
            self.stats.misses += 1
        self._counter("serving_session_misses", "session lookups that found no state")

    # -- per-session serialization ------------------------------------------
    def lock(self, session_id: str) -> threading.Lock:
        """The session's frame-ordering lock object.  Serialize a frame with
        :meth:`locked`: a bare ``lock().acquire()`` races the cleanup that
        drops idle locks."""
        with self._lock:
            lock = self._locks.get(session_id)
            if lock is None:
                lock = self._locks[session_id] = threading.Lock()
            return lock

    @contextlib.contextmanager
    def locked(self, session_id: str):
        """Hold the session's lock for one frame's get, execute and put.
        After acquiring, check that the lock is still the one mapped to the
        session (an eviction may have dropped and re-minted it in between);
        cleanup skips held locks, so once checked it stays."""
        while True:
            lock = self.lock(session_id)
            lock.acquire()
            with self._lock:
                if self._locks.get(session_id) is lock:
                    break
            lock.release()
        try:
            yield
        finally:
            lock.release()

    def _drop_lock_if_idle(self, session_id: str) -> None:
        # the caller holds self._lock; a lock a frame holds is never dropped
        lock = self._locks.get(session_id)
        if lock is not None and not lock.locked():
            del self._locks[session_id]

    # -- the map -----------------------------------------------------------
    def get(self, session_id: str) -> Optional[SessionEntry]:
        """TTL-checked lookup; a hit refreshes the entry's recency."""
        now = self._clock()
        with self._lock:
            entry = self._entries.get(session_id)
            if entry is None:
                self._miss()
                return None
            if now - entry.last_used > self.ttl_s:
                self._evict_locked(session_id, "ttl")
                self._export_gauges()
                self._miss()
                return None
            entry.last_used = now
            self._entries.move_to_end(session_id)
            with self.stats._lock:
                self.stats.hits += 1
            self._counter("serving_session_hits", "session lookups served from resident state")
            return entry

    def put(self, session_id: str, levels, *, batch: int, bucket: int, step: int,
            frames: int) -> SessionEntry:
        """Insert or replace a session's state, then evict the least recently
        used other sessions down to the byte bound (the entry just written
        stays)."""
        if not valid_session_id(session_id):
            raise ValueError(f"invalid session id {session_id!r}")
        entry = SessionEntry(levels=levels, batch=int(batch), bucket=int(bucket),
                             step=int(step), frames=int(frames), last_used=self._clock(),
                             nbytes=state_nbytes(levels))
        with self._lock:
            old = self._entries.pop(session_id, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[session_id] = entry
            self._bytes += entry.nbytes
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                oldest = next(iter(self._entries))
                if oldest == session_id:
                    break
                self._evict_locked(oldest, "lru")
            self._export_gauges()
        return entry

    def reset(self, session_id: str) -> bool:
        """Forget a session at the client's request (``/session/reset``)."""
        with self._lock:
            entry = self._entries.pop(session_id, None)
            if entry is None:
                return False
            self._bytes -= entry.nbytes
            self._drop_lock_if_idle(session_id)
            with self.stats._lock:
                self.stats.resets += 1
            self._counter("serving_session_resets", "client-requested session resets")
            self._export_gauges()
            return True

    def _evict_locked(self, session_id: str, why: str) -> None:
        entry = self._entries.pop(session_id)
        self._bytes -= entry.nbytes
        self._drop_lock_if_idle(session_id)
        with self.stats._lock:
            if why == "ttl":
                self.stats.evicted_ttl += 1
            else:
                self.stats.evicted_lru += 1
        self._counter(f"serving_session_evictions_{why}",
                      "sessions evicted by " + ("TTL expiry" if why == "ttl"
                                                else "LRU byte-bound pressure"))

    def sweep(self, *, min_interval: Optional[float] = None) -> int:
        """Evict every session past its TTL.  ``min_interval`` makes the call
        a no-op when a sweep ran more recently than that (the request path
        sweeps this way when no reload watcher runs)."""
        now = self._clock()
        evicted = 0
        with self._lock:
            if min_interval is not None and now - self._last_sweep < min_interval:
                return 0
            self._last_sweep = now
            for sid in [sid for sid, e in self._entries.items()
                        if now - e.last_used > self.ttl_s]:
                self._evict_locked(sid, "ttl")
                evicted += 1
            if evicted:
                self._export_gauges()
        return evicted

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._bytes

    def snapshot(self) -> dict:
        """Counts for ``/healthz``, never the state."""
        with self._lock:
            count, nbytes = len(self._entries), self._bytes
        with self.stats._lock:
            s = {"hits": self.stats.hits, "misses": self.stats.misses,
                 "resets": self.stats.resets, "evicted_ttl": self.stats.evicted_ttl,
                 "evicted_lru": self.stats.evicted_lru}
        return {"count": count, "bytes": nbytes, "max_bytes": self.max_bytes,
                "ttl_s": self.ttl_s, **s}

    # -- spill / restore ---------------------------------------------------
    def spill(self, directory: str) -> int:
        """Write every resident session into ``directory``: ``sessions.npz``
        (``levels/<sid>`` keys, float32) and the ``sessions.json`` manifest,
        each tmp + rename, so a crash mid-spill leaves the previous spill
        whole.  Returns the sessions written."""
        from glom_tpu_torch import checkpoint as ckpt_lib

        os.makedirs(directory, exist_ok=True)
        with self._lock:
            items = list(self._entries.items())   # oldest first (LRU order)
        arrays = {f"levels/{sid}": _host_f32(entry.levels) for sid, entry in items}
        manifest = {sid: entry.meta() for sid, entry in items}
        payload = json.dumps({"format": _SPILL_FORMAT, "sessions": manifest},
                             indent=2).encode()
        ckpt_lib._atomic_write(directory, SPILL_NPZ, lambda f: np.savez(f, **arrays))
        ckpt_lib._atomic_write(directory, SPILL_MANIFEST, lambda f: f.write(payload))
        if self.registry is not None:
            self.registry.counter("serving_session_spills",
                                  help="session-store spills to the checkpoint npz format").inc()
        return len(items)

    def restore(self, directory: str, *,
                validate: Optional[Callable[[tuple, Any], bool]] = None,
                place: Optional[Callable[[np.ndarray], Any]] = None) -> int:
        """Load a spill.  Missing or torn files are a no-op (a cold boot is
        always safe); an entry ``validate(shape, dtype)`` rejects is dropped
        (the model or the bucket ladder changed).  ``place`` puts each host
        array on the card at the serving dtype.  Restored sessions count as
        just used.  Returns the sessions restored."""
        npz_path = os.path.join(directory, SPILL_NPZ)
        man_path = os.path.join(directory, SPILL_MANIFEST)
        try:
            with open(man_path) as f:
                manifest = json.load(f)
            data = np.load(npz_path, allow_pickle=False)
        except (OSError, ValueError, zipfile.BadZipFile):
            # a torn npz is not a zip at all (BadZipFile is neither error)
            return 0
        if not isinstance(manifest, dict) or manifest.get("format") != _SPILL_FORMAT:
            data.close()
            return 0
        restored = 0
        try:
            # manifest order is the spill's LRU order, oldest first, so the
            # byte bound put() applies keeps the newest states
            for sid, meta in (manifest.get("sessions") or {}).items():
                key = f"levels/{sid}"
                if not valid_session_id(sid) or key not in data.files:
                    continue
                levels = data[key]
                if validate is not None and not validate(tuple(levels.shape), levels.dtype):
                    continue
                self.put(sid, place(levels) if place is not None else levels,
                         batch=int(meta.get("batch", levels.shape[0])),
                         bucket=int(meta.get("bucket", levels.shape[0])),
                         step=int(meta.get("step", 0)), frames=int(meta.get("frames", 0)))
                restored += 1
        finally:
            data.close()
        if restored and self.registry is not None:
            self.registry.counter("serving_session_restores",
                                  help="sessions restored warm from a spill at startup"
                                  ).inc(restored)
        return restored
