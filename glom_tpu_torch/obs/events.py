"""Typed fleet/engine timeline events.

The port's copy of ``glom_tpu/obs/events.py`` (stdlib only), the same code
so both packages export the same metrics, traces and alerts.

The router, the deploy controller and the capacity advisor of
``glom_tpu`` each once kept their own event shapes.  The attribution
plane (``glom_tpu/obs/attribution.py``) has to JOIN all three against a
regression window, so this module is the one record shape every source
emits:

  * :class:`TimelineEvent` — frozen ``(seq, t, event, fields)``; ``seq``
    is the source-local monotone cursor (the observatory reads
    incrementally), ``t`` the source's injectable clock, ``event`` the
    kind key.  ``from_dict`` still accepts the legacy ``kind`` spelling
    so recorded timelines keep replaying.
  * :class:`Timeline` — the bounded ring + seq counter + leaf lock the
    router used to carry inline, now shared by the router AND the
    serving engine (deploy transitions, capacity recommendations, bulk
    job activity all land on ``engine.timeline`` and serve at
    ``GET /debug/timeline``).

Stdlib-only, injectable clock — the rest of the obs pull plane's rules.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

#: event kinds attribution treats as deploy-plane causes
DEPLOY_EVENTS = frozenset((
    "deploy_shadow", "deploy_canary", "deploy_promote", "deploy_rollback",
    "deploy_abort", "rollout_committed", "rollout_aborted",
    "rollout_rolled_back",
))
#: event kinds attribution treats as bulk-plane causes
BULK_EVENTS = frozenset((
    "bulk_submit", "bulk_activate", "bulk_resume", "bulk_repartition",
    "bulk_revoke",
))
#: event kinds attribution treats as fleet-topology causes
FLEET_EVENTS = frozenset(("ejection", "readmission", "drain_timeout"))
#: advisory events: correlated but never blamed on their own
ADVISORY_EVENTS = frozenset(("capacity_recommendation",))


@dataclass(frozen=True)
class TimelineEvent:
    """One timeline record: the unified shape every source emits."""

    seq: int
    t: float
    event: str
    fields: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"seq": self.seq, "t": self.t, "event": self.event,
                **self.fields}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TimelineEvent":
        """Adopt a recorded event dict; tolerates the retired ``kind``
        key so pre-unification timelines (and foreign feeds) replay."""
        rest = {k: v for k, v in d.items()
                if k not in ("seq", "t", "event", "kind")}
        event = d.get("event", d.get("kind"))
        return cls(seq=int(d.get("seq", -1)), t=float(d.get("t", 0.0)),
                   event=str(event), fields=rest)


class Timeline:
    """Bounded event ring with a monotone seq cursor.

    Leaf component: :meth:`note` takes only its own lock, so it is
    safely callable from under any caller lock (the router's original
    contract, now shared by the engine's deploy/capacity/bulk planes)."""

    def __init__(self, *, maxlen: int = 256,
                 clock: Optional[Callable[[], float]] = None):
        if maxlen < 1:
            raise ValueError(f"maxlen must be >= 1, got {maxlen}")
        self._ring: "deque[TimelineEvent]" = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._seq = 0
        self._clock = clock if clock is not None else time.monotonic

    def note(self, event: str, **fields) -> TimelineEvent:
        """Append one typed event; returns the record (tests assert on
        it; production callers ignore the return)."""
        with self._lock:
            rec = TimelineEvent(
                seq=self._seq, t=round(self._clock(), 6),
                event=str(event), fields=fields)
            self._ring.append(rec)
            self._seq += 1
            return rec

    def events(self) -> List[Dict[str, Any]]:
        """The ring as plain dicts, oldest first — the
        ``/debug/timeline`` payload shape (unchanged on the wire)."""
        with self._lock:
            return [e.to_dict() for e in self._ring]

    def records(self) -> List[TimelineEvent]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


def merge_events(*feeds) -> List[TimelineEvent]:
    """Join several timelines' worth of events (dicts or
    :class:`TimelineEvent`) into one list ordered by ``(t, seq)`` —
    the attribution join, shim-free because every source shares the
    :class:`TimelineEvent` shape."""
    out: List[TimelineEvent] = []
    for feed in feeds:
        for e in feed or ():
            out.append(e if isinstance(e, TimelineEvent)
                       else TimelineEvent.from_dict(e))
    out.sort(key=lambda e: (e.t, e.seq, e.event))
    return out
