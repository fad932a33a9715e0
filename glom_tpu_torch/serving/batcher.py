"""Deadline-aware dynamic micro-batcher with admission control: the port's
own copy of ``glom_tpu/serving/batcher.py`` (without tenant admission and
tracing, which this slice does not port).

Callers :meth:`~DynamicBatcher.submit` payloads and get a
``concurrent.futures.Future``; a worker pulls flushed batches with
:meth:`~DynamicBatcher.next_batch` and resolves the futures.  A batch
flushes when the queued image count reaches ``max_batch`` or the oldest
item has waited ``max_wait_ms``, whichever comes first.  When the queue
already holds ``max_queue`` images, ``submit`` raises :class:`Overloaded`
at once (the server answers 503) instead of queueing without bound.

Time is injectable (``clock``) and ``next_batch(block=False)`` never
sleeps, so the flush rules can be tested with a fake clock.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, List, Optional


class Overloaded(RuntimeError):
    """Queue at capacity: the request was shed, not enqueued."""


class Closed(RuntimeError):
    """Submitted after shutdown began: the request was not enqueued."""


@dataclass
class _Item:
    payload: Any
    size: int
    enqueued_at: float
    future: Future = field(default_factory=Future)


class DynamicBatcher:
    """Bounded queue plus the two flush rules.  ``max_batch`` and
    ``max_queue`` count IMAGES; an item larger than ``max_batch`` could
    never flush and is refused at submit with ``ValueError``."""

    def __init__(self, *, max_batch: int = 8, max_wait_ms: float = 5.0,
                 max_queue: int = 64, clock=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        if max_queue < max_batch:
            raise ValueError(
                f"max_queue ({max_queue}) must be >= max_batch "
                f"({max_batch}) or a full batch could never queue"
            )
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.max_queue = max_queue
        self._clock = clock if clock is not None else time.monotonic
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._queued = 0
        self._closed = False
        self._draining = False

    @property
    def depth(self) -> int:
        """Queued image count."""
        with self._cond:
            return self._queued

    def submit(self, payload: Any, size: int = 1) -> Future:
        """Enqueue ``payload`` (``size`` images); returns the Future the
        worker resolves.  Raises :class:`Overloaded` at capacity or
        :class:`Closed` after shutdown began."""
        if size < 1:
            raise ValueError(f"size must be >= 1, got {size}")
        if size > self.max_batch:
            raise ValueError(
                f"item of {size} images exceeds max_batch {self.max_batch}; "
                f"split the request client-side"
            )
        with self._cond:
            if self._closed:
                raise Closed("batcher is shut down")
            if self._queued + size > self.max_queue:
                raise Overloaded(
                    f"queue at capacity ({self._queued}/{self.max_queue} "
                    f"images); request shed"
                )
            item = _Item(payload=payload, size=size, enqueued_at=self._clock())
            self._queue.append(item)
            self._queued += size
            self._cond.notify_all()
            return item.future

    def _should_flush(self, now: float) -> bool:
        """Whether the head of the queue flushes now: a full batch, a
        drain, or the oldest item's deadline.  Caller holds the lock."""
        if not self._queue:
            return False
        return (self._queued >= self.max_batch or self._draining
                or now - self._queue[0].enqueued_at >= self.max_wait_s)

    def _take_batch(self) -> List[_Item]:
        """Pop items from the head until the next would overflow
        ``max_batch``.  Caller holds the lock."""
        batch: List[_Item] = []
        total = 0
        while self._queue and total + self._queue[0].size <= self.max_batch:
            item = self._queue.popleft()
            total += item.size
            batch.append(item)
        self._queued -= total
        return batch

    def next_batch(self, *, block: bool = True,
                   timeout: Optional[float] = None) -> Optional[List[_Item]]:
        """A non-empty list of items when a flush rule fired, else None.
        ``block=True`` waits until a rule fires, the closed queue runs dry
        (returns None: the worker exits) or ``timeout`` elapses."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while True:
                if self._should_flush(self._clock()):
                    return self._take_batch()
                if self._closed and not self._queue:
                    return None
                if not block:
                    return None
                # wait for a submission, shutdown, or the head item's
                # deadline; an empty queue has no deadline to honour
                wait = None
                if self._queue:
                    wait = max(0.0, self._queue[0].enqueued_at + self.max_wait_s
                               - self._clock())
                if deadline is not None:
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        return None
                    wait = remaining if wait is None else min(wait, remaining)
                self._cond.wait(timeout=None if wait is None else max(wait, 1e-4))

    def close(self, *, drain: bool = True) -> None:
        """Stop admitting.  ``drain=True``: queued items keep flushing until
        the queue is dry.  ``drain=False``: pending futures fail with
        :class:`Closed`.  Idempotent."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            if drain:
                self._draining = True
            else:
                for item in self._queue:
                    item.future.set_exception(Closed("batcher shut down"))
                self._queue.clear()
                self._queued = 0
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed
