"""Deadline-aware dynamic micro-batcher with admission control: the port's
own copy of ``glom_tpu/serving/batcher.py``, with its tracing hooks and
counters (tenant admission waits for the port's tenancy).

Callers :meth:`~DynamicBatcher.submit` payloads and get a
``concurrent.futures.Future``; a worker pulls flushed batches with
:meth:`~DynamicBatcher.next_batch` and resolves the futures.  A batch
flushes when the queued image count reaches ``max_batch`` or the oldest
item has waited ``max_wait_ms``, whichever comes first.  When the queue
already holds ``max_queue`` images, ``submit`` raises :class:`Overloaded`
at once (the server answers 503) instead of queueing without bound.

With a ``tracer`` (:mod:`glom_tpu_torch.obs.tracing`), an item submitted
with a span context opens a ``queue_wait`` span under the request's trace,
closed when its batch is taken; the take opens one ``batch`` span (its own
trace, linking every member) that the engine closes after the execute.
:class:`BatcherStats` counts submissions, sheds and flushes by rule; the
engine folds the sheds into its registry.

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
    ctx: Any = None          # the request's span context (root span)
    queue_span: Any = None   # open queue_wait span, closed at batch take
    batch_span: Any = None   # the batch-level span this item flushed into


class BatcherStats:
    """Host-side counters the engine mirrors into its metric registry."""

    def __init__(self):
        self.submitted = 0       # accepted submissions (items, not images)
        self.shed = 0            # rejected-at-capacity submissions
        self.flush_full = 0      # batches flushed by the size rule
        self.flush_deadline = 0  # batches flushed by the deadline rule
        self.flush_drain = 0     # batches flushed by shutdown drain


class DynamicBatcher:
    """Bounded queue plus the two flush rules.  ``max_batch`` and
    ``max_queue`` count IMAGES; an item larger than ``max_batch`` could
    never flush and is refused at submit with ``ValueError``."""

    def __init__(self, *, max_batch: int = 8, max_wait_ms: float = 5.0,
                 max_queue: int = 64, clock=None, tracer=None):
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
        self._tracer = tracer
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._queued = 0
        self._closed = False
        self._draining = False
        self.stats = BatcherStats()

    @property
    def depth(self) -> int:
        """Queued image count."""
        with self._cond:
            return self._queued

    def submit(self, payload: Any, size: int = 1, *, ctx=None) -> Future:
        """Enqueue ``payload`` (``size`` images); returns the Future the
        worker resolves.  Raises :class:`Overloaded` at capacity or
        :class:`Closed` after shutdown began.  ``ctx`` (a span context)
        opens a ``queue_wait`` span under the request's trace."""
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
                self.stats.shed += 1
                raise Overloaded(
                    f"queue at capacity ({self._queued}/{self.max_queue} "
                    f"images); request shed"
                )
            item = _Item(payload=payload, size=size, enqueued_at=self._clock(), ctx=ctx)
            if self._tracer is not None and ctx is not None:
                from glom_tpu_torch.obs.tracing import SPAN_QUEUE_WAIT

                item.queue_span = self._tracer.start_span(
                    SPAN_QUEUE_WAIT, ctx, attrs={"images": size})
            self._queue.append(item)
            self._queued += size
            self.stats.submitted += 1
            self._cond.notify_all()
            return item.future

    def _flush_reason(self, now: float) -> Optional[str]:
        """Why the head of the queue flushes now (a full batch, a drain, or
        the oldest item's deadline), or None.  Caller holds the lock."""
        if not self._queue:
            return None
        if self._queued >= self.max_batch:
            return "full"
        if self._draining:
            return "drain"
        if now - self._queue[0].enqueued_at >= self.max_wait_s:
            return "deadline"
        return None

    def _take_batch(self, reason: str) -> List[_Item]:
        """Pop items from the head until the next would overflow
        ``max_batch``.  Caller holds the lock."""
        batch: List[_Item] = []
        total = 0
        while self._queue and total + self._queue[0].size <= self.max_batch:
            item = self._queue.popleft()
            total += item.size
            batch.append(item)
        self._queued -= total
        counter = "flush_" + reason
        setattr(self.stats, counter, getattr(self.stats, counter) + 1)
        if self._tracer is not None and any(it.queue_span is not None for it in batch):
            from glom_tpu_torch.obs.tracing import SPAN_BATCH

            batch_span = self._tracer.start_trace(SPAN_BATCH, attrs={
                "flush_reason": reason, "items": len(batch), "images": total,
                "links": [f"{it.ctx.trace_id}:{it.ctx.span_id}"
                          for it in batch if it.ctx is not None],
            })
            for it in batch:
                it.batch_span = batch_span
                if it.queue_span is not None:
                    self._tracer.end(it.queue_span, attrs={"flush_reason": reason})
        return batch

    def next_batch(self, *, block: bool = True,
                   timeout: Optional[float] = None) -> Optional[List[_Item]]:
        """A non-empty list of items when a flush rule fired, else None.
        ``block=True`` waits until a rule fires, the closed queue runs dry
        (returns None: the worker exits) or ``timeout`` elapses."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while True:
                reason = self._flush_reason(self._clock())
                if reason is not None:
                    return self._take_batch(reason)
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
