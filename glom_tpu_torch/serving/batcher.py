"""Deadline-aware dynamic micro-batcher with admission control: the port's
own copy of ``glom_tpu/serving/batcher.py``, with its tracing hooks,
counters and tenant bulkheads.

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

**Tenant bulkheads**: :class:`TenantAdmission` holds one token bucket per
configured tenant (``rate[:burst]`` in images/s), shared by every endpoint
of an engine.  A tenant past its quota sheds with
:class:`TenantQuotaExceeded` (the server answers 503 ``tenant_overloaded``)
while other tenants' admission is untouched.

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


class TenantQuotaExceeded(Overloaded):
    """One tenant's token bucket is empty: only that tenant's request was
    shed."""

    def __init__(self, message: str, tenant: str):
        super().__init__(message)
        self.tenant = tenant


class Closed(RuntimeError):
    """Submitted after shutdown began: the request was not enqueued."""


class TokenBucket:
    """A token bucket over an injectable clock: ``rate`` tokens/s refill up
    to ``burst``; :meth:`take` consumes all it asks for or nothing.  Not
    locked: its owner (:class:`TenantAdmission`) serializes access."""

    def __init__(self, rate: float, burst: float, *, clock=None):
        if rate <= 0:
            raise ValueError(f"rate must be > 0 tokens/s, got {rate}")
        if burst < 1:
            raise ValueError(f"burst must be >= 1 token, got {burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock if clock is not None else time.monotonic
        self._tokens = self.burst  # a fresh tenant starts with its full burst
        self._last = self._clock()

    def _refill(self) -> None:
        now = self._clock()
        self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
        self._last = now

    def take(self, n: float = 1.0) -> bool:
        self._refill()
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def give(self, n: float) -> None:
        """Return ``n`` tokens, capped at the burst."""
        self._tokens = min(self.burst, self._tokens + n)

    @property
    def tokens(self) -> float:
        self._refill()
        return self._tokens


def parse_quota(spec) -> tuple:
    """``"RATE"`` or ``"RATE:BURST"`` (images/s; the burst defaults to
    ``max(rate, 1)``) -> ``(rate, burst)``; a tuple or list passes through."""
    if isinstance(spec, (tuple, list)):
        return float(spec[0]), float(spec[1])
    text = str(spec)
    if ":" in text:
        rate_s, burst_s = text.split(":", 1)
        return float(rate_s), float(burst_s)
    rate = float(text)
    return rate, max(rate, 1.0)


class TenantAdmission:
    """Per-tenant token-bucket bulkheads, shared by every endpoint of one
    engine: a quota is a promise about the tenant's load, not about one
    endpoint's.

    ``quotas`` maps a tenant to its spec (:func:`parse_quota`); a tenant
    without one is bounded only by the global ``max_queue``.  :meth:`admit`
    takes ``images`` tokens or raises :class:`TenantQuotaExceeded`; a shed
    request takes none.  Locked: handler threads race through admission."""

    def __init__(self, quotas: dict, *, clock=None):
        clock = clock if clock is not None else time.monotonic
        self._buckets = {}
        self._limits = {}
        for tenant, spec in (quotas or {}).items():
            rate, burst = parse_quota(spec)
            self._buckets[tenant] = TokenBucket(rate, burst, clock=clock)
            self._limits[tenant] = (rate, burst)
        self._lock = threading.Lock()
        self.admitted: dict = {t: 0 for t in self._buckets}
        self.shed: dict = {t: 0 for t in self._buckets}

    def admit(self, tenant: Optional[str], images: int) -> None:
        if tenant is None:
            return
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                return
            if bucket.take(images):
                self.admitted[tenant] += images
                return
            self.shed[tenant] += 1
        rate, burst = self._limits[tenant]
        raise TenantQuotaExceeded(
            f"tenant {tenant!r} over its admission quota ({rate:g} imgs/s, "
            f"burst {burst:g}); request shed", tenant)

    def refund(self, tenant: Optional[str], images: int) -> None:
        """Give back the tokens of a request rejected downstream (a global
        queue shed): the budget counts only work admitted."""
        if tenant is None:
            return
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is not None:
                bucket.give(images)
                self.admitted[tenant] = max(0, self.admitted[tenant] - images)

    def snapshot(self) -> dict:
        """Per-tenant quota state for ``/healthz``."""
        with self._lock:
            return {
                tenant: {
                    "rate": self._limits[tenant][0],
                    "burst": self._limits[tenant][1],
                    "tokens": round(self._buckets[tenant].tokens, 3),
                    "admitted_images": self.admitted[tenant],
                    "shed_requests": self.shed[tenant],
                }
                for tenant in sorted(self._buckets)
            }


@dataclass
class _Item:
    payload: Any
    size: int
    enqueued_at: float
    future: Future = field(default_factory=Future)
    ctx: Any = None          # the request's span context (root span)
    queue_span: Any = None   # open queue_wait span, closed at batch take
    batch_span: Any = None   # the batch-level span this item flushed into
    # the request's X-Tenant (the quality plane labels its signals with it)
    tenant: Optional[str] = None
    # (model, step) the item executes against; None: the default model's
    # primary.  Items of different keys share a flush and execute as
    # separate groups
    mkey: Any = None


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

    def submit(self, payload: Any, size: int = 1, *, ctx=None, tenant: Optional[str] = None,
               mkey: Any = None) -> Future:
        """Enqueue ``payload`` (``size`` images); returns the Future the
        worker resolves.  Raises :class:`Overloaded` at capacity or
        :class:`Closed` after shutdown began.  ``ctx`` (a span context)
        opens a ``queue_wait`` span under the request's trace; ``tenant``
        rides the item; ``mkey`` pins the item to a (model, step).  A
        tenant's quota is taken upstream, in the engine."""
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
            item = _Item(payload=payload, size=size, enqueued_at=self._clock(), ctx=ctx,
                         tenant=tenant, mkey=mkey)
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
