"""Shape-bucketed padded batching with one CUDA graph per bucket: the port's
counterpart of ``glom_tpu/serving/compile_cache.py``.

``glom_tpu`` wins serving latency by never compiling on the request path:
every bucket is AOT-compiled at start-up.  On the card the cost to remove is
the host's: an eager forward calls a Python kernel wrapper 36 times on the
``"pallas"`` path (50-90 us of host time each), as long as the device's own
work at b=1.  The contract here:

  * a fixed set of batch-size **buckets**; every batch is zero-**padded up**
    to the nearest bucket and the output **sliced back** (GLOM's forward has
    no cross-batch reduction, so padding rows never touch real ones);
  * on a CUDA device, :meth:`BucketedGraphCache.warmup` builds each bucket's
    static input on the card, runs the forward once eagerly (every lazy
    initialisation happens outside capture), and captures one
    ``torch.cuda.CUDAGraph`` of the whole forward;
  * the request path copies the padded batch into the static input,
    replays, and copies the sliced static output to the host before the next
    replay may overwrite it.  A capture that fails raises: nothing on the
    card quietly serves eagerly;
  * a bucket that was not warmed (an engine built with ``warmup=False``) is
    captured on the request path and counted: :meth:`poll_captures` is the
    counterpart of ``poll_compiles``, and the engine exports it as
    ``serving_graph_captures``, which must stay 0 after warm-up;
  * on the CPU the same class runs the forward eagerly with the same
    bookkeeping (a bucket's first use without warm-up counts as a capture).

A graph holds the addresses of the tensors it was captured with, the
parameters among them, so a cache is bound to one parameter tree: a reload
builds a new cache against the new tree.  All graphs of one cache share one
memory pool, so one cache's replays run one at a time; two caches (the two
endpoints, or the sets before and after a reload) have pools of their own
and replay concurrently.  A capture must see no other CUDA work in the
process, so captures and replays share a :class:`DeviceLock`: replays hold
it shared, a capture holds it alone.

A graph's kernel launches are recorded at capture
(``kernels/_common.py::recording_launches``) and added to the wrappers'
launch counts at every replay.
"""

from __future__ import annotations

import bisect
import threading
from contextlib import contextmanager
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from glom_tpu_torch.kernels import _common


def pick_bucket(buckets: Sequence[int], n: int) -> Optional[int]:
    """Smallest bucket >= ``n``, or None when ``n`` exceeds every bucket
    (``buckets`` must be sorted ascending)."""
    if n < 1:
        raise ValueError(f"batch size must be >= 1, got {n}")
    i = bisect.bisect_left(buckets, n)
    return buckets[i] if i < len(buckets) else None


def pad_to_bucket(imgs: np.ndarray, bucket: int) -> np.ndarray:
    """Zero-pad the batch axis up to ``bucket`` (``imgs`` itself when it is
    already there)."""
    imgs = np.asarray(imgs)
    b = imgs.shape[0]
    if b > bucket:
        raise ValueError(f"batch {b} exceeds bucket {bucket}")
    if b == bucket:
        return imgs
    return np.concatenate([imgs, np.zeros((bucket - b,) + imgs.shape[1:], imgs.dtype)])


class DeviceLock:
    """Shared/exclusive lock over the card: replays take it shared, a capture
    alone.  A waiting capture stops new replays from entering, so it waits
    for at most the replays already running."""

    def __init__(self):
        self._cond = threading.Condition()
        self._shared = 0
        self._exclusive = False
        self._waiting = 0

    @contextmanager
    def shared(self):
        with self._cond:
            self._cond.wait_for(lambda: not self._exclusive and not self._waiting)
            self._shared += 1
        try:
            yield
        finally:
            with self._cond:
                self._shared -= 1
                self._cond.notify_all()

    @contextmanager
    def exclusive(self):
        with self._cond:
            self._waiting += 1
            self._cond.wait_for(lambda: not self._exclusive and self._shared == 0)
            self._waiting -= 1
            self._exclusive = True
        try:
            yield
        finally:
            with self._cond:
                self._exclusive = False
                self._cond.notify_all()


_SIDE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _side_stream(device) -> "torch.cuda.Stream":
    """The one stream per device that runs the eager pass before a capture.
    cuBLAS keeps a workspace for every stream it has run on, for the life of
    the process, so a new stream per capture would leave one behind at every
    capture of every reload."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = torch.cuda.Stream(index)
    return _SIDE_STREAMS[index]


class _Graph:
    """One bucket's captured forward: the graph, its static input and
    output, and the launches one replay makes."""

    __slots__ = ("graph", "static_in", "static_out", "launches")

    def __init__(self, graph, static_in, static_out, launches):
        self.graph, self.static_in, self.static_out = graph, static_in, static_out
        self.launches = launches


class BucketedGraphCache:
    """One forward ``fn(params, x) -> y`` served per batch bucket.

    ``x`` is a float32 ``(bucket,) + input_shape`` tensor on ``device`` and
    ``y`` a tensor whose first axis is the batch; ``fn`` runs under
    ``torch.inference_mode()``.  ``lock`` is the process's
    :class:`DeviceLock` (one is made when none is given)."""

    def __init__(self, fn: Callable, buckets: Sequence[int], *, input_shape: Tuple[int, ...],
                 device, name: str = "forward", lock: Optional[DeviceLock] = None,
                 iters: Optional[int] = None):
        buckets = sorted(set(int(b) for b in buckets))
        if not buckets:
            raise ValueError("need at least one bucket size")
        if buckets[0] < 1:
            raise ValueError(f"bucket sizes must be >= 1, got {buckets[0]}")
        self.fn = fn
        self.name = name
        self.buckets: Tuple[int, ...] = tuple(buckets)
        self.input_shape = tuple(int(s) for s in input_shape)
        self.device = torch.device(device)
        self.graphed = self.device.type == "cuda"
        self.iters = None if iters is None else int(iters)
        self._lock = lock if lock is not None else DeviceLock()
        self._replay = threading.Lock()       # one replay at a time on this cache's pool
        self._params = None                   # the tree the graphs were captured with
        self._graphs: Dict[int, _Graph] = {}
        self._ready: set = set()              # buckets prepared (captured, or first used on the CPU)
        self._pool = None
        self._new_captures = 0
        self.warmup_seconds: Optional[float] = None
        self.warmed = False

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def pick(self, n: int) -> Optional[int]:
        return pick_bucket(self.buckets, n)

    # -- capture -----------------------------------------------------------
    def _bind(self, params) -> None:
        if self._params is None:
            self._params = params
        elif params is not self._params and self.graphed:
            raise ValueError(
                f"cache {self.name!r}: its graphs were captured with another parameter "
                f"tree; build a new cache for new parameters")

    def _capture(self, bucket: int) -> bool:
        """Capture ``bucket``'s forward (on the CPU: mark it prepared).
        Returns whether this call prepared it; raises when the capture
        fails."""
        if bucket in self._ready:
            return False
        if not self.graphed:
            with self._replay:
                fresh = bucket not in self._ready
                self._ready.add(bucket)
            return fresh
        with self._lock.exclusive():
            if bucket in self._ready:
                return False
            params, dev = self._params, self.device
            with torch.cuda.device(dev), torch.inference_mode():
                static_in = torch.zeros((bucket,) + self.input_shape, dtype=torch.float32,
                                        device=dev)
                # eagerly once, on a side stream: kernel builds, planner
                # caches, cuBLAS handles and cached constants are made here
                side = _side_stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    self.fn(params, static_in)
                torch.cuda.current_stream(dev).wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with _common.recording_launches() as launches:
                    with torch.cuda.graph(graph, pool=self._pool):
                        static_out = self.fn(params, static_in)
                if self._pool is None:
                    self._pool = graph.pool()
            self._graphs[bucket] = _Graph(graph, static_in, static_out, dict(launches))
            self._ready.add(bucket)
        return True

    def warmup(self, params) -> None:
        """Capture every bucket against ``params`` (on the CPU: mark each
        prepared).  Idempotent per bucket; records ``warmup_seconds``."""
        import time

        self._bind(params)
        t0 = time.perf_counter()
        for bucket in self.buckets:
            self._capture(bucket)
        if self.graphed:
            torch.cuda.synchronize(self.device)
        self.warmup_seconds = time.perf_counter() - t0
        self.warmed = True

    # -- request path ------------------------------------------------------
    def _bucket_of(self, b: int) -> int:
        bucket = self.pick(b)
        if bucket is None:
            raise ValueError(f"batch of {b} exceeds the largest bucket {self.max_bucket}")
        return bucket

    def _eager(self, params, imgs: np.ndarray, bucket: int) -> np.ndarray:
        b = imgs.shape[0]
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(pad_to_bucket(imgs, bucket),
                                                      dtype=np.float32)).to(self.device)
            return self.fn(params, x)[:b].cpu().numpy()

    def eager(self, params, imgs: np.ndarray) -> np.ndarray:
        """The forward run eagerly at the bucket's shape, padded as the
        request path pads: what a replay must equal bit for bit."""
        bucket = self._bucket_of(imgs.shape[0])
        with self._lock.shared():
            return self._eager(params, imgs, bucket)

    def __call__(self, params, imgs: np.ndarray, *, tracer=None, contexts: Sequence = ()):
        """Pad ``imgs`` to its bucket, replay (on the CPU: run eagerly), and
        return the output's first ``len(imgs)`` rows as a host array.

        With a ``tracer``, records ``bucket_select`` / ``pad`` / ``execute``
        spans under every context in ``contexts`` (the batch span first, then
        each member request; only the first feeds the duration histograms),
        as ``glom_tpu``'s cache does.  ``execute`` ends once the output is on
        the host."""
        b = imgs.shape[0]
        self._bind(params)
        clock = tracer.clock if tracer is not None and contexts else None
        t0 = clock() if clock else 0.0
        bucket = self._bucket_of(b)
        prepared = bucket in self._ready
        if not prepared and self._capture(bucket):
            with self._replay:
                self._new_captures += 1
        if not self.graphed:
            t_pad = clock() if clock else 0.0
            out = self._eager(params, imgs, bucket)
        else:
            entry = self._graphs[bucket]
            with self._lock.shared(), self._replay, torch.inference_mode():
                entry.static_in[:b].copy_(torch.from_numpy(np.ascontiguousarray(imgs, np.float32)))
                if b < bucket:
                    entry.static_in[b:].zero_()
                t_pad = clock() if clock else 0.0
                entry.graph.replay()
                _common.add_replayed(entry.launches)
                out = entry.static_out[:b].cpu().numpy()
        if clock:
            t_done = clock()
            attrs = {"images": b, "bucket": bucket, "graph": self.graphed,
                     "prepared": prepared, "endpoint": self.name,
                     "padding_waste": round((bucket - b) / bucket, 4)}
            if self.iters is not None:
                attrs["iters"] = self.iters
            from glom_tpu_torch.obs.tracing import SPAN_BUCKET_SELECT, SPAN_EXECUTE, SPAN_PAD

            for i, ctx in enumerate(contexts):
                observe = i == 0
                tracer.record(SPAN_BUCKET_SELECT, ctx, t0, t0,
                              attrs={"bucket": bucket, "prepared": prepared}, observe=observe)
                tracer.record(SPAN_PAD, ctx, t0, t_pad, attrs=dict(attrs), observe=observe)
                tracer.record(SPAN_EXECUTE, ctx, t_pad, t_done, attrs=dict(attrs),
                              observe=observe)
        return out

    def poll_captures(self) -> int:
        """Captures made on the request path since the last poll: nonzero
        after warm-up means a bucket was not prepared at start-up."""
        with self._replay:
            n, self._new_captures = self._new_captures, 0
        return n

    # -- what the graphs cost ----------------------------------------------
    def launches_per_replay(self) -> Dict[int, Dict[str, int]]:
        """``{bucket: {wrapper name: launches}}`` one replay makes."""
        return {b: {fn.__name__: n for fn, n in g.launches.items()}
                for b, g in sorted(self._graphs.items())}

    def pool_bytes(self) -> Optional[int]:
        """Bytes the card has reserved for this cache's graph pool (None on
        the CPU, or before a capture)."""
        if self._pool is None:
            return None
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)
