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
it shared, a capture holds it alone, and a request prepares every graph it
will replay before it takes its hold.

:func:`captures_made` counts every key prepared in the process (a graph
captured on the card, a key first marked on the CPU), so a caller can show
that a path captured nothing; :attr:`DeviceLock.longest_exclusive_s` is the
longest a capture has kept replays out.

A graph's kernel launches are recorded at capture
(``kernels/_common.py::recording_launches``) and added to the wrappers'
launch counts at every replay.  The capture also records the key's
snapshot (``snapshots``, by bucket; :func:`glom_tpu_torch.profiling.
graph_snapshot`): those launches, the analytic cost the cache's
``cost_fn`` gives for the bucket, the pool's and the parameters' bytes,
and ``glom_tpu``'s labels ``quant``, ``stateful`` and ``iters``.  It is
the port's counterpart of ``glom_tpu``'s per-bucket compile snapshot, read
by warm-up bundles, forensics and the attribution plane's op-diff, and
reading it runs nothing on the card.

Stateful (session) families, ``glom_tpu``'s ``carries_state`` /
``takes_state``: a cache may take the carried ``(bucket, n, L, d)`` state as
a second static input and return the new state as a second output.  A
graph's outputs are static buffers the next replay of its bucket
overwrites, whoever triggers it, so the new state is copied into a tensor
the caller owns before the cache's lock is released.  :class:`PostPassCache`
is ``/parse``: another cache's forward followed by a post-pass captured as
a graph of its own, which copies the inner output into its static input
under the inner cache's lock.

On a mesh of ranks (``serving/sharded.py``) a cache is one rank's: given a
``shard``, a call pads the batch to its bucket, announces it to the other
ranks (the leader's header), runs this rank's rows of the bucket (its
graphs are captured at that many rows) and gathers every data rank's rows
of the output back.  ``eager_reason`` (a forward with collectives inside
it) keeps the cache eager on a card too; its snapshots carry ``mesh``,
``graphs`` and the reason.
"""

from __future__ import annotations

import bisect
import gc
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from glom_tpu_torch import profiling
from glom_tpu_torch.kernels import _common
from glom_tpu_torch.parallel.inference import pad_batch


def pick_bucket(buckets: Sequence[int], n: int) -> Optional[int]:
    """Smallest bucket >= ``n``, or None when ``n`` exceeds every bucket
    (``buckets`` must be sorted ascending)."""
    if n < 1:
        raise ValueError(f"batch size must be >= 1, got {n}")
    i = bisect.bisect_left(buckets, n)
    return buckets[i] if i < len(buckets) else None


def pad_to_bucket(imgs: np.ndarray, bucket: int) -> np.ndarray:
    """Zero-pad the batch axis up to ``bucket`` (``imgs`` itself when it is
    already there): the one padding rule, shared with the data-parallel
    forward (``parallel/inference.py::pad_batch``)."""
    imgs = np.asarray(imgs)
    b = imgs.shape[0]
    if b > bucket:
        raise ValueError(f"batch {b} exceeds bucket {bucket}")
    return pad_batch(imgs, bucket)


_PREPARED = [0]                       # keys prepared in this process
_PREPARED_LOCK = threading.Lock()


def captures_made() -> int:
    """Keys prepared in this process so far: graphs captured on a card (a
    bucket of a family, a pack at one state dtype), keys first marked on the
    CPU."""
    with _PREPARED_LOCK:
        return _PREPARED[0]


class DeviceLock:
    """Shared/exclusive lock over the card: replays take it shared, a capture
    alone.  A waiting capture stops new replays from entering, so it waits
    for at most the replays already running; the replays waiting when a
    capture ends enter before the next capture, so a run of captures (a
    deploy candidate's set, one bucket a hold) lets live traffic through
    between them.  Not reentrant: a thread that holds it shared must neither
    take it again nor capture, so every cache prepares its graph before it
    takes its hold.  ``longest_exclusive_s`` is the longest exclusive hold
    so far (a caller may reset it to 0)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._shared = 0
        self._exclusive = False
        self._waiting = 0
        self._shared_waiting = 0
        self._admit = 0        # replays let in ahead of the next capture
        self.longest_exclusive_s = 0.0

    @contextmanager
    def shared(self):
        with self._cond:
            self._shared_waiting += 1
            self._cond.wait_for(
                lambda: not self._exclusive and (not self._waiting or self._admit > 0))
            self._shared_waiting -= 1
            self._admit = max(0, self._admit - 1)
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
            self._cond.wait_for(
                lambda: not self._exclusive and self._shared == 0 and not self._admit)
            self._waiting -= 1
            self._exclusive = True
        t0 = time.perf_counter()
        try:
            yield
        finally:
            with self._cond:
                self.longest_exclusive_s = max(self.longest_exclusive_s,
                                               time.perf_counter() - t0)
                self._exclusive = False
                self._admit = self._shared_waiting
                self._cond.notify_all()


def _count_prepared() -> None:
    with _PREPARED_LOCK:
        _PREPARED[0] += 1


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


def _capture_graph(fn, args, device, pool):
    """``fn(*args)`` run once eagerly on the side stream (kernel builds,
    planner caches, cuBLAS handles and cached constants are made there),
    then captured: ``(graph, outputs, launches)``.  The caller holds the
    device lock alone.

    Destroying a graph while another is being captured invalidates the
    capture (CUDA error 901) when the capture forbids such calls process-wide.
    A set's graphs can be freed on any thread: by a reference count that
    drops (a rollback or a reload commit releasing a retired set) or by a
    cyclic collection (a dropped engine).  So the capture forbids unsafe calls
    on its own thread only (``capture_error_mode="thread_local"``; the device
    lock keeps every other replay and capture out), and Python's cyclic
    collection, which may run on the capturing thread itself, is off during
    it."""
    side = _side_stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with _common.recording_launches() as launches:
            with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                outputs = fn(*args)
    finally:
        if collecting:
            gc.enable()
    return graph, outputs, dict(launches)


def _by_name(launches: Dict) -> Dict[str, int]:
    """A capture's record, ``{wrapper: launches}``, keyed by wrapper name."""
    return {fn.__name__: n for fn, n in launches.items()}


def _pool_bytes(pool) -> Optional[int]:
    if pool is None:
        return None
    pool = tuple(pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


class _Graph:
    """One key's captured graph: its static inputs (the images, or the state
    a post-pass reads, and, for a cache that takes state, the carried state)
    and outputs (the answer and, for one that carries state, the new state),
    and the launches one replay makes."""

    __slots__ = ("graph", "static_in", "static_state", "static_out", "static_new", "launches")

    def __init__(self, graph, static_in, static_state, static_out, static_new, launches):
        self.graph, self.static_in, self.static_state = graph, static_in, static_state
        self.static_out, self.static_new = static_out, static_new
        self.launches = launches

    def replay(self) -> None:
        self.graph.replay()
        _common.add_replayed(self.launches)


class _GraphFamily:
    """What every graph cache keeps: one graph per key, captured in one
    memory pool whose replays run one at a time; the keys prepared; the
    captures made on the request path; the warm-up's time.  A subclass says
    what a key captures (:meth:`_capture_call`) and how the captured
    outputs split (:meth:`_split`)."""

    def __init__(self, buckets: Sequence[int], *, device, name: str,
                 lock: Optional[DeviceLock], quant: Optional[str] = None,
                 cost_fn: Optional[Callable[[int], Dict[str, float]]] = None,
                 mesh_axes: Optional[Dict[str, int]] = None, eager_reason: Optional[str] = None):
        self.name = name
        self.quant = quant
        self._cost_fn = cost_fn
        self.snapshots: Dict[int, Dict] = {}   # by bucket: what its graph launches and costs
        self.buckets: Tuple[int, ...] = tuple(buckets)
        self.device = torch.device(device)
        self.mesh_axes = dict(mesh_axes) if mesh_axes else None
        self.eager_reason = eager_reason
        self.graphed = self.device.type == "cuda" and eager_reason is None
        self._lock = lock if lock is not None else DeviceLock()
        self._replay = threading.Lock()       # one replay at a time on this family's pool
        self._graphs: Dict = {}
        self._ready: set = set()              # keys prepared (captured, or first used on the CPU)
        self._pool = None
        self._new_captures = 0
        self.warmup_seconds: Optional[float] = None
        self.warmed = False

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def pick(self, n: int) -> Optional[int]:
        return pick_bucket(self.buckets, n)

    def bucket_of(self, b: int, what: str = "batch of") -> int:
        """The bucket a batch of ``b`` pads to; ``ValueError`` past the
        largest."""
        bucket = self.pick(b)
        if bucket is None:
            raise ValueError(f"{what} {b} exceeds the largest bucket {self.max_bucket}")
        return bucket

    # -- capture -----------------------------------------------------------
    def _capture_call(self, key):
        """``(fn, args, static_in, static_state)``: ``fn(*args)`` is what
        ``key`` captures, its static inputs made on the card."""
        raise NotImplementedError

    def _split(self, out):
        """The captured outputs as ``(answer, new state or None)``."""
        return out, None

    def _capture(self, key) -> bool:
        """Capture ``key`` (on the CPU: mark it prepared).  Returns whether
        this call prepared it; raises when the capture fails.  The caller
        holds no hold on the device lock."""
        if key in self._ready:
            return False
        if not self.graphed:
            with self._replay:
                fresh = key not in self._ready
                self._ready.add(key)
            if fresh:
                self._record_snapshot(key, {})
                _count_prepared()
            return fresh
        with self._lock.exclusive():
            if key in self._ready:
                return False
            dev = self.device
            with torch.cuda.device(dev), torch.inference_mode():
                fn, args, static_in, static_state = self._capture_call(key)
                graph, out, launches = _capture_graph(fn, args, dev, self._pool)
                if self._pool is None:
                    self._pool = graph.pool()
            out, static_new = self._split(out)
            self._graphs[key] = _Graph(graph, static_in, static_state, out, static_new,
                                       launches)
            self._ready.add(key)
            self._record_snapshot(key, launches)
        _count_prepared()
        return True

    # -- snapshots -----------------------------------------------------------
    def _bucket(self, key) -> int:
        return int(key)

    def _param_tree(self):
        return None

    def _snapshot_labels(self) -> Dict:
        return {"quant": self.quant}

    def _record_snapshot(self, key, launches) -> None:
        """``key``'s snapshot from its capture's record (the first key of a
        bucket keeps it)."""
        bucket = self._bucket(key)
        if bucket in self.snapshots:
            return
        cost = self._cost_fn(bucket) if self._cost_fn is not None else {}
        snap = profiling.graph_snapshot(
            _by_name(launches), cost=cost,
            pool_bytes=_pool_bytes(self._pool) if self.graphed else None,
            param_bytes=profiling.tree_nbytes(self._param_tree()), device=self.device)
        snap.update(self._snapshot_labels())
        if self.mesh_axes:
            snap.update(mesh=dict(self.mesh_axes), graphs=self.graphed)
            if self.eager_reason is not None:
                snap["eager_reason"] = self.eager_reason
        self.snapshots[bucket] = snap

    def _prepare(self, key) -> bool:
        """Whether ``key`` was prepared before this call; a key that was not
        is captured now and counted."""
        prepared = key in self._ready
        if not prepared and self._capture(key):
            with self._replay:
                self._new_captures += 1
        return prepared

    def _warm(self, keys) -> None:
        """Capture every key (idempotent) and record ``warmup_seconds``."""
        t0 = time.perf_counter()
        for key in keys:
            self._capture(key)
        if self.graphed:
            torch.cuda.synchronize(self.device)
        self.warmup_seconds = time.perf_counter() - t0
        self.warmed = True

    @contextmanager
    def _holding(self, key):
        """``key``'s graph, with this family's pool held: its outputs stay
        this caller's until the block ends.  The caller holds the device
        lock shared."""
        entry = self._graphs[key]
        with self._replay, torch.inference_mode():
            yield entry

    def poll_captures(self) -> int:
        """Captures made on the request path since the last poll: nonzero
        after warm-up means a key was not prepared at start-up."""
        with self._replay:
            n, self._new_captures = self._new_captures, 0
        return n

    # -- what the graphs cost ----------------------------------------------
    def _label(self, key):
        return key

    def launches_per_replay(self) -> Dict:
        """``{key: {wrapper name: launches}}`` one replay makes."""
        return {self._label(k): _by_name(g.launches) for k, g in sorted(self._graphs.items())}

    def pool_bytes(self) -> Optional[int]:
        """Bytes the card has reserved for this family's graph pool (None on
        the CPU, or before a capture)."""
        return _pool_bytes(self._pool)


class BucketedGraphCache(_GraphFamily):
    """One forward served per batch bucket (a graph's key is its bucket).

    ``fn(params, x)`` (or ``fn(params, x, state)`` with ``takes_state``)
    takes a float32 ``(bucket,) + input_shape`` tensor on ``device`` and
    returns a tensor whose first axis is the batch, or, with
    ``carries_state``, ``(y, new_state)``: ``y`` is sliced back to the real
    batch, the new state stays bucket-shaped (the next frame's input) and is
    handed back as a fresh tensor the caller owns, copied out of the graph's
    static output before the next replay may overwrite it.  A ``takes_state``
    cache needs ``state_shape`` (the state's shape after the batch axis) and
    ``state_dtype``.  ``fn`` runs under ``torch.inference_mode()``.
    ``lock`` is the process's :class:`DeviceLock` (one is made when none is
    given).  ``shard`` (``serving/sharded.py::SetShard``) makes it one
    rank's cache of a mesh engine; a stateful cache takes none."""

    def __init__(self, fn: Callable, buckets: Sequence[int], *, input_shape: Tuple[int, ...],
                 device, name: str = "forward", lock: Optional[DeviceLock] = None,
                 iters: Optional[int] = None, carries_state: bool = False,
                 takes_state: bool = False, state_shape: Optional[Tuple[int, ...]] = None,
                 state_dtype=None, quant: Optional[str] = None,
                 cost_fn: Optional[Callable[[int], Dict[str, float]]] = None,
                 shard=None, mesh_axes: Optional[Dict[str, int]] = None,
                 eager_reason: Optional[str] = None):
        buckets = sorted(set(int(b) for b in buckets))
        if not buckets:
            raise ValueError("need at least one bucket size")
        if buckets[0] < 1:
            raise ValueError(f"bucket sizes must be >= 1, got {buckets[0]}")
        if takes_state and not carries_state:
            raise ValueError("takes_state requires carries_state (a warm step returns the "
                             "next state)")
        if takes_state and (state_shape is None or state_dtype is None):
            raise ValueError("takes_state needs state_shape and state_dtype")
        if shard is not None and carries_state:
            raise ValueError("a stateful cache runs on one rank")
        super().__init__(buckets, device=device, name=name, lock=lock, quant=quant,
                         cost_fn=cost_fn, mesh_axes=mesh_axes, eager_reason=eager_reason)
        self.shard = shard
        self.fn = fn
        self.input_shape = tuple(int(s) for s in input_shape)
        self.iters = None if iters is None else int(iters)
        self.carries_state = bool(carries_state)
        self.takes_state = bool(takes_state)
        self.state_shape = None if state_shape is None else tuple(int(s) for s in state_shape)
        self.state_dtype = state_dtype
        self._params = None                   # the tree the graphs were captured with

    # -- capture -----------------------------------------------------------
    def _bind(self, params) -> None:
        if self._params is None:
            self._params = params
        elif params is not self._params and self.graphed:
            raise ValueError(
                f"cache {self.name!r}: its graphs were captured with another parameter "
                f"tree; build a new cache for new parameters")

    def _param_tree(self):
        return self._params

    def _snapshot_labels(self) -> Dict:
        labels = {"quant": self.quant}
        if self.carries_state:
            labels["stateful"] = self.takes_state
        if self.iters is not None:
            labels["iters"] = self.iters
        return labels

    def _rows(self, bucket: int) -> int:
        """The rows of a bucket this rank computes: all of them on one rank."""
        return bucket if self.shard is None else self.shard.local_rows(bucket)

    def _capture_call(self, bucket: int):
        static_in = torch.zeros((self._rows(bucket),) + self.input_shape, dtype=torch.float32,
                                device=self.device)
        args = (self._params, static_in)
        static_state = None
        if self.takes_state:
            static_state = torch.zeros((bucket,) + self.state_shape, dtype=self.state_dtype,
                                       device=self.device)
            args += (static_state,)
        return self.fn, args, static_in, static_state

    def _split(self, out):
        return out if self.carries_state else (out, None)

    def warmup(self, params) -> None:
        """Capture every bucket against ``params`` (on the CPU: mark each
        prepared).  Idempotent per bucket; records ``warmup_seconds``."""
        self._bind(params)
        self._warm(self.buckets)

    # -- request path ------------------------------------------------------
    def _check_state(self, state, bucket: int) -> None:
        if not self.takes_state:
            return
        want = (bucket,) + self.state_shape
        if state is None or tuple(state.shape) != want:
            raise ValueError(f"cache {self.name!r} takes a carried state of shape {want}, got "
                             f"{None if state is None else tuple(state.shape)}")

    def _to_host(self, out, new, b: int):
        """The default take: the answer's first ``b`` rows on the host, and
        (with ``carries_state``) the new state copied into a tensor the
        caller owns."""
        owned = None if new is None else new.clone()
        host = out[:b].cpu().numpy()
        return host if not self.carries_state else (host, owned)

    def _run_eager(self, params, imgs: np.ndarray, rows: int, state, take):
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(pad_to_bucket(imgs, rows),
                                                      dtype=np.float32)).to(self.device)
            args = (params, x) + ((state,) if self.takes_state else ())
            out = self.fn(*args)
            new = None
            if self.carries_state:
                out, new = out
            return take(out, new, imgs.shape[0])

    def _execute(self, params, imgs: np.ndarray, bucket: int, state, take, clock=None):
        """Replay ``bucket`` (on the CPU: run eagerly) and return ``(take(out,
        new_state, b), t_pad)``: ``take`` sees the outputs while this cache
        still holds its pool and the device lock shared, so it may read them
        on the card, and replay another family's graph that is prepared."""
        b = imgs.shape[0]
        if not self.graphed:
            t_pad = clock() if clock else 0.0
            return self._run_eager(params, imgs, self._rows(bucket), state, take), t_pad
        with self._lock.shared(), self._holding(bucket) as entry:
            entry.static_in[:b].copy_(torch.from_numpy(np.ascontiguousarray(imgs, np.float32)))
            if b < bucket:
                entry.static_in[b:].zero_()
            if self.takes_state:
                entry.static_state.copy_(state)
            t_pad = clock() if clock else 0.0
            entry.replay()
            return take(entry.static_out, entry.static_new, b), t_pad

    def eager(self, params, imgs: np.ndarray, *, state=None):
        """The forward run eagerly at the bucket's shape, padded as the
        request path pads: what a replay must equal bit for bit."""
        bucket = self.bucket_of(imgs.shape[0])
        self._check_state(state, bucket)

        def run(x):
            with self._lock.shared():
                return self._run_eager(params, x, self._rows(bucket), state, self._to_host), 0.0

        return self._dispatched(self.name, imgs, bucket, run, eager=True)[0]

    def _dispatched(self, family: str, imgs: np.ndarray, bucket: int, execute, *,
                    eager: bool = False):
        """``execute(imgs)`` on one rank.  On a mesh: announced to the other
        ranks first, ``execute`` on this rank's rows of the batch padded to
        ``bucket``, then every data rank's rows gathered and the first
        ``len(imgs)`` kept.  Returns ``execute``'s ``(output, t_pad)``."""
        if self.shard is None:
            return execute(imgs)
        with self.shard.announce(family, imgs, eager):
            out, t_pad = execute(pad_to_bucket(imgs, bucket)[self.shard.rows(bucket)])
            return self.shard.gather(out)[:imgs.shape[0]], t_pad

    def __call__(self, params, imgs: np.ndarray, *, state=None, tracer=None,
                 contexts: Sequence = ()):
        """Pad ``imgs`` to its bucket, replay (on the CPU: run eagerly), and
        return the answer's first ``len(imgs)`` rows as a host array (with
        ``carries_state``: ``(rows, new_state)``, the state on the card).

        With a ``tracer``, records ``bucket_select`` / ``pad`` / ``execute``
        spans under every context in ``contexts`` (the batch span first, then
        each member request; only the first feeds the duration histograms),
        as ``glom_tpu``'s cache does.  ``execute`` ends once the output is on
        the host."""
        return self._serve(params, imgs, state, self._to_host, tracer, contexts)

    def _serve(self, params, imgs: np.ndarray, state, take, tracer, contexts,
               family: Optional[str] = None):
        """Prepare the bucket (a capture needs the device lock alone, so it
        comes before any hold), then execute it with ``take`` (on a mesh, as
        graph family ``family``, by default this cache's name)."""
        b = imgs.shape[0]
        self._bind(params)
        clock = tracer.clock if tracer is not None and contexts else None
        t0 = clock() if clock else 0.0
        bucket = self.bucket_of(b)
        self._check_state(state, bucket)
        prepared = self._prepare(bucket)
        out, t_pad = self._dispatched(
            family or self.name, imgs, bucket,
            lambda x: self._execute(params, x, bucket, state, take, clock))
        if clock:
            t_done = clock()
            attrs = {"images": b, "bucket": bucket, "graph": self.graphed,
                     "prepared": prepared, "endpoint": self.name, "stateful": self.takes_state,
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


class PostPassCache(_GraphFamily):
    """An endpoint that is another cache's forward followed by a post-pass
    (``glom_tpu/serving/compile_cache.py::PostPassCache``).

    ``/parse`` is the case: the ``index`` cache's forward, then the
    islanding pack (``hierarchy/parse.py::make_pack_fn``).  The pack is
    captured as a graph of its own per key ``(bucket, state dtype name)``,
    in this cache's pool, so no second family of forward graphs is
    captured.  A request prepares both graphs, then replays the index graph
    and, inside the index cache's hold, copies its output into the pack's
    static input (the next index replay would overwrite it), replays the
    pack and copies the rows to the host.  :meth:`apply_post` runs the pack
    alone on a session's carried state, at that state's dtype:
    :meth:`warm_state` admits a dtype's graphs at start-up.  On the CPU both
    run eagerly with the same bookkeeping.

    Trace spans come from the inner cache, so the execute span (the pack
    inside it) carries the inner endpoint's name."""

    def __init__(self, inner: BucketedGraphCache, post_fn: Callable, *,
                 state_shape: Tuple[int, ...], name: str = "parse"):
        # the pack launches no hand kernel and its work is not the model's:
        # its snapshots carry the launches (none) and the pool, no cost
        super().__init__(inner.buckets, device=inner.device, name=name, lock=inner._lock,
                         quant=inner.quant, mesh_axes=inner.mesh_axes,
                         eager_reason=inner.eager_reason)
        self.inner = inner
        self.post_fn = post_fn
        self.iters = inner.iters
        self.state_shape = tuple(int(s) for s in state_shape)
        # the inner forward's output: the index family's float32 state
        self.state_dtype = torch.float32

    @staticmethod
    def _key(bucket: int, dtype) -> Tuple[int, str]:
        return int(bucket), str(dtype).replace("torch.", "")

    def _label(self, key) -> str:
        return "%d/%s" % key

    def _bucket(self, key) -> int:
        return int(key[0])

    def _param_tree(self):
        return self.inner._params

    def _capture_call(self, key):
        bucket, dtype = key
        static_in = torch.zeros((self.inner._rows(bucket),) + self.state_shape,
                                dtype=getattr(torch, dtype), device=self.device)
        return self.post_fn, (static_in,), static_in, None

    def warm_state(self, dtype) -> None:
        """Capture the pack for a carried state of ``dtype`` at every bucket
        (idempotent)."""
        for bucket in self.buckets:
            self._capture(self._key(bucket, dtype))

    def warmup(self, params) -> None:
        """Warm the inner cache (idempotent) and capture the pack at every
        bucket for the inner forward's float32 output (``warmup_seconds``
        times the pack's captures)."""
        if not self.inner.warmed:
            self.inner.warmup(params)
        self._warm([self._key(b, self.state_dtype) for b in self.buckets])

    def _pack(self, state: torch.Tensor, b: int, bucket: Optional[int] = None) -> np.ndarray:
        """The pack on a bucket-shaped state on the card (on a mesh, this
        rank's rows of ``bucket``): rows ``[:b]`` on the host.  The caller
        holds the device lock shared."""
        if not self.graphed:
            with torch.inference_mode():
                return self.post_fn(state)[:b].cpu().numpy()
        key = self._key(state.shape[0] if bucket is None else bucket, state.dtype)
        with self._holding(key) as entry:
            entry.static_in.copy_(state)
            entry.replay()
            return entry.static_out[:b].cpu().numpy()

    def apply_post(self, state: torch.Tensor, b: Optional[int] = None) -> np.ndarray:
        """The pack alone on an already computed, bucket-shaped state (a
        session's carried state): its rows ``[:b]`` on the host."""
        b = int(state.shape[0]) if b is None else int(b)
        self._prepare(self._key(state.shape[0], state.dtype))
        with self._lock.shared():
            return self._pack(state, b)

    def __call__(self, params, imgs: np.ndarray, *, tracer=None, contexts: Sequence = ()):
        """The inner forward on ``imgs`` padded to its bucket, then the pack:
        the rows of the first ``len(imgs)`` images on the host."""
        bucket = self.bucket_of(imgs.shape[0])
        self._prepare(self._key(bucket, self.state_dtype))
        return self.inner._serve(params, imgs, None,
                                 lambda out, _new, b: self._pack(out, b, bucket), tracer,
                                 contexts, family=self.name)

    def eager(self, params, imgs: np.ndarray) -> np.ndarray:
        """The inner forward and the pack run eagerly at the bucket's shape:
        what a replay must equal (labels, counts and sizes bit for bit; the
        means up to the order of the pack's atomic sums)."""
        bucket = self.bucket_of(imgs.shape[0])
        inner = self.inner

        def run(x):
            with self._lock.shared(), torch.inference_mode():
                return inner._run_eager(
                    params, x, inner._rows(bucket), None,
                    lambda out, _new, b: self.post_fn(out)[:b].cpu().numpy()), 0.0

        return inner._dispatched(self.name, imgs, bucket, run, eager=True)[0]

    def poll_captures(self) -> int:
        """Pack captures on the request path since the last poll, plus the
        inner cache's."""
        return super().poll_captures() + self.inner.poll_captures()
