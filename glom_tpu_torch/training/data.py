"""Data pipelines, the port's copy of ``glom_tpu/training/data.py``.

The streams are ``glom_tpu``'s numpy streams: from one seed, both packages
train on the same batches, bit for bit.

  * ``synthetic`` — deterministic host-side random images; the zero-egress
    default and the bench workload.
  * ``folder`` — ``.npy``/``.npz`` image arrays from a local directory
    (e.g. a pre-exported CIFAR-10/ImageNet dump), resized by nearest
    neighbour; assembled per batch by the native core
    (``glom_tpu_torch.native``) where it builds, else by NumPy.
  * ``images`` — a JPEG/PNG folder tree through
    :class:`~glom_tpu_torch.training.image_stream.ImageFolderStream`, whose
    cursor a checkpoint carries.
  * ``elastic`` — the exactly-once elastic stream
    (:class:`ElasticBatches`): a global sample slot's content is a function
    of ``(seed, slot)``, a host takes its :func:`host_block` of each global
    batch, and the cursor (one global slot count) re-partitions across a
    change of host count; :class:`HostShardedBatches` assembles every
    host's block into the global batch, which each rank of a mesh holds.

Batches are NCHW float32 numpy arrays in [-1, 1]; the trainer moves them to
the card.  A background-thread prefetcher overlaps host batch prep with
device compute.  The stateless streams pass through :func:`fault_injected`,
the ``data`` fault-injection site, as ``glom_tpu``'s do.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time
from typing import Iterator, Optional

import numpy as np

from glom_tpu_torch.resilience import faultinject


def synthetic_batches(
    batch_size: int, image_size: int, channels: int = 3, seed: int = 0
) -> Iterator[np.ndarray]:
    """Endless deterministic stream of standard-normal images."""
    rng = np.random.default_rng(seed)
    while True:
        yield rng.standard_normal(
            (batch_size, channels, image_size, image_size), dtype=np.float32
        )


def folder_batches(
    directory: str,
    batch_size: int,
    image_size: int,
    channels: int = 3,
    seed: int = 0,
    use_native: bool = True,
) -> Iterator[np.ndarray]:
    """Stream batches from ``.npy``/``.npz`` files holding ``(N, C, H, W)`` or
    ``(N, H, W, C)`` uint8/float arrays; normalized to zero-mean/unit-ish
    range and resized by nearest-neighbor to the model's image size.

    When the native core (``glom_tpu_torch.native``) is available and the dataset
    is uint8-NHWC or float32-NCHW, batches are assembled per draw by the
    multithreaded C++ path from the raw resident buffer (no upfront
    whole-dataset conversion); otherwise the dataset is preprocessed once in
    NumPy.  Both paths produce bit-identical batches."""
    files = sorted(
        os.path.join(directory, f)
        for f in os.listdir(directory)
        if f.endswith((".npy", ".npz"))
    )
    if not files:
        raise FileNotFoundError(f"no .npy/.npz files in {directory}")
    if len(files) == 1 and files[0].endswith(".npy"):
        # single .npy: memory-map it so ImageNet-scale dumps never load into
        # RAM — both the native gather and NumPy fancy-indexing read straight
        # through the mapping (pages fault in on demand)
        data = np.load(files[0], mmap_mode="r")
        if data.ndim != 4:
            raise ValueError(f"{files[0]} must hold a 4-D array, got {data.shape}")
    else:
        arrays = []
        for f in files:
            if f.endswith(".npz"):
                with np.load(f) as z:
                    for k in z.files:
                        arr = z[k]  # decompress once
                        if arr.ndim == 4:
                            arrays.append(arr)
            else:
                arr = np.load(f)
                if arr.ndim != 4:
                    raise ValueError(f"{f} must hold a 4-D array, got {arr.shape}")
                arrays.append(arr)
        data = np.concatenate(arrays, axis=0)

    is_nhwc = data.shape[-1] in (1, 3) and data.shape[1] not in (1, 3)
    native_ok = use_native and (
        (data.dtype == np.uint8 and is_nhwc)
        or (data.dtype == np.float32 and not is_nhwc)
    )
    got_channels = data.shape[-1] if is_nhwc else data.shape[1]
    if got_channels != channels:
        raise ValueError(f"dataset has {got_channels} channels, model expects {channels}")

    rng = np.random.default_rng(seed)
    n = data.shape[0]

    if native_ok:
        from glom_tpu_torch import native

        # probe before any RNG draw so the fallback stream is identical
        if native.load() is None:
            native_ok = False

    if native_ok:
        from glom_tpu_torch import native

        data = np.ascontiguousarray(data)
        while True:
            idx = rng.integers(0, n, size=batch_size)
            yield native.assemble_batch(data, idx, image_size)

    def _process(batch: np.ndarray) -> np.ndarray:
        if is_nhwc:
            batch = batch.transpose(0, 3, 1, 2)  # NHWC -> NCHW
        if batch.dtype == np.uint8:
            batch = batch.astype(np.float32) / 127.5 - 1.0
        else:
            batch = batch.astype(np.float32)
        return _resize_nchw(batch, image_size)

    if isinstance(data, np.memmap):
        # keep the mapping lazy: gather + convert per batch, never the whole set
        while True:
            idx = rng.integers(0, n, size=batch_size)
            yield _process(np.asarray(data[idx]))

    data = _process(data)  # small in-RAM datasets: preprocess once
    while True:
        idx = rng.integers(0, n, size=batch_size)
        yield data[idx]


def _resize_nchw(data: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbor resize to size x size (no image libs in the
    zero-egress image); handles non-square inputs per axis."""
    h, w = data.shape[2], data.shape[3]
    if h != size:
        data = data[:, :, (np.arange(size) * h / size).astype(np.int64)]
    if w != size:
        data = data[:, :, :, (np.arange(size) * w / size).astype(np.int64)]
    return data


# single source of truth for the augmentation whitelist (augment_batch,
# augmented, and the --augment CLI choices all reference this)
AUGMENT_KINDS = ("none", "flip", "flip_crop")


def augment_batch(batch: np.ndarray, rng: np.random.Generator, kind: str) -> np.ndarray:
    """Host-side augmentation of an NCHW batch.

    ``"flip"``: random horizontal flip per image.
    ``"flip_crop"``: flip + random resized crop (scale 0.7-1.0, re-resized
    to the original size by nearest neighbor)."""
    if kind not in AUGMENT_KINDS:
        raise ValueError(f"unknown augmentation {kind!r}")
    if kind == "none":
        return batch
    b, c, h, w = batch.shape
    flips = rng.random(b) < 0.5
    # np.where allocates a fresh writable array, safe for in-place crops below
    out = np.where(flips[:, None, None, None], batch[:, :, :, ::-1], batch)
    if kind == "flip_crop":
        for i in range(b):
            scale = rng.uniform(0.7, 1.0)
            ch, cw = max(1, int(h * scale)), max(1, int(w * scale))
            y0 = rng.integers(0, h - ch + 1)
            x0 = rng.integers(0, w - cw + 1)
            crop = out[i, :, y0:y0 + ch, x0:x0 + cw]
            out[i] = _resize_nchw(np.ascontiguousarray(crop)[None], h)[0]
    return np.ascontiguousarray(out)


def augmented(it, kind: str, seed: int = 0):
    """Wrap a batch iterator with :func:`augment_batch` (own RNG stream).
    The kind is validated eagerly, at wrap time."""
    if kind not in AUGMENT_KINDS:
        raise ValueError(f"unknown augmentation {kind!r}")
    if kind == "none":
        return it
    rng = np.random.default_rng(seed + 0x5EED)

    def gen():
        for batch in it:
            yield augment_batch(batch, rng, kind)

    return gen()


def fault_injected(it: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
    """The ``data`` injection site (:mod:`glom_tpu_torch.resilience.faultinject`):
    an armed plan delays, drops or poisons batches, or crashes the pipeline,
    at the 1-based batch index it names.  Disarmed, one no-op call a batch."""

    def gen():
        idx = 0
        for batch in it:
            idx += 1
            kind = faultinject.fire("data", step=idx)
            if kind == "drop_batch":
                continue
            if kind == "crash":
                raise faultinject.FaultError(f"injected data-pipeline crash at batch {idx}")
            if kind == "delay":
                time.sleep(faultinject.uniform("data", 0.05, 0.25))
            elif kind == "nan_batch":
                batch = np.full_like(batch, np.nan)
            yield batch

    return gen()


class Prefetcher:
    """Bounded background-thread prefetch of host batches (the data-loader
    overlap role; the trainer moves each batch to the card).  Producer
    exceptions are captured and re-raised — original object, original
    traceback — on the consumer side as soon as the queue drains to them: a
    pipeline error must not masquerade as end-of-data.

    ``close()`` (also the context-manager exit) shuts the pipeline down
    deterministically: the worker is unblocked and joined, and an inner
    iterator exposing ``close()`` (generators; ``ImageFolderStream``'s
    decode pools) is closed too — nothing leaks until interpreter exit just
    because a consumer stopped early.  The shutdown drain is REPEATED until
    the worker exits (or a deadline passes): a single drain races a worker
    mid-``put`` that refills the just-emptied queue, leaving ``join`` to
    wait on a thread still parked against a full queue.  A worker exception
    the consumer never got to see (it stopped drawing before the queue
    reached the sentinel) is re-raised from ``close()`` — swallowing it
    would let a dying pipeline impersonate a clean early exit."""

    # class attribute (True on StatefulPrefetcher): the worker thread reads
    # it from its first iteration, so it must be set before __init__ runs
    _stateful = False

    def __init__(self, it: Iterator[np.ndarray], depth: int = 2):
        self._depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._error: Optional[BaseException] = None
        self._error_delivered = False
        self._stop = threading.Event()
        self._closed = False
        self._exhausted = False  # the _done sentinel was consumed
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            while not self._stop.is_set():
                try:
                    item = next(self._it)
                except StopIteration:
                    break
                # the inner cursor AFTER drawing this item rides the queue
                # with it: state_dict() answers for what was consumed, not
                # what the read-ahead produced
                state = self._it.state_dict() if self._stateful else None
                # bounded-wait put: a consumer that vanished (or called
                # close()) must not leave this thread blocked forever on a
                # full queue
                while not self._stop.is_set():
                    try:
                        self._q.put((item, state), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # re-raised in __next__ (or close())
            self._error = e
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(self._done, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed or self._exhausted:
            # the sentinel is consumed exactly once; without this flag a
            # second iteration would block forever in _q.get() on a queue
            # the exited worker will never feed again (iterator protocol:
            # an exhausted iterator raises StopIteration repeatedly)
            raise StopIteration
        payload = self._q.get()
        if payload is self._done:
            self._exhausted = True
            err = self._error
            if err is not None and not self._error_delivered:
                # the original exception OBJECT, carrying the worker
                # thread's traceback — the consumer sees where the
                # pipeline actually died, not a generic queue poisoning
                self._error_delivered = True
                raise err
            raise StopIteration
        item, state = payload
        if state is not None:
            self._last_state = state
        return item

    def _drain(self) -> None:
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return

    def _stop_worker(self, timeout: float) -> bool:
        """Stop + join the worker, draining REPEATEDLY so a put in flight
        (the consumer exited with the queue full) always unblocks; True
        when the thread actually exited."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        while True:
            self._drain()
            self._thread.join(timeout=0.05)
            if not self._thread.is_alive():
                return True
            if time.monotonic() >= deadline:
                return False

    def close(self, timeout: float = 5.0) -> None:
        """Deterministic shutdown (idempotent): stop the worker, drain the
        queue until its bounded put unblocks, join, close the inner
        iterator — then surface a worker exception the consumer never saw.
        After close(), iteration raises StopIteration."""
        if self._closed:
            return
        self._closed = True
        if not self._stop_worker(timeout):
            # the worker is wedged inside next(self._it) (hung decode or
            # network read): closing a generator mid-execution raises
            # "generator already executing" — and from finally blocks that
            # would mask the exception the caller actually cares about.
            # Leave the daemon thread to die with the process.
            import warnings

            warnings.warn(
                f"Prefetcher.close(): worker did not stop within "
                f"{timeout}s; skipping inner-iterator close",
                stacklevel=2,
            )
            return
        close = getattr(self._it, "close", None)
        if callable(close):
            close()
        err = self._error
        if err is not None and not self._error_delivered:
            self._error_delivered = True
            if sys.exc_info()[0] is None:
                raise err
            # close() is running from a finally while another exception
            # propagates (the caller's handling depends on THAT one):
            # raising here would replace it — surface the worker's death
            # as a warning instead of silently dropping it
            import warnings

            warnings.warn(
                f"Prefetcher worker failed after close "
                f"({type(err).__name__}: {err}); not re-raised because "
                f"another exception is already propagating",
                stacklevel=2,
            )

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class StatefulPrefetcher(Prefetcher):
    """Prefetcher over a RESUMABLE stream (``state_dict``/
    ``load_state_dict``): read-ahead without cursor desync.  The worker
    snapshots the inner cursor alongside every item it enqueues, and
    ``state_dict()`` answers with the snapshot of the last item the
    CONSUMER took — so a checkpoint cut with ``depth`` batches in flight
    records exactly the consumed position, and a restart neither replays
    the in-flight batches nor skips them.

    ``load_state_dict`` is a rewind: the worker has read ahead of the
    restored cursor, so it is stopped and joined, the queue discarded,
    the inner stream re-seeded, and a fresh worker started."""

    _stateful = True

    def __init__(self, it, depth: int = 2):
        if not (hasattr(it, "state_dict") and hasattr(it, "load_state_dict")):
            raise TypeError(
                "StatefulPrefetcher needs a resumable inner stream "
                "(state_dict/load_state_dict); use Prefetcher for "
                "stateless iterators"
            )
        # the pre-iteration cursor: correct until the first item is consumed
        self._last_state = it.state_dict()
        super().__init__(it, depth)

    def state_dict(self) -> dict:
        return dict(self._last_state)

    def load_state_dict(self, state: dict) -> None:
        if self._closed:
            raise RuntimeError("cannot rewind a closed Prefetcher")
        if not self._stop_worker(5.0):
            raise RuntimeError(
                "prefetch worker did not stop for rewind; the inner "
                "stream cannot be re-seeded safely"
            )
        self._it.load_state_dict(state)
        self._last_state = self._it.state_dict()
        self._error = None
        self._error_delivered = False
        self._exhausted = False  # a rewound stream iterates again
        self._stop = threading.Event()
        self._q = queue.Queue(maxsize=self._depth)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()


# -- exactly-once elastic data plane ---------------------------------------

def host_block(global_batch: int, host_index: int, host_count: int):
    """The deterministic per-host shard of one global batch: the CONTIGUOUS
    row block ``[host_index*B/H, (host_index+1)*B/H)``.  Contiguous (not
    striped) on purpose: concatenating all hosts' blocks in host order
    reconstructs the global batch in its original row order at ANY host
    count, which is what makes a shrink/grow restart bitwise-neutral to
    the loss (a striped layout would reorder rows — and float reductions —
    whenever the host count changed)."""
    if host_count < 1:
        raise ValueError(f"host_count must be >= 1, got {host_count}")
    if not 0 <= host_index < host_count:
        raise ValueError(
            f"host_index {host_index} out of range for host_count "
            f"{host_count}"
        )
    if global_batch % host_count != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by host_count "
            f"{host_count}"
        )
    k = global_batch // host_count
    return host_index * k, (host_index + 1) * k


class ElasticBatches:
    """Exactly-once resumable stream with deterministic per-host shard
    assignment, keyed on ``(seed, epoch, host_index, host_count)``.

    **Global-slot addressing.**  The stream is an infinite sequence of
    *global sample slots* ``0, 1, 2, ...``; one global step consumes
    ``batch_size`` consecutive slots and this host materializes only its
    :func:`host_block` of them.  Sample content is a pure function of the
    slot: synthetic mode derives each sample's RNG from ``(seed, slot)``;
    dataset mode maps ``slot -> (epoch=slot//N, perm_epoch[slot%N])``
    where ``perm_epoch`` is the per-epoch shuffle keyed on
    ``(seed, epoch)``.

    **Exactly-once cursor.**  The entire resume state is one integer —
    ``consumed``, the count of global slots drawn — checkpointed next to
    the params (``state_dict``/``load_state_dict``, the
    ``ImageFolderStream`` contract the trainer already persists).  Because
    the cursor is host-count-free, a restart with a DIFFERENT host count
    re-partitions trivially: every new host resumes at the same global
    position and takes its new block.  No slot is ever replayed or
    skipped.

    **Packing.**  Batches address slots, never epoch-aligned chunks, so an
    epoch tail short of a full batch is packed together with the next
    epoch's head instead of padded or dropped — zero pad waste by
    construction (``epochs_started`` tracks boundary crossings).
    """

    def __init__(
        self,
        batch_size: int,
        image_size: int = 8,
        channels: int = 3,
        seed: int = 0,
        *,
        host_index: int = 0,
        host_count: int = 1,
        dataset: Optional[np.ndarray] = None,
        perm_cache: Optional[dict] = None,
    ):
        host_block(batch_size, host_index, host_count)  # validate eagerly
        if dataset is not None:
            dataset = np.asarray(dataset)
            if dataset.ndim != 4:
                raise ValueError(
                    f"dataset must be (N, C, H, W), got {dataset.shape}"
                )
        self._global_batch = int(batch_size)
        self._image_size = int(image_size)
        self._channels = int(channels)
        self._seed = int(seed)
        self._host_index = int(host_index)
        self._host_count = int(host_count)
        self._dataset = dataset
        self._epoch_size = 0 if dataset is None else int(dataset.shape[0])
        self._consumed = 0  # GLOBAL slots drawn (all hosts', not just ours)
        # epoch -> permutation; shareable (HostShardedBatches hands one
        # dict to all its host streams so the O(N) shuffle happens once per
        # epoch, not once per host); bounded to the two epochs a batch can
        # straddle
        self._perm_cache: dict = perm_cache if perm_cache is not None else {}
        self.repartitioned = False

    # -- deterministic addressing -----------------------------------------
    def sample_index(self, slot: int):
        """Dataset row for a global slot (dataset mode), or the slot itself
        (synthetic mode) — the identity the exactly-once audits assert on."""
        if self._dataset is None:
            return int(slot)
        epoch, offset = divmod(int(slot), self._epoch_size)
        perm = self._perm_cache.get(epoch)
        if perm is None:
            rng = np.random.default_rng(
                np.random.SeedSequence([self._seed, epoch]))
            perm = self._perm_cache[epoch] = rng.permutation(self._epoch_size)
            for stale in [e for e in self._perm_cache
                          if e < epoch - 1 or e > epoch + 1]:
                del self._perm_cache[stale]
        return int(perm[offset])

    def _sample(self, slot: int) -> np.ndarray:
        if self._dataset is not None:
            return self._dataset[self.sample_index(slot)]
        rng = np.random.default_rng(
            np.random.SeedSequence([self._seed, int(slot)]))
        return rng.standard_normal(
            (self._channels, self._image_size, self._image_size),
            dtype=np.float32,
        )

    @property
    def consumed(self) -> int:
        return self._consumed

    @property
    def epochs_started(self) -> int:
        """Epochs the stream has touched (0 before the first draw);
        dataset mode only — synthetic streams have no epochs."""
        if self._epoch_size == 0:
            return 0
        return -(-self._consumed // self._epoch_size)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        lo, hi = host_block(self._global_batch, self._host_index,
                            self._host_count)
        base = self._consumed
        batch = np.stack([self._sample(base + j) for j in range(lo, hi)])
        self._consumed += self._global_batch
        return batch

    # -- resume cursor (checkpointed via the trainer's data tree) ---------
    def state_dict(self) -> dict:
        """Flat int dict (the checkpoint data-tree convention).  Keys are
        FIXED across host counts so the restore template always matches;
        ``host_count`` is recorded for forensics and ignored on load."""
        return {
            "consumed": self._consumed,
            "global_batch": self._global_batch,
            "epoch_size": self._epoch_size,
            "seed": self._seed,
            "host_count": self._host_count,
        }

    def load_state_dict(self, state: dict) -> None:
        for key in ("seed", "global_batch", "epoch_size"):
            if key in state and int(state[key]) != getattr(self, f"_{key}"):
                raise ValueError(
                    f"checkpointed data cursor was written by a different "
                    f"stream: {key} {int(state[key])} != "
                    f"{getattr(self, f'_{key}')} — exactly-once resume is "
                    f"only defined within one (seed, dataset, batch) "
                    f"identity"
                )
        if ("host_count" in state
                and int(state["host_count"]) != self._host_count):
            # the re-partition case: the cursor is global, so adopting it
            # under a new host count IS the re-partition
            self.repartitioned = True
        self._consumed = int(state["consumed"])


class HostShardedBatches:
    """The per-host elastic data plane assembled: one :class:`ElasticBatches`
    per host, drawn in host order and concatenated into the global batch.
    Because each host's share is a contiguous block, the concatenation is
    bit-identical to a single global stream at ANY host count.  Every rank
    of a mesh holds the global batch and takes its rows
    (``parallel/step.py::MeshShard.rows``, which is :func:`host_block` of
    the data axis), so the chaos harness and the elastic tests train every
    rank on this.

    ``state_dict`` is the host-count-free global cursor, so a checkpoint
    cut at H hosts restores into an assembler built with H' hosts (the
    shrink/grow re-partition)."""

    def __init__(
        self,
        batch_size: int,
        image_size: int = 8,
        channels: int = 3,
        seed: int = 0,
        *,
        host_count: int = 1,
        dataset: Optional[np.ndarray] = None,
    ):
        perm_cache: dict = {}  # one per-epoch shuffle shared by all hosts
        self._streams = [
            ElasticBatches(
                batch_size, image_size, channels, seed,
                host_index=i, host_count=host_count, dataset=dataset,
                perm_cache=perm_cache,
            )
            for i in range(host_count)
        ]

    @property
    def host_count(self) -> int:
        return len(self._streams)

    @property
    def consumed(self) -> int:
        return self._streams[0].consumed

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        return np.concatenate([next(s) for s in self._streams], axis=0)

    def state_dict(self) -> dict:
        return self._streams[0].state_dict()

    def load_state_dict(self, state: dict) -> None:
        for s in self._streams:
            s.load_state_dict(state)

    def close(self) -> None:
        pass  # host-side numpy only; nothing to release


class _StatefulAugmented:
    """Augmentation wrapper that forwards the inner stream's resume cursor.
    Only the iteration position is exact across resume; the augmentation RNG
    restarts (stochastic augmentation needs no exact replay)."""

    def __init__(self, inner, kind: str, seed: int):
        self._inner = inner
        self._it = augmented(inner, kind, seed)

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._it)

    def state_dict(self):
        return self._inner.state_dict()

    def load_state_dict(self, state):
        self._inner.load_state_dict(state)

    def close(self):
        close = getattr(self._inner, "close", None)
        if callable(close):
            close()


def make_batches(
    kind: str,
    batch_size: int,
    image_size: int,
    channels: int = 3,
    seed: int = 0,
    data_dir: Optional[str] = None,
    prefetch: int = 2,
    augment: str = "none",
    host_index: Optional[int] = None,
    host_count: int = 1,
) -> Iterator[np.ndarray]:
    """The stream ``kind`` names (``synthetic``, ``folder``, ``images`` or
    ``elastic``), augmented, behind a :class:`Prefetcher` of ``prefetch``
    batches (the ``images`` stream prefetches on its own and keeps its
    cursor; ``elastic`` behind a :class:`StatefulPrefetcher`, whose cursor
    is the consumer's).  The caller closes it."""
    if kind == "elastic":
        # exactly-once resumable stream (host_index=None: every host's block
        # assembled into the global batch; an int: that one host's block).
        # batch_size is the GLOBAL batch.  No fault_injected wrap (it would
        # break the state_dict forwarding; elastic faults fire at the
        # supervisor's tick instead)
        if host_index is None:
            it = HostShardedBatches(batch_size, image_size, channels, seed,
                                    host_count=host_count)
        else:
            it = ElasticBatches(batch_size, image_size, channels, seed,
                                host_index=host_index, host_count=host_count)
        if augment != "none":
            it = _StatefulAugmented(it, augment, seed)
        return StatefulPrefetcher(it, prefetch) if prefetch > 0 else it
    if kind == "synthetic":
        it = synthetic_batches(batch_size, image_size, channels, seed)
    elif kind == "folder":
        if data_dir is None:
            raise ValueError("folder data source needs data_dir")
        it = folder_batches(data_dir, batch_size, image_size, channels, seed)
    elif kind == "images":
        from glom_tpu_torch.training.image_stream import ImageFolderStream

        if data_dir is None:
            raise ValueError("images data source needs data_dir")
        stream = ImageFolderStream(
            data_dir, batch_size, image_size, channels=channels, seed=seed,
            prefetch=max(prefetch, 1),
        )
        # internal per-file prefetch + a resumable cursor: no extra wrap
        # needed (its own read-ahead already reports a consumer-exact
        # cursor; an additional StatefulPrefetcher layer would only stack
        # queues); no fault_injected wrap either — it would break the
        # state_dict forwarding contract
        if augment == "none":
            return stream
        return _StatefulAugmented(stream, augment, seed)
    else:
        raise ValueError(f"unknown data source {kind!r}")
    it = fault_injected(augmented(it, augment, seed))
    return Prefetcher(it, prefetch) if prefetch > 0 else it
