"""The bulk-job store: specs, the exactly-once slot cursor, and the
idempotent chunk sink.

The port's copy of ``glom_tpu/bulk/jobs.py`` (stdlib and numpy only), the
same code, so a store or a sink written by either package is adopted and
assembled by the other.

**Job spec.**  ``(model, version, dataset, transform, sink)`` — dataset
is either ``synthetic:<N>`` (N slots whose content is a pure function of
``(seed, slot)``, the derivation ``glom_tpu``'s ``ElasticBatches`` uses) or
a glob of per-sample ``.npy`` files (sorted listing; slot = list index).
Either way sample content is a pure function of the slot, which is what
makes resume-after-kill provable rather than hoped.

**Exactly-once cursor.**  A job covers slots ``[0, total)``, a *shard* is
a contiguous ``[lo, hi)`` block (:func:`partition_range`), and each shard's
entire resume state is ONE integer cursor in ``[lo, hi]``.  The commit
order is sink-then-cursor: a chunk's part file is written (atomic
tmp+rename) BEFORE the cursor advances past it, so a kill between the two
re-executes the chunk on resume and overwrites the part with byte-identical
content — zero dropped, zero double-written samples, pinned by ``python -m
glom_tpu_torch.tools.bulk_run --smoke``.  Adopting a persisted cursor
validates the ``(seed, dataset, transform)`` identity first: exactly-once
is only defined within one job identity.

**Idempotent sink.**  Output parts are ``part_<lo>_<hi>.npy`` keyed by
the slot range they hold; re-writing a part is an atomic replace with
identical bytes, and :meth:`ChunkSink.assemble` concatenates parts in
slot order into the uninterrupted-run output by construction.

Stdlib + numpy only — no torch, no serving imports: the store must be
readable by CLIs and routers that never touch a device.
"""

from __future__ import annotations

import glob as glob_lib
import json
import os
import re
import threading
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from glom_tpu_torch.checkpoint import _atomic_write

#: the offline transforms — "embed"/"reconstruct" are exactly the online
#: batched endpoints, so their bulk work replays the SAME captured (bucket,
#: quant) graphs; "index" is the offline-only similarity-index build
#: (hierarchy/index.py) through the index family's graphs, with a per-level
#: part-file sink instead of the flat ChunkSink layout
TRANSFORMS = ("embed", "reconstruct", "index")

JOB_STATUSES = ("pending", "running", "paused", "done", "cancelled")

_NAME_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")
_SYNTH_RE = re.compile(r"^synthetic:(?P<n>[1-9]\d*)$")
_PART_RE = re.compile(r"^part_(?P<lo>\d{10})_(?P<hi>\d{10})\.npy$")


def partition_range(lo: int, hi: int, k: int) -> List[Tuple[int, int]]:
    """Cut ``[lo, hi)`` into ``k`` contiguous near-equal blocks (first
    ``rem`` blocks one slot larger) — ``glom_tpu``'s ``host_block``
    contiguity contract without its divisibility requirement, because a fleet's
    replica count rarely divides a dataset.  Empty blocks are dropped,
    so ``k`` greater than the range yields fewer shards, never empty
    ones."""
    if hi < lo:
        raise ValueError(f"bad range [{lo}, {hi})")
    if k < 1:
        raise ValueError(f"need k >= 1 shards, got {k}")
    span = hi - lo
    base, rem = divmod(span, k)
    out: List[Tuple[int, int]] = []
    cursor = lo
    for i in range(k):
        size = base + (1 if i < rem else 0)
        if size == 0:
            continue
        out.append((cursor, cursor + size))
        cursor += size
    return out


@dataclass(frozen=True)
class BulkJobSpec:
    """One job's identity.  Frozen: the exactly-once contract is only
    defined within one ``(dataset, seed, transform)`` identity, so a
    spec can never be edited in place — cancel and resubmit."""

    name: str
    dataset: str                      # "synthetic:<N>" or a .npy glob
    transform: str = "embed"
    sink: str = ""                    # part-file directory
    model: str = "default"
    version: Optional[int] = None
    seed: int = 0
    image_size: int = 8
    channels: int = 3

    def __post_init__(self):
        if not _NAME_RE.fullmatch(self.name):
            raise ValueError(
                f"bad job name {self.name!r}: want 1-64 chars of "
                f"[A-Za-z0-9._-]")
        if self.transform not in TRANSFORMS:
            raise ValueError(
                f"unknown transform {self.transform!r}; one of {TRANSFORMS}")
        if not self.sink:
            raise ValueError("job spec needs an output sink directory")

    def to_json_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_json_dict(cls, doc: dict) -> "BulkJobSpec":
        fields = {f: doc[f] for f in (
            "name", "dataset", "transform", "sink", "model", "version",
            "seed", "image_size", "channels") if f in doc}
        return cls(**fields)


class SlotDataset:
    """Deterministic slot-addressed sample source for one job.

    ``read(lo, hi)`` materializes the ``(hi-lo, C, H, W)`` float32 block
    for those global slots; content is a pure function of the slot, so a
    re-executed chunk is byte-identical to its first execution.
    Synthetic mode derives each sample from ``SeedSequence([seed, slot])``
    — the SAME derivation as ``glom_tpu``'s ``ElasticBatches._sample``,
    so a bulk job over ``synthetic:N`` sees that training data plane's
    exact stream (tests pin the two against each other)."""

    def __init__(self, spec: BulkJobSpec):
        self.spec = spec
        self._files: Optional[List[str]] = None
        m = _SYNTH_RE.match(spec.dataset)
        if m:
            self._total = int(m.group("n"))
        else:
            files = sorted(glob_lib.glob(spec.dataset))
            if not files:
                raise ValueError(
                    f"dataset glob {spec.dataset!r} matched no files "
                    f"(want 'synthetic:<N>' or a glob of per-sample .npy)")
            self._files = files
            self._total = len(files)

    def __len__(self) -> int:
        return self._total

    def _sample(self, slot: int) -> np.ndarray:
        s = self.spec
        if self._files is not None:
            arr = np.asarray(np.load(self._files[slot]), dtype=np.float32)
            if arr.shape != (s.channels, s.image_size, s.image_size):
                raise ValueError(
                    f"{self._files[slot]}: want "
                    f"({s.channels}, {s.image_size}, {s.image_size}), "
                    f"got {arr.shape}")
            return arr
        rng = np.random.default_rng(
            np.random.SeedSequence([s.seed, int(slot)]))
        return rng.standard_normal(
            (s.channels, s.image_size, s.image_size), dtype=np.float32)

    def read(self, lo: int, hi: int) -> np.ndarray:
        if not 0 <= lo <= hi <= self._total:
            raise ValueError(
                f"slot range [{lo}, {hi}) outside [0, {self._total})")
        return np.stack([self._sample(slot) for slot in range(lo, hi)])


class ChunkSink:
    """Slot-range-keyed part files with atomic idempotent writes.

    ``part_<lo>_<hi>.npy`` holds the transform output for slots
    ``[lo, hi)``; the write is tmp+rename (the checkpoint convention),
    so a crash mid-write leaves either the previous complete part or
    none — never torn bytes — and a resume's re-execution REPLACES the
    part with identical content instead of appending a duplicate."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    @staticmethod
    def part_name(lo: int, hi: int) -> str:
        return f"part_{lo:010d}_{hi:010d}.npy"

    def write(self, lo: int, hi: int, out: np.ndarray) -> str:
        if out.shape[0] != hi - lo:
            raise ValueError(
                f"part [{lo}, {hi}) wants {hi - lo} rows, got {out.shape[0]}")
        name = self.part_name(lo, hi)
        payload = np.ascontiguousarray(out)

        def writer(f):
            np.save(f, payload)

        _atomic_write(self.root, name, writer)
        # A re-partitioned range can hold ORPHAN parts: a dead owner's
        # un-acknowledged progress past its last durable cursor, chunked
        # at boundaries the new owner won't reproduce.  Every slot they
        # cover is being re-written by this range's new parts, so any
        # part overlapping [lo, hi) that is not exactly (lo, hi) is
        # stale — drop it, or assemble() would see overlapping ranges.
        for plo, phi, path in self.parts():
            if (plo, phi) != (lo, hi) and plo < hi and lo < phi:
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    pass  # a sibling survivor already dropped it
        return os.path.join(self.root, name)

    def parts(self) -> List[Tuple[int, int, str]]:
        out = []
        for name in sorted(os.listdir(self.root)):
            m = _PART_RE.match(name)
            if m:
                out.append((int(m.group("lo")), int(m.group("hi")),
                            os.path.join(self.root, name)))
        return sorted(out)

    def assemble(self, total: Optional[int] = None) -> np.ndarray:
        """Concatenate every part in slot order, validating the ranges
        tile ``[0, total)`` exactly — a gap or overlap means the cursor
        contract was violated and assembling would hide it."""
        parts = self.parts()
        if not parts:
            raise ValueError(f"no parts in {self.root}")
        cursor = 0
        arrays = []
        for lo, hi, path in parts:
            if lo != cursor:
                raise ValueError(
                    f"parts don't tile: expected slot {cursor}, "
                    f"found part [{lo}, {hi})")
            arrays.append(np.load(path))
            cursor = hi
        if total is not None and cursor != total:
            raise ValueError(
                f"parts cover [0, {cursor}) but job total is {total}")
        return np.concatenate(arrays)


class JobStore:
    """Durable job state: one atomic JSON file per job under ``root``.

    A job document is ``{"spec": ..., "status": ..., "shards": [...]}``
    where each shard is ``{"lo", "hi", "cursor", "owner"}`` and the
    cursor is the shard's entire resume state (``glom_tpu``'s
    ``ElasticBatches`` ``consumed`` analogue).  Every mutation rewrites the file atomically,
    so a killed process leaves the last durable cursor — never a torn
    one.  Thread-safe; shareable between a runner and an admin HTTP
    handler."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()

    # -- paths / IO --------------------------------------------------------
    def _path(self, name: str) -> str:
        if not _NAME_RE.fullmatch(name):
            raise ValueError(f"bad job name {name!r}")
        return os.path.join(self.root, f"{name}.json")

    def _read(self, name: str) -> dict:
        path = self._path(name)
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            raise KeyError(f"no job {name!r} in {self.root}") from None

    def _write(self, name: str, doc: dict) -> None:
        payload = json.dumps(doc, indent=2).encode()
        _atomic_write(self.root, f"{name}.json", lambda f: f.write(payload))

    # -- lifecycle ---------------------------------------------------------
    def submit(self, spec: BulkJobSpec, *, total: int,
               shards: Optional[Sequence[Tuple[int, int]]] = None,
               owner: str = "local") -> dict:
        """Create (or extend) a job.  A resubmit with the SAME spec and a
        new disjoint shard range appends the shard — that is how a fleet
        re-partition lands a dead replica's remaining range on a
        survivor.  A resubmit with a DIFFERENT spec identity raises: the
        exactly-once contract is per-identity, exactly like
        ``glom_tpu``'s ``ElasticBatches.load_state_dict`` seed/batch check."""
        if total < 1:
            raise ValueError(f"job total must be >= 1, got {total}")
        shards = list(shards) if shards else [(0, total)]
        with self._lock:
            try:
                doc = self._read(spec.name)
            except KeyError:
                doc = {"spec": spec.to_json_dict(), "status": "pending",
                       "total": int(total), "shards": []}
            else:
                self._check_identity(doc, spec, total)
                if doc["status"] in ("done", "cancelled"):
                    raise RuntimeError(
                        f"job {spec.name!r} is {doc['status']}; cancel and "
                        f"resubmit under a new name to rerun")
            for lo, hi in shards:
                if not 0 <= lo < hi <= total:
                    raise ValueError(
                        f"shard [{lo}, {hi}) outside [0, {total})")
                existing = next((s for s in doc["shards"]
                                 if s["lo"] == lo and s["hi"] == hi), None)
                if existing is not None:
                    existing["owner"] = owner  # idempotent re-submit
                    continue
                if any(lo < s["hi"] and s["lo"] < hi
                       for s in doc["shards"]):
                    raise ValueError(
                        f"shard [{lo}, {hi}) overlaps an existing shard of "
                        f"job {spec.name!r} — overlapping cursors would "
                        f"double-write slots")
                doc["shards"].append(
                    {"lo": int(lo), "hi": int(hi), "cursor": int(lo),
                     "owner": owner})
            doc["shards"].sort(key=lambda s: s["lo"])
            self._write(spec.name, doc)
            return doc

    @staticmethod
    def _check_identity(doc: dict, spec: BulkJobSpec, total: int) -> None:
        have = BulkJobSpec.from_json_dict(doc["spec"])
        if have != spec or int(doc["total"]) != int(total):
            raise ValueError(
                f"job {spec.name!r} already exists with a different "
                f"identity — exactly-once resume is only defined within "
                f"one (dataset, seed, transform, sink) identity")

    def load(self, name: str) -> dict:
        with self._lock:
            return self._read(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(
                f[:-len(".json")] for f in os.listdir(self.root)
                if f.endswith(".json"))

    # -- the exactly-once cursor ------------------------------------------
    def advance(self, name: str, lo: int, cursor: int) -> dict:
        """Durably advance the ``[lo, hi)`` shard's cursor AFTER its sink
        part landed (the sink-then-cursor commit order).  Monotone and
        bounded: moving backwards or past ``hi`` raises — both would
        break the no-drop/no-double-write proof."""
        with self._lock:
            doc = self._read(name)
            shard = next((s for s in doc["shards"] if s["lo"] == lo), None)
            if shard is None:
                raise KeyError(f"job {name!r} has no shard starting at {lo}")
            if not shard["cursor"] <= cursor <= shard["hi"]:
                raise ValueError(
                    f"cursor {cursor} outside [{shard['cursor']}, "
                    f"{shard['hi']}] for shard [{lo}, {shard['hi']}) of "
                    f"{name!r} — the cursor is monotone by contract")
            shard["cursor"] = int(cursor)
            if doc["status"] == "pending":
                doc["status"] = "running"
            if all(s["cursor"] == s["hi"] for s in doc["shards"]):
                doc["status"] = "done"
            self._write(name, doc)
            return doc

    def set_status(self, name: str, status: str) -> dict:
        if status not in JOB_STATUSES:
            raise ValueError(f"unknown status {status!r}")
        with self._lock:
            doc = self._read(name)
            if doc["status"] == "done" and status not in ("done", "cancelled"):
                raise RuntimeError(f"job {name!r} is already done")
            doc["status"] = status
            self._write(name, doc)
            return doc

    def repartition(self, name: str, dead_owner: str,
                    survivors: Sequence[str]) -> List[dict]:
        """Re-cut a dead owner's unfinished ranges across survivors:
        each of its shards' remaining ``[cursor, hi)`` is partitioned
        contiguously (:func:`partition_range`) and appended as new
        shards owned by the survivors; the dead shard is truncated to
        what it durably finished.  Returns the new shards.  Slots
        between the dead owner's last durable cursor and wherever it
        actually died are re-executed — idempotent by the sink contract,
        so re-partition preserves exactly-once."""
        if not survivors:
            raise ValueError("repartition needs at least one survivor")
        with self._lock:
            doc = self._read(name)
            new_shards: List[dict] = []
            for shard in list(doc["shards"]):
                if shard["owner"] != dead_owner:
                    continue
                cursor, hi = int(shard["cursor"]), int(shard["hi"])
                if cursor >= hi:
                    continue  # the dead owner had finished this shard
                if cursor == shard["lo"]:
                    doc["shards"].remove(shard)
                else:
                    shard["hi"] = cursor  # keep only the durable prefix
                for i, (lo2, hi2) in enumerate(
                        partition_range(cursor, hi, len(survivors))):
                    ns = {"lo": lo2, "hi": hi2, "cursor": lo2,
                          "owner": survivors[i % len(survivors)]}
                    doc["shards"].append(ns)
                    new_shards.append(ns)
            doc["shards"].sort(key=lambda s: s["lo"])
            if new_shards:
                self._write(name, doc)
            return new_shards

    # -- views -------------------------------------------------------------
    def status(self, name: str) -> dict:
        """Progress summary for one job: slots done / total, per-shard
        cursors, and doneness — the shape ``/admin/jobs/status`` and the
        observatory jobs pane render."""
        with self._lock:
            doc = self._read(name)
        done = sum(s["cursor"] - s["lo"] for s in doc["shards"])
        covered = sum(s["hi"] - s["lo"] for s in doc["shards"])
        return {
            "name": name,
            "status": doc["status"],
            "transform": doc["spec"]["transform"],
            "total": doc["total"],
            "covered": covered,
            "done": done,
            "remaining": covered - done,
            "shards": [dict(s) for s in doc["shards"]],
        }

    def summary(self) -> Dict[str, Any]:
        """All jobs' statuses plus the aggregate backlog (queued slots
        not yet durably finished) — the capacity plane's scale-signal
        input."""
        jobs = {}
        backlog = 0
        for name in self.names():
            st = self.status(name)
            jobs[name] = st
            if st["status"] in ("pending", "running"):
                backlog += st["remaining"]
        return {"jobs": jobs, "backlog": backlog}
