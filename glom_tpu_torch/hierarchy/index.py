"""Level-aware nearest-neighbour index, the ``/similar`` store (a copy of
``glom_tpu/hierarchy/index.py``).

Shard-append-only part files, one family per level::

    index_<level>_part_<lo:010d>_<hi:010d>.npy    # (hi-lo, e_l, d) float32

Slot ``s`` of level ``l`` holds ``e_l`` entry vectors: the per-patch
columns (``e_l = n``) below the top level ("search by part") and the
patch-mean whole (``e_l = 1``) at the top level ("search by whole").  Parts
are written tmp + fsync + rename with orphan-overlap cleanup, so an index
build killed mid-job and resumed from its cursor assembles to a bitwise
identical index: content is a pure function of the slot range.

Stdlib + numpy only, with no import of the port or of torch: queries and
audits run on machines with no device by loading this file on its own, and
a file written by either package's copy reads in the other.  Query staging
is bounded: chunks are scored one mmap'd part at a time and the candidate
list is trimmed to ``k`` after every chunk.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

INDEX_PART_RE = re.compile(
    r"^index_(?P<level>\d+)_part_(?P<lo>\d{10})_(?P<hi>\d{10})\.npy$")


def index_part_name(level: int, lo: int, hi: int) -> str:
    return f"index_{level}_part_{lo:010d}_{hi:010d}.npy"


def _atomic_write(directory: str, name: str, payload: np.ndarray) -> str:
    """tmp + fsync + rename, the checkpoint layer's publish rule, inlined
    (not imported) so that this module loads on its own."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, name)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.save(f, payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def write_index_parts(root: str, lo: int, hi: int,
                      levels_out: np.ndarray) -> List[str]:
    """Publish one bulk chunk's ``(hi-lo, n, L, d)`` float32 column
    states as one part file per level.  Idempotent: a resume's
    re-execution REPLACES each part with identical bytes, and any part
    overlapping ``[lo, hi)`` at different boundaries (a dead owner's
    orphan past its durable cursor) is dropped, per level family."""
    levels_out = np.ascontiguousarray(levels_out, dtype=np.float32)
    if levels_out.ndim != 4 or levels_out.shape[0] != hi - lo:
        raise ValueError(
            f"index part [{lo}, {hi}) wants ({hi - lo}, n, L, d) states, "
            f"got {levels_out.shape}")
    num_levels = levels_out.shape[2]
    written = []
    for level in range(num_levels):
        if level == num_levels - 1:
            # top level: one whole-scene vector per slot (patch mean)
            vecs = levels_out[:, :, level, :].mean(axis=1, keepdims=True)
        else:
            vecs = levels_out[:, :, level, :]          # (k, n, d) parts
        path = _atomic_write(root, index_part_name(level, lo, hi),
                             np.ascontiguousarray(vecs, np.float32))
        written.append(path)
        for plo, phi, ppath in level_parts(root, level):
            if (plo, phi) != (lo, hi) and plo < hi and lo < phi:
                try:
                    os.unlink(ppath)
                except FileNotFoundError:
                    pass  # a sibling survivor already dropped it
    return written


def level_parts(root: str, level: int) -> List[Tuple[int, int, str]]:
    """Sorted ``(lo, hi, path)`` part triples for one level family."""
    out = []
    if not os.path.isdir(root):
        return out
    for name in sorted(os.listdir(root)):
        m = INDEX_PART_RE.match(name)
        if m and int(m.group("level")) == level:
            out.append((int(m.group("lo")), int(m.group("hi")),
                        os.path.join(root, name)))
    return sorted(out)


def assemble_level(root: str, level: int,
                   total: Optional[int] = None) -> np.ndarray:
    """Concatenate one level's parts in slot order, validating the
    ranges tile ``[0, cursor)`` exactly (what an audit hashes for bitwise
    identity)."""
    parts = level_parts(root, level)
    if not parts:
        raise ValueError(f"no level-{level} index parts in {root}")
    cursor = 0
    arrays = []
    for lo, hi, path in parts:
        if lo != cursor:
            raise ValueError(
                f"level {level} parts don't tile: expected slot {cursor}, "
                f"found part [{lo}, {hi})")
        arrays.append(np.load(path))
        cursor = hi
    if total is not None and cursor != total:
        raise ValueError(
            f"level {level} parts cover [0, {cursor}) but job total "
            f"is {total}")
    return np.concatenate(arrays)


def _normalize(x: np.ndarray) -> np.ndarray:
    norm = np.sqrt(np.sum(x * x, axis=-1, keepdims=True))
    return x / np.maximum(norm, 1e-12)


class LevelIndex:
    """Read side: mmap'd chunk-at-a-time cosine scan over one directory
    of level part families.

    ``query`` re-lists the directory each call — the index is
    append-only while bulk jobs run, and a listing is the only way a
    long-lived engine sees parts that landed after it booted.  Scoring
    stages at most ONE part in memory at a time and trims the candidate
    heap to ``k`` after every part, so query memory is bounded by the
    bulk chunk size (one bucket of states), never the index size."""

    def __init__(self, root: str, levels: int):
        self.root = root
        self.levels = int(levels)

    def stats(self) -> Dict[str, object]:
        chunks = {}
        slots = {}
        for level in range(self.levels):
            parts = level_parts(self.root, level)
            chunks[str(level)] = len(parts)
            slots[str(level)] = max((hi for _, hi, _ in parts), default=0)
        return {"root": self.root, "levels": self.levels,
                "chunks": chunks, "slots": slots}

    def query(self, queries: np.ndarray, level: int,
              k: int = 5) -> List[Dict[str, float]]:
        """Top-``k`` slots for ``(q, d)`` query vectors at ``level`` —
        per-patch queries below the top level, one whole vector at it.
        A slot's score is the max cosine over every (query vector, entry
        vector) pair: any part matching any part.  Deterministic order:
        score descending, then slot ascending."""
        if not 0 <= level < self.levels:
            raise ValueError(
                f"level {level} outside [0, {self.levels})")
        if k < 1:
            raise ValueError(f"need k >= 1, got {k}")
        q = _normalize(np.asarray(queries, np.float32))
        if q.ndim == 1:
            q = q[None, :]
        best: List[Tuple[float, int]] = []
        for lo, hi, path in level_parts(self.root, level):
            entries = np.load(path, mmap_mode="r")      # (kc, e, d)
            block = _normalize(np.asarray(entries, np.float32))
            # (kc,) max over query x entry cosine pairs
            sims = np.einsum("qd,ked->kqe", q, block)
            scores = sims.reshape(sims.shape[0], -1).max(axis=1)
            best.extend(
                (float(scores[i]), lo + i) for i in range(len(scores)))
            # float32 scores compare exactly: the trim can never drop a
            # slot a full sort would have kept
            best.sort(key=lambda t: (-t[0], t[1]))
            del best[k:]
        return [{"slot": slot, "score": score} for score, slot in best]
