"""Checkpoint integrity policy (``glom_tpu/resilience/integrity.py``):
quarantine and newest-valid fallback.

The byte-level check lives in :mod:`glom_tpu_torch.checkpoint` (a CRC of
every array and of the whole file, written beside each npz).  This module
decides what happens when it fails:

* :func:`quarantine` renames a step's artifacts ``*.corrupt``, so no later
  scan considers them, and keeps the bytes for a post-mortem;
* :func:`latest_valid_step` is the newest step that verifies, scanning
  newest first and quarantining failures on the way down;
* :func:`restore_with_fallback` loads the newest valid step and, when a
  step that passed the scan fails its per-array CRCs at load, quarantines
  it and tries the next.  A pinned step raises instead;
* :class:`IntegrityObserver` is the telemetry splice: every quarantine
  bumps ``ckpt_corrupt_total`` and fires the debounced ``ckpt_corrupt``
  forensics trigger (one bundle an incident, not one a damaged file), as
  the trainer's anomaly pipeline does.

Steps without an integrity record (a sharded step has none) are presumed
good.  No step above the manifest's is ever chosen: the manifest's rename is
the barrier that finalizes a save (a sharded save that crashed between its
shard writes and the manifest is never resumed).
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, Optional, Tuple

from glom_tpu_torch import checkpoint as ckpt_lib
from glom_tpu_torch.obs.triggers import TRIGGER_CKPT_CORRUPT

QUARANTINE_SUFFIX = ".corrupt"


class IntegrityObserver:
    """Routes quarantine events into the shared obs stack: counter +
    debounced ``ckpt_corrupt`` trigger + forensics bundle.  All three are
    optional (an observer with only a registry still counts);
    ``triggers`` and ``forensics`` may be attached after construction (the
    serving engine builds them later in its own ``__init__``)."""

    def __init__(self, *, registry=None, triggers=None, forensics=None):
        self.registry = registry
        self.triggers = triggers
        self.forensics = forensics

    def on_corrupt(self, directory: str, step: int, detail: Dict[str, Any]) -> None:
        if self.registry is not None:
            self.registry.counter(
                "ckpt_corrupt_total",
                help="checkpoints quarantined after failing integrity verification",
            ).inc()
        if self.forensics is None:
            return
        if self.triggers is not None and not self.triggers.fire(TRIGGER_CKPT_CORRUPT, step):
            return  # debounced: one bundle per incident, not per artifact
        detail = dict(detail, directory=directory)
        path = self.forensics.capture(TRIGGER_CKPT_CORRUPT, step, detail, trace=False)
        if path is None and self.triggers is not None:
            self.triggers.refund(TRIGGER_CKPT_CORRUPT, step)


def quarantine(directory: str, step: int, *, observer: Optional[IntegrityObserver] = None,
               reason: str = "") -> list:
    """Rename step ``step``'s npz or shard files and its integrity record to
    ``<name>.corrupt`` and tell ``observer``.  Warns, never raises; returns
    the renamed paths."""
    renamed = []
    for path in (ckpt_lib.npz_path(directory, step), ckpt_lib.integrity_path(directory, step),
                 *ckpt_lib.shard_paths(directory, step)):
        if not os.path.exists(path):
            continue
        try:
            os.replace(path, path + QUARANTINE_SUFFIX)
            renamed.append(path + QUARANTINE_SUFFIX)
        except OSError as e:
            warnings.warn(f"failed to quarantine {path} ({type(e).__name__}: {e})", stacklevel=2)
    if renamed:
        warnings.warn(
            f"quarantined corrupt checkpoint step {step} in {directory}"
            + (f" ({reason})" if reason else ""),
            stacklevel=2,
        )
        if observer is not None:
            observer.on_corrupt(directory, step, {
                "step": int(step),
                "reason": reason or "integrity verification failed",
                "quarantined": [os.path.basename(p) for p in renamed],
            })
    return renamed


def _candidate_steps(directory: str) -> list:
    """Every step with an artifact (an npz or shard files) on disk, newest
    first."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted({s for s in map(ckpt_lib.step_of, names) if s is not None}, reverse=True)


def latest_valid_step(directory: str, *, newer_than: Optional[int] = None,
                      quarantine_corrupt: bool = True,
                      observer: Optional[IntegrityObserver] = None) -> Optional[int]:
    """The newest step at or below the manifest's that passes its whole-file
    CRC, quarantining every newer one that fails (unless
    ``quarantine_corrupt=False``: a read-only scan, as the model registry's
    lineage makes); None when no step is loadable.  Steps at or below
    ``newer_than`` are returned without the CRC read: a server already holds
    that step and only asks whether a newer one landed (its watcher polls
    every few seconds)."""
    manifest_step = -1   # read only when a step above newer_than needs it
    for step in _candidate_steps(directory):
        if newer_than is not None and step <= newer_than:
            return step
        if manifest_step == -1:
            manifest_step = ckpt_lib.latest_step(directory)
        if manifest_step is not None and step > manifest_step:
            continue   # above the finalization barrier
        if ckpt_lib.verify_file_integrity(directory, step) is False:
            if quarantine_corrupt:
                quarantine(directory, step, observer=observer, reason="file CRC mismatch")
            continue
        return step
    return None


class NoValidCheckpoint(FileNotFoundError):
    """Every candidate step of a directory is corrupt or absent."""


def restore_with_fallback(directory: str, names: Tuple[str, ...], *,
                          optional: Tuple[str, ...] = (),
                          step: Optional[int] = None,
                          observer: Optional[IntegrityObserver] = None
                          ) -> Tuple[int, Dict[str, dict]]:
    """``(step, {name: tree of numpy arrays})`` of the named trees, and of
    those in ``optional`` that the step holds, with their per-process
    copies (``<name>@p<i>``).  With ``step=None`` the newest valid step
    loads, and a step whose per-array CRCs fail at load is quarantined and
    the next one tried (:class:`NoValidCheckpoint` when none is left).  A
    pinned ``step`` raises
    :class:`~glom_tpu_torch.checkpoint.CorruptCheckpointError` on a bad
    CRC."""

    def load(s):
        arrays = ckpt_lib.load_arrays(directory, s)
        trees = ckpt_lib.unflatten(arrays)
        missing = [n for n in names if n not in trees]
        if missing:
            raise KeyError(f"checkpoint step {s} in {directory} holds no tree named {missing}")
        return s, {n: t for n, t in trees.items()
                   if n in names or n.split("@p", 1)[0] in optional}

    if step is not None:
        return load(step)
    while True:
        chosen = latest_valid_step(directory, observer=observer)
        if chosen is None:
            raise NoValidCheckpoint(
                f"no valid checkpoint in {directory} (every candidate corrupt or absent)")
        try:
            return load(chosen)
        except ckpt_lib.CorruptCheckpointError as e:
            # each pass quarantines its failure, so the candidates shrink
            quarantine(directory, chosen, observer=observer, reason=str(e))
