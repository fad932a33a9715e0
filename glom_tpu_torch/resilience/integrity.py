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
  it and tries the next.  A pinned step raises instead.

Steps without an integrity record are presumed good.  No step above the
manifest's is ever chosen: the manifest's rename is the barrier that
finalizes a save.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Optional, Tuple

from glom_tpu_torch import checkpoint as ckpt_lib

QUARANTINE_SUFFIX = ".corrupt"


def quarantine(directory: str, step: int, *, reason: str = "") -> list:
    """Rename step ``step``'s npz and integrity record to ``<name>.corrupt``.
    Warns, never raises; returns the renamed paths."""
    renamed = []
    for path in (ckpt_lib.npz_path(directory, step), ckpt_lib.integrity_path(directory, step)):
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
    return renamed


def _candidate_steps(directory: str) -> list:
    """Every step with an artifact on disk, newest first."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted({s for s in map(ckpt_lib.step_of, names) if s is not None}, reverse=True)


def latest_valid_step(directory: str) -> Optional[int]:
    """The newest step at or below the manifest's that passes its whole-file
    CRC, quarantining every newer one that fails; None when no step is
    loadable."""
    manifest_step = ckpt_lib.latest_step(directory)
    for step in _candidate_steps(directory):
        if manifest_step is not None and step > manifest_step:
            continue   # above the finalization barrier
        if ckpt_lib.verify_file_integrity(directory, step) is False:
            quarantine(directory, step, reason="file CRC mismatch")
            continue
        return step
    return None


def restore_with_fallback(directory: str, names: Tuple[str, ...], *,
                          step: Optional[int] = None) -> Tuple[int, Dict[str, dict]]:
    """``(step, {name: tree of numpy arrays})`` of the named trees.  With
    ``step=None`` the newest valid step loads, and a step whose per-array
    CRCs fail at load is quarantined and the next one tried.  A pinned
    ``step`` raises :class:`~glom_tpu_torch.checkpoint.CorruptCheckpointError`
    on a bad CRC."""

    def load(s):
        arrays = ckpt_lib.load_arrays(directory, s)
        trees = ckpt_lib.unflatten(arrays)
        missing = [n for n in names if n not in trees]
        if missing:
            raise KeyError(f"checkpoint step {s} in {directory} holds no tree named {missing}")
        return s, {n: trees[n] for n in names}

    if step is not None:
        return load(step)
    while True:
        chosen = latest_valid_step(directory)
        if chosen is None:
            raise FileNotFoundError(
                f"no valid checkpoint in {directory} (every candidate corrupt or absent)")
        try:
            return load(chosen)
        except ckpt_lib.CorruptCheckpointError as e:
            # each pass quarantines its failure, so the candidates shrink
            quarantine(directory, chosen, reason=str(e))
