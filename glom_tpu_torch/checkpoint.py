"""Checkpoints in the JAX package's npz layout (``glom_tpu/checkpoint.py``).

numpy only.  A step is ``ckpt_{step}.npz`` holding every named tree,
flattened by '/'-joined key paths (``params/glom/bottom_up/w1``), beside
``ckpt_{step}.integrity.json`` (a CRC32 of every array and of the whole
file) and a ``manifest.json`` naming the newest step.  Every write is
atomic (a temporary file, then a rename).  Checkpoints written here restore
in ``glom_tpu`` and the other way round.  ``save`` threads the ``ckpt_write``
fault-injection site (:mod:`glom_tpu_torch.resilience.faultinject`) as
``glom_tpu``'s does.
"""

from __future__ import annotations

import json
import os
import tempfile
import zlib
from typing import Dict, Optional

import numpy as np

from glom_tpu_torch.resilience import faultinject

_SEP = "/"


class CorruptCheckpointError(ValueError):
    """An artifact failed its integrity check (torn write, bit rot)."""


def _atomic_write(directory: str, name: str, write_fn) -> str:
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
        path = os.path.join(directory, name)
        os.replace(tmp, path)
        return path
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def write_json(directory: str, name: str, payload) -> str:
    """Atomically write ``payload`` as JSON into ``directory/name``."""
    os.makedirs(directory, exist_ok=True)
    data = json.dumps(payload, indent=2).encode()
    return _atomic_write(directory, name, lambda f: f.write(data))


def npz_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step}.npz")


def integrity_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step}.integrity.json")


def _array_crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _file_crc(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc


def flatten(trees: Dict[str, object]) -> Dict[str, np.ndarray]:
    """``{"params": {"glom": {...}}}`` -> ``{"params/glom/...": array}``."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}{_SEP}{k}", node[k])
        else:
            flat[prefix] = np.asarray(node)

    for name, tree in trees.items():
        if tree is not None:
            walk(name, tree)
    return flat


def unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, arr in flat.items():
        node = tree
        *parents, leaf = key.split(_SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def save(directory: str, step: int, trees: Dict[str, object]) -> str:
    """Write step ``step`` holding every named tree of numpy arrays, its
    integrity record, then the manifest.  Returns the artifact's path."""
    os.makedirs(directory, exist_ok=True)
    arrays = flatten(trees)
    path = _atomic_write(directory, f"ckpt_{step}.npz", lambda f: np.savez(f, **arrays))
    write_json(directory, os.path.basename(integrity_path(directory, step)), {
        "schema": 1,
        "algo": "crc32",
        "step": int(step),
        "artifact": os.path.basename(path),
        "file_size": os.path.getsize(path),
        "file_crc32": _file_crc(path),
        "arrays": {k: _array_crc(v) for k, v in arrays.items()},
    })
    # after the integrity record, so an injected corruption is detectable,
    # as a real one is (a good write whose bytes later go bad)
    _apply_write_fault(path, step)
    write_json(directory, "manifest.json", {"latest_step": int(step), "path": path})
    return path


def _apply_write_fault(path: str, step: int) -> None:
    """The ``ckpt_write`` injection site (``glom_tpu/checkpoint.py``'s): a
    torn write truncates the artifact to half, a bitflip inverts one byte at
    the plan's seeded offset.  A no-op when no plan is armed."""
    kind = faultinject.fire("ckpt_write", step=step)
    if kind is None:
        return
    size = os.path.getsize(path)
    if kind == "torn":
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 1))
    elif kind == "bitflip":
        off = int(faultinject.uniform("ckpt_write", 0, max(size - 1, 0)))
        with open(path, "r+b") as f:
            f.seek(off)
            b = f.read(1) or b"\0"
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))


def latest_step(directory: str, *, strict: bool = False) -> Optional[int]:
    """The step the manifest names, or None when there is no manifest.  An
    unreadable manifest is None too, unless ``strict`` (the trainer's
    auto-resume), where it raises ``ValueError`` rather than let a run
    restart from step 0 over a long run's checkpoints."""
    manifest = os.path.join(directory, "manifest.json")
    try:
        with open(manifest) as f:
            return int(json.load(f)["latest_step"])
    except FileNotFoundError:
        return None
    except (json.JSONDecodeError, KeyError, TypeError, ValueError, OSError) as e:
        if strict:
            raise ValueError(
                f"unreadable checkpoint manifest {manifest} ({type(e).__name__}: {e}); "
                f"refusing to treat {directory} as fresh"
            ) from e
        return None


def step_of(name: str) -> Optional[int]:
    """The step of a ``ckpt_<step>.npz`` file name, else None."""
    if name.startswith("ckpt_") and name.endswith(".npz"):
        try:
            return int(name[len("ckpt_"):-len(".npz")])
        except ValueError:
            return None
    return None


def verify_file_integrity(directory: str, step: int) -> Optional[bool]:
    """The whole-file CRC of step ``step`` against its integrity record: True
    (verified), False (corrupt, or missing while a record exists), None (no
    record: unverifiable, presumed good)."""
    rec = read_integrity(directory, step)
    if rec is None or "file_crc32" not in rec:
        return None
    try:
        return _file_crc(os.path.join(directory, rec.get("artifact", f"ckpt_{step}.npz"))) == rec["file_crc32"]
    except OSError:
        return False


def prune(directory: str, keep: int, *, protect: int) -> None:
    """Delete all but the ``keep`` newest steps (artifact and integrity
    record), never step ``protect``."""
    steps = sorted({s for s in map(step_of, os.listdir(directory)) if s is not None})
    for step in steps[:-keep] if keep > 0 else []:
        if step == protect:
            continue
        for path in (npz_path(directory, step), integrity_path(directory, step)):
            if os.path.exists(path):
                os.remove(path)


def read_integrity(directory: str, step: int) -> Optional[dict]:
    """The step's integrity record, or None when it has none (or the record
    is unreadable: the artifact may be fine)."""
    try:
        with open(integrity_path(directory, step)) as f:
            rec = json.load(f)
    except FileNotFoundError:
        return None
    except (json.JSONDecodeError, OSError):
        return None
    return rec if isinstance(rec, dict) and "arrays" in rec else None


def load_arrays(directory: str, step: int) -> Dict[str, np.ndarray]:
    """Every array of step ``step``, checked against its integrity record
    when there is one; a mismatch raises :class:`CorruptCheckpointError`."""
    path = npz_path(directory, step)
    rec = read_integrity(directory, step)
    try:
        with np.load(path) as data:
            arrays = dict(data)
    except FileNotFoundError:
        raise
    except Exception as e:
        if rec is None:
            raise
        raise CorruptCheckpointError(
            f"checkpoint step {step} in {directory} is unreadable "
            f"({type(e).__name__}: {e}) but has an integrity record"
        ) from e
    if rec is not None:
        bad = sorted(k for k, crc in rec["arrays"].items()
                     if k not in arrays or _array_crc(arrays[k]) != crc)
        if bad:
            raise CorruptCheckpointError(
                f"checkpoint step {step} in {directory} failed per-array CRC "
                f"verification for {len(bad)} of {len(rec['arrays'])} arrays "
                f"(first: {bad[:3]})"
            )
    return arrays


def load_tree(directory: str, step: int, name: str) -> dict:
    """The named tree of step ``step`` as nested dicts of numpy arrays."""
    prefix = name + _SEP
    flat = {k[len(prefix):]: v for k, v in load_arrays(directory, step).items()
            if k.startswith(prefix)}
    if not flat:
        raise KeyError(f"checkpoint step {step} in {directory} holds no tree named {name!r}")
    return unflatten(flat)
