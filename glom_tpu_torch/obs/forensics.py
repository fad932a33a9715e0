"""Forensics bundles: the port's partial copy of ``glom_tpu/obs/forensics.py``.

It holds the bundle format that the fleet observatory
(:mod:`glom_tpu_torch.obs.observatory`) writes and reads, as
``glom_tpu``'s does:

  * :func:`write_bundle` — atomic bundle publish: files are written into a
    dot-prefixed staging directory and renamed into place, so a reader
    (or a crashed writer) can never observe a partial bundle;
  * :func:`is_bundle_dir` — a published bundle has a manifest
    (:data:`MANIFEST`) and no staging prefix.

``FlightRecorder``, ``env_fingerprint`` and ``ForensicsManager`` (the
trainer's and the engine's own bundles, with compile snapshots) are not
ported yet: they wait for ROADMAP queue 1, item 7, as the engine's
``forensics_dir`` and ``warmup_dir`` do (``serving/engine.py::UNPORTED``).
A bundle either package writes is read by the other.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict

BUNDLE_SCHEMA = 1
MANIFEST = "manifest.json"
_STAGING_PREFIX = ".tmp-"


def write_bundle(root: str, name: str, files: Dict[str, Any]) -> str:
    """Atomically publish ``{filename: content}`` as ``<root>/<name>/``.

    Contents are str (text) or bytes; dicts/lists are JSON-encoded.  All
    files land in a ``.tmp-`` staging directory first and the directory is
    renamed into place — a crashed writer leaves only a dot-prefixed
    staging dir (cleaned on the next attempt, ignored by readers), never a
    partial bundle.  If ``name`` already exists a ``-<k>`` suffix is
    appended rather than clobbering earlier evidence."""
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, name)
    k = 1
    while os.path.exists(final):
        k += 1
        final = os.path.join(root, f"{name}-{k}")
    staging = os.path.join(root, f"{_STAGING_PREFIX}{os.path.basename(final)}-{os.getpid()}")
    if os.path.exists(staging):
        shutil.rmtree(staging, ignore_errors=True)
    os.makedirs(staging)
    try:
        for fname, content in files.items():
            if isinstance(content, (dict, list)):
                content = json.dumps(content, indent=2, default=repr)
            mode = "wb" if isinstance(content, bytes) else "w"
            with open(os.path.join(staging, fname), mode) as f:
                f.write(content)
        os.replace(staging, final)
    except BaseException:
        shutil.rmtree(staging, ignore_errors=True)
        raise
    return final


def is_bundle_dir(path: str) -> bool:
    """A published bundle: has a manifest and is not a staging leftover."""
    return (os.path.isdir(path)
            and not os.path.basename(path).startswith(_STAGING_PREFIX)
            and not os.path.basename(path).startswith(".")
            and os.path.exists(os.path.join(path, MANIFEST)))
