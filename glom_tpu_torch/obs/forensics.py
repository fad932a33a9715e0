"""Anomaly-triggered forensics (``glom_tpu/obs/forensics.py``): the flight
recorder and post-mortem bundles.

When a monitor fires (or the run crashes or is preempted), the evidence —
the last N log records, what the step launches and costs, the environment
that produced them — is what a line in a JSONL file does not keep.  This
module captures it:

  * :class:`FlightRecorder` — a bounded ring of the records the trainer
    logs (window records with phase timings, event records, diagnostics).
    Appending is a host-side dict copy at the logging cadence, never a
    per-step device sync.
  * :func:`env_fingerprint` — torch and CUDA versions, the card's name,
    compute capability and driver, the git SHA: the "which build on which
    hardware" half of every post-mortem (``glom_tpu``'s reports jax,
    jaxlib, the backend and the mesh in their place).
  * :func:`write_bundle` — atomic bundle publish: files are written into a
    dot-prefixed staging directory and renamed into place, so a reader
    (or a crashed writer) can never observe a partial bundle.
  * :class:`ForensicsManager` — orchestrates one capture: flush the ring,
    take the step or graph snapshot through a caller-supplied closure,
    optionally arm a bounded ``torch.profiler`` trace window, and write
    ``<root>/<trigger>-<step>/``.

The snapshot files: ``cost_analysis.json`` and ``memory_analysis.json``
keep ``glom_tpu``'s names; in place of ``hlo.txt`` (an XLA module) a port
bundle carries ``kernels.json``, the launches of each kernel wrapper one
step or one graph replay makes (:mod:`glom_tpu_torch.profiling`).  A bundle
either package writes is read by the other, and by either package's
``tools/forensics_report.py``.  The trigger policy (debounce, budget, the
step-time regression detector) lives in :mod:`glom_tpu_torch.obs.triggers`.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import warnings
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from glom_tpu_torch.obs.exporters import normalize_scalar

Clock = Callable[[], float]

BUNDLE_SCHEMA = 1
MANIFEST = "manifest.json"
_STAGING_PREFIX = ".tmp-"
# the trace file a triggered trace window writes under the bundle's trace/
TRACE_FILE = "trace.json"
# after a triggered trace starts (_start_trace): small kernels launched, then
# seconds the card stays idle, before the traced steps
TRACE_BURST = 64
TRACE_SETTLE_S = 0.05


def env_fingerprint(mesh=None) -> Dict[str, Any]:
    """Environment identity for a bundle: versions, the card, git SHA.
    Every field degrades to ``None`` rather than raising — a fingerprint
    must be writable from any crash path.  ``mesh`` is ``glom_tpu``'s
    argument; the port runs on one card and records none."""
    import platform
    import sys

    fp: Dict[str, Any] = {}
    try:
        import torch

        fp["torch_version"] = torch.__version__
        fp["cuda_version"] = torch.version.cuda
        cuda = torch.cuda.is_available()
        fp["backend"] = "cuda" if cuda else "cpu"
        fp["device_count"] = torch.cuda.device_count() if cuda else 0
        fp["local_device_count"] = fp["device_count"]
        fp["device_kind"] = torch.cuda.get_device_name(0) if cuda else None
        fp["device_capability"] = (".".join(map(str, torch.cuda.get_device_capability(0)))
                                   if cuda else None)
        fp["process_index"] = 0
        fp["process_count"] = 1
    except Exception:  # glomlint: disable=conc-broad-except -- a fingerprint must be writable from any crash path; whatever torch raises here, None fields beat no bundle
        fp.setdefault("torch_version", None)
    fp["driver_version"] = _driver_version() if fp.get("backend") == "cuda" else None
    fp["python_version"] = sys.version.split()[0]
    fp["hostname"] = platform.node()
    fp["git_sha"] = _git_sha()
    return fp


def _driver_version() -> Optional[str]:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
            capture_output=True, timeout=10)
        line = out.stdout.decode().strip().splitlines()
        return line[0].strip() if out.returncode == 0 and line else None
    except (OSError, subprocess.SubprocessError, UnicodeDecodeError):
        return None


def _git_sha() -> Optional[str]:
    import subprocess

    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, timeout=5,
        )
        sha = out.stdout.decode().strip()
        return sha if out.returncode == 0 and sha else None
    except (OSError, subprocess.SubprocessError, UnicodeDecodeError):
        return None


class FlightRecorder:
    """Bounded ring of the run's recent log records.

    The trainer tees every record it logs (window records, events,
    diagnostics) into ``record()``; ``snapshot()`` returns the ring oldest
    first.  Values are normalized with the exporters' one scalar rule so a
    flushed ring is byte-identical in shape to the JSONL log it mirrors —
    readers share one schema.  Recording never raises: a value that won't
    normalize is stored as ``repr`` (losing a field beats losing the run).
    """

    def __init__(self, capacity: int = 256,
                 clock: Optional[Clock] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        # injectable clock, same pattern as obs.tracing.Tracer: tests
        # drive record timestamps deterministically
        self._clock: Clock = clock if clock is not None else time.time
        self._t0 = self._clock()
        self.recorded = 0  # lifetime total (ring holds min(recorded, capacity))

    def record(self, step: int, scalars: Dict[str, Any]) -> None:
        rec: Dict[str, Any] = {"step": int(step),
                               "time": round(self._clock() - self._t0, 3)}
        for k, v in scalars.items():
            try:
                rec[k] = normalize_scalar(v)
            except Exception:  # glomlint: disable=conc-broad-except -- recording never raises: a value that won't normalize is stored as repr (losing a field beats losing the run)
                rec[k] = repr(v)
        self._ring.append(rec)
        self.recorded += 1

    def snapshot(self) -> List[Dict[str, Any]]:
        return list(self._ring)

    def to_jsonl(self) -> str:
        return "".join(json.dumps(r) + "\n" for r in self._ring)


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


class ForensicsManager:
    """One capture pipeline: ring flush + env/config + step snapshot +
    optional bounded trace window, written as an atomic bundle.

    ``snapshot_fn`` is a zero-arg closure returning ``{"kernels": dict,
    "cost_analysis": dict, "memory_analysis": dict}`` (the trainer binds it
    to :func:`glom_tpu_torch.profiling.step_snapshot`, the engine to its
    largest ``/embed`` graph's record); it may be None (no snapshot in
    bundles) and any exception it raises is recorded in the manifest
    instead of propagating — forensics must never kill the run it is
    documenting.  A snapshot that carries ``glom_tpu``'s ``hlo`` text is
    written as ``hlo.txt``, as there.

    Trace windows: with ``trace_steps > 0`` a capture starts a
    ``torch.profiler`` trace (host operations and, on a card, its kernels)
    and the step loop calls :meth:`trace_due` / :meth:`stop_trace` to end it
    ``trace_steps`` steps later; the trace is written as
    ``<bundle>/trace/trace.json`` (Chrome/Perfetto).  At most one trace is
    in flight; a capture that finds one running simply skips tracing.  Two
    profilers cannot run at once, so a caller with a profiler of its own
    (the trainer's ``profile_dir``) passes ``trace_steps=0``.
    """

    def __init__(self, root: str, *, recorder: Optional[FlightRecorder] = None,
                 config: Optional[Dict[str, Any]] = None, mesh=None,
                 trace_steps: int = 0,
                 snapshot_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 registry=None, clock: Optional[Clock] = None,
                 attribution_fn: Optional[Callable[[],
                                                   Dict[str, Any]]] = None):
        if trace_steps < 0:
            raise ValueError(f"trace_steps must be >= 0, got {trace_steps}")
        self.root = root
        # wall clock for manifest timestamps (injectable for tests)
        self._clock: Clock = clock if clock is not None else time.time
        self.recorder = recorder
        self._config = config
        self._mesh = mesh
        self.trace_steps = trace_steps
        self._snapshot_fn = snapshot_fn
        self._registry = registry
        # attribution_fn() -> verdict dict; regression-class bundles
        # (slo_burn / capacity_pressure / quality_drift) attach it as
        # attribution.json so the bundle answers "why" not just "what"
        self._attribution_fn = attribution_fn
        self._env: Optional[Dict[str, Any]] = None
        self._trace_stop_step: Optional[int] = None
        self._trace_bundle: Optional[str] = None
        self._profiler = None
        self._fh_file = None
        self.bundles: List[str] = []

    # -- capture ----------------------------------------------------------
    def capture(self, trigger: str, step: int,
                detail: Optional[Dict[str, Any]] = None, *,
                snapshot: bool = True, trace: bool = True,
                extra_files: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Write one bundle; returns its path, or None on failure (warned,
        never raised).  ``snapshot=False`` skips the step snapshot
        (a preemption grace window spends nothing it does not need);
        ``trace=False`` skips arming the trace window.  ``extra_files``
        (``{filename: str|bytes|dict}``) lets the trigger site attach its
        own evidence — e.g. the SLO burn trigger ships the offending
        traces' spans as ``slo_traces.json``."""
        try:
            return self._capture(trigger, step, detail or {},
                                 snapshot=snapshot, trace=trace,
                                 extra_files=extra_files)
        except Exception as e:
            warnings.warn(
                f"forensics capture {trigger!r} at step {step} failed "
                f"({type(e).__name__}: {e}) — training continues",
                stacklevel=2,
            )
            return None

    def _capture(self, trigger, step, detail, *, snapshot, trace,
                 extra_files=None):
        if self._env is None:
            self._env = env_fingerprint(self._mesh)
        files: Dict[str, Any] = {"env.json": self._env}
        if extra_files:
            files.update(extra_files)
        attribution_error = None
        if self._attribution_fn is not None and trigger in (
                "slo_burn", "capacity_pressure", "quality_drift"):
            # regression-class triggers get the automatic root-cause
            # verdict; a failed attribution must never block the bundle
            try:
                verdict = self._attribution_fn()
                if verdict is not None:
                    files["attribution.json"] = verdict
            except Exception as e:  # glomlint: disable=conc-broad-except -- attribution is derived evidence; the primary bundle must land even when the verdict engine breaks
                attribution_error = f"{type(e).__name__}: {e}"
        if self._config is not None:
            files["config.json"] = self._config
        if self.recorder is not None:
            files["flight_recorder.jsonl"] = self.recorder.to_jsonl()
        if self._registry is not None:
            files["metrics.json"] = self._registry.snapshot()
        manifest: Dict[str, Any] = {
            "schema": BUNDLE_SCHEMA,
            "trigger": trigger,
            "step": int(step),
            "detail": detail,
            "created_unix": self._clock(),
            "ring_records": len(self.recorder.snapshot()) if self.recorder else 0,
        }
        if attribution_error is not None:
            manifest["attribution_error"] = attribution_error
        if snapshot and self._snapshot_fn is not None:
            try:
                snap = self._snapshot_fn() or {}
            except Exception as e:
                manifest["snapshot_error"] = f"{type(e).__name__}: {e}"
            else:
                if snap.get("hlo"):
                    files["hlo.txt"] = snap["hlo"]
                if snap.get("kernels") is not None:
                    files["kernels.json"] = snap["kernels"]
                if snap.get("cost_analysis") is not None:
                    files["cost_analysis.json"] = snap["cost_analysis"]
                if snap.get("memory_analysis") is not None:
                    files["memory_analysis.json"] = snap["memory_analysis"]
        want_trace = trace and self.trace_steps > 0 and not self.trace_active
        # the manifest never promises a trace before one actually starts:
        # it publishes with trace=None and is atomically rewritten to
        # "recording" on start_trace success, then "complete" on stop —
        # a start failure leaves no dead reference
        manifest["trace"] = None
        manifest["files"] = sorted(files) + [MANIFEST]
        files[MANIFEST] = manifest
        path = write_bundle(self.root, f"{trigger}-{int(step)}", files)
        self.bundles.append(path)  # glomlint: disable=obs-unbounded-series -- bounded upstream: every capture passes the TriggerEngine's global max_captures budget before reaching here
        if self._registry is not None:
            self._registry.counter(
                "forensics_bundles", help="forensics bundles written"
            ).inc()
        if want_trace and self._start_trace(path, step):
            self._update_manifest(path, trace="trace/", trace_state="recording")
        return path

    @staticmethod
    def _update_manifest(bundle_dir: str, **fields) -> None:
        """Atomically patch a published bundle's manifest (tmp + rename —
        a reader never sees a torn manifest).  Best-effort: manifest drift
        must never take down the run."""
        path = os.path.join(bundle_dir, MANIFEST)
        try:
            with open(path) as f:
                manifest = json.load(f)
            manifest.update(fields)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(manifest, f, indent=2, default=repr)
            os.replace(tmp, path)
        except Exception as e:
            warnings.warn(
                f"forensics manifest update failed ({type(e).__name__}: {e})",
                stacklevel=2,
            )

    # -- bounded trace window ---------------------------------------------
    @property
    def trace_active(self) -> bool:
        return self._trace_stop_step is not None

    def trace_due(self, step: int) -> bool:
        return (self._trace_stop_step is not None
                and step >= self._trace_stop_step)

    def _start_trace(self, bundle_dir: str, step: int) -> bool:
        import torch
        from torch.profiler import ProfilerActivity, profile

        try:
            activities = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
            prof = profile(activities=activities)
            prof.start()
            if torch.cuda.is_available():
                # the first few milliseconds of kernel records after a start
                # can be lost (on an H100, a traced step's first 21 kernels,
                # in a process that had run the profiler before): a burst of
                # small kernels and an idle settle take that loss, not the
                # steps the bundle promises
                burst = torch.zeros(256, device="cuda")
                for _ in range(TRACE_BURST):
                    burst.add_(1.0)
                torch.cuda.synchronize()
                time.sleep(TRACE_SETTLE_S)
        except Exception as e:
            warnings.warn(
                f"forensics trace failed to start ({type(e).__name__}: {e})",
                stacklevel=2,
            )
            return False
        self._profiler = prof
        self._trace_stop_step = step + self.trace_steps
        self._trace_bundle = bundle_dir
        return True

    def stop_trace(self) -> None:
        """End the in-flight trace window (idempotent).  The caller drains
        dispatched device work FIRST so the trace holds the steps it
        promises (the trainer charges that drain to the ``step`` phase)."""
        if self._trace_stop_step is None:
            return
        self._trace_stop_step = None
        bundle = self._trace_bundle
        self._trace_bundle = None
        prof, self._profiler = self._profiler, None
        import torch

        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            os.makedirs(os.path.join(bundle, "trace"), exist_ok=True)
            prof.export_chrome_trace(os.path.join(bundle, "trace", TRACE_FILE))
        except Exception as e:
            warnings.warn(
                f"forensics trace failed to stop ({type(e).__name__}: {e})",
                stacklevel=2,
            )
            return
        if bundle is not None:
            self._update_manifest(bundle, trace_state="complete")

    # -- crash instrumentation --------------------------------------------
    def arm_faulthandler(self) -> bool:
        """Point ``faulthandler`` at ``<root>/faulthandler.log`` so a hard
        crash (segfault in a C extension, deadlocked runtime killed by
        SIGABRT) still leaves stack evidence next to the bundles.  No-op
        (returns False) when the user already enabled faulthandler."""
        import faulthandler

        if faulthandler.is_enabled():
            return False
        try:
            os.makedirs(self.root, exist_ok=True)
            self._fh_file = open(os.path.join(self.root, "faulthandler.log"), "a")
            faulthandler.enable(file=self._fh_file)
            return True
        except (OSError, ValueError, RuntimeError):
            self._fh_file = None
            return False

    def disarm_faulthandler(self) -> None:
        import faulthandler

        if self._fh_file is not None:
            try:
                faulthandler.disable()
            finally:
                self._fh_file.close()
                self._fh_file = None
