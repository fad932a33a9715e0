"""Metrics logging facade (``glom_tpu/training/metrics.py::MetricLogger``).

``MetricLogger`` is what the Trainer (and CLI) log through: one record per
logging boundary, fanned out to pluggable exporters
(:mod:`glom_tpu_torch.obs.exporters`).  The default keeps the historical
format: JSONL to stdout (or a given stream) plus an optional append-mode
file.  A record is ``{"step", "time", **scalars}``: ints, bools and strings
pass through, floats round to 6 significant digits
(:func:`~glom_tpu_torch.obs.exporters.normalize_scalar`), and a tensor
scalar is read as a float.

``registry`` is the :class:`~glom_tpu_torch.obs.registry.MetricRegistry`
that exporters which want one (``wants_registry``: the Prometheus textfile)
render with each record; the Trainer adopts a caller's logger's registry as
``glom_tpu``'s does.  ``close()`` flushes and closes every exporter and is
idempotent; a later ``log`` reopens file sinks in append mode.  ``emit``
False makes ``log`` a no-op: on a mesh of ranks the Trainer clears it on
every rank but 0, as ``glom_tpu`` gates on process 0 of a multi-host job.
"""

from __future__ import annotations

import sys
import time
from typing import IO, Callable, Optional

from glom_tpu_torch.obs.exporters import JsonlExporter, normalize_scalar


class MetricLogger:
    def __init__(self, path: Optional[str] = None, stream: Optional[IO] = None,
                 exporters=None, registry=None,
                 clock: Optional[Callable[[], float]] = None):
        self.path = path
        self.registry = registry
        self._exporters = [JsonlExporter(path=path,
                                         stream=stream if stream is not None else sys.stdout)]
        if exporters:
            self._exporters.extend(exporters)
        # injectable clock: record `time` fields are deterministic in tests
        self._clock = clock if clock is not None else time.time
        self._t0 = self._clock()
        self.emit = True

    def add_exporter(self, exporter) -> None:
        """Attach another sink.  A second exporter of the same class on the
        same path is a no-op: two Trainers sharing one logger must not
        double-write the same file."""
        path = getattr(exporter, "path", None)
        if path is not None and any(
                type(e) is type(exporter) and getattr(e, "path", None) == path
                for e in self._exporters):
            return
        self._exporters.append(exporter)

    def log(self, step: int, **scalars) -> None:
        if not self.emit:
            return
        rec = {"step": int(step), "time": round(self._clock() - self._t0, 3)}
        for k, v in scalars.items():
            rec[k] = normalize_scalar(v)
        for ex in self._exporters:
            if getattr(ex, "wants_registry", False):
                ex.emit(rec, registry=self.registry)
            else:
                ex.emit(rec)

    def close(self) -> None:
        for ex in self._exporters:
            ex.close()

    def __enter__(self) -> "MetricLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
