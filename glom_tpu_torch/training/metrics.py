"""JSONL metric records (``glom_tpu/training/metrics.py::MetricLogger``).

One JSON object per line, to stdout (or a given stream) and, with ``path``,
appended to a file.  A record is ``{"step", "time", **scalars}``: ints,
bools and strings pass through, floats round to 6 significant digits (the
JAX package's ``normalize_scalar``), and a tensor scalar is read as a float.
``close()`` is idempotent; a later ``log`` reopens the file for appending.
"""

from __future__ import annotations

import json
import math
import sys
import time
from typing import IO, Callable, Optional


def normalize_scalar(v):
    if isinstance(v, (bool, int, str)):
        return v
    f = float(v)
    return float(f"{f:.6g}") if math.isfinite(f) else f


class MetricLogger:
    def __init__(self, path: Optional[str] = None, stream: Optional[IO] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.path = path
        self._stream = stream if stream is not None else sys.stdout
        self._file = None
        self._clock = clock if clock is not None else time.time
        self._t0 = self._clock()

    def log(self, step: int, **scalars) -> None:
        rec = {"step": int(step), "time": round(self._clock() - self._t0, 3)}
        rec.update({k: normalize_scalar(v) for k, v in scalars.items()})
        line = json.dumps(rec)
        print(line, file=self._stream, flush=True)
        if self.path:
            if self._file is None:
                self._file = open(self.path, "a")
            self._file.write(line + "\n")
            self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
