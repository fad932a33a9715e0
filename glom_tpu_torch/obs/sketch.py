"""Bounded, mergeable streaming sketches for the quality plane.

The port's copy of ``glom_tpu/obs/sketch.py`` (stdlib only), the same code:
a sketch serialized by either package loads and merges exactly in the other.

Two sketch types, both built on a FIXED discretization chosen at
construction time, because that is what makes the fleet view honest:

  * :class:`HistogramSketch` — fixed bin edges, one integer count per
    bin.  Merge is bin-wise addition, which is exactly associative and
    commutative (integer adds), so replica → fleet rollup is EXACT, not
    an approximation — ``(a ⊕ b) ⊕ c == a ⊕ (b ⊕ c)`` bit-for-bit on the
    counts.  PSI between two same-edged sketches is closed-form.
  * :class:`QuantileSketch` — a fixed value grid over ``[lo, hi]``;
    each observation is quantized to its nearest grid index and the
    sketch holds ``{index: count}``.  Quantile queries walk the grid
    cumulatively (error bounded by the grid pitch, known a priori).
    Merge is key-wise count addition — again exactly associative.

Compressed quantile sketches (GK, t-digest) trade a smaller footprint
for merge results that depend on merge ORDER; the fleet observatory
merges replicas in whatever order health polls land, so order-dependence
would make the fleet view nondeterministic.  Fixed discretization costs
a few hundred bytes per metric and buys exactness.

Memory discipline (the ``obs-unbounded-series`` rule): every container
here is hard-bounded by construction — the histogram's count list never
changes length, the quantile grid admits at most ``resolution + 1``
distinct keys and ``record``/``merge`` check ``len(self._counts)``
against that cap before inserting a new key.  Out-of-range observations
clamp into the edge bins and tick ``overflow`` — the sketch DEGRADES
(edge bins get fat, the overflow counter says so) but never grows.

Stdlib only; the clock is injectable for deterministic tests.
"""

from __future__ import annotations

import bisect
import math
import time
from typing import Dict, List, Optional, Sequence

__all__ = [
    "HistogramSketch",
    "QuantileSketch",
    "ks_distance",
    "psi",
    "sketch_from_dict",
]


class HistogramSketch:
    """Fixed-edge histogram with exact, associative merge.

    ``edges`` are the ``len(edges) - 1`` bin boundaries (ascending);
    values land in ``[edges[i], edges[i+1])``.  Values outside the range
    clamp into the first/last bin and increment ``overflow`` — bounded
    degradation, never growth.
    """

    kind = "histogram"

    def __init__(self, edges: Sequence[float], *, clock=None):
        edges = tuple(float(e) for e in edges)
        if len(edges) < 2:
            raise ValueError("HistogramSketch needs >= 2 edges")
        if any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError(f"edges must be strictly ascending: {edges}")
        self.edges = edges
        # fixed-length by construction: one slot per bin, forever
        self._counts: List[int] = [0] * (len(edges) - 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.overflow = 0
        self.last_t: Optional[float] = None
        self._clock = clock or time.monotonic

    # -- ingest ------------------------------------------------------------
    def record(self, value: float, weight: int = 1) -> None:
        value = float(value)
        if not math.isfinite(value):
            self.overflow += weight
            return
        self.count += weight
        self.sum += value * weight
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        self.last_t = self._clock()
        if value < self.edges[0] or value > self.edges[-1]:
            self.overflow += weight
        i = bisect.bisect_right(self.edges, value) - 1
        i = min(max(i, 0), len(self._counts) - 1)
        self._counts[i] += weight

    # -- merge (exact: bin-wise integer addition) --------------------------
    def merge(self, other: "HistogramSketch") -> "HistogramSketch":
        if not isinstance(other, HistogramSketch):
            raise TypeError(f"cannot merge {type(other).__name__}")
        if other.edges != self.edges:
            raise ValueError(
                f"edge mismatch: {self.edges} vs {other.edges} — sketches "
                f"must share one discretization to merge exactly")
        for i, c in enumerate(other._counts):
            self._counts[i] += c
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        self.overflow += other.overflow
        if other.last_t is not None:
            self.last_t = (other.last_t if self.last_t is None
                           else max(self.last_t, other.last_t))
        return self

    # -- queries -----------------------------------------------------------
    def pdf(self) -> List[float]:
        """Normalized per-bin mass (sums to 1; all-zero when empty)."""
        total = sum(self._counts)
        if not total:
            return [0.0] * len(self._counts)
        return [c / total for c in self._counts]

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def counts(self) -> List[int]:
        return list(self._counts)

    # -- wire format -------------------------------------------------------
    def to_dict(self) -> Dict:
        return {
            "kind": self.kind,
            "edges": list(self.edges),
            "counts": list(self._counts),
            "count": self.count,
            "sum": self.sum,
            "min": None if self.count == 0 else self.min,
            "max": None if self.count == 0 else self.max,
            "overflow": self.overflow,
        }

    @classmethod
    def from_dict(cls, d: Dict, *, clock=None) -> "HistogramSketch":
        s = cls(d["edges"], clock=clock)
        counts = [int(c) for c in d["counts"]]
        if len(counts) != len(s._counts):
            raise ValueError("counts length does not match edges")
        s._counts = counts
        s.count = int(d.get("count", sum(counts)))
        s.sum = float(d.get("sum", 0.0))
        s.min = math.inf if d.get("min") is None else float(d["min"])
        s.max = -math.inf if d.get("max") is None else float(d["max"])
        s.overflow = int(d.get("overflow", 0))
        return s


class QuantileSketch:
    """Fixed-grid quantile sketch with exact, associative merge.

    The value range ``[lo, hi]`` is divided into ``resolution`` equal
    steps; an observation quantizes to its nearest grid index.  At most
    ``resolution + 1`` keys can ever exist — ``record`` and ``merge``
    enforce the cap with an explicit ``len`` check before inserting a
    new key (unreachable by construction for in-grid indices; the guard
    is the hard backstop, and out-of-cap observations fold into
    ``overflow`` instead of growing the dict).
    """

    kind = "quantile"

    def __init__(self, lo: float, hi: float, *, resolution: int = 128,
                 clock=None):
        lo, hi = float(lo), float(hi)
        if not (hi > lo):
            raise ValueError(f"need hi > lo, got [{lo}, {hi}]")
        if resolution < 2:
            raise ValueError(f"resolution must be >= 2, got {resolution}")
        self.lo, self.hi = lo, hi
        self.resolution = int(resolution)
        self.max_bins = self.resolution + 1  # the hard key cap
        self._counts: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.overflow = 0
        self.last_t: Optional[float] = None
        self._clock = clock or time.monotonic

    def _index(self, value: float) -> int:
        i = round((value - self.lo) / (self.hi - self.lo) * self.resolution)
        return min(max(int(i), 0), self.resolution)

    def _value(self, index: int) -> float:
        return self.lo + index * (self.hi - self.lo) / self.resolution

    # -- ingest ------------------------------------------------------------
    def record(self, value: float, weight: int = 1) -> None:
        value = float(value)
        if not math.isfinite(value):
            self.overflow += weight
            return
        if value < self.lo or value > self.hi:
            self.overflow += weight  # clamped into the edge of the grid
        i = self._index(value)
        if i not in self._counts and len(self._counts) >= self.max_bins:
            # unreachable for in-grid indices (the grid IS the cap), but
            # the guarantee must not depend on _index staying correct:
            # degrade to overflow rather than grow
            self.overflow += weight
            return
        self.count += weight
        self.sum += value * weight
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        self.last_t = self._clock()
        self._counts[i] = self._counts.get(i, 0) + weight

    # -- merge (exact: key-wise integer addition on one shared grid) -------
    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        if not isinstance(other, QuantileSketch):
            raise TypeError(f"cannot merge {type(other).__name__}")
        if (other.lo, other.hi, other.resolution) != (
                self.lo, self.hi, self.resolution):
            raise ValueError(
                f"grid mismatch: [{self.lo},{self.hi}]/{self.resolution} vs "
                f"[{other.lo},{other.hi}]/{other.resolution}")
        for i, c in other._counts.items():
            if i not in self._counts and len(self._counts) >= self.max_bins:
                self.overflow += c
                continue
            self._counts[i] = self._counts.get(i, 0) + c
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        self.overflow += other.overflow
        if other.last_t is not None:
            self.last_t = (other.last_t if self.last_t is None
                           else max(self.last_t, other.last_t))
        return self

    # -- queries -----------------------------------------------------------
    def quantile(self, q: float) -> Optional[float]:
        """Value at quantile ``q`` in [0, 1]; grid-pitch accuracy."""
        if not self.count:
            return None
        q = min(max(float(q), 0.0), 1.0)
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        for i in sorted(self._counts):
            seen += self._counts[i]
            if seen >= rank:
                return self._value(i)
        return self._value(max(self._counts))

    def cdf_at(self, value: float) -> float:
        """Fraction of mass at or below ``value`` (0 when empty)."""
        if not self.count:
            return 0.0
        i = self._index(value)
        return sum(c for k, c in self._counts.items() if k <= i) / self.count

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    # -- wire format -------------------------------------------------------
    def to_dict(self) -> Dict:
        return {
            "kind": self.kind,
            "lo": self.lo,
            "hi": self.hi,
            "resolution": self.resolution,
            # JSON keys are strings; sorted so the wire form is canonical
            "counts": {str(i): self._counts[i] for i in sorted(self._counts)},
            "count": self.count,
            "sum": self.sum,
            "min": None if self.count == 0 else self.min,
            "max": None if self.count == 0 else self.max,
            "overflow": self.overflow,
        }

    @classmethod
    def from_dict(cls, d: Dict, *, clock=None) -> "QuantileSketch":
        s = cls(d["lo"], d["hi"], resolution=d["resolution"], clock=clock)
        for k, c in d.get("counts", {}).items():
            i = int(k)
            if i < 0 or i > s.resolution:
                raise ValueError(f"grid index {i} outside [0, {s.resolution}]")
            s._counts[i] = int(c)
        s.count = int(d.get("count", sum(s._counts.values())))
        s.sum = float(d.get("sum", 0.0))
        s.min = math.inf if d.get("min") is None else float(d["min"])
        s.max = -math.inf if d.get("max") is None else float(d["max"])
        s.overflow = int(d.get("overflow", 0))
        return s


def sketch_from_dict(d: Dict, *, clock=None):
    """Inverse of ``to_dict`` for either sketch kind (the fleet ingest
    path deserializes whatever a replica's summary carried)."""
    kind = d.get("kind")
    if kind == HistogramSketch.kind:
        return HistogramSketch.from_dict(d, clock=clock)
    if kind == QuantileSketch.kind:
        return QuantileSketch.from_dict(d, clock=clock)
    raise ValueError(f"unknown sketch kind {kind!r}")


# -- drift distances -------------------------------------------------------

def psi(live: HistogramSketch, ref: HistogramSketch,
        *, eps: float = 1e-4) -> float:
    """Population Stability Index between two same-edged histograms:
    ``sum((p_i - q_i) * ln(p_i / q_i))``, with ``eps`` smoothing so an
    empty bin on either side stays finite.  Conventional reading:
    < 0.1 stable, 0.1–0.25 moderate shift, > 0.25 major shift."""
    if live.edges != ref.edges:
        raise ValueError("PSI needs matching histogram edges")
    p, q = live.pdf(), ref.pdf()
    total = 0.0
    for pi, qi in zip(p, q):
        pi, qi = max(pi, eps), max(qi, eps)
        total += (pi - qi) * math.log(pi / qi)
    return total


def ks_distance(live: QuantileSketch, ref: QuantileSketch) -> float:
    """Kolmogorov–Smirnov statistic between two same-grid quantile
    sketches: the max CDF gap over the union of occupied grid points.
    In [0, 1]; 0 when either side is empty (no evidence, no drift)."""
    if (live.lo, live.hi, live.resolution) != (ref.lo, ref.hi, ref.resolution):
        raise ValueError("KS needs matching quantile grids")
    if not live.count or not ref.count:
        return 0.0
    keys = sorted(set(live._counts) | set(ref._counts))
    d = 0.0
    ca = cb = 0
    for k in keys:
        ca += live._counts.get(k, 0)
        cb += ref._counts.get(k, 0)
        d = max(d, abs(ca / live.count - cb / ref.count))
    return d
