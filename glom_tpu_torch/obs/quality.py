"""Model-quality telemetry plane: the port's copy of ``glom_tpu/obs/quality.py``.

The host side (the sketches' metric grid, :class:`CreditSampler`,
:class:`QualityPlane`, :class:`FleetQualityPlane`, the reference profile) is
``glom_tpu``'s code, stdlib only, so both packages sample, sketch, drift and
serialize alike (a ``quality_ref.json`` or a ``/healthz`` quality summary
written by either loads in the other).  The traced side is torch:
:func:`agreement_maps`, :func:`agreement_stats` and :func:`make_quality_fn`,
the post-pass the serving engine captures as a graph family of its own
(``quality``) beside its endpoints, so a sampled batch replays it and the
request path captures nothing.  torch is imported inside them, so the plane
itself (and ``obs/slo.py``, which takes :data:`QUALITY_SLO_METRICS` from
here) imports without it.

The systems planes (metrics, tracing, SLOs, capacity) watch whether the
service is *up*; this plane watches whether the model is *right*.  GLOM's
central claim is that islands of agreement ARE the parse — so the
quality signals are the parse signals, computed per request by the
post-pass, sampled at a configurable fraction by the same deterministic
credit accumulator the trace tail-sampler uses:

  * ``agreement`` — per-level mean neighbor cosine agreement
    (``models/islands.py``), the island-formation score;
  * ``entropy`` — normalized entropy of the per-level agreement mass
    over patches (1 = agreement spread uniformly, low = concentrated
    islands);
  * ``norm`` — per-level mean embedding L2 norm (collapse / blow-up
    detector);
  * ``residual`` — reconstruction MSE through the trained decoder head
    at the training loss timestep.

Each metric feeds a pair of bounded, exactly-mergeable sketches
(:mod:`glom_tpu_torch.obs.sketch`).  A reference profile captured at
deploy/checkpoint time (``quality_ref.json``, written with the
checkpoint layer's atomic-rename convention) makes drift first-class:
PSI over the histogram pair and KS over the quantile pair, live vs
reference, recomputed as live data lands.  Gauges named ``quality_*``
land in the shared registry, so the series sampler of the capacity plane
records their history with zero extra wiring.

:class:`FleetQualityPlane` is the router-side half: it ingests each
replica's serialized sketches from the ``/healthz`` quality summary and
merges them — merge is associative, so the fleet view is EXACT, not
sampled.
"""

from __future__ import annotations

import json
import math
import os
import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from glom_tpu_torch.obs.sketch import (
    HistogramSketch,
    QuantileSketch,
    ks_distance,
    psi,
    sketch_from_dict,
)

#: per-request scalar quality metrics (code-defined, fixed — the sketch
#: dict cardinality is this tuple, never input data)
QUALITY_METRICS = ("agreement", "entropy", "norm", "residual")

#: metrics an SLO objective may target — the per-request four, plus the
#: shadow-compare ``divergence`` and the live-vs-reference ``drift``
QUALITY_SLO_METRICS = QUALITY_METRICS + ("divergence", "drift")

#: fixed sketch range per metric — one shared discretization per metric
#: name is what makes replica/reference merges and distances exact
METRIC_RANGES: Dict[str, Tuple[float, float]] = {
    "agreement": (-1.0, 1.0),
    "entropy": (0.0, 1.0),
    "norm": (0.0, 10.0),
    "residual": (0.0, 4.0),
    "divergence": (0.0, 2.0),
}

#: file name for the reference profile, living beside the checkpoint
#: artifacts (the "checkpoint conventions" home for deploy-time state)
REFERENCE_FILE = "quality_ref.json"

_HIST_BINS = 16
_QUANTILE_RESOLUTION = 64


def make_sketch_pair(metric: str, *, clock=None) -> Dict[str, object]:
    """One (quantile, histogram) sketch pair on the metric's fixed grid."""
    lo, hi = METRIC_RANGES[metric]
    edges = [lo + (hi - lo) * i / _HIST_BINS for i in range(_HIST_BINS + 1)]
    return {
        "quantile": QuantileSketch(
            lo, hi, resolution=_QUANTILE_RESOLUTION, clock=clock),
        "hist": HistogramSketch(edges, clock=clock),
    }


class CreditSampler:
    """Deterministic stratified sampling by credit accumulation — the
    tail-sampler rule of the traces, factored for reuse: every decision adds
    ``fraction`` of credit; a decision keeps when the accumulated credit
    crosses a seeded uniform draw, then spends one credit.  Long-run keep
    rate is exactly ``fraction`` and keeps are spread evenly through the
    stream (no RNG coin per item => no unlucky clumps), reproducible
    under a fixed seed."""

    def __init__(self, fraction: float, *, seed: int = 0, rng=None):
        self.fraction = min(max(float(fraction), 0.0), 1.0)
        self._rng = rng if rng is not None else random.Random(seed)
        self._credit = 0.0
        self._pick = self._rng.random()
        self.decided = 0
        self.kept = 0

    def decide(self) -> bool:
        self.decided += 1
        self._credit += self.fraction
        if self._credit >= self._pick:
            self._credit -= 1.0
            self._pick = self._rng.random()
            self.kept += 1
            return True
        return False


# -- the post-pass (torch; captured as a CUDA graph by the serving engine) ---

def agreement_maps(levels, side: int):
    """``(b, n, L, d)`` column state -> ``(levels_f32, agree)``, ``agree``
    the ``(b, L, side, side)`` neighbour-cosine agreement grid, computed in
    float32.  The quality post-pass and the parse post-pass
    (``hierarchy/parse.py``) both build on it, so the two can never differ on
    what "agreement" means."""
    from glom_tpu_torch.models.islands import neighbor_agreement

    levels = levels.float()
    return levels, neighbor_agreement(levels, side)


def agreement_stats(agree, log_n: float):
    """``(b, L, s, s)`` agreement maps -> ``(agreement, entropy)``, both
    ``(b, L)``: the mean neighbour cosine, and the normalized entropy of the
    agreement mass over patches (cosine shifted to [0, 1] mass; the eps keeps
    a uniform -1 map finite)."""
    import torch

    flat = agree.reshape(agree.shape[0], agree.shape[1], -1)
    agreement = flat.mean(dim=-1)
    w = (flat + 1.0) * 0.5 + 1e-6
    p = w / w.sum(dim=-1, keepdim=True)
    entropy = -(p * torch.log(p)).sum(dim=-1) / log_n
    return agreement, entropy


def make_quality_fn(config, train_cfg, iters: Optional[int],
                    *, ff_fn=None, fused_fn=None, consensus_fn=None, apply_fn=None):
    """``(params, imgs) -> (b, 3L + 1)`` float32 PER-IMAGE signal matrix.

    Columns: ``[agreement_l0..l{L-1}, entropy_l0.., norm_l0..,
    residual]``.  One packed tensor (not a tuple) because the graph
    cache slices one output's batch padding off (``out[:b]``); per-image
    rows mean bucket padding never contaminates the signals — the host
    slices the real rows before aggregating.

    One ``glom_model.apply`` with ``capture_timestep`` yields both the
    final levels (agreement/entropy/norm) and the captured state the
    trained decoder head reconstructs from (residual) — a single model
    pass per sampled batch.  The step functions, when given, are
    ``models/glom.py::resolve_step_fns``'s (the serving engine resolves
    them once, outside its graphs); ``apply_fn`` stands for
    ``glom_model.apply`` (a mesh rank's:
    ``serving/sharded.py::make_sharded_apply``).  Nothing in it reads the
    device from the host, so it captures as a CUDA graph.
    """
    import torch

    from glom_tpu_torch.models import glom as glom_model
    from glom_tpu_torch.models.heads import decoder_apply
    from glom_tpu_torch.training import denoise

    side = config.image_size // config.patch_size
    n_patches = side * side
    log_n = math.log(n_patches) if n_patches > 1 else 1.0
    resolved_iters = iters if iters is not None else (
        train_cfg.iters if train_cfg.iters is not None
        else config.default_iters)
    timestep = denoise.resolve_loss_timestep(train_cfg, resolved_iters)

    apply_fn = apply_fn or glom_model.apply

    def f(params, imgs):
        levels, captured = apply_fn(
            params["glom"], imgs, config=config, iters=resolved_iters,
            capture_timestep=timestep, consensus_fn=consensus_fn,
            ff_fn=ff_fn, fused_fn=fused_fn)
        levels, agree = agreement_maps(levels, side)  # (b,n,L,d), (b,L,s,s)
        agreement, entropy = agreement_stats(agree, log_n)      # (b, L) x2
        norms = torch.sqrt((levels * levels).sum(dim=-1)).mean(dim=1)  # (b, L)
        recon = decoder_apply(
            params["decoder"], captured, config,
            arch=train_cfg.decoder, level=train_cfg.loss_level).float()
        residual = ((recon - imgs.float()) ** 2).mean(dim=(1, 2, 3))  # (b,)
        return torch.cat([agreement, entropy, norms, residual[:, None]],
                         dim=-1).float()

    f.iters = resolved_iters
    return f


def unpack_signals(row: Sequence[float], levels: int) -> Dict[str, object]:
    """One signal-matrix row -> named per-level lists + scalar residual."""
    row = [float(v) for v in row]
    if len(row) != 3 * levels + 1:
        raise ValueError(
            f"signal row has {len(row)} columns, expected {3 * levels + 1}")
    return {
        "agreement_levels": row[:levels],
        "entropy_levels": row[levels:2 * levels],
        "norm_levels": row[2 * levels:3 * levels],
        "residual": row[3 * levels],
    }


def _atomic_json_write(directory: str, name: str, payload: Dict) -> str:
    """tmp + fsync + rename — the checkpoint layer's publish rule,
    inlined so the obs layer stays dependency-free."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, name)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


class QualityPlane:
    """Engine-side quality accounting: sampled per-request signals into
    bounded sketches, drift vs an optional reference profile, worst-N
    offender tracking, and ``quality_*`` registry gauges (which the
    TSDB-lite sampler then records as history for free).

    Thread-safe: the engine's worker threads call :meth:`observe`
    concurrently with ``/healthz`` / ``/quality`` reads.
    """

    #: trace-id -> input-fingerprint retention (forensics bundles name
    #: offending traces; the fingerprint identifies the INPUT)
    MAX_FINGERPRINTS = 256

    def __init__(self, registry, *, levels: int, sample: float = 1.0,
                 seed: int = 0, clock=None, worst_n: int = 8):
        self.registry = registry
        self.levels = int(levels)
        self.worst_n = int(worst_n)
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self.sampler = CreditSampler(sample, seed=seed)
        # one sketch pair per code-defined metric name — fixed cardinality
        self.live = {m: make_sketch_pair(m, clock=clock)
                     for m in QUALITY_METRICS}
        self.reference: Optional[Dict[str, Dict[str, object]]] = None
        self.reference_meta: Dict[str, object] = {}
        self._drift: Dict[str, Dict[str, float]] = {}
        self._latest: Dict[str, object] = {}
        self._worst: List[Dict[str, object]] = []
        self._fingerprints: Dict[str, str] = {}
        self.observed = 0

    # -- sampling ----------------------------------------------------------
    def should_sample(self) -> bool:
        """One credit-accumulator decision per BATCH (the post-pass runs
        whole batches; per-image sampling would buy nothing)."""
        with self._lock:
            return self.sampler.decide()

    # -- ingest ------------------------------------------------------------
    def observe(self, signals: Dict[str, object], *,
                trace_id: Optional[str] = None,
                tenant: Optional[str] = None,
                version: Optional[object] = None,
                fingerprint: Optional[str] = None) -> Dict[str, float]:
        """Record one sampled request's signals (the
        :func:`unpack_signals` shape).  Returns the flat scalar view —
        per-metric means plus current ``drift`` — which is exactly what
        the SLO layer's quality evaluators consume."""
        agreement = [float(v) for v in signals["agreement_levels"]]
        entropy = [float(v) for v in signals["entropy_levels"]]
        norm = [float(v) for v in signals["norm_levels"]]
        residual = float(signals["residual"])
        flat = {
            "agreement": sum(agreement) / len(agreement),
            "entropy": sum(entropy) / len(entropy),
            "norm": sum(norm) / len(norm),
            "residual": residual,
        }
        with self._lock:
            self.observed += 1
            for metric, value in flat.items():
                pair = self.live[metric]
                pair["quantile"].record(value)
                pair["hist"].record(value)
            self._latest = dict(flat)
            self._latest["agreement_levels"] = agreement
            self._latest["entropy_levels"] = entropy
            self._latest["norm_levels"] = norm
            if trace_id and fingerprint:
                if (trace_id not in self._fingerprints
                        and len(self._fingerprints) >= self.MAX_FINGERPRINTS):
                    self._fingerprints.pop(next(iter(self._fingerprints)))
                self._fingerprints[trace_id] = fingerprint
            self._note_worst(flat["agreement"], residual, trace_id,
                             fingerprint, tenant)
            drift = self._recompute_drift()
        flat["drift"] = drift
        self._export_gauges(flat, agreement, tenant, version)
        return flat

    def _note_worst(self, agreement: float, residual: float,
                    trace_id, fingerprint, tenant) -> None:
        """Bounded worst-N ring, keyed by agreement (low = bad parse)."""
        entry = {"agreement": round(agreement, 4),
                 "residual": round(residual, 4),
                 "trace_id": trace_id, "fingerprint": fingerprint,
                 "tenant": tenant}
        if len(self._worst) < self.worst_n:
            self._worst.append(entry)
            self._worst.sort(key=lambda e: e["agreement"])
            return
        if agreement < self._worst[-1]["agreement"]:
            self._worst[-1] = entry
            self._worst.sort(key=lambda e: e["agreement"])

    def _recompute_drift(self) -> float:
        """Live-vs-reference distances; 0.0 while no reference is loaded
        (no evidence, no drift).  Caller holds the lock."""
        if self.reference is None:
            self._drift = {}
            return 0.0
        drift: Dict[str, Dict[str, float]] = {}
        worst = 0.0
        for metric in QUALITY_METRICS:
            ref = self.reference.get(metric)
            if ref is None:
                continue
            live = self.live[metric]
            d_ks = ks_distance(live["quantile"], ref["quantile"])
            d_psi = psi(live["hist"], ref["hist"])
            drift[metric] = {"ks": round(d_ks, 6), "psi": round(d_psi, 6)}
            worst = max(worst, d_ks)
        drift["max_ks"] = worst
        self._drift = drift
        return worst

    def _export_gauges(self, flat: Dict[str, float],
                       agreement_levels: Sequence[float],
                       tenant, version) -> None:
        reg = self.registry
        if reg is None:
            return
        for metric in QUALITY_METRICS:
            reg.gauge(f"quality_{metric}",
                      help=f"sampled per-request {metric} (mean)").set(
                flat[metric])
        for i, v in enumerate(agreement_levels):
            reg.gauge(f"quality_agreement_l{i}",
                      help="per-level island agreement").set(v)
        reg.gauge("quality_drift",
                  help="max KS distance, live vs reference sketches").set(
            flat.get("drift", 0.0))
        # per-tenant / per-version views mint names through the
        # cardinality guard — a label storm collapses to __other__
        if tenant:
            reg.gauge(reg.labeled("quality_agreement_tenant_", tenant)).set(
                flat["agreement"])
        if version is not None:
            reg.gauge(reg.labeled("quality_drift_version_", version)).set(
                flat.get("drift", 0.0))
        reg.counter("quality_observed_total",
                    help="requests whose quality signals were recorded").inc()

    # -- reference profile -------------------------------------------------
    def save_reference(self, directory: str, *, step=None) -> str:
        """Freeze the CURRENT live sketches as the reference profile
        (``quality_ref.json``, atomic rename — checkpoint conventions)
        and adopt it immediately."""
        with self._lock:
            sketches = {m: {"quantile": p["quantile"].to_dict(),
                            "hist": p["hist"].to_dict()}
                        for m, p in self.live.items()}
            payload = {
                "version": 1,
                "step": step,
                "levels": self.levels,
                "observed": self.observed,
                "sketches": sketches,
            }
        path = _atomic_json_write(directory, REFERENCE_FILE, payload)
        self.adopt_reference(payload, source=path)
        return path

    def load_reference(self, path: str) -> bool:
        """Load ``quality_ref.json`` if present; False when absent."""
        if os.path.isdir(path):
            path = os.path.join(path, REFERENCE_FILE)
        if not os.path.exists(path):
            return False
        with open(path) as f:
            payload = json.load(f)
        self.adopt_reference(payload, source=path)
        return True

    def adopt_reference(self, payload: Dict, *, source: str = "") -> None:
        ref = {}
        for metric, d in payload.get("sketches", {}).items():
            if metric not in METRIC_RANGES:
                continue
            ref[metric] = {"quantile": sketch_from_dict(d["quantile"]),
                           "hist": sketch_from_dict(d["hist"])}
        with self._lock:
            self.reference = ref
            self.reference_meta = {
                "step": payload.get("step"),
                "observed": payload.get("observed"),
                "source": source,
            }
            self._recompute_drift()

    # -- views -------------------------------------------------------------
    def drift(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._drift)

    def summary(self) -> Dict[str, object]:
        """Compact view for ``/healthz`` — carries the serialized live
        sketches so the router's health poll is also the fleet-merge
        feed (zero extra HTTP, same as the capacity plane)."""
        with self._lock:
            return {
                "sample_fraction": self.sampler.fraction,
                "observed": self.observed,
                "decided": self.sampler.decided,
                "sampled": self.sampler.kept,
                "signals": {k: v for k, v in self._latest.items()
                            if not isinstance(v, list)},
                "drift": dict(self._drift),
                "reference": bool(self.reference),
                "sketches": {m: {"quantile": p["quantile"].to_dict(),
                                 "hist": p["hist"].to_dict()}
                             for m, p in self.live.items()},
            }

    def payload(self) -> Dict[str, object]:
        """Full ``/quality`` body: live-vs-reference stats tables,
        per-level agreement, drift scores, worst-N offenders."""
        with self._lock:
            metrics = {}
            for m in QUALITY_METRICS:
                live_q = self.live[m]["quantile"]
                live_h = self.live[m]["hist"]
                row = {
                    "live": _sketch_stats(live_q, live_h),
                    "reference": None,
                    "drift": self._drift.get(m),
                }
                if self.reference and m in self.reference:
                    row["reference"] = _sketch_stats(
                        self.reference[m]["quantile"],
                        self.reference[m]["hist"])
                metrics[m] = row
            return {
                "levels": self.levels,
                "sample_fraction": self.sampler.fraction,
                "observed": self.observed,
                "decided": self.sampler.decided,
                "sampled": self.sampler.kept,
                "signals": dict(self._latest),
                "metrics": metrics,
                "drift": dict(self._drift),
                "reference": dict(self.reference_meta) if self.reference
                else None,
                "worst": list(self._worst),
            }

    def fingerprints(self, trace_ids: Sequence[str]) -> Dict[str, str]:
        """Input fingerprints for the given trace ids (bundle evidence)."""
        with self._lock:
            return {t: self._fingerprints[t] for t in trace_ids
                    if t in self._fingerprints}


def _sketch_stats(q: QuantileSketch, h: HistogramSketch) -> Dict[str, object]:
    return {
        "count": q.count,
        "mean": None if q.mean is None else round(q.mean, 6),
        "p50": q.quantile(0.5),
        "p95": q.quantile(0.95),
        "min": None if q.count == 0 else round(q.min, 6),
        "max": None if q.count == 0 else round(q.max, 6),
        "overflow": q.overflow + h.overflow,
    }


class FleetQualityPlane:
    """Router-side rollup: per-replica quality summaries in, an EXACT
    fleet view out.  Sketch merge is associative (fixed shared grids),
    so merging replicas in health-poll arrival order is deterministic —
    the fleet distribution is the true union of every replica's sampled
    observations, not a resample.

    ``store`` is the shared fleet TSDB-lite (the capacity plane's
    SeriesStore): per-replica points land labeled, fleet aggregates land
    bare-named, so ``/debug/series`` and the capacity advisor's forecast
    table cover quality with zero new plumbing."""

    #: replica retention cap — fleets are small, but an unbounded
    #: name-keyed dict is exactly what obs-unbounded-series forbids
    MAX_REPLICAS = 256

    def __init__(self, *, store=None, registry=None, clock=None):
        self.store = store
        self.registry = registry
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._replica: Dict[str, Dict] = {}

    def ingest(self, replica: str, summary, *, t: Optional[float] = None):
        """One replica's ``/healthz`` quality summary (may be None — old
        replicas without the plane simply don't contribute)."""
        if not isinstance(summary, dict):
            return
        with self._lock:
            if (replica not in self._replica
                    and len(self._replica) >= self.MAX_REPLICAS):
                self._replica.pop(next(iter(self._replica)))
            self._replica[replica] = summary
        if self.store is not None:
            snap = {}
            signals = summary.get("signals") or {}
            for m in QUALITY_METRICS:
                if m in signals:
                    snap[f"quality_{m}"] = float(signals[m])
            drift = summary.get("drift") or {}
            if "max_ks" in drift:
                snap["quality_drift"] = float(drift["max_ks"])
            if snap:
                self.store.record_snapshot(
                    snap, t=t if t is not None else self._clock(),
                    labels={"replica": replica})

    def merged_sketches(self) -> Dict[str, Dict[str, object]]:
        """Exact fleet-wide sketches: deserialize every replica's pair
        and fold — associativity makes the fold order irrelevant."""
        with self._lock:
            replicas = {name: s.get("sketches") or {}
                        for name, s in self._replica.items()}
        fleet: Dict[str, Dict[str, object]] = {}
        for sketches in replicas.values():
            for metric, d in sketches.items():
                if metric not in METRIC_RANGES:
                    continue
                pair = fleet.get(metric)
                incoming_q = sketch_from_dict(d["quantile"])
                incoming_h = sketch_from_dict(d["hist"])
                if pair is None:
                    fleet[metric] = {"quantile": incoming_q,
                                     "hist": incoming_h}
                else:
                    pair["quantile"].merge(incoming_q)
                    pair["hist"].merge(incoming_h)
        return fleet

    def rollup(self, now: Optional[float] = None) -> Dict[str, object]:
        """Fold the latest replica summaries into fleet signals, record
        them as bare-named ``quality_*`` series, and export router-side
        gauges (the console's quality pane reads those)."""
        fleet = self.merged_sketches()
        signals = {}
        for metric, pair in fleet.items():
            mean = pair["quantile"].mean
            if mean is not None:
                signals[metric] = round(mean, 6)
        with self._lock:
            drift = max((float((s.get("drift") or {}).get("max_ks", 0.0))
                         for s in self._replica.values()), default=0.0)
            n_replicas = len(self._replica)
        out = {
            "replicas": n_replicas,
            "signals": signals,
            "drift": drift,
        }
        snap = {f"quality_{m}": v for m, v in signals.items()}
        snap["quality_drift"] = drift
        if self.store is not None and snap:
            self.store.record_snapshot(
                snap, t=now if now is not None else self._clock())
        if self.registry is not None:
            for name, v in snap.items():
                self.registry.gauge(name, help="fleet quality rollup").set(v)
        return out

    def payload(self) -> Dict[str, object]:
        """``/quality`` on the router: the exact fleet view plus each
        replica's compact summary."""
        fleet = self.merged_sketches()
        stats = {m: _sketch_stats(p["quantile"], p["hist"])
                 for m, p in fleet.items()}
        roll = self.rollup()
        with self._lock:
            per_replica = {
                name: {"signals": s.get("signals"), "drift": s.get("drift"),
                       "observed": s.get("observed"),
                       "sampled": s.get("sampled")}
                for name, s in self._replica.items()
            }
        return {
            "role": "router",
            "fleet": {**roll, "metrics": stats,
                      "sketches": {m: {"quantile": p["quantile"].to_dict(),
                                       "hist": p["hist"].to_dict()}
                                   for m, p in fleet.items()}},
            "replicas": per_replica,
        }
