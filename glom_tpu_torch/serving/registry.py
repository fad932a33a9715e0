"""Model registry: named models and versions resident at once, the port's
counterpart of ``glom_tpu/serving/registry.py``.

One :class:`~glom_tpu_torch.serving.engine.ServingEngine` serves the
``default`` model's ``primary`` record.  A deploy candidate
(:mod:`glom_tpu_torch.serving.deploy`) is a second resident version of the
same model; an extra model (another checkpoint, another config) is a record
under its own name.  The registry keeps:

  * **residency** -- each :class:`ModelVersion` names a ``(model, step)`` and
    holds its :class:`~glom_tpu_torch.serving.engine.ServingSet` (its
    parameters on the card and the CUDA graphs captured against them) as
    ``caches``; ``max_versions_per_model`` bounds how many sets a model keeps;
  * **lineage** -- each model's checkpoint directory, the newest step that
    verifies there (``integrity.latest_valid_step``, read without
    quarantining), the resident steps and the recent transitions.

**What ``aliased`` means here.**  In ``glom_tpu`` parameters are arguments of
the AOT executables, so two versions whose :func:`cache_signature` matches
share one set of executables and the second costs no compile.  A CUDA graph
holds the addresses of the tensors it was captured with, the parameters
among them, so a graph cannot serve another tree.  Here :meth:`find_alias`
still decides that two versions are one program: the same signature means
the same graph functions (one config, quant mode, bucket ladder and
iteration count; the kernels are built once a process from the checkout's
sources, so the nvcc build is the same for every version), and an aliased
version reuses its alias's :class:`~glom_tpu_torch.serving.engine.ServingProgram`.
Each version still gets graphs of its own, captured against its own
parameters off the request path, at the cost of its parameters and one pool
a graph family on the card.  ``summary()["cache_aliased"]`` keeps
``glom_tpu``'s value for the same sequence of calls, so the two registries'
snapshots compare field for field.

Host-side bookkeeping only; injectable clock; every mutation is serialized
under one lock and reads return snapshots.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from glom_tpu_torch.obs.registry import MetricRegistry

#: the engine's own model name in its registry
DEFAULT_MODEL = "default"

ROLES = ("primary", "candidate", "resident")


def cache_signature(config, quant: str, buckets, *, iters=None,
                    mesh_axes: Optional[dict] = None) -> Tuple:
    """The program-identity key, ``glom_tpu``'s tuple (its last field the
    mesh's axes, empty on one rank): two versions with equal signatures run
    the same graph functions."""
    return (
        tuple(sorted(config.to_json_dict().items(), key=lambda kv: kv[0])),
        str(quant),
        tuple(int(b) for b in buckets),
        None if iters is None else int(iters),
        tuple(sorted((mesh_axes or {}).items())),
    )


@dataclass
class ModelVersion:
    """One resident ``(model, step)``: its serving set (parameters and
    graphs) and the program the graphs were captured from."""

    model: str
    step: int
    quant: str
    caches: Any                      # ServingSet: parameters + graph caches
    config: Any                      # GlomConfig the parameters serve under
    train_cfg: Any = None
    signature: Tuple = ()
    source_dir: Optional[str] = None
    role: str = "resident"
    aliased: bool = False            # the same program as another version
    loaded_at: float = 0.0
    program: Any = None              # ServingProgram (shared when aliased)

    @property
    def params(self):
        return self.caches.params

    def summary(self) -> dict:
        return {
            "model": self.model,
            "step": int(self.step),
            "quant": self.quant,
            "role": self.role,
            "cache_aliased": bool(self.aliased),
            # the quality post-pass is a family, not an endpoint (glom_tpu
            # keeps it beside the endpoint caches)
            "endpoints": sorted(k for k in self.caches.caches if k != "quality"),
            "loaded_at": round(self.loaded_at, 3),
        }


class ModelRegistry:
    """Residency and lineage of every loaded ``(model, step)``.

    The engine registers its start-up set as ``(DEFAULT_MODEL, step,
    role="primary")`` and re-anchors it on every swap (:meth:`sync_primary`);
    the deploy controller adds and retires ``role="candidate"`` records;
    extra models register under their own names."""

    def __init__(self, *, registry: Optional[MetricRegistry] = None, clock=None,
                 max_versions_per_model: int = 3, history: int = 32):
        self.metrics = registry if registry is not None else MetricRegistry()
        self._clock = clock if clock is not None else time.monotonic
        if max_versions_per_model < 2:
            # a primary and one candidate is the least a deploy needs
            raise ValueError(
                f"max_versions_per_model must be >= 2, got {max_versions_per_model}")
        self.max_versions_per_model = max_versions_per_model
        self._lock = threading.Lock()
        self._versions: Dict[Tuple[str, int], ModelVersion] = {}
        self._dirs: Dict[str, str] = {}      # model -> checkpoint dir
        self._history: "deque" = deque(maxlen=history)

    # -- residency ---------------------------------------------------------
    def register(self, model: str, step: int, *, caches, config, quant: str,
                 signature: Tuple = (), train_cfg=None, source_dir: Optional[str] = None,
                 role: str = "resident", aliased: bool = False,
                 program=None) -> ModelVersion:
        if role not in ROLES:
            raise ValueError(f"unknown role {role!r}; one of {ROLES}")
        step = int(step)
        with self._lock:
            key = (model, step)
            if key in self._versions:
                raise ValueError(f"{model}@{step} is already resident")
            mine = [v for v in self._versions.values() if v.model == model]
            if len(mine) >= self.max_versions_per_model:
                raise ValueError(
                    f"model {model!r} already holds {len(mine)} resident versions (max "
                    f"{self.max_versions_per_model}); retire one first — each version is "
                    f"a full set of parameters and graphs on the card")
            if role == "primary":
                for v in mine:
                    if v.role == "primary":
                        raise ValueError(f"{model} already has primary @{v.step}; use "
                                         f"promote()/sync_primary()")
            version = ModelVersion(
                model=model, step=step, quant=quant, caches=caches, config=config,
                train_cfg=train_cfg, signature=signature, source_dir=source_dir, role=role,
                aliased=aliased, loaded_at=self._clock(), program=program)
            self._versions[key] = version
            if source_dir:
                self._dirs.setdefault(model, source_dir)
            self._note("register", model, step, role=role, aliased=aliased)
        self._gauges()
        if aliased:
            self.metrics.counter(
                "registry_cache_alias_total",
                help="resident versions of another version's program (graphs of their own)",
            ).inc()
        return version

    def find_alias(self, model: str, signature: Tuple) -> Optional[ModelVersion]:
        """A resident version of ``model`` with the same signature: a new
        version may reuse its program."""
        with self._lock:
            for v in self._versions.values():
                if v.model == model and v.signature == signature:
                    return v
        return None

    def get(self, model: str, step: Optional[int] = None) -> Optional[ModelVersion]:
        """``step=None``: the model's primary."""
        with self._lock:
            if step is not None:
                return self._versions.get((model, int(step)))
            for v in self._versions.values():
                if v.model == model and v.role == "primary":
                    return v
        return None

    def versions(self, model: Optional[str] = None) -> List[ModelVersion]:
        with self._lock:
            out = [v for v in self._versions.values() if model is None or v.model == model]
        return sorted(out, key=lambda v: (v.model, v.step))

    def models(self) -> List[str]:
        with self._lock:
            return sorted({v.model for v in self._versions.values()})

    def remove(self, model: str, step: int) -> bool:
        """Retire one resident version; its set (parameters, graphs and their
        pools) is freed when the last batch that read it completes."""
        with self._lock:
            version = self._versions.pop((model, int(step)), None)
            if version is not None:
                self._note("retire", model, int(step), role=version.role)
        self._gauges()
        return version is not None

    # -- primary transitions ----------------------------------------------
    def promote(self, model: str, step: int) -> ModelVersion:
        """The resident ``(model, step)`` becomes primary; the displaced
        primary's record is retired (the engine keeps its own rollback
        point)."""
        with self._lock:
            version = self._versions.get((model, int(step)))
            if version is None:
                raise KeyError(f"{model}@{step} is not resident")
            for v in list(self._versions.values()):
                if v.model == model and v.role == "primary":
                    del self._versions[(model, v.step)]
                    self._note("retire", model, v.step, role="displaced")
            version.role = "primary"
            self._note("promote", model, int(step))
        self._gauges()
        return version

    def sync_primary(self, model: str, step: int, caches, *, source: str = "reload") -> None:
        """Every swap of the engine (hot reload, staged commit, promote,
        rollback) re-anchors the primary record on the set now serving.  A
        swap to a step already resident (a promoted candidate) adopts that
        record; otherwise the primary record takes the new step and set (a
        reload captured new graphs: a graph cannot serve new parameters)."""
        step = int(step)
        with self._lock:
            old = None
            for v in list(self._versions.values()):
                if v.model == model and v.role == "primary":
                    old = v
                    del self._versions[(model, v.step)]
            existing = self._versions.get((model, step))
            if existing is not None:
                existing.role = "primary"
                existing.caches = caches
            elif old is not None:
                old.step = step
                old.caches = caches
                old.loaded_at = self._clock()
                self._versions[(model, step)] = old
            self._note("sync_primary", model, step, source=source)
        self._gauges()

    # -- lineage -----------------------------------------------------------
    def lineage(self, model: str) -> dict:
        """The model's checkpoint lineage: the newest step that verifies in
        its directory (a read-only scan), the resident steps and the recent
        transitions."""
        from glom_tpu_torch.resilience import integrity

        with self._lock:
            source_dir = self._dirs.get(model)
            resident = sorted(v.step for v in self._versions.values() if v.model == model)
            primary = next((v.step for v in self._versions.values()
                            if v.model == model and v.role == "primary"), None)
            history = [h for h in self._history if h["model"] == model]
        latest_valid = None
        if source_dir:
            # a lineage read must not mutate the directory: quarantine stays
            # the watcher's call
            latest_valid = integrity.latest_valid_step(source_dir, quarantine_corrupt=False)
        return {
            "model": model,
            "checkpoint_dir": source_dir,
            "latest_valid_step": latest_valid,
            "primary_step": primary,
            "resident_steps": resident,
            "history": history,
        }

    # -- views -------------------------------------------------------------
    def snapshot(self) -> dict:
        """The ``/healthz`` ``models`` block."""
        with self._lock:
            versions = [v.summary() for v in self._versions.values()]
        versions.sort(key=lambda s: (s["model"], s["step"]))
        return {"resident": versions, "models": sorted({s["model"] for s in versions})}

    def _note(self, event: str, model: str, step: int, **fields) -> None:
        # the caller holds the lock
        self._history.append({"event": event, "model": model, "step": int(step),
                              "t": round(self._clock(), 6), **fields})

    def _gauges(self) -> None:
        with self._lock:
            by_model: Dict[str, int] = {}
            for v in self._versions.values():
                by_model[v.model] = by_model.get(v.model, 0) + 1
            total = len(self._versions)
        self.metrics.gauge(
            "registry_resident_versions",
            help="model versions resident (each a full set of parameters and graphs)",
        ).set(total)
        for model, count in by_model.items():
            self.metrics.gauge(self.metrics.labeled("registry_resident_versions_", model),
                               help="resident versions of one model").set(count)


def load_version(model: str, checkpoint_dir: str, *, buckets=(1, 2, 4, 8), quant: str = "f32",
                 iters: Optional[int] = None, step: Optional[int] = None, warmup: bool = True,
                 models: Optional[ModelRegistry] = None, role: str = "resident",
                 device=None, lock=None) -> ModelVersion:
    """Load ``(model, step)`` from a trainer checkpoint directory into a
    servable :class:`ModelVersion`: its parameters placed (quantized under a
    reduced mode) and its graph families (``embed``, ``reconstruct``,
    ``index`` and ``/parse``'s pack) captured against them unless
    ``warmup=False``.  ``step=None`` takes the newest step that verifies.
    With ``models``, a resident version of the same signature lends its
    program (``aliased``) and the new version is registered.  ``lock`` is the
    serving engine's :class:`~glom_tpu_torch.serving.compile_cache.DeviceLock`
    (its captures must not overlap the engine's replays)."""
    from glom_tpu_torch.config import resolve_device
    from glom_tpu_torch.serving.engine import ServingProgram, load_params

    device = resolve_device(device)
    loaded_step, config, train_cfg, params = load_params(checkpoint_dir, step, quant, device)
    signature = cache_signature(config, quant, buckets, iters=iters)
    alias = models.find_alias(model, signature) if models is not None else None
    if alias is not None:
        program, aliased = alias.program, True
    else:
        program = ServingProgram(config, train_cfg, quant=quant, buckets=buckets, iters=iters,
                                 device=device, lock=lock)
        aliased = False
    serving = program.make(loaded_step, params, quality=False)
    if warmup:
        program.warm(serving)
    version_kwargs = dict(caches=serving, config=program.serve_config, train_cfg=train_cfg,
                          signature=signature, source_dir=checkpoint_dir, role=role,
                          aliased=aliased, quant=quant, program=program)
    if models is not None:
        return models.register(model, loaded_step, **version_kwargs)
    return ModelVersion(model=model, step=int(loaded_step), loaded_at=0.0, **version_kwargs)
