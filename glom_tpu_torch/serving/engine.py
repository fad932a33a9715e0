"""Serving engine: model lifecycle and batched execution
(``glom_tpu/serving/engine.py``, its single-replica path).

request -> :class:`~glom_tpu_torch.serving.batcher.DynamicBatcher` (one per
endpoint) -> worker thread -> the batch padded to its bucket and replayed as
that bucket's CUDA graph
(:class:`~glom_tpu_torch.serving.compile_cache.BucketedGraphCache`; eager on
the CPU) -> per-request slices on the callers' futures.

* ``embed``: ``mean(apply(imgs), over patches)`` -> ``(k, L, d)``, the
  per-level embeddings.
* ``reconstruct``: the state after the training loss timestep
  (``resolve_loss_timestep``) decoded through the trained head ->
  ``(k, c, H, W)``.  The forward stops at that timestep: the iterations
  after it would not change the answer.
* ``parse``: one packed islanding row an image
  (``hierarchy/parse.py::parse_row_width`` columns).

The engine loads the newest valid checkpoint of a directory written by
either package and serves it with the kernel choice the checkpoint recorded
(``ff_impl`` / ``attention_impl``), as ``glom_tpu``'s engine does; an
explicit ``ff_impl`` or ``attention_impl`` overrides it (the weights are the
same either way), and ``"pallas"`` picks the hand-written CUDA kernels.
``ff_impl="fused"`` serves each iteration as one call of the fused
level-update kernels where the model's shape allows it
(``models/glom.py::fused_update_supported``), and falls back to the
grouped-FF and consensus kernels where it does not.  The step's functions
and the locality mask are resolved once, here, outside every graph.

Model lifecycle:

  * **warm-up** -- :meth:`ServingEngine.warm` (run by the constructor unless
    ``warmup=False``) captures every (endpoint, bucket) pair as a CUDA graph,
    so no request captures; ``serving_warmup_seconds`` records how long it
    took, and ``serving_graph_captures`` counts captures the request path
    made (``serving_xla_compiles`` in ``glom_tpu``; 0 after warm-up);
  * **hot reload** -- a watcher polls for a newer valid step every
    ``reload_poll_s``; the new weights are restored, a new graph set is
    captured against them off the request path, and ``(step, params,
    graphs)`` is swapped in with one reference assignment.  In-flight
    batches hold the old set and finish on it; it is freed when no replay
    holds it.  A reload that fails warns, counts ``serving_reload_failures``
    and keeps serving the old set;
  * **staged reload** -- :meth:`ServingEngine.stage_reload` /
    :meth:`commit_staged` / :meth:`abort_staged` / :meth:`finalize_reload`
    / :meth:`rollback` (``/admin/reload/*``), ``glom_tpu``'s two-phase
    fleet primitive;
  * **drain** -- :meth:`ServingEngine.shutdown` with ``drain=True`` stops
    admission, lets queued work flush and joins the workers.

Observability is ``glom_tpu``'s, through the port's copies of its obs
modules: the registry's ``serving_*`` families (the server's ``/metrics``),
a trace per request (the server mints the root span; the batcher, the engine
and the graph cache record ``queue_wait``, ``batch_assembly``,
``bucket_select``, ``pad`` and ``execute`` under it; ``reload_swap`` times a
swap; ``trace_log`` writes one JSONL record per completed trace), a
per-endpoint :class:`~glom_tpu_torch.obs.triggers.QueueSaturationMonitor`
(``serving_queue_saturation_events``, and an event on the timeline), and
declarative SLOs (``slos``) with burn-rate alerting.

Forensics (``glom_tpu``'s, through :mod:`glom_tpu_torch.obs.forensics`):

  * ``forensics_dir``: the triggers shared by the engine write post-mortem
    bundles there, each through the one debounced, budgeted
    :class:`~glom_tpu_torch.obs.triggers.TriggerEngine`: overload
    (``queue_saturation``), ``slo_burn``, ``quality_drift``,
    ``capacity_pressure`` (the three regression-class ones with the
    attribution plane's verdict as ``attribution.json``),
    ``deploy_rollback`` and ``ckpt_corrupt`` (a quarantine at load, reload
    or a candidate's load).  A bundle's snapshot is the largest ``/embed``
    bucket's graph record (``serving/compile_cache.py``): what one replay
    launches, its analytic cost and its memory, read without a capture or
    a replay.  ``/debug/forensics`` lists the bundles;
  * ``warmup_dir``: at start-up, one bundle a (family, bucket) with that
    graph's record.

Serving at reduced precision, per tenant and with state:

  * ``quant`` (``f32`` | ``bf16`` | ``int8``; :mod:`.quant`): the tree is
    quantized on the host and placed once; the int8 dequant runs inside
    every graph, so every weight reaches the kernels as bf16; a reload
    re-quantizes the new tree before its graphs are captured;
  * ``tenant_quotas``: per-tenant token buckets (``X-Tenant``) in front of
    every endpoint, the session and ``/similar`` paths included;
  * ``warm_iters``: stateful sessions (``/session/embed``,
    ``/session/parse``, ``/session/reset``; :mod:`.sessions`).  Two more
    graph families, ``session_cold`` (the full settle from the init state,
    returning the state) and ``session_warm`` (``warm_iters`` iterations
    from the carried state), whose new state is copied out of the graph
    into storage the store owns before the bucket's next replay.  The state
    stays on the card between frames; ``session_spill_dir`` spills it on
    drain (float32) and restores it at start-up;
  * the part-whole endpoints: ``/parse`` is the ``index`` family's forward
    followed by the islanding pack, captured as a graph of its own per
    bucket (:class:`~glom_tpu_torch.serving.compile_cache.PostPassCache`;
    ``parse_thresholds``); ``/similar`` embeds through the ``index`` family
    and scans ``index_dir``'s level index; ``/session/parse`` runs the pack
    on a session's carried state, at its dtype.

Several models and safe deploys:

  * ``models`` (:mod:`.registry`): every servable ``(model, step)`` is a
    record; the start-up set is the default model's primary, re-anchored by
    every swap (hot reload, staged commit, promote, rollback), and each of
    ``extra_models`` (``{name: checkpoint dir}``) is a primary of its own,
    loaded with its own config into a set of its own (a request names it in
    its ``model`` field);
  * ``deploy`` (:mod:`.deploy`): shadow / canary / promote / rollback of a
    newer checkpoint of the default model (``deploy_*``).  The candidate's
    set is captured off the request path from the engine's program against
    its own parameters.  A flushed batch runs as one group per ``mkey``:
    the primary's, the canary's (the candidate's graphs; a retired
    candidate's items fall back to the primary) and each extra model's,
    each padded to its own bucket; the primary's answers are mirrored to the
    shadow after its futures resolve.  A session with state stays on the
    version that computed it, and restarts cold (``version_retired``) when
    that candidate was retired.

The capacity and quality planes (``glom_tpu``'s, through the port's copies
of its obs modules):

  * ``capacity`` (:class:`~glom_tpu_torch.obs.capacity.CapacityPlane`): a
    series store sampled from the registry, the ``capacity_*`` signals
    (duty cycle = execute-span time over wall time, shed ratio, queue depth,
    p95, padding waste per bucket, tenant headroom) and a dry-run advisor
    over ``capacity_policy``; a scale-up that persists
    ``capacity_persist_windows`` windows fires ``capacity_pressure``
    (counted, and a bundle with a ``forensics_dir``).  Utilization needs
    ``capacity_ceiling``: the port never reads a ``BENCH_*.json`` of the
    repository (a TPU's rate) in its place.  Nothing samples until
    :meth:`CapacityPlane.tick` is driven or its timer thread started (the
    server's ``main`` starts it); the thread reads the registry only, never
    the device;
  * ``quality`` (:class:`~glom_tpu_torch.obs.quality.QualityPlane`): with
    ``quality_sample > 0`` every set carries one more graph family,
    ``quality`` (:func:`~glom_tpu_torch.obs.quality.make_quality_fn`: the
    forward, agreement, entropy and norms of the final levels, and the
    decoder's residual), captured with the others.  After a primary group's
    futures resolve, a credit sampler (``quality_sample``, ``quality_seed``)
    decides whether the batch replays it; each request's rows feed the
    sketches, the drift against ``quality_ref.json`` and the quality SLOs.
    A post-pass that raises is counted (``quality_post_pass_failures``) and
    answered by nothing else.  ``quality_sample <= 0`` builds no family.

The bulk tier (:mod:`.bulk`; ``bulk_dir``): scavenger-class offline jobs
over a durable job store.  The runner adopts every unfinished job of the
store at construction (resume after a kill needs no operator), fills the
padding rows of a primary group's bucket with bulk slots (the online rows
first; the futures, the shadow mirror, the quality sampler and the
accounting see only theirs), and replays whole buckets from its own thread
while no batcher holds a queued image.  Either way the bulk rows go through
the same cache call as online rows: the graphs captured at start-up, never
a new capture.  ``/admin/jobs/*`` drives it; ``/healthz`` carries its
summary as ``bulk``.

A mesh of ranks (:mod:`.sharded`; ``mesh_shape``, ``param_sharding``,
``mesh_axis_names``): the engine is one rank of a ``torch.distributed``
world of ``prod(mesh_shape)`` processes, each holding its shard of the
parameters (placed by ``glom_tpu``'s rules, at start-up and at every reload
alike) and computing its rows of every bucket on the hand kernels.  Rank 0
leads: it alone serves, and announces each cache call, load and drop to the
followers, which run :meth:`ServingEngine.follow`.  A pure-DP mesh replays
each rank's graphs; a forward with collectives inside (TP, EP, seq) runs
eagerly, and ``/healthz`` and the snapshots say why.  Above one rank,
sessions, extra models, the bulk tier, ``/similar``'s index and deploys are
refused by name (``sharded.ITEM_1B``).

The one argument of ``glom_tpu``'s engine that means nothing to a CUDA graph
(buffer donation) is refused by name when set: :data:`UNPORTED`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
import warnings
import weakref
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from glom_tpu_torch import checkpoint as ckpt_lib
from glom_tpu_torch import profiling
from glom_tpu_torch.config import GlomConfig, TrainConfig, resolve_device
from glom_tpu_torch.hierarchy import parse as hierarchy_parse
from glom_tpu_torch.kernels import _build, consensus, ff, fused_update
from glom_tpu_torch.models import glom as glom_model
from glom_tpu_torch.models.heads import decoder_apply, decoder_param_shapes
from glom_tpu_torch.obs import attribution as obs_attribution
from glom_tpu_torch.obs.capacity import DEFAULT_POLICY, CapacityPlane
from glom_tpu_torch.obs.events import Timeline
from glom_tpu_torch.obs.forensics import MANIFEST, ForensicsManager, is_bundle_dir, write_bundle
from glom_tpu_torch.obs.quality import QualityPlane, make_quality_fn, unpack_signals
from glom_tpu_torch.obs.registry import MetricRegistry
from glom_tpu_torch.obs.slo import SLO, SloManager, parse_slo
from glom_tpu_torch.obs.tracing import SPAN_BATCH_ASSEMBLY, SPAN_RELOAD, TraceSink, Tracer
from glom_tpu_torch.obs.triggers import (
    TRIGGER_QUEUE_SATURATION,
    QueueSaturationMonitor,
    TriggerEngine,
)
from glom_tpu_torch.parallel import mesh as mesh_lib
from glom_tpu_torch.parallel.placement import shard_tree
from glom_tpu_torch.resilience import faultinject, integrity
from glom_tpu_torch.serving import quant as serving_quant
from glom_tpu_torch.serving import sessions as serving_sessions
from glom_tpu_torch.serving import sharded
from glom_tpu_torch.serving.batcher import (  # noqa: F401
    Closed,
    DynamicBatcher,
    Overloaded,
    TenantAdmission,
    TenantQuotaExceeded,
)
from glom_tpu_torch.serving.compile_cache import (
    BucketedGraphCache,
    DeviceLock,
    PostPassCache,
)
from glom_tpu_torch.training import denoise

ENDPOINTS = ("embed", "reconstruct", "parse")
# endpoints an SLO may target: the batched three, and the session and
# similarity paths, which have no batcher but report their outcomes alike
SLO_ENDPOINTS = ENDPOINTS + ("session", "similar")

# glom_tpu's demo model (glom_tpu/serving/engine.py::DEMO_CONFIG): the kernels
# take its width (16) through their wrappers' padding.
DEMO_CONFIG = GlomConfig(dim=16, levels=3, image_size=16, patch_size=8)

# glom_tpu's engine arguments this port does not take: name -> (the value that
# leaves it unset, why).  Any other value is refused.
UNPORTED = {
    "donate_inputs": (None, "an XLA buffer donation; a graph's static input is reused as it is"),
}


# what a mesh above one rank does not carry yet, by the argument or call that
# asks for it
MESH_REFUSED = {
    "warm_iters": "stateful sessions",
    "extra_models": "extra registry models",
    "bulk_dir": "the bulk tier",
    "index_dir": "/similar's level index",
    "deploy": "deploys (begin_shadow and the canary)",
}


def refuse_on_mesh(name: str, ranks: int) -> None:
    """Raise for a :data:`MESH_REFUSED` feature on a mesh of ``ranks`` > 1."""
    if ranks > 1:
        raise NotImplementedError(
            f"{name} ({MESH_REFUSED[name]}) on a mesh of {ranks} ranks is not in the port yet: "
            f"the leader's dispatch does not carry it ({sharded.ITEM_1B})")


def refuse_unported(args: dict) -> None:
    """Raise for an unknown argument, and for one of :data:`UNPORTED` set to
    anything but its unset value, naming what it waits for."""
    for name, value in args.items():
        if name not in UNPORTED:
            raise TypeError(f"ServingEngine() got an unexpected keyword argument {name!r}")
        unset, needs = UNPORTED[name]
        if value != unset:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet: it needs {needs}")


def demo_params(config: GlomConfig, train: TrainConfig, seed: int = 0) -> dict:
    """Seeded numpy weights for a trainer checkpoint's ``params`` tree, drawn
    as torch's default inits draw them (uniform ``1/sqrt(fan_in)`` bounds,
    standard normal embeddings)."""
    rng = np.random.default_rng(seed)
    c = config

    def unif(shape, fan_in):
        bound = fan_in ** -0.5
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    def linear(fan_in, fan_out):
        return {"w": unif((fan_in, fan_out), fan_in), "b": unif((fan_out,), fan_in)}

    def ff(groups):
        h = c.dim * c.ff_mult
        return {"w1": unif((groups, c.dim, h), c.dim), "b1": unif((groups, h), c.dim),
                "w2": unif((groups, h, c.dim), h), "b2": unif((groups, c.dim), h)}

    glom = {
        "patch_embed": linear(c.patch_dim, c.dim),
        "pos_emb": rng.standard_normal((c.num_patches, c.dim), dtype=np.float32),
        "init_levels": rng.standard_normal((c.levels, c.dim), dtype=np.float32),
        "bottom_up": ff(c.levels),
        "top_down": ff(c.levels - 1),
    }
    shapes = decoder_param_shapes(c, arch=train.decoder, hidden_mult=train.decoder_hidden_mult)
    if "w" in shapes:
        decoder = linear(*shapes["w"])
    else:
        l1, l2 = linear(*shapes["w1"]), linear(*shapes["w2"])
        decoder = {"w1": l1["w"], "b1": l1["b"], "w2": l2["w"], "b2": l2["b"]}
    return {"glom": glom, "decoder": decoder}


def make_demo_checkpoint(directory: str, *, config: Optional[GlomConfig] = None,
                         train: Optional[TrainConfig] = None, seed: int = 0,
                         step: int = 0) -> int:
    """Write an untrained, servable checkpoint (``step``, default 0) with
    seeded numpy weights, in the Trainer's layout (``config.json`` + npz +
    integrity record + manifest), which ``glom_tpu`` also reads.  A later
    ``step`` with another ``seed`` is what a running server hot-reloads.
    Returns the step."""
    config = config if config is not None else DEMO_CONFIG
    train = train if train is not None else TrainConfig(batch_size=2, steps=0)
    ckpt_lib.write_json(directory, "config.json",
                        {"glom": config.to_json_dict(), "train": train.to_json_dict()})
    ckpt_lib.save(directory, step, {"params": demo_params(config, train, seed)})
    return step


def kernel_launches() -> Dict[str, int]:
    """Launch counts of the CUDA kernels, process-wide."""
    return {"grouped_ff": ff.grouped_ff.launches,
            "consensus_attention": consensus.consensus_attention.launches,
            "fused_level_update": fused_update.fused_level_update.launches}




def make_embed_fn(config: GlomConfig, iters: int, step_fns, *, apply_fn=None):
    """``(params, imgs) -> (b, L, d)`` float32: the mean over patches of the
    forward after ``iters`` iterations, every level computed (the endpoint
    slices one on the host).  ``apply_fn`` stands for ``models/glom.py::apply``
    (a seq rank's: ``sharded.make_sharded_apply``)."""
    consensus_fn, ff_fn, fused_fn = step_fns
    apply_fn = apply_fn or glom_model.apply

    def f(params, imgs):
        out = apply_fn(params["glom"], imgs, config=config, iters=iters,
                       consensus_fn=consensus_fn, ff_fn=ff_fn, fused_fn=fused_fn)
        return out.mean(dim=1).float()

    return f


def make_reconstruct_fn(config: GlomConfig, train_cfg: TrainConfig, timestep: int, step_fns,
                        *, apply_fn=None):
    """``(params, imgs) -> (b, c, H, W)`` float32: the state after the
    training loss timestep, decoded through the trained head."""
    consensus_fn, ff_fn, fused_fn = step_fns
    apply_fn = apply_fn or glom_model.apply

    def f(params, imgs):
        state = apply_fn(params["glom"], imgs, config=config, iters=timestep,
                         consensus_fn=consensus_fn, ff_fn=ff_fn, fused_fn=fused_fn)
        return decoder_apply(params["decoder"], state, config, arch=train_cfg.decoder,
                             level=train_cfg.loss_level).float()

    return f


def make_session_fns(config: GlomConfig, cold_iters: int, warm_iters: int, step_fns):
    """The two forwards of a stateful session, ``models/video.py``'s carried
    levels split in two: ``cold(params, imgs) -> (emb, levels)``, the full
    settle from the init state at ``cold_iters`` (a session's first frame, or
    a restart), and ``warm(params, imgs, levels) -> (emb, levels)``,
    ``warm_iters`` iterations from the previous frame's state.  ``emb`` is
    the float32 mean over patches; ``levels`` the new state in the compute
    dtype.  Chained, they are ``video.rollout_varied`` with the schedule
    ``[cold_iters, warm_iters, ...]``."""
    consensus_fn, ff_fn, fused_fn = step_fns

    def cold(params, imgs):
        levels = glom_model.apply(params["glom"], imgs, config=config, iters=cold_iters,
                                  consensus_fn=consensus_fn, ff_fn=ff_fn, fused_fn=fused_fn)
        return levels.mean(dim=1).float(), levels

    def warm(params, imgs, levels):
        new = glom_model.apply(params["glom"], imgs, config=config, iters=warm_iters,
                               levels=levels, consensus_fn=consensus_fn, ff_fn=ff_fn,
                               fused_fn=fused_fn)
        return new.mean(dim=1).float(), new

    return cold, warm


@dataclasses.dataclass(frozen=True)
class ServingSet:
    """What serves: a checkpoint's step, its parameters on the device (the
    quantized tree under ``quant``), and the graph caches captured against
    them: one per endpoint, ``index`` (the ``/similar`` forward, and
    ``parse``'s inner forward), with sessions ``session_cold`` and
    ``session_warm``, and with quality sampling ``quality`` (the post-pass of
    a sampled batch).  Swapped as one reference."""
    step: int
    params: dict
    caches: Dict[str, Union[BucketedGraphCache, PostPassCache]]


def load_params(checkpoint_dir: str, step: Optional[int], quant: str, device, *,
                observer=None):
    """``(step, config, train_cfg, params)`` of a checkpoint: on ``device``
    under ``f32``, on the host under a reduced mode (quantized there, then
    placed once by :meth:`ServingProgram.make`)."""
    load_device = device if quant == "f32" else torch.device("cpu")
    return denoise.load_checkpoint_state(checkpoint_dir, step=step, device=load_device,
                                         observer=observer)


class ServingProgram:
    """What a :class:`ServingSet` is captured from: the graph functions of one
    model config, quant mode, bucket ladder and iteration counts (one
    ``registry.cache_signature``).  :meth:`make` places a parameter tree and
    builds its caches, :meth:`warm` captures them.  The engine's primary, a
    deploy candidate and every reload build their sets from the engine's
    program; ``registry.load_version`` builds an extra model's from its own.

    ``config`` is the checkpoint's config (with the engine's kernel
    overrides); ``warm_iters`` (an int, or None) adds the session families
    ``session_cold`` and ``session_warm``; ``quality_sample > 0`` the
    ``quality`` family (the sets :meth:`make` builds with ``quality=True``).
    On a card, the kernels the config runs are built here, before any
    request.

    On a mesh of ranks (``mesh``, above one rank; ``dispatch`` is its
    :class:`~glom_tpu_torch.serving.sharded.MeshDispatch`) the forwards are
    this rank's: the step functions of ``sharded.resolve_sharded_kernels``,
    the seq rank's columns (``sharded.make_sharded_apply``), and
    :meth:`make` places this rank's shard of the tree by ``specs``
    (``sharded.param_shardings``).  ``mesh_axes`` labels the snapshots (a mesh
    of one rank included)."""

    def __init__(self, config: GlomConfig, train_cfg: TrainConfig, *, quant: str, buckets,
                 iters: Optional[int], device, lock: Optional[DeviceLock] = None,
                 warm_iters: Optional[int] = None, parse_thresholds=None,
                 quality_sample: float = 0.0, mesh=None, param_sharding: str = "replicated",
                 axis_names=mesh_lib.DEFAULT_AXES, dispatch=None):
        if quant not in serving_quant.QUANT_MODES:
            raise ValueError(f"unknown quant mode {quant!r}; one of {serving_quant.QUANT_MODES}")
        self.quant = quant
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        self.device = torch.device(device)
        self.lock = lock if lock is not None else DeviceLock()
        # the config the forwards run: bf16 compute under a reduced mode
        self.serve_config = c = serving_quant.serving_config(config, quant)
        self.mesh_axes = sharded.mesh_axes_dict(mesh)
        self.param_sharding = param_sharding
        self.mesh = mesh if mesh is not None and mesh.world_size > 1 else None
        self.dispatch = dispatch
        self.specs = None            # the spec tree, from the first tree placed
        self._model_axis = axis_names[1]
        self.eager_reason = None
        # resolved once, outside every graph: the step's functions and the
        # locality mask on the device
        apply_fn = glom_model.apply
        if self.mesh is None:
            self.step_fns = glom_model.resolve_step_fns(c, self.device)
        else:
            data_axis, model_axis, seq_axis = axis_names
            self.step_fns = sharded.resolve_sharded_kernels(
                self.mesh, c, self.device, param_sharding=param_sharding, data_axis=data_axis,
                model_axis=model_axis, seq_axis=seq_axis)
            apply_fn = sharded.make_sharded_apply(self.mesh, c, seq_axis)
            self.eager_reason = sharded.eager_reason(self.mesh, param_sharding,
                                                     model_axis=model_axis, seq_axis=seq_axis)
        consensus_fn, ff_fn, fused_fn = self.step_fns
        self.embed_iters = iters if iters is not None else config.default_iters
        recon_iters = iters if iters is not None else (
            train_cfg.iters if train_cfg.iters is not None else config.default_iters)
        self.reconstruct_timestep = denoise.resolve_loss_timestep(train_cfg, recon_iters)
        # the state every stateful path carries: the compute dtype, (n, L, d)
        self.state_dtype = c.resolved_compute_dtype
        self.state_tail = (c.num_patches, c.levels, c.dim)
        self.parse_thresholds = hierarchy_parse.parse_thresholds(parse_thresholds, c.levels)
        self.pack_fn = hierarchy_parse.make_pack_fn(c, self.parse_thresholds)
        fns = {
            "embed": make_embed_fn(c, self.embed_iters, self.step_fns, apply_fn=apply_fn),
            "reconstruct": make_reconstruct_fn(c, train_cfg, self.reconstruct_timestep,
                                               self.step_fns, apply_fn=apply_fn),
            "index": hierarchy_parse.make_index_fn(c, self.embed_iters, ff_fn=ff_fn,
                                                   fused_fn=fused_fn, consensus_fn=consensus_fn,
                                                   apply_fn=apply_fn),
        }
        self.session_cold_iters = int(self.embed_iters)
        self.session_warm_iters = warm_iters
        if warm_iters is not None:
            fns["session_cold"], fns["session_warm"] = make_session_fns(
                c, self.session_cold_iters, warm_iters, self.step_fns)
        self.quality_iters = None
        if quality_sample > 0:
            fns["quality"] = make_quality_fn(c, train_cfg, iters, ff_fn=ff_fn,
                                             fused_fn=fused_fn, consensus_fn=consensus_fn,
                                             apply_fn=apply_fn)
            self.quality_iters = fns["quality"].iters
        self.fns = {name: serving_quant.quantized_forward(fn, quant) for name, fn in fns.items()}
        if self.device.type == "cuda" and (config.ff_impl, config.attention_impl) != (
                "dense", "dense"):
            # built before the first request, so no request waits for nvcc
            _build.build_all()

    @property
    def sessions(self) -> bool:
        return self.session_warm_iters is not None

    @property
    def quality(self) -> bool:
        return self.quality_iters is not None

    def make(self, step: int, params: dict, *, quality: bool = True,
             set_id: Optional[int] = None) -> ServingSet:
        """A set for ``params`` (cast to the compute dtype under ``f32``,
        quantized and placed on the device otherwise) with its graph caches,
        not yet captured; ``quality=False`` leaves the ``quality`` family out
        (an extra model's set: only the default model's batches are
        sampled).  On a mesh the set holds this rank's shard of the tree
        (each slice contiguous: the kernels take no views), and ``set_id``
        names it in the dispatch's headers."""
        c = self.serve_config
        if self.quant == "f32":
            dt = c.resolved_compute_dtype
            params = glom_model.tree_map(lambda p: p.to(dt), params)
        else:
            params = serving_quant.quantize_tree(params, self.quant)
        if self.mesh is not None:
            if self.specs is None:
                self.specs = sharded.param_shardings(self.mesh, c, params,
                                                     param_sharding=self.param_sharding,
                                                     model_axis=self._model_axis)
            params = shard_tree(params, self.specs, self.mesh)
        if self.quant != "f32":
            params = serving_quant.tree_to(params, self.device)
        shape = (c.channels, c.image_size, c.image_size)
        shard = (sharded.SetShard(self.dispatch, int(set_id))
                 if self.dispatch is not None else None)
        param_bytes = profiling.tree_nbytes(params)

        def cache(name, iters, **kw):
            # each bucket's snapshot carries the analytic cost of its forward
            def cost(bucket):
                return profiling.analytic_cost(c, bucket, iters, param_bytes=param_bytes)

            return BucketedGraphCache(self.fns[name], self.buckets, input_shape=shape,
                                      device=self.device, name=name, lock=self.lock,
                                      iters=iters, quant=self.quant, cost_fn=cost,
                                      shard=shard, mesh_axes=self.mesh_axes,
                                      eager_reason=self.eager_reason, **kw)

        caches = {"embed": cache("embed", self.embed_iters),
                  "reconstruct": cache("reconstruct", self.reconstruct_timestep),
                  "index": cache("index", self.embed_iters)}
        caches["parse"] = PostPassCache(caches["index"], self.pack_fn,
                                        state_shape=self.state_tail, name="parse")
        if self.sessions:
            caches["session_cold"] = cache("session_cold", self.session_cold_iters,
                                           carries_state=True)
            caches["session_warm"] = cache("session_warm", self.session_warm_iters,
                                           carries_state=True, takes_state=True,
                                           state_shape=self.state_tail,
                                           state_dtype=self.state_dtype)
        if quality and self.quality:
            caches["quality"] = cache("quality", self.quality_iters)
        return ServingSet(int(step), params, caches)

    def warm(self, serving: ServingSet) -> None:
        """Capture every (family, bucket) of ``serving``, one bucket a hold of
        the device lock, so live replays run between the captures."""
        for cache in serving.caches.values():
            cache.warmup(serving.params)
        if self.sessions:
            # /session/parse runs the pack on the carried state, at its dtype
            serving.caches["parse"].warm_state(self.state_dtype)


class ServingEngine:
    """One loaded model, one batcher and one worker thread per endpoint, and
    the hot-reload watcher.

    Runs on ``cuda`` unless ``device`` names another device; without a card
    it raises unless ``device="cpu"``.  ``clock`` is injectable (tests drive
    batching and SLOs deterministically); ``start(workers=False)`` skips the
    threads, so tests can pump :meth:`process_once` and call
    :meth:`check_reload` by hand.

    With ``mesh_shape`` every rank of the initialized process group builds
    its engine with the same arguments, in the same order; rank 0 then
    serves and every other rank calls :meth:`follow`.  ``param_sharding``
    (``"replicated"``, ``"tp"``, ``"ep"``) places the parameters on the
    ``model`` axis; ``mesh_axis_names`` names the (data, model, seq)
    axes."""

    def __init__(
        self,
        checkpoint_dir: str,
        *,
        buckets: Sequence[int] = (1, 2, 4, 8),
        iters: Optional[int] = None,
        max_wait_ms: float = 5.0,
        max_queue: int = 64,
        registry: Optional[MetricRegistry] = None,
        reload_poll_s: float = 2.0,
        reload_retries: int = 3,
        reload_retry_base_s: float = 0.05,
        reload_backoff_max: int = 8,
        sleep=None,
        warmup: bool = True,
        saturation_threshold: float = 0.9,
        saturation_sustained: int = 3,
        saturation_debounce: int = 200,
        max_captures: int = 3,
        clock=None,
        trace_log: Optional[str] = None,
        trace_max_traces: int = 256,
        slos: Optional[Sequence] = None,
        device=None,
        ff_impl: Optional[str] = None,
        attention_impl: Optional[str] = None,
        quant: str = "f32",
        warm_iters=None,
        session_ttl_s: float = 600.0,
        session_max_bytes: int = 256 * 2 ** 20,
        session_spill_dir: Optional[str] = None,
        tenant_quotas: Optional[Dict[str, object]] = None,
        parse_thresholds=None,
        index_dir: Optional[str] = None,
        extra_models: Optional[Dict[str, str]] = None,
        deploy_promote_after: int = 3,
        deploy_window_s: Optional[float] = None,
        deploy_min_events: Optional[int] = None,
        deploy_canary_fraction: float = 0.1,
        deploy_pin_url: Optional[str] = None,
        capacity_policy: Optional[str] = None,
        capacity_interval_s: float = 1.0,
        capacity_window_s: float = 30.0,
        capacity_persist_windows: int = 5,
        capacity_ceiling: Optional[float] = None,
        quality_sample: float = 1.0,
        quality_seed: int = 0,
        bulk_dir: Optional[str] = None,
        warmup_dir: Optional[str] = None,
        forensics_dir: Optional[str] = None,
        mesh_shape: Optional[Sequence[int]] = None,
        param_sharding: str = "replicated",
        mesh_axis_names: Sequence[str] = mesh_lib.DEFAULT_AXES,
        **unported,
    ):
        refuse_unported(unported)
        self.device = resolve_device(device)
        self.checkpoint_dir = checkpoint_dir
        self.registry = registry if registry is not None else MetricRegistry()
        self._clock = clock if clock is not None else time.monotonic

        # -- end-to-end tracing: always on (host-side bookkeeping in a
        # bounded sink); with trace_log, one JSONL record per completed trace
        trace_exporter = None
        if trace_log:
            from glom_tpu_torch.obs.exporters import JsonlExporter

            trace_exporter = JsonlExporter(path=trace_log)
        self.tracer = Tracer(clock=self._clock, sink=TraceSink(max_traces=trace_max_traces),
                             registry=self.registry, exporter=trace_exporter)
        self._reload_poll_s = reload_poll_s
        if reload_retries < 1:
            raise ValueError(f"reload_retries must be >= 1, got {reload_retries}")
        self._reload_retries = reload_retries
        self._reload_retry_base_s = reload_retry_base_s
        self._reload_backoff_max = max(1, reload_backoff_max)
        self._reload_failstreak = 0
        self._sleep = sleep if sleep is not None else time.sleep
        self._warmup_dir = warmup_dir
        # checkpoint-integrity telemetry (triggers and forensics attached
        # below, once they exist): corrupt artifacts found at load or reload
        # are quarantined, counted and ckpt_corrupt-triggered
        self._integrity_obs = integrity.IntegrityObserver(registry=self.registry)

        if ckpt_lib.latest_step(checkpoint_dir) is None:
            raise FileNotFoundError(
                f"no finalized checkpoint in {checkpoint_dir!r}; train first, "
                f"or write one with make_demo_checkpoint"
            )
        # -- a mesh of ranks (serving/sharded.py): the mesh and its dispatch
        # before anything is loaded, every rank in the same order; what a
        # mesh above one rank does not carry is refused before any group
        # starts
        self.param_sharding = param_sharding
        self.mesh = self._dispatch = None
        axes = tuple(mesh_axis_names)
        if mesh_shape is not None or param_sharding != "replicated":
            if mesh_shape is None:
                raise ValueError(
                    f"param_sharding={param_sharding!r} needs a mesh_shape "
                    f"(e.g. (1, 4, 1) for 4-way TP)")
            if param_sharding not in sharded.PARAM_SHARDINGS:
                raise ValueError(f"unknown param_sharding {param_sharding!r}; one of "
                                 f"{sharded.PARAM_SHARDINGS}")
            ranks = int(np.prod([int(s) for s in mesh_shape]))
            for name, value in (("warm_iters", warm_iters), ("extra_models", extra_models),
                                ("bulk_dir", bulk_dir), ("index_dir", index_dir)):
                if value is not None and value != {}:
                    refuse_on_mesh(name, ranks)
            self.mesh = sharded.resolve_mesh(mesh_shape, axes)
            sharded.validate_buckets(buckets, self.mesh, data_axis=axes[0])
            if self.mesh.world_size > 1:
                self._dispatch = sharded.MeshDispatch(self.mesh, data_axis=axes[0])
        # -- quantized serving: one mode an engine; a reload quantizes its
        # new tree the same way
        self.quant = quant
        step, config, self.train_cfg, params = self._load_start_up()
        # None keeps the checkpoint's choice; a value overrides it
        overrides = {k: v for k, v in (("ff_impl", ff_impl), ("attention_impl", attention_impl))
                     if v is not None}
        self.config = dataclasses.replace(config, **overrides)
        # -- stateful sessions: warm_iters enables them ("auto" = half the
        # cold iterations)
        cold_iters = int(iters if iters is not None else self.config.default_iters)
        if warm_iters is not None:
            if warm_iters == "auto":
                warm_iters = max(1, cold_iters // 2)
            warm_iters = int(warm_iters)
            if warm_iters < 1:
                raise ValueError(f"warm_iters must be >= 1, got {warm_iters}")
        # replays share the card; a capture (start-up, reload, a deploy
        # candidate, or a lazy bucket) holds it alone
        self._device_lock = DeviceLock()
        self._program = program = ServingProgram(
            self.config, self.train_cfg, quant=quant, buckets=buckets, iters=iters,
            device=self.device, lock=self._device_lock, warm_iters=warm_iters,
            parse_thresholds=parse_thresholds, quality_sample=quality_sample,
            mesh=self.mesh, param_sharding=param_sharding, axis_names=axes,
            dispatch=self._dispatch)
        self.buckets = program.buckets
        self.serve_config = program.serve_config
        self._step_fns = program.step_fns
        self._consensus_fn, self._ff_fn, self._fused_fn = self._step_fns
        self.embed_iters = program.embed_iters
        self.reconstruct_timestep = program.reconstruct_timestep
        self._state_dtype, self._state_tail = program.state_dtype, program.state_tail
        self._session_cold_iters = program.session_cold_iters
        self._session_warm_iters = program.session_warm_iters
        # -- the part-whole endpoints: /parse is the index forward and the
        # islanding pack; /similar embeds through the index forward
        self.parse_thresholds = program.parse_thresholds
        self._pack_fn = program.pack_fn
        self.index_dir = index_dir
        self._index = None
        if index_dir is not None:
            from glom_tpu_torch.hierarchy.index import LevelIndex

            self._index = LevelIndex(index_dir, self.serve_config.levels)
        self.sessions: Optional[serving_sessions.SessionStore] = None
        self._session_spill_dir = session_spill_dir
        if program.sessions:
            self.sessions = serving_sessions.SessionStore(
                max_bytes=session_max_bytes, ttl_s=session_ttl_s, registry=self.registry,
                clock=self._clock)
        self._serving = program.make(step, params, set_id=0)
        # a follower's sets by id (the leader names them in its headers); the
        # leader's followers drop a set when the leader frees it
        self._follower_sets: Dict[int, ServingSet] = {}
        if self._dispatch is not None:
            if self._dispatch.is_leader:
                weakref.finalize(self._serving, self._dispatch.release, 0)
            else:
                self._follower_sets[0] = self._serving
        if self.sessions is not None and session_spill_dir:
            # warm boot: a drained replica's spilled states come back
            # resident (invalid ones are dropped)
            self.sessions.restore(session_spill_dir, validate=self._valid_spilled_state,
                                  place=self._place_state)
        # -- tenant bulkheads: one admission for every endpoint
        self.tenants: Optional[TenantAdmission] = (
            TenantAdmission(tenant_quotas, clock=self._clock) if tenant_quotas else None)

        self.batchers: Dict[str, DynamicBatcher] = {
            ep: DynamicBatcher(max_batch=self.buckets[-1], max_wait_ms=max_wait_ms,
                               max_queue=max_queue, clock=self._clock, tracer=self.tracer)
            for ep in ENDPOINTS
        }
        # -- overload detection, per endpoint (each has its own queue)
        self._saturation = {
            ep: QueueSaturationMonitor(threshold=saturation_threshold,
                                       sustained=saturation_sustained)
            for ep in ENDPOINTS
        }
        self._triggers = TriggerEngine(debounce_steps=saturation_debounce,
                                       max_captures=max_captures, registry=self.registry)
        self.timeline = Timeline(clock=self._clock)
        # -- forensics bundles: the snapshot is the largest /embed bucket's
        # capture record, so an overload capture never captures or replays
        self._forensics: Optional[ForensicsManager] = None
        if forensics_dir:
            max_bucket = self.buckets[-1]
            self._forensics = ForensicsManager(
                forensics_dir,
                config={"checkpoint_dir": checkpoint_dir, "buckets": list(self.buckets),
                        "max_queue": max_queue, "max_wait_ms": max_wait_ms,
                        "glom": self.config.to_json_dict()},
                snapshot_fn=lambda: self.caches["embed"].snapshots.get(max_bucket),
                registry=self.registry,
                attribution_fn=lambda: obs_attribution.attribute(
                    obs_attribution.collect_engine_evidence(self)))
        # quarantines now reach the debounced ckpt_corrupt trigger's bundle
        self._integrity_obs.triggers = self._triggers
        self._integrity_obs.forensics = self._forensics
        # -- SLO burn-rate alerting
        self._slo: Optional[SloManager] = None
        self._slo_lock = threading.Lock()
        if slos:
            parsed = [s if isinstance(s, SLO) else parse_slo(s) for s in slos]
            for s in parsed:
                if s.endpoint is not None and s.endpoint not in SLO_ENDPOINTS:
                    raise ValueError(
                        f"SLO {s.name!r} names unknown endpoint {s.endpoint!r}; "
                        f"valid endpoints: {SLO_ENDPOINTS}")
            self._slo = SloManager(parsed, clock=self._clock, registry=self.registry,
                                   triggers=self._triggers, forensics=self._forensics,
                                   tracer=self.tracer)

        # -- model-quality telemetry: the plane always exists (it never
        # samples without the quality family); the reference profile rides
        # the checkpoint conventions, adopted when one was frozen
        self.quality = QualityPlane(self.registry, levels=self.serve_config.levels,
                                    sample=quality_sample, seed=quality_seed, clock=self._clock)
        self.quality.load_reference(checkpoint_dir)

        # -- the model registry: the start-up set is the default model's
        # primary; an extra model is a primary of its own, with its own
        # config, program and graphs
        from glom_tpu_torch.serving import registry as model_registry

        self.models = model_registry.ModelRegistry(registry=self.registry, clock=self._clock)
        self.models.register(
            model_registry.DEFAULT_MODEL, self._serving.step, caches=self._serving,
            config=self.serve_config, train_cfg=self.train_cfg,
            signature=model_registry.cache_signature(self.config, quant, self.buckets,
                                                     iters=iters,
                                                     mesh_axes=program.mesh_axes),
            source_dir=checkpoint_dir, quant=quant, role="primary", program=self._program)
        for name, model_dir in (extra_models or {}).items():
            if name == model_registry.DEFAULT_MODEL:
                raise ValueError(f"extra model name {name!r} collides with the engine's own "
                                 f"model")
            model_registry.load_version(
                name, model_dir, buckets=self.buckets, quant=quant, iters=iters,
                warmup=warmup, models=self.models, role="primary", device=self.device,
                lock=self._device_lock)
        # -- shadow/canary deploys of the default model
        from glom_tpu_torch.serving.deploy import DeployController

        self.deploy = DeployController(
            self, promote_after=deploy_promote_after, window_s=deploy_window_s,
            min_events=deploy_min_events, canary_fraction=deploy_canary_fraction,
            pin_url=deploy_pin_url)

        # -- the capacity plane: host-side work only, and nothing samples
        # until tick() is driven or start() runs its timer thread.  Its
        # recommendations are dry-run: it never touches admission, batching
        # or the device
        self.capacity = CapacityPlane(
            self.registry, policy=capacity_policy or DEFAULT_POLICY,
            ceiling_imgs_per_sec=capacity_ceiling, interval_s=capacity_interval_s,
            window_s=capacity_window_s, persist_windows=capacity_persist_windows,
            clock=self._clock, triggers=self._triggers, forensics=self._forensics,
            tenants_fn=lambda: self.tenants.snapshot() if self.tenants is not None else None,
            on_recommend=lambda rec: self.timeline.note(
                "capacity_recommendation", action=rec["action"],
                reasons=rec.get("reasons", []), persisted=rec.get("persisted", 0)))

        # -- the bulk tier: with a bulk_dir the runner adopts every
        # unfinished job of the store now (resume after a kill is
        # zero-touch), scavenges bucket padding from process_once and runs
        # idle buckets from its own thread (started with the workers)
        self.bulk = None
        # the clock when an online batch last started or ended (the idle
        # buckets' grace runs from it)
        self.online_at = float("-inf")
        if bulk_dir is not None:
            from glom_tpu_torch.serving.bulk import BulkRunner

            self.bulk = BulkRunner(self, bulk_dir, clock=self._clock)

        # -- staged (two-phase) reload: ``_staged`` is a set loaded and
        # captured but not serving; ``_prev`` the set a commit displaced
        self._staged: Optional[ServingSet] = None
        self._prev: Optional[ServingSet] = None
        self._reload_lock = threading.Lock()

        self._lock = threading.Lock()  # set swap + counters + saturation
        # session frames bypass the batchers: the drain waits on this count
        # before the spill, so every acknowledged frame's state is in it
        self._session_inflight = 0
        self._session_cv = threading.Condition()
        # /session/parse's delta baselines (_note_parse_labels)
        self._parse_labels: Dict[str, np.ndarray] = {}
        self._threads: list = []
        self._stop = threading.Event()
        self._started = False
        self._shed_seen = {ep: 0 for ep in ENDPOINTS}
        self.request_count = 0
        self._warm = False
        if warmup:
            self.warm()
        if self._dispatch is not None:
            # set 0 is built and warmed on every rank: the leader's idle
            # heartbeat may start
            self._dispatch.start_heartbeat()

    # -- the mesh -----------------------------------------------------------
    def _load_start_up(self):
        """The start-up checkpoint, ``load_params``'s tuple: the newest valid
        step (a corrupt one quarantined); on a mesh the leader picks it and
        every follower loads the step the leader loaded."""
        d = self._dispatch
        if d is None or d.is_leader:
            try:
                loaded = load_params(self.checkpoint_dir, None, self.quant, self.device,
                                     observer=self._integrity_obs)
            except BaseException:
                if d is not None:
                    d.agree_step(None)
                raise
            if d is not None:
                d.agree_step(loaded[0])
            return loaded
        return load_params(self.checkpoint_dir, d.agree_step(None), self.quant, self.device)

    @property
    def is_leader(self) -> bool:
        """True on one rank and on a mesh's rank 0, the rank that serves."""
        return self._dispatch is None or self._dispatch.is_leader

    @property
    def mesh_rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.rank

    def _check_leader(self) -> None:
        """A follower serves no request: its cache calls come from the
        leader's headers (a call of its own would break the ranks' order)."""
        if not self.is_leader:
            raise RuntimeError(f"rank {self.mesh_rank} follows the mesh and serves no request; "
                               f"rank 0 leads")

    def refuse_on_mesh(self, name: str) -> None:
        """Raise for a :data:`MESH_REFUSED` feature when this engine is a
        rank of a mesh above one rank."""
        refuse_on_mesh(name, 1 if self.mesh is None else self.mesh.world_size)

    def follow(self) -> int:
        """A follower rank's serving (``serving/sharded.py``): run each of the
        leader's headers on this rank's shard (a cache call, a set loaded or
        dropped, an acknowledgement, a heartbeat) until the leader stops the
        mesh; returns the calls run.  A follower binds no port and serves no
        request; an error or a lost leader raises out of it."""
        if self.is_leader:
            raise RuntimeError("only a follower rank of a mesh follows; rank 0 serves")
        return self._dispatch.follow(self)

    def follow_run(self, set_id: int, family: str, imgs: np.ndarray, eager: bool) -> None:
        serving = self._follower_sets[set_id]
        cache = serving.caches[family]
        (cache.eager if eager else cache)(serving.params, imgs)
        self._serving = serving

    def follow_load(self, set_id: int, step: int) -> None:
        """A follower's part of a reload or a stage: the leader's step
        restored into a new set and warmed as the leader warms its own.  A
        failure is reported at the leader's ``ACK``: only the leader acts on
        the checkpoint directory (quarantines)."""
        try:
            _, _, _, params = load_params(self.checkpoint_dir, step, self.quant, self.device)
            serving = self._program.make(step, params, set_id=set_id)
            if self._warm:
                self._warm_set(serving)
        except Exception as e:  # the leader learns it at the ACK and serves nothing of it
            warnings.warn(f"rank {self.mesh_rank}: set {set_id} of step {step} did not load "
                          f"({type(e).__name__}: {e})", stacklevel=2)
            return
        self._follower_sets[set_id] = serving

    def follow_drop(self, set_id: int) -> None:
        serving = self._follower_sets.pop(set_id, None)
        if serving is not None and serving is self._serving and self._follower_sets:
            self._serving = self._follower_sets[max(self._follower_sets)]

    def follow_has(self, set_id: int) -> bool:
        return set_id in self._follower_sets

    # -- serving sets ------------------------------------------------------
    def _warm_set(self, serving: ServingSet) -> None:
        self._program.warm(serving)

    def warm(self) -> None:
        """Capture every (endpoint, bucket) pair of the serving set; the
        request path captures nothing after this returns, and reloads
        capture their new set before swapping it in."""
        t0 = self._clock()
        self._warm_set(self._serving)
        self._warm = True
        if self._warmup_dir:
            for family, cache in self._serving.caches.items():
                self._write_warmup_snapshots(family, cache)
        self.registry.gauge(
            "serving_warmup_seconds",
            help="wall time of the startup graph-capture pass", unit="seconds",
        ).set(self._clock() - t0)

    def _write_warmup_snapshots(self, family: str, cache) -> None:
        """One bundle a (family, bucket) under ``warmup_dir``, named
        ``<family>-b<bucket>``: ``glom_tpu``'s manifest (endpoint, bucket,
        quant, cost and memory analyses) and, in place of its ``hlo.txt``,
        ``kernels.json``, the launches one replay of the graph makes."""
        for bucket, snap in sorted(cache.snapshots.items()):
            files = {MANIFEST: {
                "endpoint": family, "bucket": bucket, "quant": cache.quant,
                "cost_analysis": snap.get("cost_analysis", {}),
                "memory_analysis": snap.get("memory_analysis", {}),
            }, "kernels.json": snap.get("kernels", {})}
            try:
                write_bundle(self._warmup_dir, f"{family}-b{bucket}", files)
            except OSError as e:
                warnings.warn(f"warmup snapshot write failed ({e})", stacklevel=2)

    @property
    def serving(self) -> ServingSet:
        return self._serving

    @property
    def step(self) -> int:
        return self._serving.step

    @property
    def params(self) -> dict:
        return self._serving.params

    @property
    def caches(self) -> Dict[str, BucketedGraphCache]:
        return self._serving.caches

    def _load_set(self, step: int) -> ServingSet:
        """Restore ``step`` onto the device and capture its graphs (when the
        engine warms) off the request path.  On a mesh every follower builds
        the same set first (the leader's ``LOAD``), placed by the same call
        as at start-up, and the set serves only once every rank holds it
        (``ACK``); the followers drop it when the leader frees it."""
        d = self._dispatch
        set_id = d.load(step) if d is not None else None
        try:
            serving = self._restore_set(step, set_id=set_id)
            if self._warm:
                self._warm_set(serving)
        except BaseException:
            if d is not None:
                d.release(set_id)
            raise
        if d is not None:
            weakref.finalize(serving, d.release, set_id)
            d.confirm(set_id)
        return serving

    def _restore_set(self, step: int, *, set_id: Optional[int] = None) -> ServingSet:
        """Restore ``step`` onto the device as a set whose graphs are not
        captured yet."""
        _, _, _, params = load_params(self.checkpoint_dir, step, self.quant, self.device)
        return self._program.make(step, params, set_id=set_id)

    def graph_pool_bytes(self) -> Dict[str, Optional[int]]:
        """Bytes the card holds for each graph family's pool (None on the
        CPU)."""
        return {name: cache.pool_bytes() for name, cache in self.caches.items()}

    def param_bytes(self) -> int:
        """Bytes the served parameter tree holds on the device."""
        return serving_quant.tree_nbytes(self._serving.params)

    # -- the forward -------------------------------------------------------
    def run(self, name: str, imgs: np.ndarray, **kw):
        """One batch of ``k <= max(buckets)`` images through graph family
        ``name`` (an endpoint, ``index``, or with sessions ``session_cold``
        and ``session_warm``, which takes ``state=``), padded to its bucket
        and replayed on the card; the family's output for the ``k``."""
        self._check_leader()
        serving = self._serving
        return self._cache(serving, name)(serving.params, imgs, **kw)

    def run_eager(self, name: str, imgs: np.ndarray, **kw):
        """The same batch through the eager forward of the same weights at
        the same bucket: what a replay equals bit for bit."""
        self._check_leader()
        serving = self._serving
        return self._cache(serving, name).eager(serving.params, imgs, **kw)

    @staticmethod
    def _cache(serving: ServingSet, name: str):
        if name not in serving.caches:
            raise ValueError(f"unknown graph family {name!r}; this engine has "
                             f"{sorted(serving.caches)}")
        return serving.caches[name]

    # -- lifecycle ---------------------------------------------------------
    def start(self, *, workers: bool = True, watch: Optional[bool] = None) -> None:
        """Start one worker thread per endpoint and the hot-reload watcher
        (``watch`` defaults to ``reload_poll_s > 0``)."""
        if self._started:
            return
        self._started = True
        if watch is None:
            watch = self._reload_poll_s > 0
        if workers:
            for ep in ENDPOINTS:
                t = threading.Thread(target=self._worker_loop, args=(ep,),
                                     name=f"glom-torch-serving-{ep}", daemon=True)
                t.start()
                self._threads.append(t)
        if watch:
            t = threading.Thread(target=self._watch_loop, name="glom-torch-serving-reload",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        if workers and self.bulk is not None:
            # idle buckets need live workers to preempt them; workers=False
            # tests drive bulk.run_idle_once() by hand
            self.bulk.start()

    def shutdown(self, *, drain: bool = True, timeout: float = 30.0) -> None:
        """Close admission, let queued work flush (``drain=True``) or fail it,
        stop the watcher and join the threads.  Idempotent."""
        for batcher in self.batchers.values():
            batcher.close(drain=drain)
        self._stop.set()
        if self.bulk is not None:
            # before the workers are joined: a chunk still staged is never
            # committed, so the durable cursor stays at the last completed
            # part and the next engine over the store re-executes it
            self.bulk.stop()
        self.deploy.close()
        self.capacity.stop()  # a no-op unless its timer thread was started
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        self._threads = []
        if self._dispatch is not None and self._dispatch.is_leader:
            # every worker and the watcher are done: the followers' loops end
            self._dispatch.stop()
        if self.sessions is not None and self._session_spill_dir:
            # spill after the workers drained and every admitted session
            # frame made its put (admission is shut by _stop, so the count
            # only falls); a crash mid-spill leaves the previous spill whole
            with self._session_cv:
                drained = self._session_cv.wait_for(
                    lambda: self._session_inflight == 0,
                    timeout=max(0.0, deadline - time.monotonic()))
            if not drained:
                warnings.warn(f"{self._session_inflight} session frame(s) still in flight at "
                              f"the drain deadline; spilling without them", stacklevel=2)
            try:
                self.sessions.spill(self._session_spill_dir)
            except OSError as e:
                warnings.warn(f"session spill failed ({e}); the sessions restart cold",
                              stacklevel=2)
        if self.tracer.exporter is not None:
            self.tracer.exporter.close()

    # -- hot reload --------------------------------------------------------
    def _reload_failure(self, what: str, e: Exception) -> None:
        self.registry.counter(
            "serving_reload_failures",
            help="failed hot-reload polls/loads (engine kept old params)",
        ).inc()
        warnings.warn(f"{what} failed ({type(e).__name__}: {e}); continuing to serve "
                      f"step {self.step}", stacklevel=3)

    def _poll_latest(self) -> Optional[int]:
        """The newest valid step; the step already served is returned
        without its CRC read.  The ``reload`` fault-injection site sits in
        front: ``io_error`` raises as a flaky mount would, ``corrupt_manifest``
        reads as nothing finalized."""
        kind = faultinject.fire("reload")
        if kind == "io_error":
            raise faultinject.FaultError("injected reload io_error")
        if kind == "corrupt_manifest":
            warnings.warn("injected corrupt reload manifest", stacklevel=2)
            return None
        return integrity.latest_valid_step(self.checkpoint_dir, newer_than=self.step,
                                           observer=self._integrity_obs)

    def check_reload(self) -> bool:
        """One watcher poll: load, capture and swap when a newer valid step
        landed.  Returns True on a swap.  Never raises: a poll retries with
        backoff, a corrupt step is quarantined, and any failure keeps the
        old set serving with ``serving_reload_failures`` counted."""
        newest = None
        for attempt in range(self._reload_retries):
            try:
                newest = self._poll_latest()
                self._reload_failstreak = 0
                break
            except Exception as e:
                self._reload_failure("reload poll", e)
                if attempt + 1 >= self._reload_retries:
                    self._reload_failstreak += 1
                    return False
                self._sleep(self._reload_retry_base_s * (2 ** attempt))
        if newest is None or newest <= self.step:
            return False
        with self._reload_lock:
            if newest <= self.step:
                return False
            span = self.tracer.start_trace(
                SPAN_RELOAD, attrs={"from_step": int(self.step), "to_step": int(newest)})
            try:
                serving = self._load_set(newest)
            except ckpt_lib.CorruptCheckpointError as e:
                self.tracer.end(span, attrs={"error": repr(e)})
                integrity.quarantine(self.checkpoint_dir, newest, observer=self._integrity_obs,
                                     reason=str(e))
                self._reload_failure(f"hot reload of step {newest}", e)
                self._reload_failstreak += 1
                return False
            except Exception as e:
                self.tracer.end(span, attrs={"error": repr(e)})
                self._reload_failure(f"hot reload of step {newest}", e)
                self._reload_failstreak += 1
                return False
            with self._lock:
                # the old set is not kept: only a staged commit keeps one
                # to roll back to
                self._serving = serving
            self.tracer.end(span)
            self._note_swap(newest)
            return True

    def _note_swap(self, step: int) -> None:
        self.registry.counter("serving_param_reloads",
                              help="successful checkpoint hot reloads").inc()
        self.registry.gauge("serving_checkpoint_step",
                            help="step of the params being served").set(step)
        # every swap re-anchors the registry's primary record on the set now
        # serving, so /healthz's models block never drifts from it
        self.models.sync_primary("default", step, self._serving)

    def stage_reload(self, step: Optional[int] = None) -> Optional[int]:
        """Phase one of a coordinated rollout: load a step and capture its
        graphs off the request path, without serving it.  ``step=None`` polls
        for the newest valid step above the one serving; a pinned ``step``
        stages exactly that one.  Returns the staged step, or None when there
        is nothing to stage or the load failed.  Every attempt supersedes
        earlier staging."""
        with self._reload_lock:
            self._staged = None
            target = step
            if target is None:
                try:
                    target = self._poll_latest()
                except Exception as e:
                    self._reload_failure("stage poll", e)
                    return None
            if target is None or (step is None and target <= self.step):
                return None
            if target == self.step:
                return None
            resident = self.models.get("default", int(target))
            if resident is not None:
                # a promote pinned through a router stages the step a
                # deploy already holds: adopt its set (restore nothing,
                # capture nothing), as sync_primary adopts its record
                self._staged = resident.caches
                return int(target)
            try:
                serving = self._load_set(int(target))
            except ckpt_lib.CorruptCheckpointError as e:
                integrity.quarantine(self.checkpoint_dir, int(target),
                                     observer=self._integrity_obs, reason=str(e))
                self._reload_failure(f"stage of step {target}", e)
                return None
            except Exception as e:
                self._reload_failure(f"stage of step {target}", e)
                return None
            self._staged = serving
            return int(target)

    def commit_staged(self) -> Optional[int]:
        """Phase two: swap the staged set in (one reference assignment;
        in-flight batches finish on the old set), keeping the displaced set
        as the rollback point.  Returns the step now serving."""
        with self._reload_lock:
            if self._staged is None:
                return int(self.step)
            serving, self._staged = self._staged, None
            span = self.tracer.start_trace(SPAN_RELOAD, attrs={
                "from_step": int(self.step), "to_step": serving.step, "phase": "commit"})
            with self._lock:
                self._prev = self._serving
                self._serving = serving
            self.tracer.end(span)
            self._note_swap(serving.step)
            return serving.step

    def abort_staged(self) -> bool:
        """Drop the staged set; True when one was staged."""
        with self._reload_lock:
            had = self._staged is not None
            self._staged = None
            return had

    def finalize_reload(self) -> bool:
        """Release the rollback point (a full second set of weights and
        graphs); True when one was held."""
        with self._reload_lock:
            had = self._prev is not None
            self._prev = None
            return had

    def rollback(self) -> Optional[int]:
        """Swap back to the set the last commit displaced (one-shot);
        returns the step now serving, or None with nothing to roll to."""
        with self._reload_lock:
            if self._prev is None:
                return None
            serving, self._prev = self._prev, None
            span = self.tracer.start_trace(SPAN_RELOAD, attrs={
                "from_step": int(self.step), "to_step": serving.step, "phase": "rollback"})
            with self._lock:
                self._serving = serving
            self.tracer.end(span)
            self.registry.counter(
                "serving_reload_rollbacks",
                help="param swaps reverted by a fleet-coordinated rollback").inc()
            self.registry.gauge("serving_checkpoint_step",
                                help="step of the params being served").set(serving.step)
            self.models.sync_primary("default", serving.step, serving, source="rollback")
            return serving.step

    def promote_candidate(self, step: int) -> int:
        """The deploy controller's local promote: the resident candidate's set
        becomes the serving set by the same reference swap as a staged commit
        (nothing restored, nothing captured), and the displaced set is kept
        as the rollback point until :meth:`finalize_reload`."""
        version = self.models.get("default", int(step))
        if version is None:
            raise KeyError(f"no resident default@{step} to promote")
        with self._reload_lock:
            span = self.tracer.start_trace(SPAN_RELOAD, attrs={
                "from_step": int(self.step), "to_step": int(step), "phase": "promote"})
            with self._lock:
                self._prev = self._serving
                self._serving = version.caches
            self.tracer.end(span)
            self._note_swap(int(step))
        return int(step)

    def _watch_loop(self) -> None:
        # consecutive fully-failed polls stretch the wait (doubling, capped
        # at reload_backoff_max x poll); one answered poll resets it
        while not self._stop.wait(
                self._reload_poll_s * min(2 ** self._reload_failstreak, self._reload_backoff_max)):
            self.check_reload()
            if self.sessions is not None:
                # idle sessions age out on the watcher's cadence
                self.sessions.sweep()

    # -- the request path --------------------------------------------------
    def submit(self, endpoint: str, imgs: np.ndarray, *, ctx=None,
               tenant: Optional[str] = None, model: Optional[str] = None,
               version: Optional[int] = None):
        """Enqueue a ``(k, c, H, W)`` batch; returns the Future of the
        endpoint's output.  Raises the batcher's ``Overloaded`` (shed),
        :class:`TenantQuotaExceeded` (``tenant`` past its quota) or
        ``Closed`` (shutting down).  ``ctx`` (the request's root span)
        threads the trace through the batcher and the executor.  ``model``
        targets an extra registry model (``ValueError`` for one not
        resident); ``version`` pins the default model's deploy candidate
        (the server takes it from :meth:`DeployController.assign`)."""
        self._check_leader()
        self._admit(tenant, imgs.shape[0])
        mkey = None
        if model is not None:
            if self.models.get(model) is None:
                raise ValueError(f"unknown model {model!r}; resident: {self.models.models()}")
            mkey = (model, None)
        elif version is not None:
            mkey = ("default", int(version))
        batcher = self.batchers[endpoint]
        try:
            future = batcher.submit(np.ascontiguousarray(imgs, dtype=np.float32),
                                    size=imgs.shape[0], ctx=ctx, tenant=tenant, mkey=mkey)
        except Overloaded:
            if self.tenants is not None:
                # the tokens bought nothing: a global shed gives them back
                self.tenants.refund(tenant, int(imgs.shape[0]))
            self.registry.counter("serving_shed_total",
                                  help="requests shed at queue capacity").inc()
            self._observe_saturation(endpoint)
            raise
        self._observe_saturation(endpoint)
        return future

    def _admit(self, tenant: Optional[str], images: int) -> None:
        """The tenant's quota, shared by the batched, session and similarity
        paths; a shed counts into the shed totals."""
        if self.tenants is None:
            return
        try:
            self.tenants.admit(tenant, int(images))
        except TenantQuotaExceeded:
            self.registry.counter("serving_shed_total",
                                  help="requests shed at queue capacity").inc()
            self.registry.counter(self.registry.labeled("serving_tenant_shed_", tenant),
                                  help="requests shed at a tenant's admission quota").inc()
            raise

    def _resolve_group(self, primary: ServingSet, mkey):
        """``(set, retired)`` one execute group runs on: ``mkey`` None is the
        default primary; ``("default", step)`` the deploy candidate, or the
        primary when it was retired between submit and execute (the
        post-rollback contract); ``(model, None)`` an extra model's primary."""
        if mkey is None:
            return primary, False
        model, step = mkey
        if model == "default" and step is not None:
            version = self.deploy.candidate(step)
            if version is None:
                return primary, True
            return version.caches, False
        version = self.models.get(model)
        if version is None:
            raise RuntimeError(f"model {model!r} was retired with items in flight")
        return version.caches, False

    def process_once(self, endpoint: str, *, block: bool = False,
                     timeout: Optional[float] = None) -> int:
        """Pull one flushed batch and run it; returns the images served.
        The worker loops the blocking form; tests call the non-blocking
        form.  Items of different ``mkey`` (canary traffic, extra models)
        share the flush and run as separate groups, each padded to its own
        bucket and replayed from its own set's graphs; a group's failure
        fails only its own futures.  With a shadow deploy, the primary
        group's images and answers are mirrored to the shadow after its
        futures resolve, and a batch the quality sampler picks replays the
        primary set's ``quality`` family (:meth:`_observe_quality`)."""
        batch = self.batchers[endpoint].next_batch(block=block, timeout=timeout)
        if not batch:
            return 0
        self.online_at = self._clock()
        # the batch span (made at take) feeds the duration histograms; each
        # member request's root span mirrors the same physical operations
        batch_span = batch[0].batch_span
        n_total = sum(item.size for item in batch)
        groups: Dict = {}
        for item in batch:
            groups.setdefault(item.mkey, []).append(item)
        t_asm0 = self.tracer.clock()
        group_imgs = {}
        for mkey, items in groups.items():
            arrays = [item.payload for item in items]
            group_imgs[mkey] = arrays[0] if len(arrays) == 1 else np.concatenate(arrays)
        contexts = ([batch_span] if batch_span is not None else []) + [
            it.ctx for it in batch if it.ctx is not None]
        if contexts:
            t_asm1 = self.tracer.clock()
            for i, ctx in enumerate(contexts):
                self.tracer.record(SPAN_BATCH_ASSEMBLY, ctx, t_asm0, t_asm1,
                                   attrs={"items": len(batch), "images": n_total},
                                   observe=i == 0)
        # one read of the serving set: a swap during the batch leaves the
        # primary group on the set it started with
        primary = self._serving
        served = 0
        primary_imgs = primary_out = None
        primary_items = ()
        batch_error = None
        for mkey, items in groups.items():
            imgs = group_imgs[mkey]
            n = imgs.shape[0]
            group_ctxs = ([batch_span] if batch_span is not None else []) + [
                it.ctx for it in items if it.ctx is not None]
            bulk_token = None
            try:
                serving, retired = self._resolve_group(primary, mkey)
                cache = serving.caches[endpoint]
                exec_imgs = imgs
                if mkey is None and self.bulk is not None:
                    # scavenge: the bucket pads to its size anyway, so bulk
                    # slots fill the padding and the same replay runs them;
                    # the online rows come first and everything below sees
                    # only out[:n]
                    bucket = cache.pick(n)
                    if bucket is not None and bucket > n:
                        bulk_token = self.bulk.fill(endpoint, bucket - n)
                        if bulk_token is not None:
                            exec_imgs = np.concatenate([imgs, bulk_token.imgs])
                t0 = self._clock()
                out_all = cache(serving.params, exec_imgs, tracer=self.tracer,
                                contexts=group_ctxs)
                out = out_all[:n] if bulk_token is not None else out_all
                if mkey is not None and mkey[1] is not None and not retired:
                    # the canary group's fault seam: a delay is latency the
                    # client sees, never an error
                    kind = self.deploy.injected_fault()
                    if kind == "delay":
                        self._sleep(self.deploy.fault_delay_s)
                    elif kind == "error":
                        raise faultinject.FaultError("injected candidate error")
            except Exception as e:  # the group's callers get the error
                if bulk_token is not None:
                    # nothing was committed: the staged slots run again later
                    self.bulk.abandon(bulk_token)
                for item in items:
                    if not item.future.done():
                        item.future.set_exception(e)
                batch_error = e
                continue
            batch_s = self._clock() - t0
            offset = 0
            for item in items:
                item.future.set_result(out[offset:offset + item.size])
                offset += item.size
            if mkey is None:
                primary_imgs, primary_out, primary_items = imgs, out, items
            self._account_batch(endpoint, cache, n, batch_s)
            if bulk_token is not None:
                self.bulk.commit(bulk_token, out_all[n:])
            if mkey is not None and mkey[0] != "default":
                self.registry.counter(self.registry.labeled("serving_model_requests_", mkey[0]),
                                      help="images served per non-default registry model").inc(n)
            elif mkey is not None and not retired:
                self.registry.counter("deploy_canary_requests",
                                      help="live images executed against the deploy "
                                           "candidate").inc(n)
            served += n
        if batch_span is not None:
            self.tracer.end(batch_span,
                            attrs={} if batch_error is None else {"error": repr(batch_error)})
        if primary_imgs is not None and self.deploy.phase == "shadow":
            # the primary's answers ride along: the shadow compares the
            # candidate with the primary on the same batch
            self.deploy.mirror(endpoint, primary_imgs, primary_out)
        if (primary_imgs is not None and "quality" in primary.caches
                and self.quality.should_sample()):
            self._observe_quality(endpoint, primary, primary_imgs, primary_items)
        self.online_at = self._clock()
        return served

    def _worker_loop(self, endpoint: str) -> None:
        batcher = self.batchers[endpoint]
        while True:
            served = self.process_once(endpoint, block=True, timeout=0.25)
            if served == 0 and batcher.closed and batcher.depth == 0:
                return

    # -- stateful sessions (/session/*) -------------------------------------
    @property
    def sessions_enabled(self) -> bool:
        return self.sessions is not None

    def _valid_spilled_state(self, shape, dtype) -> bool:
        # the spill is float32 whatever the serving dtype, and _place_state
        # casts it back: only the shape gates a restore, and its batch must
        # be a bucket this engine captured
        del dtype
        return (len(shape) == 4 and shape[0] in self.buckets
                and tuple(shape[1:]) == self._state_tail)

    def _place_state(self, host_levels: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(host_levels, np.float32)).to(
            device=self.device, dtype=self._state_dtype)

    def session_embed(self, session_id: str, imgs: np.ndarray, *, ctx=None,
                      tenant: Optional[str] = None):
        """One frame of a stateful session: ``warm_iters`` iterations from the
        session's resident state when it has one, the full cold settle
        otherwise.  Returns ``(embeddings, info)``, ``info`` carrying
        ``cold``, ``frames``, ``iters`` and ``step`` (and ``restart`` after a
        batch change).

        Runs on the caller's thread: a session's frames are ordered (frame
        k+1 takes frame k's state), so batching across requests buys nothing
        within a session; the per-session locks let other sessions' frames
        interleave.  Each frame is one replay of a captured graph; the state
        never leaves the card between frames."""
        return self._session_frame(session_id, imgs, ctx=ctx, tenant=tenant, parse=False)

    def session_parse(self, session_id: str, imgs: np.ndarray, *, ctx=None,
                      tenant: Optional[str] = None):
        """One parse frame of a session (``/session/parse``): the same state
        update as :meth:`session_embed` (one state a session, so the two
        kinds of frame interleave freely), answered with the packed islanding
        rows of the new state; ``info["deltas"]`` holds each image's island
        deltas against the previous parse frame
        (:func:`~glom_tpu_torch.hierarchy.parse.island_deltas`).  A cold
        frame, or a session's first parse frame, reports every island
        ``appeared``."""
        return self._session_frame(session_id, imgs, ctx=ctx, tenant=tenant, parse=True)

    def _session_frame(self, session_id: str, imgs: np.ndarray, *, ctx, tenant, parse: bool):
        if self.sessions is None:
            raise RuntimeError("sessions disabled on this engine (construct with warm_iters= "
                               "to enable /session/embed and /session/parse)")
        if not serving_sessions.valid_session_id(session_id):
            raise ValueError(f"invalid session id {session_id!r} (want "
                             f"{serving_sessions.SESSION_ID_RE.pattern})")
        # the tenant's quota covers sessions too: a frame past it sheds
        # before it takes any device time
        self._admit(tenant, imgs.shape[0])
        imgs = np.ascontiguousarray(imgs, dtype=np.float32)
        b = imgs.shape[0]
        bucket = self.caches["session_cold"].bucket_of(b, "session frame batch")
        contexts = [ctx] if ctx is not None else []
        restart = None
        # admission and the drain's count under one condition, so that no
        # frame slips between the check and the count
        with self._session_cv:
            if self._stop.is_set():
                raise Closed("engine draining; session frame rejected")
            self._session_inflight += 1
        try:
            with self.sessions.locked(session_id):
                entry = self.sessions.get(session_id)
                if entry is not None and entry.batch != b:
                    # the state is shaped for the session's first batch: a
                    # new image count a frame starts a fresh equilibrium
                    self.sessions.reset(session_id)
                    entry, restart = None, "batch_changed"
                # one read of the serving set: the frame runs whole on it
                # (after a reload, the new set's graphs take the old state)
                serving, canary = self._serving, False
                if (entry is not None and entry.step != serving.step
                        and self.deploy.retired(entry.step)):
                    # the state was computed by a candidate a rollback or an
                    # abort retired: never warm-iterate it on the primary
                    self.sessions.reset(session_id)
                    entry, restart = None, "version_retired"
                cand_step = self.deploy.candidate_step
                if cand_step is not None:
                    # a session with state stays on the version that
                    # computed it; only a cold frame follows the canary
                    # assignment
                    assigned = (cand_step if entry is not None and entry.step == cand_step
                                else (self.deploy.assign(session_id) if entry is None
                                      else None))
                    if assigned is not None:
                        version = self.deploy.candidate(assigned)
                        if version is not None:
                            serving, canary = version.caches, True
                t0 = self._clock()
                if entry is None:
                    out, new_levels = serving.caches["session_cold"](
                        serving.params, imgs, tracer=self.tracer, contexts=contexts)
                    cold, frames = True, 1
                else:
                    out, new_levels = serving.caches["session_warm"](
                        serving.params, imgs, state=entry.levels, tracer=self.tracer,
                        contexts=contexts)
                    cold, frames = False, entry.frames + 1
                if parse:
                    # the pack on the new (bucket-shaped) state replaces the
                    # embeddings; only the rows slice back to the batch
                    out = serving.caches["parse"].apply_post(new_levels, b)
                elapsed = self._clock() - t0
                self.sessions.put(session_id, new_levels, batch=b, bucket=bucket,
                                  step=serving.step, frames=frames)
                # still under the session's lock: this frame's labels pair
                # with the previous parse frame's
                deltas = self._note_parse_labels(session_id, out, cold) if parse else None
        finally:
            with self._session_cv:
                self._session_inflight -= 1
                self._session_cv.notify_all()
        self._account_session(serving, cold, b, elapsed, restart)
        info = {"cold": cold, "frames": frames,
                "iters": self._session_cold_iters if cold else self._session_warm_iters,
                "step": int(serving.step)}
        if canary:
            # the server routes this outcome to the candidate's evaluators
            info["canary_step"] = int(serving.step)
        if restart is not None:
            info["restart"] = restart
        if deltas is not None:
            info["deltas"] = deltas
        return out, info

    #: retained per-session parse labels (host int32 grids), the delta
    #: baseline; bounded, so abandoned sessions cannot grow the host map
    _PARSE_LABELS_MAX = 4096

    def _note_parse_labels(self, session_id: str, packed: np.ndarray, cold: bool):
        """One parse frame's label bookkeeping (the caller holds the
        session's lock): the deltas against the previous parse frame's
        labels, then this frame's kept as the next baseline.  A cold frame
        never diffs against labels from before its restart."""
        c = self.config
        side = c.image_size // c.patch_size
        n = side * side
        cur = np.rint(packed[:, :c.levels * n]).astype(np.int32)
        cur = cur.reshape(packed.shape[0], c.levels, side, side)
        prev = None if cold else self._parse_labels.get(session_id)
        if prev is not None and prev.shape != cur.shape:
            prev = None
        deltas = [hierarchy_parse.island_deltas(None if prev is None else prev[i], cur[i])
                  for i in range(cur.shape[0])]
        self._parse_labels[session_id] = cur
        while len(self._parse_labels) > self._PARSE_LABELS_MAX:
            self._parse_labels.pop(next(iter(self._parse_labels)))
        return deltas

    def session_reset(self, session_id: str) -> bool:
        """Drop a session's state (``/session/reset``); its next frame is
        cold.  Returns whether it had state.  Under the session's lock, so a
        reset and an in-flight frame order one way or the other."""
        if self.sessions is None:
            raise RuntimeError("sessions disabled on this engine")
        with self.sessions.locked(session_id):
            self._parse_labels.pop(session_id, None)
            return self.sessions.reset(session_id)

    def _account_session(self, serving: ServingSet, cold: bool, images: int, elapsed_s: float,
                         restart) -> None:
        reg = self.registry
        with self._lock:
            self.request_count += 1
        reg.counter("serving_requests_total", help="images served across endpoints").inc(images)
        mode = "cold" if cold else "warm"
        reg.counter(f"serving_session_{mode}_frames",
                    help=f"session frames served {mode} "
                         + ("(full settle)" if cold else "(warm-started)")).inc()
        reg.histogram(f"serving_session_frame_seconds_{mode}",
                      help=f"device time per {mode} session frame",
                      unit="seconds").observe(elapsed_s)
        if restart is not None:
            reg.counter("serving_session_cold_restarts",
                        help="sessions restarted cold after a per-frame batch-size change "
                             "(eviction/failover colds surface as serving_session_misses)").inc()
        caches = serving.caches
        self._count_captures(sum(caches[name].poll_captures()
                                 for name in ("session_cold", "session_warm", "parse")))
        # with no reload watcher running, the traffic itself drives the TTL
        # sweep, gated by an interval
        self.sessions.sweep(min_interval=max(1.0, self.sessions.ttl_s / 10.0))

    def _count_captures(self, n: int) -> None:
        if n:
            self.registry.counter(
                "serving_graph_captures",
                help="request-path CUDA graph captures after warm-up (must stay 0)",
            ).inc(n)

    # -- model-quality telemetry -------------------------------------------
    def poll_quality_compiles(self, serving: Optional[ServingSet] = None) -> None:
        """Fold the captures the ``quality`` family of ``serving`` (default:
        the set serving now) made on the request path into
        ``serving_graph_captures``: it is captured at start-up like every
        family, so the zero-after-warm-up rule covers it."""
        serving = self._serving if serving is None else serving
        cache = serving.caches.get("quality")
        if cache is not None:
            self._count_captures(cache.poll_captures())

    def _observe_quality(self, endpoint: str, serving: ServingSet, imgs: np.ndarray,
                         items) -> None:
        """One sampled primary batch through ``serving``'s ``quality`` family:
        its per-image rows (bucket padding sliced off, copied to the host
        before the family can replay again) are averaged back to each
        request's signals, which the quality plane (sketches, drift, gauges)
        and the quality SLOs observe.  Telemetry never fails a served batch:
        a post-pass that raises is counted, and nothing else answers it."""
        try:
            mat = serving.caches["quality"](serving.params, imgs)
        except Exception:  # counted: telemetry must never fail a served batch
            self.registry.counter(
                "quality_post_pass_failures",
                help="quality post-pass executions that raised "
                     "(telemetry-only; the served batch was unaffected)",
            ).inc()
            return
        self.poll_quality_compiles(serving)
        levels = self.config.levels
        offset = 0
        for item in items:
            rows = mat[offset:offset + item.size]
            offset += item.size
            if rows.size == 0:
                continue
            signals = unpack_signals(rows.mean(axis=0), levels)
            trace_id = getattr(item.ctx, "trace_id", None)
            # the input's fingerprint, what a quality_drift detection names so
            # an offending input is findable after the request is gone
            fingerprint = hashlib.sha1(
                np.ascontiguousarray(item.payload).tobytes()).hexdigest()[:16]
            flat = self.quality.observe(signals, trace_id=trace_id, tenant=item.tenant,
                                        version=serving.step, fingerprint=fingerprint)
            if self._slo is not None:
                with self._slo_lock:
                    self._slo.observe_quality(flat, endpoint=endpoint, trace_id=trace_id,
                                              step=self.request_count, tenant=item.tenant,
                                              fingerprint=fingerprint)

    # -- similarity queries (/similar) --------------------------------------
    @property
    def similar_enabled(self) -> bool:
        return self._index is not None

    def similar(self, imgs: np.ndarray, *, level: Optional[int] = None, k: int = 5, ctx=None,
                tenant: Optional[str] = None):
        """Level-aware nearest neighbours (``/similar``): the query images go
        through the ``index`` graphs (the forward an index build runs, so
        queries and entries share one space), then this replica's level
        index is scanned on the host.  Below the top level the query is an
        image's patch vectors ("search by part"), at the top their mean.
        Returns ``(results, info)``, one top-``k`` list an image."""
        if self._index is None:
            raise RuntimeError("similarity index disabled on this engine (construct with "
                               "index_dir= to enable /similar)")
        self._admit(tenant, imgs.shape[0])
        imgs = np.ascontiguousarray(imgs, dtype=np.float32)
        b = imgs.shape[0]
        c = self.config
        level = c.levels - 1 if level is None else int(level)
        if not 0 <= level < c.levels:
            raise ValueError(f"level {level} outside [0, {c.levels})")
        if k < 1:
            raise ValueError(f"need k >= 1, got {k}")
        self.caches["index"].bucket_of(b, "query batch")
        contexts = [ctx] if ctx is not None else []
        serving = self._serving
        t0 = self._clock()
        states = serving.caches["index"](serving.params, imgs, tracer=self.tracer,
                                         contexts=contexts)             # (b, n, L, d)
        results = []
        for i in range(b):
            q = states[i, :, level, :]
            if level == c.levels - 1:
                q = q.mean(axis=0, keepdims=True)
            results.append(self._index.query(q, level, k=k))
        elapsed = self._clock() - t0
        self._account_similar(b, elapsed)
        return results, {"level": level, "k": int(k), "index": self._index.stats()}

    def _account_similar(self, images: int, elapsed_s: float) -> None:
        reg = self.registry
        with self._lock:
            self.request_count += 1
        reg.counter("serving_requests_total", help="images served across endpoints").inc(images)
        reg.counter("serving_similar_queries", help="similarity queries answered").inc()
        reg.histogram("serving_similar_seconds",
                      help="embed + index-scan time per similarity query",
                      unit="seconds").observe(elapsed_s)
        self._count_captures(self._serving.caches["index"].poll_captures())

    # -- accounting / overload detection -----------------------------------
    def _account_batch(self, endpoint: str, cache: BucketedGraphCache, n: int,
                       batch_s: float) -> None:
        reg = self.registry
        with self._lock:
            self.request_count += n
        reg.counter("serving_requests_total", help="images served across endpoints").inc(n)
        reg.histogram(f"serving_batch_seconds_{endpoint}", help="device batch execution time",
                      unit="seconds").observe(batch_s)
        bucket = cache.pick(n) or n
        reg.histogram("serving_batch_occupancy",
                      help="real images / bucket size per executed batch").observe(n / bucket)
        reg.histogram(reg.labeled("serving_batch_occupancy_b", bucket),
                      help="real images / bucket size for one bucket").observe(n / bucket)
        reg.gauge("serving_queue_depth", help="queued images").set(self.batchers[endpoint].depth)
        self._count_captures(cache.poll_captures())

    def _observe_saturation(self, endpoint: str) -> None:
        batcher = self.batchers[endpoint]
        with self._lock:
            shed_total = batcher.stats.shed
            shed_delta = shed_total - self._shed_seen[endpoint]
            self._shed_seen[endpoint] = shed_total
            detail = self._saturation[endpoint].update(batcher.depth, batcher.max_queue,
                                                       shed_delta)
            if detail is not None:
                self.registry.counter("serving_queue_saturation_events",
                                      help="sustained-overload detections").inc()
                self.timeline.note("queue_saturation", endpoint=endpoint, **detail)
                detail["endpoint"] = endpoint
                count = self.request_count
                if self._forensics is not None and self._triggers.fire(
                        TRIGGER_QUEUE_SATURATION, count):
                    # the bundle write is small and captures are rare, so it
                    # runs under the lock (two racing threads could overshoot
                    # the capture budget)
                    path = self._forensics.capture(TRIGGER_QUEUE_SATURATION, count, detail,
                                                   trace=False)
                    if path is None:
                        self._triggers.refund(TRIGGER_QUEUE_SATURATION, count)
        self.registry.gauge("serving_queue_depth", help="queued images").set(batcher.depth)

    def observe_outcome(self, endpoint: str, latency_ms: Optional[float], error: bool,
                        trace_id: Optional[str] = None, tenant: Optional[str] = None,
                        version: Optional[int] = None) -> None:
        """One request's terminal outcome, fed to the SLO burn-rate
        evaluators (the server calls this for successes and errors: sheds
        burn the error budget too).  ``tenant`` mints the per-tenant outcome
        metrics (cardinality-bounded) and scopes per-tenant SLOs.  The SLOs
        are serialized under their own lock, not the engine's, so alerting
        never stalls the workers' accounting or a swap.  ``version`` routes a
        canary outcome to the deploy candidate's evaluators instead of the
        primary's SLOs; one of a candidate retired in flight feeds neither."""
        if tenant is not None:
            reg = self.registry
            reg.counter(reg.labeled("serving_tenant_requests_", tenant),
                        help="requests answered per tenant (all outcomes)").inc()
            if error:
                reg.counter(reg.labeled("serving_tenant_errors_", tenant),
                            help="5xx-class outcomes per tenant").inc()
            if latency_ms is not None:
                reg.histogram(reg.labeled("serving_tenant_latency_ms_", tenant),
                              help="request latency per tenant", unit="ms").observe(latency_ms)
        if version is not None:
            if version == self.deploy.candidate_step:
                self.deploy.observe_candidate(endpoint, latency_ms, error, trace_id=trace_id,
                                              tenant=tenant)
            return
        if self._slo is None:
            return
        with self._slo_lock:
            self._slo.observe(endpoint, latency_ms, error, trace_id=trace_id,
                              step=self.request_count, tenant=tenant)

    def debug_forensics(self) -> dict:
        """The ``/debug/forensics`` payload the fleet observatory polls on
        every replica: this engine's bundle manifests (none without a
        ``forensics_dir``), its registry snapshot and its recent SLO
        firings.  Read-only and cheap: a directory listing and small JSON
        reads; never touches the request path."""
        import json
        import os

        bundles = []
        root = self._forensics.root if self._forensics is not None else None
        if root and os.path.isdir(root):
            for name in sorted(os.listdir(root)):
                path = os.path.join(root, name)
                if not is_bundle_dir(path):
                    continue
                try:
                    with open(os.path.join(path, MANIFEST)) as f:
                        manifest = json.load(f)
                except (OSError, ValueError):
                    continue  # a manifest mid-write: the next poll sees it
                bundles.append({"name": name, "manifest": manifest})
        # copy `fired` under the SLO lock: request threads append to the
        # deque inside _slo.observe(), and iterating a deque concurrent
        # with appends raises RuntimeError
        if self._slo is not None:
            with self._slo_lock:
                slo_fired = list(self._slo.fired)
        else:
            slo_fired = []
        return {"role": "engine", "step": int(self.step), "bundles": bundles,
                "registry": self.registry.snapshot(), "slo_fired": slo_fired}

    # -- health ------------------------------------------------------------
    def health(self) -> dict:
        """The ``/healthz`` payload: liveness, the model's input contract,
        the reload state, the graphs and the kernels' launch counts."""
        c = self.config
        serving, staged = self._serving, self._staged
        failed = None if self._dispatch is None else self._dispatch.failed
        mesh = None
        if self.mesh is not None:
            mesh = {"rank": self.mesh.rank, "backend": self.mesh.backend,
                    "graphs": self._program.eager_reason is None,
                    "eager_reason": self._program.eager_reason,
                    **({} if self._dispatch is None else self._dispatch.status())}
        return {
            # a mesh that lost a rank serves nothing more: not ok
            "status": "ok" if failed is None else "mesh_failed",
            "step": int(serving.step),
            # glom_tpu's mesh labels, and the port's rank and dispatch state
            "mesh": sharded.mesh_axes_dict(self.mesh),
            "param_sharding": self.param_sharding,
            "mesh_dispatch": mesh,
            "warm": all(cache.warmed for cache in serving.caches.values()),
            "queue_depth": {ep: b.depth for ep, b in self.batchers.items()},
            "buckets": list(self.buckets),
            "quant": self.quant,
            "ff_impl": c.ff_impl,
            "attention_impl": c.attention_impl,
            "staged_step": None if staged is None else int(staged.step),
            # the deploy phase and the resident versions, so an operator or
            # a router sees "this replica is canarying step N"
            "deploy": self.deploy.status(),
            "models": self.models.snapshot(),
            "sessions": None if self.sessions is None else {
                "warm_iters": self._session_warm_iters,
                "cold_iters": self._session_cold_iters,
                **self.sessions.snapshot()},
            "tenants": None if self.tenants is None else self.tenants.snapshot(),
            # the part-whole endpoints' contract: the islanding thresholds
            # and this replica's index inventory
            "hierarchy": {"parse_thresholds": list(self.parse_thresholds),
                          "index": None if self._index is None else self._index.stats()},
            # the capacity and quality summaries ride /healthz, so a fleet
            # router's health poll is also its capacity and sketch feed
            "capacity": self.capacity.summary(),
            "quality": self.quality.summary(),
            # the bulk summary rides /healthz too: per-shard durable cursors
            # a fleet router re-partitions a dead replica's range from
            "bulk": None if self.bulk is None else self.bulk.summary(),
            "graphs": {ep: {"graphed": cache.graphed, "warmup_seconds": cache.warmup_seconds,
                            "launches_per_replay": cache.launches_per_replay()}
                       for ep, cache in serving.caches.items()},
            "image_size": c.image_size,
            "patch_size": c.patch_size,
            "channels": c.channels,
            "levels": c.levels,
            "dim": c.dim,
            "device": str(self.device),
            "kernel_launches": kernel_launches(),
        }
