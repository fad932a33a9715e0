"""The single-card trainer (``glom_tpu/training/trainer.py``).

It runs the loop of the JAX package's ``Trainer`` on one device: ``fit``
runs the denoising step (``training/denoise.py``) to a step count, logs a
JSONL record every ``log_every`` steps (loss, the raw pre-clip grad norm,
images per second over the window, the window's numerics and device memory,
its phase times), halts with :class:`NonFiniteError` on non-finite values
when ``halt_on_nan``, checkpoints every ``checkpoint_every`` steps,
auto-resumes from the newest checkpoint that passes its integrity check,
and on SIGTERM stops after the step in flight and saves.

Every ``eval_every`` steps the loop evaluates, as ``glom_tpu``'s does: with
an :class:`~glom_tpu_torch.training.eval.EvalSuite` (``set_eval_suite``) it
logs the held-out PSNR and linear-probe accuracies; without one, the
denoising PSNR (``psnr_db``) of the incoming batch before the step consumes
it.  The eval's noise comes from a generator of its own seeded ``seed + i``
at step ``i``, never from the train step's, so a run with eval trains on the
same noise as one without.

A checkpoint is the port's npz layout with its CRC sidecar
(``glom_tpu_torch/checkpoint.py``) beside ``config.json``, under
``glom_tpu``'s names, so that either package's trainer restores the other's:
* ``params``: the ``{"glom", "decoder"}`` tree, which ``glom_tpu``'s
  ``load_checkpoint_state`` and the port's ``ServingEngine`` read too;
* ``opt``: the Adam state ``{count, mu, nu}`` (``training/optim.py``) in the
  layout of the optax chain ``glom_tpu``'s trainer builds from the same
  ``config.json`` (adam or adamw, with or without a schedule, either under
  ``clip_by_global_norm``; :func:`opt_state_to_optax`), which
  :func:`opt_state_from_optax` maps back;
* ``rng``: a JAX PRNG key ``PRNGKey(seed + step)`` (two uint32 words), so
  that ``glom_tpu`` resumes with a key of its own;
* ``generator``: the port's noise generator (uint8), so a resumed run draws
  the noise an unbroken run would.  A ``glom_tpu`` checkpoint has none: its
  resume warns and keeps the trainer's freshly seeded generator;
* ``data``: with a resumable stream (``state_dict`` / ``load_state_dict``,
  as :class:`~glom_tpu_torch.training.image_stream.ImageFolderStream` has),
  its cursor, which ``restore(batches=...)`` hands back, so the stream goes
  on with the exact next batch.

With ``async_checkpoint`` the save copies the state to the host (numpy,
device to host) before it returns, so the next step cannot touch what is
written, and a background thread writes the npz.  :meth:`finish_saves`
joins it and re-raises its error; ``fit`` returns only once the checkpoint
is durable.  Where the port differs: the writer reads its artifact back
against the integrity record before the save counts as durable, because no
caller sees a background write fail otherwise (a torn or flipped artifact,
the ``ckpt_write`` fault seam's, raises from :meth:`finish_saves` here, and
not only at the next resume).

Observability is ``glom_tpu``'s (``glom_tpu_torch/obs``): one
:class:`~glom_tpu_torch.obs.registry.MetricRegistry` per trainer and logger
(a caller's logger's registry is adopted), exporters from the config
(``metrics_csv``, ``prom_textfile``), the loop phase-timed
(``obs/timing.py``: ``t_data_wait``, ``t_h2d``, ``t_step``, ``t_log_sync``,
``t_stop_poll``, and ``t_eval``, ``t_diag``, ``t_checkpoint``,
``t_log_emit`` in a window that had them, left out of ``imgs_per_sec``),
each phase a span of a per-window trace (``trace_dir`` writes
``train_trace.json`` at the end of ``fit``) and an
:func:`~glom_tpu_torch.profiling.annotate` region, the monitors
(``obs/monitors.py``: numerics with the grad-norm spike flag, device
memory, kernel rebuilds), ``diag_every``'s GLOM diagnostics
(``obs/diagnostics.py``) in a ``diag`` phase of their own, and with
``forensics_dir`` post-mortem bundles (``obs/forensics.py``) through the
debounced triggers ``nan``, ``grad_spike``, ``step_time_regression``,
``recompile``, ``ckpt_corrupt``, and the terminal ``crash`` and
``preempt``, with ``faulthandler`` armed around ``fit``.  A bundle's step
snapshot (``profiling.step_snapshot``) is the kernel launches of the last
step, its analytic cost and its memory.  With ``profile_dir`` the loop
traces steps ``start+2`` to ``start+4`` (``profiling.trace``), the window
``glom_tpu`` traces; a triggered trace is then off, as two profilers cannot
run at once.

On a mesh of ranks (``mesh_shape`` above one, over an initialized process
group; ``parallel/mesh.py``) the trainer follows ``glom_tpu``'s mesh rules:
batch and microbatch must divide the data axis; ``attention_impl="auto"``
under a seq axis above one becomes ``"ring"``; the params are placed by the
spec tables of ``param_sharding`` (``"tp"``, ``"ep"``, ``"replicated"``), each
rank holding its slice; the FF runs per shard (``parallel/ff_shard.py``: K1,
and K2/K3 in the backward, at the shard's shapes), K8 per data shard under
pure DP (``parallel/fused_shard.py``; any other mesh takes the sharded
unfused pair with ``glom_tpu``'s warning), the ring or Ulysses consensus over
the seq axis (a dense or kernel consensus there runs on the columns gathered
over it, as GSPMD runs ``glom_tpu``'s); and the step is the one-process step
on this rank's rows and columns (``parallel/step.py::MeshShard``), which draws
the global batch's noise as one process does and reduces the gradients.
Rank 0 logs
and writes the npz (from :func:`~glom_tpu_torch.parallel.placement.gather_to_host`)
while the others wait at a barrier; a resume loads, then slices.  Still
refused by name (:data:`UNSUPPORTED`, and on a mesh of ranks the fields
:func:`check_mesh_supported` names): sharded saves, and on a mesh the
diagnostics, the eval suite and the two-view objective (ROADMAP queue 1,
item 6b).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import signal
import threading
import time
import traceback
import warnings
from typing import Iterator, Optional

import numpy as np
import torch

from glom_tpu_torch import checkpoint as ckpt_lib
from glom_tpu_torch import profiling
from glom_tpu_torch.config import GlomConfig, TrainConfig, resolve_device
from glom_tpu_torch.kernels import _build
from glom_tpu_torch.kernels import wrappers as kernel_wrappers
from glom_tpu_torch.models.glom import tree_map
from glom_tpu_torch.obs import (
    EVENT_FORENSICS,
    EVENT_NAN,
    EVENT_PREEMPT_STOP,
    EVENT_RECOMPILE,
    EVENT_RESUME,
    MetricRegistry,
    StepTimeRegressionMonitor,
    TraceExporter,
    TraceSink,
    Tracer,
    TriggerEngine,
)
from glom_tpu_torch.obs.diagnostics import flatten_diagnostics, make_diagnostics_fn
from glom_tpu_torch.obs.forensics import FlightRecorder, ForensicsManager
from glom_tpu_torch.obs.monitors import MemoryMonitor, NumericsMonitor, RecompileMonitor
from glom_tpu_torch.obs.timing import PhaseTimer
from glom_tpu_torch.obs.triggers import (
    TRIGGER_CRASH,
    TRIGGER_GRAD_SPIKE,
    TRIGGER_NAN,
    TRIGGER_PREEMPT,
    TRIGGER_RECOMPILE,
    TRIGGER_STEP_TIME,
)
from glom_tpu_torch.profiling import annotate, trace
from glom_tpu_torch.resilience import integrity
from glom_tpu_torch.models import glom as glom_model
from glom_tpu_torch.parallel.comm import raw_all_reduce
from glom_tpu_torch.parallel.ff_shard import make_sharded_ff, make_sharded_ff_pallas
from glom_tpu_torch.parallel.fused_shard import make_sharded_fused_update
from glom_tpu_torch.parallel.mesh import Mesh, make_mesh
from glom_tpu_torch.parallel.placement import gather_to_host, shard_tree, state_shardings
from glom_tpu_torch.parallel.ring import make_ring_consensus
from glom_tpu_torch.parallel.sharding import (decoder_pspecs, level_sharded_pspecs,
                                              param_pspecs, replicated_pspecs)
from glom_tpu_torch.parallel.step import MeshShard, column_slice, make_gathered_consensus
from glom_tpu_torch.parallel.ulysses import make_ulysses_consensus
from glom_tpu_torch.training import denoise
from glom_tpu_torch.training.eval import make_psnr_fn
from glom_tpu_torch.training.metrics import MetricLogger
from glom_tpu_torch.training.optim import Optimizer, tree_map2


def _adam_chain(node, decay_key: Optional[str]) -> Optional[dict]:
    """The ``{count, mu, nu}`` of an adam or adamw chain's flattened optax
    state, or None.  ``optax.adam(lr)`` is ``chain(scale_by_adam,
    scale_by_learning_rate)`` and ``adamw`` puts ``add_decayed_weights``
    between them; only ``scale_by_adam`` (entry 0) and, with a schedule,
    ``scale_by_learning_rate``'s step count (entry ``decay_key``: 1 for
    adam, 2 for adamw; None for a constant rate) hold arrays: the empty
    states leave no key in a checkpoint."""
    if not isinstance(node, dict):
        return None
    adam = node.get("0")
    if not (isinstance(adam, dict) and set(adam) == {"count", "mu", "nu"}):
        return None
    if set(node) != ({"0"} if decay_key is None else {"0", decay_key}):
        return None
    if decay_key is not None:
        v = node[decay_key]
        if not isinstance(v, dict) or set(v) != {"count"} or int(np.asarray(v["count"])) != int(
                np.asarray(adam["count"])):
            return None
    return adam


def opt_state_from_optax(opt, train: dict) -> Optional[dict]:
    """A ``glom_tpu`` checkpoint's optax state in the port's layout ``{count,
    mu, nu}``, or None.  ``train`` is the checkpoint's ``config.json`` train
    section; its ``weight_decay``, ``grad_clip_norm`` and ``lr_schedule``
    name the chain ``glom_tpu/training/trainer.py`` builds from it (adam or
    adamw, either one under ``clip_by_global_norm``, whose state is empty and
    leaves entry 1 alone), and the state must have that chain's shape.  A
    state of another shape, as a custom ``tx`` leaves, gives None; one of
    the same shape (optax's adam with other b1, b2 or eps; yogi) cannot be
    told apart, so the port's Adam constants are assumed."""
    sched = train.get("lr_schedule", "constant") != "constant"
    decay_key = ("2" if train.get("weight_decay") else "1") if sched else None
    if train.get("grad_clip_norm"):
        if not (isinstance(opt, dict) and set(opt) == {"1"}):
            return None
        opt = opt["1"]
    return _adam_chain(opt, decay_key)


def opt_state_to_optax(opt: dict, train: TrainConfig) -> dict:
    """The port's ``{count, mu, nu}`` (numpy trees) in the layout of the
    optax chain ``glom_tpu``'s trainer builds from ``train``: the inverse of
    :func:`opt_state_from_optax`."""
    count = np.asarray(opt["count"], np.int32)
    node = {"0": {"count": count, "mu": opt["mu"], "nu": opt["nu"]}}
    if train.lr_schedule != "constant":
        node["2" if train.weight_decay else "1"] = {"count": count}
    return {"1": node} if train.grad_clip_norm else node


class NonFiniteError(RuntimeError):
    """Raised (with ``TrainConfig.halt_on_nan``) when a numerics window shows
    non-finite gradients or loss, before the poisoned parameters can be
    checkpointed: failing fast is what lets a supervisor
    (:mod:`glom_tpu_torch.resilience.supervisor`) restart from the last
    clean checkpoint."""


# Why the port lacks each thing it refuses: the one table of reasons, read by
# the trainer's refusals (UNSUPPORTED) and by the CLI's (training/train.py)
REASONS = {
    "mesh": "sharded saves and elasticity, ROADMAP queue 1, item 6b",
    "device": "the port picks its device with --device",
}

# TrainConfig fields the port's trainer does not implement: (default, REASONS key)
UNSUPPORTED = {
    "checkpoint_backend": ("npz", "mesh"),
}

PARAM_SHARDINGS = ("tp", "ep", "replicated")


def check_supported(train: TrainConfig) -> None:
    """Refuse the TrainConfig fields this trainer does not implement."""
    for field, (default, why) in UNSUPPORTED.items():
        if getattr(train, field) != default:
            raise NotImplementedError(
                f"TrainConfig.{field}={getattr(train, field)!r} is not in the port's "
                f"trainer yet ({REASONS[why]})")
    if train.param_sharding not in PARAM_SHARDINGS:
        raise ValueError(f"unknown param_sharding {train.param_sharding!r}; one of "
                         f"{PARAM_SHARDINGS}")


def check_mesh_supported(config: GlomConfig, train: TrainConfig, mesh) -> None:
    """Refuse what the mesh path of a world above one rank does not run yet."""
    for field, on in (("diag_every", bool(train.diag_every)),
                      ("consistency", train.consistency != "none")):
        if on:
            raise NotImplementedError(
                f"TrainConfig.{field}={getattr(train, field)!r} on a mesh of "
                f"{mesh.world_size} ranks is not in the port yet ({REASONS['mesh']})")
    if config.fuse_ff and train.param_sharding == "ep":
        raise NotImplementedError(
            f"fuse_ff with param_sharding='ep' on a mesh of ranks concatenates the two nets' "
            f"group-split weights, which no rank holds whole ({REASONS['mesh']})")


def _to_numpy_tree(tree):
    """float32 numpy copies of a tensor tree, made before this returns (a
    card's tensors copy to the host; a host tensor is copied too, so the
    arrays never share memory with the live state)."""
    return tree_map(lambda t: t.detach().to("cpu", torch.float32, copy=True).numpy(), tree)


class Trainer:
    # fields that fix the parameters' shapes and meaning (glom_tpu's list)
    _ARCH_FIELDS = ("dim", "levels", "image_size", "patch_size", "channels", "ff_mult")
    # per-step numerics keys: logged as window aggregates (NumericsMonitor),
    # never as the last step's raw values
    _NUMERICS_KEYS = ("nonfinite_grads", "loss_nonfinite")

    def __init__(self, config: GlomConfig, train: TrainConfig, *, device=None,
                 optimizer: Optional[Optimizer] = None, logger: Optional[MetricLogger] = None,
                 mesh: Optional[Mesh] = None):
        check_supported(train)
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(train.mesh_shape, train.mesh_axes)
        config = self._plan_mesh(config, train)
        self.config = config
        self.train_cfg = train
        self.optimizer = optimizer if optimizer is not None else Optimizer.from_config(train)
        # ONE registry per trainer and logger pair: a caller's logger's
        # registry is adopted, so what the trainer instruments and what the
        # exporters render are one set of metrics
        self.logger = logger if logger is not None else MetricLogger()
        self.registry = getattr(self.logger, "registry", None) or MetricRegistry()
        if getattr(self.logger, "registry", "absent") is None:
            self.logger.registry = self.registry
        if not self.mesh.is_leader and hasattr(self.logger, "emit"):
            self.logger.emit = False    # rank 0 logs, as glom_tpu's process 0
        if hasattr(self.logger, "add_exporter"):
            from glom_tpu_torch.obs import CsvExporter, PrometheusTextfileExporter

            if train.metrics_csv:
                self.logger.add_exporter(CsvExporter(train.metrics_csv))
            if train.prom_textfile:
                self.logger.add_exporter(PrometheusTextfileExporter(train.prom_textfile))
        # every rank draws the whole state from the seed, then keeps its slice
        self.state = denoise.init_state(
            torch.Generator().manual_seed(train.seed), config, self.optimizer,
            decoder=train.decoder, decoder_hidden_mult=train.decoder_hidden_mult,
            device=self.device, noise_seed=train.seed)
        self._specs = state_shardings(self.state.params, {
            "glom": self._glom_specs, "decoder": decoder_pspecs(train.decoder)})
        if self._sharded:
            params = shard_tree(self.state.params, self._specs, self.mesh)
            self.state = denoise.DenoiseState(params, self.optimizer.init(params), 0,
                                              self.state.generator)
        # on a mesh of ranks, each step and eval computes this rank's rows and
        # columns and reduces over the ranks
        fns = dict(consensus_fn=self._consensus_fn, ff_fn=self._ff_fn, fused_fn=self._fused_fn,
                   shard=MeshShard(config, self.mesh, self._specs, self._data_axis,
                                   self._seq_axis) if self._sharded else None)
        self._eval_suite = None
        self._step = denoise.make_step_fn(config, train, self.optimizer, **fns)
        # without a suite, eval scores the incoming batch's denoising PSNR
        self._eval = make_psnr_fn(config, noise_std=train.noise_std, iters=train.iters,
                                  timestep=train.loss_timestep, level=train.loss_level,
                                  decoder=train.decoder, **fns)
        self._stop_requested = False
        if self.device.type == "cuda" and (config.ff_impl, config.attention_impl) != ("dense", "dense"):
            # every kernel the config can run (K8 and its backward's K1-K7 with
            # "fused"), before the first step, which would otherwise pay for it
            _build.build_all()

        # -- runtime health monitors: kernel builds and loads mid-run are the
        # port's recompiles
        self._recompile_mon = RecompileMonitor(lambda: sum(_build.events().values()))
        self._mem_mon = MemoryMonitor(self.device)
        self._num_mon = NumericsMonitor(spike_factor=train.grad_spike_factor)
        # -- step-scoped spans: each logging window one trace, each phase a
        # span; a window holds about 9 phase spans a step
        self.tracer = Tracer(registry=self.registry, sink=TraceSink(
            max_spans=max(512, 12 * (train.log_every or 1) + 16)))

        # -- anomaly-triggered forensics: the flight recorder tees every
        # logged record into a bounded ring; bundles, triggers and the
        # step-time detector exist only with a forensics_dir
        self._recorder = FlightRecorder(capacity=train.forensics_ring) if train.forensics_ring \
            else None
        self._forensics = None
        self._triggers = None
        self._steptime_mon = None
        self._wrappers = kernel_wrappers()
        self._last_batch = None            # (images, shape) of the last step
        self._last_launches: dict = {}     # the wrappers' launches across it
        if train.forensics_dir and self.mesh.is_leader:
            self._triggers = TriggerEngine(debounce_steps=train.forensics_debounce_steps,
                                           max_captures=train.forensics_max_captures,
                                           registry=self.registry)
            self._forensics = ForensicsManager(
                train.forensics_dir, recorder=self._recorder,
                config={"glom": config.to_json_dict(), "train": train.to_json_dict()},
                # profile_dir's trace owns the profiler: two cannot coexist
                trace_steps=0 if train.profile_dir else train.forensics_trace_steps,
                snapshot_fn=self._forensics_snapshot if train.forensics_hlo else None,
                registry=self.registry)
            if train.forensics_step_time_factor:
                self._steptime_mon = StepTimeRegressionMonitor(
                    factor=train.forensics_step_time_factor)
        # checkpoint-integrity telemetry: quarantines found during resume
        # count ckpt_corrupt_total and fire the debounced ckpt_corrupt trigger
        self._integrity_obs = integrity.IntegrityObserver(
            registry=self.registry, triggers=self._triggers, forensics=self._forensics)

        self._diag = None
        if train.diag_every:
            self._diag = make_diagnostics_fn(config, iters=train.iters, device=self.device)
        self._ckpt_thread: Optional[threading.Thread] = None
        self._ckpt_error: Optional[BaseException] = None
        # every rank built: on a process group even a world of one runs its
        # backend's collective here
        self.mesh.barrier()

    def _plan_mesh(self, config: GlomConfig, train: TrainConfig) -> GlomConfig:
        """``glom_tpu``'s mesh rules (``glom_tpu/training/trainer.py``): the
        batch checks, ``"auto"`` resolving to the ring under a seq axis, the
        spec tables, and the consensus, FF and fused functions the step runs.
        Returns the config with ``attention_impl`` resolved."""
        mesh = self.mesh
        axes = train.mesh_axes
        if len(axes) < 2:
            raise ValueError(
                f"mesh_axes needs at least (data, model) axes, got {axes}; "
                "use mesh_shape=(N, 1, 1) for pure DP")
        data_axis, model_axis = axes[0], axes[1]
        seq_axis = axes[2] if len(axes) > 2 else None
        self._data_axis, self._seq_axis = data_axis, seq_axis
        if train.batch_size % mesh.size(data_axis) != 0:
            raise ValueError(f"batch_size {train.batch_size} not divisible by data-axis size "
                             f"{mesh.size(data_axis)}")
        microbatch = train.batch_size // train.grad_accum_steps
        if microbatch % mesh.size(data_axis) != 0:
            raise ValueError(
                f"microbatch {microbatch} (batch {train.batch_size} / grad_accum_steps "
                f"{train.grad_accum_steps}) not divisible by data-axis size "
                f"{mesh.size(data_axis)}")
        seq_size = mesh.size(seq_axis) if seq_axis else 1
        if config.attention_impl == "auto" and seq_size > 1:
            if config.num_patches % seq_size == 0:
                config = dataclasses.replace(config, attention_impl="ring")
            else:
                warnings.warn(
                    f"attention_impl='auto' cannot resolve to the ring "
                    f"consensus: num_patches {config.num_patches} not "
                    f"divisible by seq-axis size {seq_size} — falling "
                    f"back to the model-level rule, which all-gathers "
                    f"the seq-sharded state (no sequence parallelism in "
                    f"the consensus)", stacklevel=3)
        self._sharded = mesh.world_size > 1
        if self._sharded:
            check_mesh_supported(config, train, mesh)
            column_slice(config, mesh, seq_axis)    # n must split over seq
        expert_axes = tuple(a for a in axes[3:] if mesh.size(a) > 1)
        if train.param_sharding == "tp":
            self._glom_specs = param_pspecs(config, model_axis=model_axis)
        elif train.param_sharding == "ep":
            self._glom_specs = level_sharded_pspecs(
                config, model_axis=model_axis, axis_size=mesh.size(model_axis),
                extra_axes={a: mesh.size(a) for a in expert_axes} or None)
        else:
            self._glom_specs = replicated_pspecs(config)

        consensus_fn = ff_fn = fused_fn = None
        if config.attention_impl in ("ring", "ulysses"):
            if seq_axis is None:
                raise ValueError(
                    f"attention_impl={config.attention_impl!r} needs a third "
                    f"(seq) mesh axis; got mesh_axes={axes}")
            make_sp = make_ring_consensus if config.attention_impl == "ring" \
                else make_ulysses_consensus
            consensus_fn = make_sp(
                mesh, attend_self=config.consensus_self,
                non_local_mask=glom_model.resolve_locality_mask(config, self.device),
                seq_axis=seq_axis, num_patches=config.num_patches)
        elif seq_size > 1:
            # a dense or kernel consensus of all n columns, gathered over seq
            consensus_fn = make_gathered_consensus(
                glom_model.make_consensus_fn(config, self.device), mesh, seq_axis)
        denoise.check_trainable(config, train, consensus_fn=consensus_fn)
        params_sharded = (train.param_sharding != "replicated"
                          and any(mesh.size(a) > 1 for a in (model_axis,) + expert_axes))
        if self._sharded:
            # pure DP or replicated params: K8 on each rank's rows
            fused_fn = make_sharded_fused_update(config, self.device, seq_size=seq_size,
                                                 params_sharded=params_sharded)
            if fused_fn is None:
                shard_kw = dict(param_sharding=train.param_sharding, model_axis=model_axis,
                                extra_expert_axes=expert_axes)
                if config.ff_impl in ("pallas", "fused"):
                    ff_fn = make_sharded_ff_pallas(mesh, fused_bwd=config.ff_fused_bwd,
                                                   **shard_kw)
                elif params_sharded:
                    ff_fn = make_sharded_ff(mesh, **shard_kw)
        self._consensus_fn, self._ff_fn, self._fused_fn = consensus_fn, ff_fn, fused_fn
        return config

    def set_eval_suite(self, suite) -> None:
        """Attach or replace the held-out :class:`~glom_tpu_torch.training.eval.EvalSuite`
        (one rank's: on a mesh of ranks it is refused, ROADMAP queue 1, item 6b)."""
        if self._sharded and suite is not None:
            raise NotImplementedError(
                f"an EvalSuite on a mesh of {self.mesh.world_size} ranks is not in the port "
                f"yet ({REASONS['mesh']})")
        self._eval_suite = suite

    # -- one step ------------------------------------------------------------
    def put(self, img) -> torch.Tensor:
        """A batch (numpy or tensor) as the step takes it: float32 on the
        trainer's device."""
        return torch.as_tensor(img).to(self.device, torch.float32)

    def step(self, img, *, noise: Optional[torch.Tensor] = None) -> dict:
        """One train step on a batch (numpy or tensor); returns its metrics
        as device scalars."""
        self.state, metrics = self._step(self.state, self.put(img), noise=noise)
        return metrics

    # -- forensics -------------------------------------------------------------
    def _log(self, step: int, **scalars) -> None:
        """Log one record and tee it into the flight recorder, so a later
        bundle carries the records leading up to the anomaly.  Every log
        site of the trainer goes through here."""
        if self._recorder is not None:
            self._recorder.record(step, scalars)
        self.logger.log(step, **scalars)

    def _launch_counts(self) -> dict:
        return {name: fn.launches for name, fn in self._wrappers.items()}

    def _forensics_snapshot(self) -> dict:
        """The last step's snapshot (``profiling.step_snapshot``): its
        kernel launches, the analytic cost of a step at its batch, the
        state's memory.  Runs nothing on the card."""
        if self._last_batch is None:
            return {}
        tc = self.train_cfg
        iters = tc.iters if tc.iters is not None else self.config.default_iters
        executed = denoise.resolve_loss_timestep(tc, iters)
        images = self._last_batch * (2 if tc.consistency != "none" else 1)
        cost = profiling.analytic_cost(self.config, images, executed, train=True,
                                       param_bytes=profiling.tree_nbytes(self.state.params))
        return profiling.step_snapshot(self._last_launches, cost=cost, params=self.state.params,
                                       opt_state=self.state.opt_state, device=self.device)

    def _maybe_capture(self, trigger: str, step: int, detail: dict) -> None:
        """Route one monitor firing through the trigger engine (debounce and
        budget) and, when accepted, write a bundle.  Never raises."""
        if self._forensics is None:
            return
        if self._triggers is not None and not self._triggers.fire(trigger, step):
            return
        path = self._forensics.capture(trigger, step, detail)
        if path:
            self._log(step, event=EVENT_FORENSICS, trigger=trigger, bundle=path)
        elif self._triggers is not None:
            # the capture failed (warned by the manager): give the budget
            # slot back so a later anomaly can still be captured
            self._triggers.refund(trigger, step)

    def _crash_capture(self, exc: BaseException) -> None:
        """The bundle of an exception out of ``fit``: past the trigger engine
        (a crash fires once), best effort; the exception is what surfaces."""
        if self._forensics is None:
            return
        self._forensics.stop_trace()
        self._forensics.capture(
            TRIGGER_CRASH, int(self.state.step),
            {"error": f"{type(exc).__name__}: {exc}",
             "traceback": "".join(traceback.format_exception(type(exc), exc,
                                                             exc.__traceback__))})

    # -- checkpoints ---------------------------------------------------------
    def finish_saves(self) -> None:
        """Block until an async checkpoint write in flight is durable.
        Re-raises the writer's exception (a swallowed ENOSPC, or a torn
        artifact, would let ``fit`` claim a checkpoint that is not there)."""
        t = self._ckpt_thread
        if t is not None:
            t.join()
            self._ckpt_thread = None
            err, self._ckpt_error = self._ckpt_error, None
            if err is not None:
                raise err

    def _write_config_json(self, directory: str) -> None:
        """Make the directory self-describing; refuse to save a different
        architecture into it."""
        path = os.path.join(directory, "config.json")
        if os.path.exists(path):
            self._validate_config_json(directory, verb="save into")
        ckpt_lib.write_json(directory, "config.json", {
            "glom": self.config.to_json_dict(), "train": self.train_cfg.to_json_dict()})

    def _validate_config_json(self, directory: str, *, verb: str = "load") -> None:
        path = os.path.join(directory, "config.json")
        if not os.path.exists(path):
            return
        with open(path) as f:
            recorded = json.load(f)["glom"]
        mine = self.config.to_json_dict()
        diff = {k: (recorded.get(k), mine.get(k)) for k in self._ARCH_FIELDS
                if recorded.get(k) != mine.get(k)}
        if diff:
            raise ValueError(
                f"refusing to {verb} {directory}: it holds checkpoints of a different "
                f"model architecture; differing fields (directory, this trainer): {diff}")

    @staticmethod
    def _recorded_train(directory: str) -> dict:
        """The train section of ``directory``'s ``config.json``; empty when
        there is none (the defaults: adam, a constant rate, no clipping)."""
        path = os.path.join(directory, "config.json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f).get("train", {})

    def _host_trees(self, data_state: Optional[dict]) -> dict:
        """The state as numpy trees on the host, copied before this returns;
        on a mesh of ranks each sharded leaf is all-gathered first (every
        rank takes part)."""
        st = self.state
        if self._sharded:
            host = lambda tree: gather_to_host(tree, self.mesh, self._specs)
        else:
            host = _to_numpy_tree
        opt = {"count": st.opt_state["count"], "mu": host(st.opt_state["mu"]),
               "nu": host(st.opt_state["nu"])}
        trees = {
            "params": host(st.params),
            "opt": opt_state_to_optax(opt, self.train_cfg),
            "rng": np.asarray([0, (self.train_cfg.seed + st.step) % 2 ** 32], np.uint32),
            "generator": st.generator.get_state().numpy().copy(),
        }
        if data_state is not None:
            trees["data"] = {k: np.asarray(int(v)) for k, v in data_state.items()}
        return trees

    @staticmethod
    def _write(directory: str, step: int, trees: dict) -> str:
        path = ckpt_lib.save(directory, step, trees)
        ckpt_lib.prune(directory, 3, protect=step)
        return path

    def save(self, directory: str, *, data_state: Optional[dict] = None) -> str:
        """Write the full training state at the current step, with the data
        stream's cursor ``data_state`` when given; returns the artifact's
        path.  With ``async_checkpoint`` the path is named at once and the
        write runs on a thread: it is durable only once
        :meth:`finish_saves` returns (``fit`` drains on every exit path)."""
        self.finish_saves()  # order the manifests; at most one write in flight
        if self._sharded and data_state is not None:
            # one artifact carries one cursor, and the ranks' would differ
            warnings.warn(
                "data-iterator cursor is not checkpointed with backend='npz' on a mesh "
                f"of {self.mesh.world_size} ranks; sharded saves are {REASONS['mesh']}",
                stacklevel=2)
            data_state = None
        step = int(self.state.step)
        trees = self._host_trees(data_state)
        if not self.mesh.is_leader:
            # rank 0 writes the gathered state; the others wait for it
            self.mesh.barrier()
            return ""
        os.makedirs(directory, exist_ok=True)
        self._write_config_json(directory)
        if not self.train_cfg.async_checkpoint:
            path = self._write(directory, step, trees)
            self.mesh.barrier()
            return path

        def write():
            try:
                self._write(directory, step, trees)
                if ckpt_lib.verify_file_integrity(directory, step) is False:
                    raise ckpt_lib.CorruptCheckpointError(
                        f"checkpoint step {step} in {directory} failed its integrity check "
                        f"after the write")
            except BaseException as e:  # surfaced by finish_saves()
                self._ckpt_error = e

        # non-daemon: interpreter exit must not kill a write mid-savez
        self._ckpt_error = None
        self._ckpt_thread = threading.Thread(target=write, name="glom-torch-ckpt")
        self._ckpt_thread.start()
        self.mesh.barrier()
        return ckpt_lib.npz_path(directory, step)

    def restore(self, directory: str, *, step: Optional[int] = None, batches=None) -> int:
        """Restore params, optimizer state and the noise generator; with
        ``step=None`` from the newest step that passes its integrity check
        (quarantining corrupt newer ones).  The optimizer state is mapped
        from the optax layout of the chain ``config.json`` names
        (:func:`opt_state_from_optax`).  A ``glom_tpu`` checkpoint holds no
        generator state (its JAX PRNG key has no torch counterpart), so the
        noise generator keeps its fresh seed, with a warning.  When
        ``batches`` is resumable (``load_state_dict``), the checkpoint's
        ``data`` cursor is handed to it; a checkpoint without one warns and
        leaves the stream where it is.  Returns the step."""
        self.finish_saves()  # never read past a write in flight
        self._validate_config_json(directory)
        step, trees = integrity.restore_with_fallback(
            directory, ("params", "opt"), optional=("generator", "data"), step=step,
            observer=self._integrity_obs)
        opt = opt_state_from_optax(trees["opt"], self._recorded_train(directory))
        if opt is None and isinstance(trees["opt"], dict) and set(trees["opt"]) == {
                "count", "mu", "nu"}:
            raise ValueError(
                f"checkpoint step {step} in {directory} is in the port's older layout (opt as "
                f"one {{count, mu, nu}} tree, rng as the generator's bytes), which no longer "
                f"resumes: load its params with load_checkpoint_state or Glom.load and start "
                f"a new optimizer")
        if opt is None:
            raise ValueError(
                f"checkpoint step {step} in {directory}: its optimizer state is not in "
                f"the port's layout (the optax adam or adamw chain its config.json names; "
                f"a custom optax transformation's state is not resumed: load its params "
                f"with load_checkpoint_state and start a new optimizer)")
        ref = self.state.params

        def like(tree, template):
            # a mesh rank keeps its slice of the whole tree it loaded
            whole = tree_map2(lambda t, a: torch.from_numpy(np.asarray(a)).to(t.dtype),
                              template, tree)
            if self._sharded:
                whole = shard_tree(whole, self._specs, self.mesh)
            return tree_map2(lambda t, a: a.to(t.device), template, whole)

        params = like(trees["params"], ref)
        self.state = denoise.DenoiseState(
            params,
            {"count": int(opt["count"]), "mu": like(opt["mu"], ref), "nu": like(opt["nu"], ref)},
            int(step), self.state.generator)
        if "generator" in trees:
            self.state.generator.set_state(torch.from_numpy(np.asarray(trees["generator"],
                                                                       np.uint8)))
        else:
            warnings.warn(
                f"checkpoint step {step} in {directory} is glom_tpu's: its optimizer state "
                f"resumes as the chain its config.json names, with optax's default Adam "
                f"constants (b1 0.9, b2 0.999, eps 1e-8) assumed; its JAX PRNG key has no "
                f"torch counterpart, so the noise generator starts fresh from this "
                f"trainer's seed", stacklevel=2)
        if batches is not None and hasattr(batches, "load_state_dict"):
            if "data" in trees:
                batches.load_state_dict({k: int(v) for k, v in trees["data"].items()})
            else:
                warnings.warn(f"checkpoint step {step} carries no data-iterator state; the "
                              f"stream restarts from its initial cursor", stacklevel=2)
        return int(step)

    # -- the loop ------------------------------------------------------------
    def fit(self, batches: Iterator, steps: Optional[int] = None) -> dict:
        """Run the loop to ``steps`` total steps (default ``TrainConfig.steps``).
        With a checkpoint dir the loop first resumes from its newest valid
        step, so ``steps`` at or below it does nothing.  A resumable stream
        (``state_dict``) has its cursor restored with the state and saved in
        every checkpoint.  Returns the last logged metrics.

        With ``forensics_dir``, an exception out of the loop writes a
        ``crash-<step>`` bundle (the flight recorder's ring, the env
        fingerprint, the step snapshot, the traceback) before it surfaces,
        and ``faulthandler`` writes the crashes Python never sees to
        ``<forensics_dir>/faulthandler.log``.  Every exit path drains the
        async checkpoint writer and closes the logger's exporters."""
        armed = self._forensics is not None and self._forensics.arm_faulthandler()
        try:
            return self._fit(batches, steps)
        except Exception as e:
            self._crash_capture(e)
            raise
        finally:
            if armed:
                self._forensics.disarm_faulthandler()
            try:
                self.finish_saves()
            except Exception:
                # the original exception is the one to surface, but the user
                # must still learn that the last checkpoint write failed
                warnings.warn("async checkpoint write failed while handling another error; "
                              "the latest checkpoint may be missing:\n"
                              + traceback.format_exc(), stacklevel=2)
            finally:
                try:
                    self.logger.close()
                except OSError:
                    pass  # a full disk must not mask the original error

    def _fit(self, batches, steps: Optional[int]) -> dict:
        cfg = self.train_cfg
        steps = steps if steps is not None else cfg.steps
        if cfg.checkpoint_dir and ckpt_lib.latest_step(cfg.checkpoint_dir, strict=True) is not None:
            resume = integrity.latest_valid_step(cfg.checkpoint_dir, observer=self._integrity_obs)
            if resume is not None:
                self._log(self.restore(cfg.checkpoint_dir, step=resume, batches=batches),
                          event=EVENT_RESUME)
            else:
                warnings.warn(f"every checkpoint in {cfg.checkpoint_dir} failed its integrity "
                              f"check and was quarantined; training restarts from step 0",
                              stacklevel=2)
        self._stop_requested = False
        previous = None
        if threading.current_thread() is threading.main_thread():
            previous = signal.signal(signal.SIGTERM, self._request_stop)
        try:
            return self._fit_loop(batches, steps)
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)

    def _request_stop(self, signum, frame) -> None:
        self._stop_requested = True

    def _agreed(self, flag: bool) -> bool:
        """``flag`` on any rank (a stop must end every rank at one step)."""
        if not self._sharded:
            return flag
        votes = torch.tensor([float(flag)], device=self.device)
        for name in self.mesh.axis_names:
            votes = raw_all_reduce(votes, self.mesh.axis(name))
        return bool(votes.item() > 0)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _drain_steps(self, timer: PhaseTimer) -> None:
        """Wait out the issued steps, charged to the ``step`` phase, before a
        blocking phase (eval, diagnostics, checkpoint): its first sync would
        otherwise take the queued train work into its own bucket, and
        ``imgs_per_sec`` leaves those phases out."""
        with timer.phase("step"):
            self._sync()

    def _evaluate(self, i: int, x: torch.Tensor, timer: PhaseTimer) -> None:
        """The eval phase before step ``i + 1``: the queued steps drain first,
        then the suite runs, or the incoming batch's PSNR is taken before the
        step consumes it, with noise from a generator seeded ``seed + i``."""
        self._drain_steps(timer)
        with timer.phase("eval"), annotate("eval"):
            gen = torch.Generator(device=self.device).manual_seed(self.train_cfg.seed + i)
            if self._eval_suite is not None:
                self._log(i + 1, **self._eval_suite.run(self.state.params, gen))
            else:
                self._log(i + 1, psnr_db=float(self._eval(self.state.params, x, generator=gen)))

    def _fit_loop(self, batches, steps: int) -> dict:
        cfg = self.train_cfg
        data_state = batches.state_dict if hasattr(batches, "state_dict") else lambda: None
        start = self.state.step
        last_metrics: dict = {}
        last_saved = -1
        completed, stopped = steps, False
        window, window_imgs = [], 0
        poll = cfg.log_every or cfg.stop_poll_steps or 1
        self._sync()
        timer = PhaseTimer(registry=self.registry, tracer=self.tracer)
        emitted_recompiles = self._recompile_mon.recompiles
        with contextlib.ExitStack() as profiler:
            for i in range(start, steps):
                if cfg.profile_dir:
                    # trace a 3-step window (steps 2, 3, 4 of this run), as
                    # glom_tpu does; trace() drains the card at its end
                    if i == start + 2:
                        self._sync()
                        profiler.enter_context(trace(cfg.profile_dir))
                    elif i == start + 5:
                        profiler.close()
                with timer.phase("data_wait"), annotate("data_wait"):
                    img = next(batches)
                with timer.phase("h2d"), annotate("h2d"):
                    x = self.put(img)
                if cfg.eval_every and (i + 1) % cfg.eval_every == 0:
                    self._evaluate(i, x, timer)
                before = self._launch_counts() if self._forensics is not None else None
                with timer.phase("step"), annotate("step"):
                    self.state, metrics = self._step(self.state, x)
                if before is not None:
                    # host-side counters: a bundle's snapshot names what the
                    # last step launched without replaying it
                    after = self._launch_counts()
                    self._last_launches = {k: after[k] - before[k] for k in after
                                           if after[k] != before[k]}
                    self._last_batch = int(x.shape[0])
                timer.count_step()
                window_imgs += int(x.shape[0])
                if self._forensics is not None and self._forensics.trace_due(i + 1):
                    # the triggered trace holds the steps it promises
                    self._drain_steps(timer)
                    self._forensics.stop_trace()
                if cfg.log_every or cfg.monitor_numerics:
                    window.append(metrics)
                if self._recompile_mon.poll() and (
                        self._recompile_mon.recompiles > emitted_recompiles):
                    # a kernel built or loaded past the first step: surface
                    # it with the step that paid for it
                    emitted_recompiles = self._recompile_mon.recompiles
                    self.registry.counter(
                        "recompiles", help="kernel builds or loads after the first step").inc()
                    self._log(i + 1, event=EVENT_RECOMPILE,
                              compile_count=self._recompile_mon.compiles)
                    self._maybe_capture(TRIGGER_RECOMPILE, i + 1, {
                        "compile_count": self._recompile_mon.compiles,
                        "recompiles": self._recompile_mon.recompiles})
                if self._diag is not None and (i + 1) % cfg.diag_every == 0:
                    self._drain_steps(timer)
                    with timer.phase("diag"), annotate("diag"):
                        diag = flatten_diagnostics(self._diag(self.state.params["glom"], x))
                    for k in ("island_agreement", "attn_entropy"):
                        self.registry.gauge(k).set(diag[k])
                    self._log(i + 1, **diag)
                if cfg.log_every and (i + 1) % cfg.log_every == 0:
                    last_metrics = self._log_window(i + 1, window, window_imgs, timer)
                    window, window_imgs = [], 0
                elif not cfg.log_every and cfg.monitor_numerics and (i + 1) % poll == 0:
                    # logging off: NaN surveillance still runs, bounded
                    self._numerics_summary(i + 1, self._fetch(window))
                    window = []
                every = cfg.checkpoint_every
                if cfg.checkpoint_dir and every and (i + 1) % every == 0:
                    self._drain_steps(timer)
                    with timer.phase("checkpoint"), annotate("checkpoint"):
                        self.save(cfg.checkpoint_dir, data_state=data_state())
                    last_saved = i + 1
                with timer.phase("stop_poll"):
                    stop = self._agreed(self._stop_requested)
                if stop:
                    self._log(i + 1, event=EVENT_PREEMPT_STOP)
                    if self._forensics is not None:
                        # terminal path, past the trigger engine (fires once);
                        # no snapshot and no trace in the grace window
                        self._forensics.stop_trace()
                        self._forensics.capture(TRIGGER_PREEMPT, i + 1, {"reason": "SIGTERM"},
                                                snapshot=False, trace=False)
                    completed, stopped = i + 1, True
                    break
        self._sync()
        if self._forensics is not None:
            self._forensics.stop_trace()  # a trace window outliving the loop
        if window and cfg.monitor_numerics:
            # the tail past the last boundary (the steps right before a stop,
            # where a diverging run most likely went non-finite) is still
            # surveyed; its throughput record stays dropped
            self._numerics_summary(completed, self._fetch(window))
        if (cfg.checkpoint_dir and (cfg.checkpoint_every or stopped)
                and last_saved != completed and start < completed):
            self.save(cfg.checkpoint_dir, data_state=data_state())
        self.finish_saves()  # fit returns only once the checkpoint is durable
        timer.close()  # the tail window's root span closes before the export
        if cfg.trace_dir and self.mesh.is_leader:
            # Perfetto-loadable export of the run's phase spans; best effort
            try:
                os.makedirs(cfg.trace_dir, exist_ok=True)
                TraceExporter(self.tracer.sink).write(
                    os.path.join(cfg.trace_dir, "train_trace.json"))
            except OSError as e:
                warnings.warn(f"trace export failed ({e})", stacklevel=2)
        return last_metrics

    @staticmethod
    def _fetch(window: list) -> list:
        """A window's per-step device scalars as host floats, in one copy,
        keyed in sorted order as ``glom_tpu``'s jitted step returns them (the
        records' key order follows it)."""
        if not window:
            return []
        keys = sorted(window[0])
        values = torch.stack([torch.stack([m[k].detach().float().reshape(()) for k in keys])
                              for m in window]).cpu().tolist()
        return [dict(zip(keys, row)) for row in values]

    def _numerics_summary(self, step: int, fetched: list) -> dict:
        """Fold one window of fetched per-step metrics into the numerics
        monitor; a window with non-finite values logs the ``nan`` event,
        counts ``nan_windows``, fires the ``nan`` trigger and, with
        ``halt_on_nan``, raises :class:`NonFiniteError` before the step's
        checkpoint can keep the poisoned parameters."""
        num = self._num_mon.update(fetched)
        if num.get("nonfinite_grads") or num.get("loss_nonfinite_steps"):
            self.registry.counter("nan_windows",
                                  help="logging windows with nonfinite grads/loss").inc()
            self._log(step, event=EVENT_NAN, nonfinite_grads=num["nonfinite_grads"],
                      loss_nonfinite_steps=num["loss_nonfinite_steps"])
            # a NaN storm is one incident: the debounce collapses its windows
            self._maybe_capture(TRIGGER_NAN, step, {
                "nonfinite_grads": num["nonfinite_grads"],
                "loss_nonfinite_steps": num["loss_nonfinite_steps"]})
            if self.train_cfg.halt_on_nan:
                raise NonFiniteError(
                    f"nonfinite grads/loss detected at step {step} "
                    f"(nonfinite_grads={num['nonfinite_grads']}, "
                    f"loss_nonfinite_steps={num['loss_nonfinite_steps']}); halting so a "
                    f"supervisor can resume from the last clean checkpoint")
        return num

    def _log_window(self, step: int, window: list, imgs: int, timer: PhaseTimer) -> dict:
        """Cut one logging window: fetch its per-step scalars (the loop's one
        host sync), fold in the monitors, and log the phase-timed record:
        the last step's loss and grad norm, images per second over the
        window's train time (eval, checkpoint, diagnostics and exporter
        writes left out, as ``glom_tpu`` counts it), the window's numerics,
        the card's memory and the phase times.  Returns the last step's
        loss and grad norm."""
        with timer.phase("log_sync"), annotate("log_sync"):
            fetched = self._fetch(window)
        last = {k: v for k, v in fetched[-1].items() if k not in self._NUMERICS_KEYS}
        num = self._numerics_summary(step, fetched) if self.train_cfg.monitor_numerics else {}
        mem = self._mem_mon.sample()
        phases = timer.window()
        overhead = sum(phases.get(f"t_{p}", 0.0) for p in ("eval", "checkpoint", "diag",
                                                            "log_emit"))
        train_s = max(phases["t_window"] - overhead, 1e-9)
        # from the cut to the end of the exporters' writes: the next
        # window's log_emit phase
        t_emit = time.monotonic()
        self.registry.counter("steps_total", help="train steps completed").inc(
            phases["window_steps"])
        self.registry.counter("imgs_total", help="images consumed").inc(imgs)
        for k in ("loss", "grad_norm"):
            if k in last:
                self.registry.gauge(k).set(last[k])
        for k, v in mem.items():
            self.registry.gauge(k, unit="bytes").set(v)
        self._log(step, imgs_per_sec=imgs / train_s,
                  imgs_per_sec_per_chip=imgs / train_s / self.mesh.world_size,
                  **last, **num, **mem, **phases)
        if num.get("grad_norm_spike"):
            self._maybe_capture(TRIGGER_GRAD_SPIKE, step, {"grad_norm": last.get("grad_norm")})
        if self._steptime_mon is not None and phases["window_steps"]:
            regression = self._steptime_mon.update(train_s / phases["window_steps"])
            if regression is not None:
                self._maybe_capture(TRIGGER_STEP_TIME, step, regression)
        timer.add("log_emit", time.monotonic() - t_emit)
        return last
