"""A minimal single-card trainer (``glom_tpu/training/trainer.py``).

It covers the loop of the JAX package's ``Trainer`` on one device:
``fit`` runs the denoising step (``training/denoise.py``) to a step count,
logs a JSONL record every ``log_every`` steps (loss, the raw pre-clip grad
norm, images per second over the window, the window's non-finite counts),
halts with :class:`NonFiniteError` on non-finite values when
``halt_on_nan``, checkpoints every ``checkpoint_every`` steps, auto-resumes
from the newest checkpoint that passes its integrity check, and on SIGTERM
stops after the step in flight and saves.

A checkpoint is the port's npz layout with its CRC sidecar
(``glom_tpu_torch/checkpoint.py``) beside ``config.json``:
* ``params``: the ``{"glom", "decoder"}`` tree under ``glom_tpu``'s names,
  so ``glom_tpu``'s ``load_checkpoint_state`` and the port's
  ``ServingEngine`` read it;
* ``opt``: the port's optimizer state, ``{"count", "mu", "nu"}``
  (``training/optim.py``).  A ``glom_tpu`` checkpoint's optax state resumes
  too when it has the shape of the chain its ``config.json`` names (adam or
  adamw, either under ``clip_by_global_norm``, as ``glom_tpu``'s trainer
  builds them): :func:`opt_state_from_optax` maps it;
* ``rng``: the state of the noise generator (uint8), so a resumed run
  draws the noise an unbroken run would.  A ``glom_tpu`` checkpoint holds a
  JAX PRNG key instead, which has no torch counterpart: its resume warns
  and keeps the trainer's freshly seeded generator.

The loop is phase-timed as ``glom_tpu``'s is (``obs/timing.py``): every
logged record carries ``t_data_wait``, ``t_h2d``, ``t_step`` and
``t_log_sync`` (seconds over the window), ``t_window`` and
``window_steps``, and each phase is an :func:`~glom_tpu_torch.profiling.annotate`
region.  With ``profile_dir`` the loop traces steps ``start+2`` to
``start+4`` (``profiling.trace``), the window ``glom_tpu`` traces.

Not here yet, each refused by name when the config asks for it: a mesh and
sharded saves (ROADMAP queue 1, item 6), eval (item 3), forensics, request
traces, diagnostics, metric exporters and async saves (item 7).
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import threading
import warnings
from typing import Iterator, Optional

import numpy as np
import torch

from glom_tpu_torch import checkpoint as ckpt_lib
from glom_tpu_torch.config import GlomConfig, TrainConfig, resolve_device
from glom_tpu_torch.convert import params_to_numpy
from glom_tpu_torch.kernels import _build
from glom_tpu_torch.models.glom import tree_map
from glom_tpu_torch.obs.timing import PhaseTimer
from glom_tpu_torch.profiling import annotate, trace
from glom_tpu_torch.resilience import integrity
from glom_tpu_torch.training import denoise
from glom_tpu_torch.training.metrics import MetricLogger
from glom_tpu_torch.training.optim import Optimizer, tree_map2

EVENT_RESUME = "resume"
EVENT_PREEMPT_STOP = "preempt_stop"
EVENT_NAN = "nan"


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


class NonFiniteError(RuntimeError):
    """Raised (with ``TrainConfig.halt_on_nan``) when a logging window shows
    non-finite gradients or loss, before the poisoned parameters can be
    checkpointed."""


# TrainConfig fields the port does not implement, each with its default and
# the ROADMAP item that ports it
_UNSUPPORTED = {
    "eval_every": (0, "queue 1, item 3"),
    "checkpoint_backend": ("npz", "queue 1, item 6"),
    "async_checkpoint": (False, "queue 1, item 7"),
    "forensics_dir": (None, "queue 1, item 7"),
    "forensics_trace_steps": (0, "queue 1, item 7"),
    "trace_dir": (None, "queue 1, item 7"),
    "diag_every": (0, "queue 1, item 7"),
    "metrics_csv": (None, "queue 1, item 7"),
    "prom_textfile": (None, "queue 1, item 7"),
}


def check_supported(train: TrainConfig) -> None:
    """Refuse the TrainConfig fields this trainer does not implement."""
    for field, (default, item) in _UNSUPPORTED.items():
        if getattr(train, field) != default:
            raise NotImplementedError(
                f"TrainConfig.{field}={getattr(train, field)!r} is not in the port's "
                f"trainer yet (ROADMAP {item})")
    if train.mesh_shape is not None and int(np.prod(train.mesh_shape)) > 1:
        raise NotImplementedError(
            f"mesh_shape={train.mesh_shape}: the port trains on one card; the "
            f"multi-GPU port is ROADMAP queue 1, item 6")


def _to_numpy_tree(tree):
    return tree_map(lambda t: t.detach().to("cpu", torch.float32).numpy(), tree)


class Trainer:
    # fields that fix the parameters' shapes and meaning (glom_tpu's list)
    _ARCH_FIELDS = ("dim", "levels", "image_size", "patch_size", "channels", "ff_mult")

    def __init__(self, config: GlomConfig, train: TrainConfig, *, device=None,
                 optimizer: Optional[Optimizer] = None, logger: Optional[MetricLogger] = None):
        denoise.check_trainable(config, train)
        check_supported(train)
        self.config = config
        self.train_cfg = train
        self.device = resolve_device(device)
        self.optimizer = optimizer if optimizer is not None else Optimizer.from_config(train)
        self.logger = logger if logger is not None else MetricLogger()
        self.state = denoise.init_state(
            torch.Generator().manual_seed(train.seed), config, self.optimizer,
            decoder=train.decoder, decoder_hidden_mult=train.decoder_hidden_mult,
            device=self.device, noise_seed=train.seed)
        self._step = denoise.make_step_fn(config, train, self.optimizer)
        self._stop_requested = False
        if self.device.type == "cuda" and (config.ff_impl, config.attention_impl) != ("dense", "dense"):
            # every kernel the config can run (K8 and its backward's K1-K7 with
            # "fused"), before the first step, which would otherwise pay for it
            _build.build_all()

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

    # -- checkpoints ---------------------------------------------------------
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

    def save(self, directory: str) -> str:
        """Write the full training state at the current step; returns the
        artifact's path."""
        os.makedirs(directory, exist_ok=True)
        self._write_config_json(directory)
        st = self.state
        trees = {
            "params": params_to_numpy(st.params),
            "opt": {"count": np.asarray(st.opt_state["count"], np.int32),
                    "mu": _to_numpy_tree(st.opt_state["mu"]),
                    "nu": _to_numpy_tree(st.opt_state["nu"])},
            "rng": st.generator.get_state().numpy(),
        }
        path = ckpt_lib.save(directory, st.step, trees)
        ckpt_lib.prune(directory, 3, protect=st.step)
        return path

    def restore(self, directory: str, *, step: Optional[int] = None) -> int:
        """Restore params, optimizer state and the noise generator; with
        ``step=None`` from the newest step that passes its integrity check
        (quarantining corrupt newer ones).  A ``glom_tpu`` checkpoint's optax
        state is mapped onto the port's (:func:`opt_state_from_optax`); its
        JAX PRNG key is not, so the noise generator keeps its fresh seed.
        Returns the step."""
        self._validate_config_json(directory)
        step, trees = integrity.restore_with_fallback(
            directory, ("params", "opt", "rng"), step=step)
        opt = trees["opt"]
        from_port = isinstance(opt, dict) and set(opt) == {"count", "mu", "nu"}
        if not from_port:
            opt = opt_state_from_optax(opt, self._recorded_train(directory))
        if opt is None:
            raise ValueError(
                f"checkpoint step {step} in {directory}: its optimizer state is not in "
                f"the port's layout {{count, mu, nu}} (a glom_tpu checkpoint holds optax "
                f"state, which the port does not resume; load its params with "
                f"load_checkpoint_state and start a new optimizer)")
        ref = self.state.params

        def like(tree, template):
            return tree_map2(lambda t, a: torch.from_numpy(np.asarray(a)).to(t.device, t.dtype),
                             template, tree)

        params = like(trees["params"], ref)
        self.state = denoise.DenoiseState(
            params,
            {"count": int(opt["count"]), "mu": like(opt["mu"], ref), "nu": like(opt["nu"], ref)},
            int(step), self.state.generator)
        if from_port:
            self.state.generator.set_state(torch.from_numpy(np.asarray(trees["rng"], np.uint8)))
        else:
            warnings.warn(
                f"checkpoint step {step} in {directory} is glom_tpu's: its optimizer state "
                f"resumes as the chain its config.json names, with optax's default Adam "
                f"constants (b1 0.9, b2 0.999, eps 1e-8) assumed; its JAX PRNG key has no "
                f"torch counterpart, so the noise generator starts fresh from this "
                f"trainer's seed", stacklevel=2)
        return int(step)

    # -- the loop ------------------------------------------------------------
    def fit(self, batches: Iterator, steps: Optional[int] = None) -> dict:
        """Run the loop to ``steps`` total steps (default ``TrainConfig.steps``).
        With a checkpoint dir the loop first resumes from its newest valid
        step, so ``steps`` at or below it does nothing.  Returns the last
        logged metrics."""
        cfg = self.train_cfg
        steps = steps if steps is not None else cfg.steps
        if cfg.checkpoint_dir and ckpt_lib.latest_step(cfg.checkpoint_dir, strict=True) is not None:
            resume = integrity.latest_valid_step(cfg.checkpoint_dir)
            if resume is not None:
                self.logger.log(self.restore(cfg.checkpoint_dir, step=resume), event=EVENT_RESUME)
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
            self.logger.close()

    def _request_stop(self, signum, frame) -> None:
        self._stop_requested = True

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fit_loop(self, batches, steps: int) -> dict:
        cfg = self.train_cfg
        start = self.state.step
        last_metrics: dict = {}
        last_saved = -1
        completed, stopped = steps, False
        window, window_imgs = [], 0
        poll = cfg.log_every or cfg.stop_poll_steps or 1
        self._sync()
        timer = PhaseTimer()
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
                with timer.phase("step"), annotate("step"):
                    self.state, metrics = self._step(self.state, x)
                timer.count_step()
                window.append(metrics)
                window_imgs += int(x.shape[0])
                if cfg.log_every and (i + 1) % cfg.log_every == 0:
                    last_metrics = self._log_window(i + 1, window, window_imgs, timer)
                    window, window_imgs = [], 0
                elif cfg.monitor_numerics and (i + 1) % poll == 0:
                    self._numerics(i + 1, window)
                    window = []
                every = cfg.checkpoint_every
                if cfg.checkpoint_dir and every and (i + 1) % every == 0:
                    self.save(cfg.checkpoint_dir)
                    last_saved = i + 1
                if self._stop_requested:
                    self.logger.log(i + 1, event=EVENT_PREEMPT_STOP)
                    completed, stopped = i + 1, True
                    break
        self._sync()
        if window and cfg.monitor_numerics:
            self._numerics(completed, window)
        if (cfg.checkpoint_dir and (cfg.checkpoint_every or stopped)
                and last_saved != completed and start < completed):
            self.save(cfg.checkpoint_dir)
        return last_metrics

    def _numerics(self, step: int, window: list) -> dict:
        """The window's non-finite counts; logs a ``nan`` event and, with
        ``halt_on_nan``, raises :class:`NonFiniteError` when any."""
        if not self.train_cfg.monitor_numerics:
            return {}
        bad = sum(float(m["nonfinite_grads"]) for m in window)
        bad_loss = sum(int(float(m["loss_nonfinite"])) for m in window)
        num = {"nonfinite_grads": bad, "loss_nonfinite_steps": bad_loss}
        if bad or bad_loss:
            self.logger.log(step, event=EVENT_NAN, **num)
            if self.train_cfg.halt_on_nan:
                raise NonFiniteError(
                    f"nonfinite grads/loss at step {step} (nonfinite_grads={bad}, "
                    f"loss_nonfinite_steps={bad_loss}); halting before a checkpoint "
                    f"can keep them")
        return num

    def _log_window(self, step: int, window: list, imgs: int, timer: PhaseTimer) -> dict:
        """One record: the last step's loss and grad norm, the window's
        images per second (host clock from the window's start until its last
        step's values are on the host), its non-finite counts and its phase
        times (``timer.window()``)."""
        with timer.phase("log_sync"), annotate("log_sync"):
            last = {k: float(window[-1][k]) for k in ("loss", "grad_norm")}
        phases = timer.window()
        num = self._numerics(step, window)
        self.logger.log(step, imgs_per_sec=imgs / max(phases["t_window"], 1e-9), **last, **num,
                        **phases)
        return last
