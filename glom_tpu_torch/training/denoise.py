"""The denoising-SSL objective and train step (``glom_tpu/training/denoise.py``),
and the loader of a self-describing checkpoint directory.

The step computes what ``glom_tpu``'s computes: noise the image, run the
forward to the loss timestep, decode ``state[..., level]`` with the decoder
head, take the MSE in at least float32, backpropagate, apply the optimizer.
One difference: the forward STOPS at the loss timestep.  ``glom_tpu``'s
scan runs all ``iters`` iterations and discards the state after the
timestep; that state does not reach the loss, so the loss and the gradients
are the same, and the port saves the iterations.

The noise is drawn from an explicit ``torch.Generator`` (``jax.random``'s
keys have no torch counterpart), or passed in as a tensor, so that a test
can hand both packages the same noise.

Refused here, by name of its ROADMAP item: ``consistency != "none"``
(queue 1, item 3).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import torch

from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.convert import params_from_numpy
from glom_tpu_torch.models import glom as glom_model
from glom_tpu_torch.models.glom import param_shapes, tree_leaves, tree_map
from glom_tpu_torch.models.heads import decoder_apply, decoder_init, decoder_param_shapes
from glom_tpu_torch.obs.monitors import numerics_metrics
from glom_tpu_torch.resilience import integrity
from glom_tpu_torch.training.optim import Optimizer, apply_updates, global_norm, tree_map2


@dataclasses.dataclass
class DenoiseState:
    """The carried training state: ``{"glom", "decoder"}`` params, the
    optimizer state, the step count, and the generator of the noise."""

    params: dict
    opt_state: dict
    step: int
    generator: torch.Generator


def init_state(generator: torch.Generator, config: GlomConfig, optimizer: Optimizer, *,
               decoder: str = "linear", decoder_hidden_mult: int = 2, device=None,
               noise_seed: int = 0) -> DenoiseState:
    """Parameters drawn on the CPU from ``generator`` (torch inits; other
    numbers than ``jax.random``'s), moved to ``device``; the noise generator
    lives on ``device``, seeded with ``noise_seed``."""
    params = {
        "glom": glom_model.init(generator, config),
        "decoder": decoder_init(generator, config, arch=decoder, hidden_mult=decoder_hidden_mult,
                                dtype=config.param_dtype),
    }
    params = tree_map(lambda t: t.to(device), params)
    noise = torch.Generator(device=device if device is not None else "cpu")
    noise.manual_seed(noise_seed)
    return DenoiseState(params, optimizer.init(params), 0, noise)


def resolve_loss_timestep(train: TrainConfig, iters: int) -> int:
    """The iteration whose state feeds the decoder: ``train.loss_timestep``
    when set (0 is the initial state), else ``iters // 2 + 1`` (the
    reference recipe reads the state after 7 of 12 iterations)."""
    t = train.loss_timestep if train.loss_timestep is not None else iters // 2 + 1
    if not 0 <= t <= iters:
        raise ValueError(f"loss_timestep {t} outside [0, {iters}]")
    return t


def check_trainable(config: GlomConfig, train: TrainConfig) -> None:
    """Refuse what the port's train step does not implement yet: the
    unported ``attention_impl`` values (``ring``, ``ulysses``) and the
    two-view consistency term."""
    glom_model.make_consensus_fn(config)
    if train.consistency != "none":
        raise NotImplementedError(
            f"consistency={train.consistency!r}: the two-view regularizer "
            f"(training/consistency.py) is ROADMAP queue 1, item 3; use 'none'")


def make_loss_fn(config: GlomConfig, train: TrainConfig, *, consensus_fn=None, ff_fn=None,
                 fused_fn=None):
    """``loss(params, img, *, generator=None, noise=None) -> (loss, recon)``.
    ``noise`` (standard normal, ``img``'s shape) is scaled by
    ``train.noise_std``; without it the noise is drawn from ``generator``.
    ``consensus_fn`` / ``ff_fn`` / ``fused_fn`` go to
    :func:`glom_tpu_torch.models.glom.apply` as they are."""
    check_trainable(config, train)
    iters = train.iters if train.iters is not None else config.default_iters
    timestep = resolve_loss_timestep(train, iters)

    def loss_fn(params, img, *, generator=None, noise=None):
        if noise is None:
            noise = torch.randn(img.shape, generator=generator, device=img.device, dtype=img.dtype)
        noised = img + noise.to(img.dtype) * train.noise_std
        # the forward stops at the loss timestep: its state is what decodes
        state = glom_model.apply(params["glom"], noised, config=config, iters=timestep,
                                 consensus_fn=consensus_fn, ff_fn=ff_fn, fused_fn=fused_fn)
        recon = decoder_apply(params["decoder"], state, config, arch=train.decoder,
                              level=train.loss_level)
        acc_dt = torch.promote_types(recon.dtype, torch.float32)
        loss = torch.mean((recon.to(acc_dt) - img.to(acc_dt)) ** 2)
        return loss, recon

    return loss_fn


def make_step_fn(config: GlomConfig, train: TrainConfig, optimizer: Optimizer, *,
                 consensus_fn=None, ff_fn=None, fused_fn=None):
    """``step(state, img, *, noise=None) -> (state, metrics)``.

    With ``train.grad_accum_steps > 1`` the batch splits into that many
    microbatches run one after the other; their gradients add up in float32
    (or wider) accumulators and average before the one optimizer update, so
    for this loss (a mean over the batch) the step is the full-batch step.
    ``noise``, when given, is the whole batch's, split the same way.
    Metrics (device scalars): ``loss``, the raw pre-clip ``grad_norm`` and,
    with ``train.monitor_numerics``, ``nonfinite_grads`` and
    ``loss_nonfinite``.

    ``glom_tpu``'s ``make_train_step`` jits this function and donates its
    state; eager PyTorch has neither, so this is the port's train step."""
    loss_fn = make_loss_fn(config, train, consensus_fn=consensus_fn, ff_fn=ff_fn,
                           fused_fn=fused_fn)
    accum = train.grad_accum_steps

    def grad_of(params, img, noise, generator):
        return loss_and_grads(loss_fn, params, img, generator=generator, noise=noise)

    def step_fn(state: DenoiseState, img: torch.Tensor, *, noise: Optional[torch.Tensor] = None):
        if accum == 1:
            loss, grads = grad_of(state.params, img, noise, state.generator)
        else:
            mb = img.shape[0] // accum
            acc_dt = lambda dt: torch.promote_types(dt, torch.float32)
            loss = torch.zeros((), dtype=acc_dt(config.resolved_compute_dtype), device=img.device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt(p.dtype), device=p.device),
                             state.params)
            for i in range(accum):
                sl = slice(i * mb, (i + 1) * mb)
                l, g = grad_of(state.params, img[sl], None if noise is None else noise[sl],
                               state.generator)
                loss = loss + l.to(loss.dtype)
                grads = tree_map2(lambda a, b: a + b.to(a.dtype), grads, g)
            loss = loss / accum
            grads = tree_map2(lambda g, p: (g / accum).to(p.dtype), grads, state.params)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = apply_updates(state.params, updates)
        metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        if train.monitor_numerics:
            metrics.update(numerics_metrics(tree_leaves(grads), loss))
        return DenoiseState(params, opt_state, state.step + 1, state.generator), metrics

    return step_fn


def loss_and_grads(loss_fn, params, img, **kw):
    """``(loss, grads)`` of ``loss_fn(params, img, **kw)[0]``; ``grads`` has
    ``params``' tree structure."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = loss_fn(live, img, **kw)
    leaves = tree_leaves(live)
    by_leaf = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return loss.detach(), tree_map(lambda p: by_leaf[id(p)], live)


def checkpoint_shapes(config: GlomConfig, train: TrainConfig) -> dict:
    """The shapes of the ``params`` tree a trainer checkpoint holds."""
    return {
        "glom": param_shapes(config),
        "decoder": decoder_param_shapes(
            config, arch=train.decoder, hidden_mult=train.decoder_hidden_mult),
    }


def read_configs(directory: str):
    """``(config, train_cfg)`` from a checkpoint directory's ``config.json``."""
    with open(os.path.join(directory, "config.json")) as f:
        payload = json.load(f)
    return (GlomConfig.from_json_dict(payload["glom"]),
            TrainConfig.from_json_dict(payload.get("train") or {}))


def load_checkpoint_state(directory: str, *, step: Optional[int] = None, device=None):
    """``(step, config, train_cfg, params)`` from a checkpoint directory
    written by ``glom_tpu``'s Trainer or by this package: ``config.json``
    gives the configs, the npz the ``{"glom": ..., "decoder": ...}`` tree,
    returned as tensors on ``device`` in ``config.param_dtype``.

    With ``step=None`` the newest step that passes its integrity check
    loads: a corrupt newer step is quarantined (renamed ``*.corrupt``) and
    the load falls back, as ``glom_tpu``'s loader does.  A pinned ``step``
    raises :class:`~glom_tpu_torch.checkpoint.CorruptCheckpointError` on a
    bad CRC.  A tree that does not match the recorded config raises
    ``ValueError``."""
    config, train_cfg = read_configs(directory)
    step, trees = integrity.restore_with_fallback(directory, ("params",), step=step)
    tree = trees["params"]
    want = checkpoint_shapes(config, train_cfg)
    got = {k: tree_map(lambda a: tuple(a.shape), tree[k]) if k in tree else None
           for k in want}
    if got != want:
        raise ValueError(
            f"checkpoint step {step} in {directory} does not match its "
            f"config.json: parameter shapes {got} vs {want}"
        )
    return step, config, train_cfg, params_from_numpy(tree, config, device)
