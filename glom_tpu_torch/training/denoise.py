"""The denoising-SSL objective and train step (``glom_tpu/training/denoise.py``),
and the loader of a self-describing checkpoint directory.

The step computes what ``glom_tpu``'s computes: noise the image, run the
forward to the loss timestep, decode ``state[..., level]`` with the decoder
head, take the MSE in at least float32, backpropagate, apply the optimizer.
One difference: the forward STOPS at the loss timestep.  ``glom_tpu``'s
scan runs all ``iters`` iterations and discards the state after the
timestep; that state does not reach the loss, so the loss and the gradients
are the same, and the port saves the iterations.  An injected ``apply_fn``
(the pipelined forward) keeps ``glom_tpu``'s contract and runs all
``iters``.

The noise is drawn from an explicit ``torch.Generator`` (``jax.random``'s
keys have no torch counterpart), or passed in as a tensor, so that a test
can hand both packages the same noise.

With ``train.consistency`` ``"mse"`` or ``"infonce"`` the step runs two
independently noised views of each image as ONE forward of 2·b images, the
first b rows view 1 and the last b view 2; the decoder reads view 1 and
``training/consistency.py`` couples the two views' pooled states.  Their
noise has the layout ``(2, b, ...)``: ``noise[0]`` is view 1's,
``noise[1]`` view 2's.  A microbatch of rows ``sl`` takes ``noise[:, sl]``,
which flattens to the ``(2·mb, ...)`` draw ``glom_tpu`` makes per
microbatch (view 1's rows, then view 2's).
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
from glom_tpu_torch.models.heads import (decoder_apply, decoder_init, decoder_param_shapes,
                                         decoder_patches)
from glom_tpu_torch.obs.monitors import numerics_metrics
from glom_tpu_torch.ops.patch import patchify
from glom_tpu_torch.resilience import integrity
from glom_tpu_torch.training.consistency import regularizer_from_state
from glom_tpu_torch.training.optim import Optimizer, apply_updates, tree_map2


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


CONSISTENCY_KINDS = ("none", "mse", "infonce")


def check_trainable(config: GlomConfig, train: TrainConfig, *, consensus_fn=None,
                    apply_fn=None) -> None:
    """Refuse an ``attention_impl`` the step cannot run without an injected
    ``consensus_fn`` or ``apply_fn`` (``ring`` and ``ulysses`` need a mesh)
    and an unknown consistency kind."""
    if consensus_fn is None and apply_fn is None:
        glom_model.make_consensus_fn(config)
    if train.consistency not in CONSISTENCY_KINDS:
        raise ValueError(f"unknown consistency kind {train.consistency!r}; one of "
                         f"{CONSISTENCY_KINDS}")


def make_loss_fn(config: GlomConfig, train: TrainConfig, *, consensus_fn=None, ff_fn=None,
                 fused_fn=None, apply_fn=None, columns: Optional[slice] = None):
    """``loss(params, img, *, generator=None, noise=None) -> (loss, recon)``.
    ``noise`` (standard normal; ``img``'s shape, or ``(2, *img.shape)`` with
    two views) is scaled by ``train.noise_std``; without it the noise is
    drawn from ``generator``.  ``consensus_fn`` / ``ff_fn`` / ``fused_fn`` go
    to :func:`glom_tpu_torch.models.glom.apply` as they are.

    ``apply_fn`` replaces the forward, with ``glom_tpu``'s contract:
    ``apply_fn(glom_params, img, iters=..., capture_timestep=t) -> (final,
    state_after_t)``, run for all ``iters`` iterations.  A pipelined caller
    passes ``parallel.pipeline.make_pipelined_apply(...)``, which closed over
    its mesh and its consensus and FF choices; it takes the whole batch on
    every rank, so it takes no ``columns``.

    ``columns`` (a seq shard's slice of the patch columns) runs the forward
    on those columns only (``apply(columns=...)``) and takes the MSE of
    their decoded patches against the image's: the mean over the shard's
    pixels, whose mean over the seq ranks is the whole image's MSE; ``recon``
    is then the ``(b, n/S, p*p*c)`` patches."""
    if apply_fn is not None and columns is not None:
        raise ValueError("apply_fn runs the whole batch on every rank; it takes no columns")
    check_trainable(config, train, consensus_fn=consensus_fn, apply_fn=apply_fn)
    iters = train.iters if train.iters is not None else config.default_iters
    timestep = resolve_loss_timestep(train, iters)
    two_views = train.consistency != "none"

    def loss_fn(params, img, *, generator=None, noise=None):
        b = img.shape[0]
        shape = ((2,) if two_views else ()) + tuple(img.shape)
        if noise is None:
            noise = torch.randn(shape, generator=generator, device=img.device, dtype=img.dtype)
        if tuple(noise.shape) != shape:
            raise ValueError(f"noise of shape {tuple(noise.shape)}; this step takes {shape}")
        noise = noise.to(img.dtype).reshape((-1,) + tuple(img.shape[1:]))
        # two views: one forward of 2b images, view 1's rows then view 2's
        noised = (torch.cat([img, img]) if two_views else img) + noise * train.noise_std
        if apply_fn is not None:
            _, state = apply_fn(params["glom"], noised, iters=iters, capture_timestep=timestep)
        else:
            # the forward stops at the loss timestep: its state is what decodes
            state = glom_model.apply(params["glom"], noised, config=config, iters=timestep,
                                     consensus_fn=consensus_fn, ff_fn=ff_fn, fused_fn=fused_fn,
                                     columns=columns)
        if columns is None:
            recon = decoder_apply(params["decoder"], state[:b], config, arch=train.decoder,
                                  level=train.loss_level)
            target = img
        else:
            recon = decoder_patches(params["decoder"], state[:b], config, arch=train.decoder,
                                    level=train.loss_level)
            target = patchify(img, config.patch_size)[:, columns]
        acc_dt = torch.promote_types(recon.dtype, torch.float32)
        loss = torch.mean((recon.to(acc_dt) - target.to(acc_dt)) ** 2)
        if two_views:
            loss = loss + train.consistency_weight * regularizer_from_state(
                train.consistency, state[:b], state[b:], level=train.consistency_level,
                temperature=train.consistency_temperature)
        return loss, recon

    return loss_fn


class WholeBatch:
    """Which part of the batch a step computes, and how the parts combine:
    for one process all rows and columns, and nothing to reduce.  On a mesh
    of ranks :class:`~glom_tpu_torch.parallel.step.MeshShard` takes a
    rank's rows and columns and reduces over the ranks."""

    columns: Optional[slice] = None

    def rows(self, n: int) -> slice:
        return slice(None)

    def mean(self, tensors: list) -> list:
        return tensors

    def leaf_sum(self, values: list) -> torch.Tensor:
        """``sum(values)``, one scalar a params leaf."""
        return sum(values[1:], values[0])


def make_step_fn(config: GlomConfig, train: TrainConfig, optimizer: Optimizer, *,
                 consensus_fn=None, ff_fn=None, fused_fn=None, apply_fn=None, shard=None):
    """``step(state, img, *, noise=None) -> (state, metrics)``.

    With ``train.grad_accum_steps > 1`` the batch splits into that many
    microbatches run one after the other; their gradients add up in float32
    (or wider) accumulators and average before the one optimizer update, so
    for the denoising loss (a mean over the batch) the step is the
    full-batch step.  InfoNCE's negatives are then the microbatch's, as in
    ``glom_tpu``'s accumulated step.  ``noise``, when given, is the whole
    batch's (:func:`make_loss_fn`'s shape), split the same way along the
    batch axis (with two views, its second); else each microbatch's is drawn
    from the state's generator.
    Metrics (device scalars): ``loss``, the raw pre-clip ``grad_norm`` and,
    with ``train.monitor_numerics``, ``nonfinite_grads`` and
    ``loss_nonfinite``.

    ``shard`` (:class:`WholeBatch` by default) picks the rows and columns of
    each microbatch this process computes and combines the gradients, the
    loss and the norm's terms over the processes; the noise is drawn for the
    whole microbatch first, so that every shard sees one process's draw.

    ``apply_fn`` (:func:`make_loss_fn`'s) replaces the forward: with the
    pipelined forward every rank runs this step on the whole batch, its
    gradients summed over the pipeline's ranks inside the forward's
    backward (``parallel/pipeline.py``), so it takes no ``shard``.

    ``glom_tpu``'s ``make_train_step`` jits this function and donates its
    state; eager PyTorch has neither, so this is the port's train step."""
    if apply_fn is not None and shard is not None:
        raise ValueError("apply_fn runs the whole batch on every rank; it takes no shard")
    # a shard's optimizer clips by the norm over every process's; one
    # process's optimizer takes the norm of what it holds
    sharded = shard is not None
    shard = shard if shard is not None else WholeBatch()
    loss_fn = make_loss_fn(config, train, consensus_fn=consensus_fn, ff_fn=ff_fn,
                           fused_fn=fused_fn, apply_fn=apply_fn, columns=shard.columns)
    accum = train.grad_accum_steps
    two_views = train.consistency != "none"
    acc_dt = lambda dt: torch.promote_types(dt, torch.float32)

    def noise_shape(img: torch.Tensor) -> tuple:
        return ((2,) if two_views else ()) + tuple(img.shape)

    def step_fn(state: DenoiseState, img: torch.Tensor, *, noise: Optional[torch.Tensor] = None):
        if noise is not None and tuple(noise.shape) != noise_shape(img):
            raise ValueError(f"noise of shape {tuple(noise.shape)}; this step takes "
                             f"{noise_shape(img)}")
        mb = img.shape[0] // accum
        mine = shard.rows(mb)
        rows = (slice(None), mine) if two_views else mine
        loss = grads = None
        for i in range(accum):
            block = img[i * mb:(i + 1) * mb]
            if noise is None:
                micro = torch.randn(noise_shape(block), generator=state.generator,
                                    device=img.device, dtype=img.dtype)
            else:
                sl = slice(i * mb, (i + 1) * mb)
                micro = noise[:, sl] if two_views else noise[sl]
            l, g = loss_and_grads(loss_fn, state.params, block[mine], noise=micro[rows])
            if accum == 1:
                loss, grads = l, g
                break
            if grads is None:
                loss = torch.zeros((), dtype=acc_dt(config.resolved_compute_dtype),
                                   device=img.device)
                grads = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt(p.dtype),
                                                       device=p.device), state.params)
            loss = loss + l.to(loss.dtype)
            grads = tree_map2(lambda a, b: a + b.to(a.dtype), grads, g)
        if accum > 1:
            loss = loss / accum
            grads = tree_map2(lambda g, p: (g / accum).to(p.dtype), grads, state.params)
        leaves = tree_leaves(grads)
        *reduced, loss = shard.mean(leaves + [loss])
        by_leaf = dict(zip(map(id, leaves), reduced))
        grads = tree_map(lambda g: by_leaf[id(g)], grads)
        leaves = tree_leaves(grads)
        norm = torch.sqrt(shard.leaf_sum([torch.sum(g * g) for g in leaves]))
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params,
                                              **({"norm": norm} if sharded else {}))
        params = apply_updates(state.params, updates)
        metrics = {"loss": loss, "grad_norm": norm}
        if train.monitor_numerics:
            metrics.update(numerics_metrics(leaves, loss, total=shard.leaf_sum))
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


def load_checkpoint_state(directory: str, *, step: Optional[int] = None, device=None,
                          observer=None):
    """``(step, config, train_cfg, params)`` from a checkpoint directory
    written by ``glom_tpu``'s Trainer or by this package: ``config.json``
    gives the configs, the npz the ``{"glom": ..., "decoder": ...}`` tree,
    returned as tensors on ``device`` in ``config.param_dtype``.

    With ``step=None`` the newest step that passes its integrity check
    loads: a corrupt newer step is quarantined (renamed ``*.corrupt``) and
    the load falls back, as ``glom_tpu``'s loader does, telling ``observer``
    (an :class:`~glom_tpu_torch.resilience.integrity.IntegrityObserver`) of
    each quarantine.  A pinned ``step``
    raises :class:`~glom_tpu_torch.checkpoint.CorruptCheckpointError` on a
    bad CRC.  A tree that does not match the recorded config raises
    ``ValueError``."""
    config, train_cfg = read_configs(directory)
    step, trees = integrity.restore_with_fallback(directory, ("params",), step=step,
                                                  observer=observer)
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
