"""Video denoising-SSL training (``glom_tpu/training/video.py``).

Every frame of a noised clip rolls through :func:`models.video.rollout`
with carried state, each frame's final state decodes at
``train.loss_level`` through the linear ``patches_to_images`` head, and the
loss is the mean frame-reconstruction MSE.  The gradient flows through the
carried state across frames (full backprop through time: memory grows with
the clip's length unless ``config.remat`` is set).  On the card each frame's
forward runs the config's kernels and the backward their backward kernels;
each kernel's autograd Function takes a ``levels`` input that the previous
frame's graph produced.

The noise is drawn from a ``torch.Generator`` or passed in as a standard
normal tensor of the clip's shape (scaled by ``train.noise_std`` here), as
in :func:`glom_tpu_torch.training.denoise.make_loss_fn`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.models.heads import decoder_apply
from glom_tpu_torch.models.video import rollout
from glom_tpu_torch.training.denoise import DenoiseState, loss_and_grads
from glom_tpu_torch.training.optim import Optimizer, apply_updates, global_norm


def make_video_loss_fn(config: GlomConfig, train: TrainConfig, *, consensus_fn=None):
    """``loss(params, frames, *, generator=None, noise=None) -> (loss,
    recon_frames)``; ``frames``, the clean clip ``(t, b, c, H, W)``.

    Only the linear decoder: ``glom_tpu`` decodes with
    ``patches_to_images_apply`` whatever ``train.decoder`` says, and fails on
    the missing keys of any other head; the port refuses it by name."""
    if train.decoder != "linear":
        raise ValueError(f"video training decodes with the linear head; decoder "
                         f"{train.decoder!r} is not supported here")
    iters = train.iters if train.iters is not None else config.default_iters

    def loss_fn(params, frames, *, generator=None, noise=None):
        if noise is None:
            noise = torch.randn(frames.shape, generator=generator, device=frames.device,
                                dtype=frames.dtype)
        if noise.shape != frames.shape:
            raise ValueError(f"noise of shape {tuple(noise.shape)}; this clip takes "
                             f"{tuple(frames.shape)}")
        noised = frames + noise.to(frames.dtype) * train.noise_std
        _, states = rollout(params["glom"], noised, config=config, iters=iters,
                            return_states=True, consensus_fn=consensus_fn)  # (t, b, n, L, d)
        t, b = states.shape[:2]
        recon = decoder_apply(params["decoder"], states.flatten(0, 1), config, arch="linear",
                              level=train.loss_level)
        recon = recon.reshape(t, b, config.channels, config.image_size, config.image_size)
        acc_dt = torch.promote_types(recon.dtype, torch.float32)
        loss = torch.mean((recon.to(acc_dt) - frames.to(acc_dt)) ** 2)
        return loss, recon

    return loss_fn


def make_video_train_step(config: GlomConfig, train: TrainConfig, optimizer: Optimizer, *,
                          consensus_fn=None):
    """``step(state, frames, *, noise=None) -> (state, metrics)`` over clips;
    ``metrics``: ``loss`` and the pre-clip ``grad_norm``, device scalars.
    Without ``noise`` the step draws it from ``state.generator``."""
    loss_fn = make_video_loss_fn(config, train, consensus_fn=consensus_fn)

    def step_fn(state: DenoiseState, frames: torch.Tensor, *,
                noise: Optional[torch.Tensor] = None) -> Tuple[DenoiseState, dict]:
        loss, grads = loss_and_grads(loss_fn, state.params, frames, generator=state.generator,
                                     noise=noise)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = apply_updates(state.params, updates)
        return (DenoiseState(params, opt_state, state.step + 1, state.generator),
                {"loss": loss, "grad_norm": global_norm(grads)})

    return step_fn
