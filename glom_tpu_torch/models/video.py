"""Stateful / video processing (``glom_tpu/models/video.py``).

The README's stateful recipe: each frame's forward starts from the previous
frame's settled ``levels``.  ``glom_tpu`` scans over frames inside one XLA
graph; here the frame loop is a Python loop around
:func:`glom_tpu_torch.models.glom.apply`, so every frame runs the config's
kernels, and under autograd the gradient flows back through the carried
state from frame to frame (backprop through time).

  * :func:`rollout` — the same ``iters`` for every frame;
  * :func:`rollout_varied` — per-frame iteration counts (the README's
    12 / 10 / 6 pattern).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.models import glom as glom_model


def rollout(params: dict, frames: torch.Tensor, *, config: GlomConfig,
            iters: Optional[int] = None, levels: Optional[torch.Tensor] = None,
            return_states: bool = False, consensus_fn=None):
    """Process ``frames`` of shape ``(t, b, c, H, W)`` in order with carried
    level state.

    Returns the final state ``(b, n, L, d)``, or with ``return_states``
    ``(final, states)`` with the per-frame final states ``(t, b, n, L, d)``.
    The carry is in the compute dtype from the first frame on, as
    ``glom_tpu``'s scan carry is: a given ``levels`` is cast to it."""
    if frames.dim() != 5:
        raise ValueError(f"frames must be (t, b, c, H, W), got {tuple(frames.shape)}")
    if iters is None:
        iters = config.default_iters
    b = frames.shape[1]
    dt = config.resolved_compute_dtype
    if levels is None:
        levels = glom_model.initial_levels(params, b, config, dt)
    else:
        levels = levels.to(dt)
    states = []
    for frame in frames:
        levels = glom_model.apply(params, frame, config=config, iters=iters, levels=levels,
                                  consensus_fn=consensus_fn)
        if return_states:
            states.append(levels)
    if return_states:
        return levels, torch.stack(states)
    return levels


def rollout_varied(params: dict, frames, iters_schedule: Sequence[int], *, config: GlomConfig,
                   levels: Optional[torch.Tensor] = None, consensus_fn=None):
    """Per-frame iteration counts (e.g. ``[12, 10, 6]``) with carried state.
    ``frames`` is a sequence of ``(b, c, H, W)`` tensors or one stacked
    ``(t, b, c, H, W)`` tensor; returns the final state.

    The schedule is validated up front, against ``frames.shape[0]`` for a
    stacked clip: the frame loop is ``zip``-driven, and zip stops at the
    shorter operand, so a short schedule (or an exhausted generator, which
    has no ``len``) would otherwise drop the clip's tail frames."""
    schedule = [int(it) for it in iters_schedule]
    bad = [it for it in schedule if it < 1]
    if bad:
        raise ValueError(f"iteration counts must be >= 1, got {bad}")
    if isinstance(frames, torch.Tensor):
        if frames.dim() != 5:
            raise ValueError(f"stacked frames must be (t, b, c, H, W), got "
                             f"{tuple(frames.shape)}")
        n_frames = int(frames.shape[0])
    else:
        frames = list(frames)
        n_frames = len(frames)
    if n_frames != len(schedule):
        raise ValueError(f"{n_frames} frames but {len(schedule)} iteration counts")
    state = levels
    for frame, it in zip(frames, schedule):
        state = glom_model.apply(params, frame, config=config, iters=it, levels=state,
                                 consensus_fn=consensus_fn)
    return state
