"""The train step's optimizer and learning-rate schedule
(``glom_tpu/training/trainer.py:71-111``), written out so that a step
matches optax's:

* ``adam`` (b1 0.9, b2 0.999, eps 1e-8 added outside the square root, bias
  correction at the incremented count) or, with ``weight_decay``, ``adamw``
  (the decay ``weight_decay * p`` added to the Adam direction before the
  learning rate scales it: decoupled, as ``torch.optim.AdamW`` applies it);
* ``clip_by_global_norm`` first when ``grad_clip_norm`` is set: the
  gradients scale by ``max / |g|`` only when ``|g| >= max``, with no
  ``+1e-6`` (``torch.nn.utils.clip_grad_norm_`` adds one);
* the learning rate is constant, or ``warmup_cosine_decay_schedule(0, lr,
  max(warmup, 1), max(steps, warmup + 1))`` read at the update count BEFORE
  the update, so the first update under warmup uses ``schedule(0) = 0``.

The state is the port's own layout, ``{"count": int, "mu": tree, "nu":
tree}`` with the moments in the parameters' dtype (optax's default).  It is
saved as the checkpoint's ``opt`` tree; ``glom_tpu``'s optax state has
another layout, which ``training/trainer.py::opt_state_from_optax`` maps
onto this one.
"""

from __future__ import annotations

import math
from typing import Callable, Union

import numpy as np
import torch

from glom_tpu_torch.config import TrainConfig
from glom_tpu_torch.models.glom import tree_leaves, tree_map

Schedule = Union[float, Callable[[int], float]]
# Adam's moment decays and denominator epsilon (optax's defaults)
B1, B2, EPS = 0.9, 0.999, 1e-8


def tree_map2(fn, a, b):
    """``fn`` over the paired leaves of two trees of nested dicts."""
    if isinstance(a, dict):
        return {k: tree_map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def warmup_cosine_decay_schedule(peak_value: float, warmup_steps: int, decay_steps: int):
    """optax's ``warmup_cosine_decay_schedule(0, peak_value, warmup_steps,
    decay_steps)``: linear from 0 to ``peak_value`` over ``warmup_steps``,
    then cosine to 0 at ``decay_steps``, in float32 as optax computes it."""
    f32 = np.float32
    decay = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(warmup_steps)
            return float(-f32(peak_value) * frac + f32(peak_value))
        t = f32(min(count - warmup_steps, decay))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t / f32(decay), dtype=f32))
        return float(f32(peak_value) * cosine)

    return schedule


def make_lr_schedule(train: TrainConfig) -> Schedule:
    """``TrainConfig``'s learning rate: a float, or the cosine schedule."""
    if train.lr_schedule == "cosine":
        return warmup_cosine_decay_schedule(
            train.learning_rate, max(train.warmup_steps, 1),
            max(train.steps, train.warmup_steps + 1))
    if train.lr_schedule != "constant":
        raise ValueError(f"unknown lr_schedule {train.lr_schedule!r}; 'constant' or 'cosine'")
    return train.learning_rate


def global_norm(tree) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every leaf (optax's ``global_norm``)."""
    return torch.sqrt(sum(torch.sum(g * g) for g in tree_leaves(tree)))


class Optimizer:
    """``chain(clip_by_global_norm(clip_norm), adam(w))`` over a tree of
    tensors: :meth:`init` the state, :meth:`update` to ``(updates, state)``,
    then :func:`apply_updates`."""

    def __init__(self, learning_rate: Schedule, *, weight_decay: float = 0.0,
                 clip_norm: float = 0.0):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm

    @classmethod
    def from_config(cls, train: TrainConfig) -> "Optimizer":
        return cls(make_lr_schedule(train), weight_decay=train.weight_decay,
                   clip_norm=train.grad_clip_norm)

    def init(self, params) -> dict:
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def update(self, grads, state: dict, params):
        if self.clip_norm:
            g_norm = global_norm(grads)
            keep = g_norm < self.clip_norm
            grads = tree_map(lambda t: torch.where(keep, t, (t / g_norm.to(t.dtype)) * self.clip_norm),
                             grads)
        mu = tree_map2(lambda g, m: (1 - B1) * g + B1 * m, grads, state["mu"])
        nu = tree_map2(lambda g, v: (1 - B2) * (g * g) + B2 * v, grads, state["nu"])
        count = state["count"] + 1
        # 1 - b**count in float32, as optax's bias correction computes it
        c1 = float(np.float32(1) - np.power(np.float32(B1), np.float32(count), dtype=np.float32))
        c2 = float(np.float32(1) - np.power(np.float32(B2), np.float32(count), dtype=np.float32))
        step = -self.lr(state["count"])

        def direction(m, v, p):
            u = (m / c1) / (torch.sqrt(v / c2) + EPS)
            if self.weight_decay:
                u = u + self.weight_decay * p
            return step * u

        updates = tree_map2(lambda mv, p: direction(mv[0], mv[1], p),
                            tree_map2(lambda m, v: (m, v), mu, nu), params)
        return updates, {"count": count, "mu": mu, "nu": nu}


def apply_updates(params, updates):
    """``p + u`` in the parameter's dtype (optax's ``apply_updates``)."""
    return tree_map2(lambda p, u: (p + u).to(p.dtype), params, updates)
