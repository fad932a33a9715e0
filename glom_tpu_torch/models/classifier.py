"""Supervised classification on GLOM (``glom_tpu/models/classifier.py``).

``{glom, head}``: the GLOM backbone, the patch mean of one level of its
settled state, and a linear head, trained with cross-entropy.
``freeze_backbone`` is the linear-probe switch: the backbone's forward runs
without autograd (so a frozen step launches no backward kernel) and its
updates are exactly zero.

The forward takes the config's ``ff_impl`` / ``attention_impl``, as
``glom_tpu``'s does; on the card ``"pallas"`` and ``"fused"`` run the hand
kernels, and an unfrozen step's gradient runs their backward kernels.  The
step takes the port's :class:`~glom_tpu_torch.training.optim.Optimizer`
where ``glom_tpu`` takes an optax ``tx``; its state keeps the port's layout
over the whole tree, glom leaves included, so it crosses to optax and back
as the trainer's does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.models import glom as glom_model
from glom_tpu_torch.models.glom import tree_leaves, tree_map
from glom_tpu_torch.ops.patch import uniform
from glom_tpu_torch.training.optim import Optimizer, apply_updates


def init(generator: torch.Generator, config: GlomConfig, num_classes: int, device=None) -> dict:
    """``{glom, head: {w (dim, C), b (C,)}}``: the backbone as
    :func:`glom_model.init` draws it, then the head ``U(-dim^-1/2, dim^-1/2)``
    from the same ``generator``, the bias zero; moved to ``device``."""
    params = {
        "glom": glom_model.init(generator, config),
        "head": {
            "w": uniform(generator, (config.dim, num_classes), config.dim ** -0.5,
                         config.param_dtype),
            "b": torch.zeros((num_classes,), dtype=config.param_dtype),
        },
    }
    return tree_map(lambda t: t.to(device), params) if device is not None else params


def pooled_features(glom_params: dict, imgs: torch.Tensor, *, config: GlomConfig,
                    iters: Optional[int] = None, level: int = -1,
                    consensus_fn=None) -> torch.Tensor:
    """``(b, c, H, W) -> (b, dim)``: the patch mean of ``level`` of the
    settled state."""
    out = glom_model.apply(glom_params, imgs, config=config, iters=iters,
                           consensus_fn=consensus_fn)
    return out[:, :, level].mean(dim=1)


def head_apply(head: dict, pooled: torch.Tensor) -> torch.Tensor:
    """``pooled @ w + b`` in the promoted type (a bfloat16 state against
    float32 weights gives float32 logits, as ``jnp`` promotes)."""
    dt = torch.promote_types(pooled.dtype, head["w"].dtype)
    return pooled.to(dt) @ head["w"].to(dt) + head["b"].to(dt)


def apply(params: dict, imgs: torch.Tensor, *, config: GlomConfig, iters: Optional[int] = None,
          level: int = -1, consensus_fn=None) -> torch.Tensor:
    """``(b, c, H, W) -> (b, num_classes)`` logits."""
    pooled = pooled_features(params["glom"], imgs, config=config, iters=iters, level=level,
                             consensus_fn=consensus_fn)
    return head_apply(params["head"], pooled)


def _loss_and_accuracy(logits: torch.Tensor, labels: torch.Tensor):
    loss = F.cross_entropy(logits.float(), labels)
    acc = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, acc


def make_loss_fn(config: GlomConfig, *, iters: Optional[int] = None, level: int = -1):
    """``loss(params, imgs, labels) -> (loss, accuracy)``: the float32
    cross-entropy of the logits against integer ``labels``, mean over the
    batch, and the top-1 accuracy."""

    def loss_fn(params, imgs, labels):
        return _loss_and_accuracy(
            apply(params, imgs, config=config, iters=iters, level=level), labels)

    return loss_fn


def grads_of(loss: torch.Tensor, live: dict) -> dict:
    """The gradients of ``loss`` with respect to the leaves of ``live``, as a
    tree of ``live``'s structure."""
    leaves = tree_leaves(live)
    by_leaf = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return tree_map(lambda p: by_leaf[id(p)], live)


def make_train_step(config: GlomConfig, optimizer: Optimizer, *, iters: Optional[int] = None,
                    level: int = -1, freeze_backbone: bool = False):
    """``step(params, opt_state, imgs, labels) -> (params, opt_state,
    metrics)``; ``metrics``: ``loss`` (float32 cross-entropy, mean over the
    batch) and ``accuracy``, device scalars; ``labels`` integer class ids.

    ``freeze_backbone=True``: the backbone's forward runs under
    ``torch.no_grad()``, its gradients are zeros (``glom_tpu``'s
    ``stop_gradient``), the optimizer sees them as optax does, and the glom
    leaves come back as the same tensors: decoupled weight decay cannot move
    them."""
    loss_fn = make_loss_fn(config, iters=iters, level=level)

    def step(params, opt_state, imgs, labels):
        if freeze_backbone:
            with torch.no_grad():
                pooled = pooled_features(params["glom"], imgs, config=config, iters=iters,
                                         level=level)
            head = tree_map(lambda p: p.detach().requires_grad_(True), params["head"])
            loss, acc = _loss_and_accuracy(head_apply(head, pooled), labels)
            grads = {"glom": tree_map(torch.zeros_like, params["glom"]),
                     "head": grads_of(loss, head)}
        else:
            live = tree_map(lambda p: p.detach().requires_grad_(True), params)
            loss, acc = loss_fn(live, imgs, labels)
            grads = grads_of(loss, live)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        if freeze_backbone:
            new = {"glom": params["glom"], "head": apply_updates(params["head"], updates["head"])}
        else:
            new = apply_updates(params, updates)
        return new, opt_state, {"loss": loss.detach(), "accuracy": acc}

    return step
