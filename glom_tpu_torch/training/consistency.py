"""Two-view consistency regularization of the top-ish levels
(``glom_tpu/training/consistency.py``).

Two independently noised views of each image run through the model as one
batch of 2·b; their level states at the loss timestep are mean-pooled over
the columns, one ``(b, d)`` embedding a view, and pulled together:

* ``mse``: the mean squared distance between the two views' embeddings;
* ``infonce``: the symmetric InfoNCE over the batch, the other view the
  positive and the batch's other images the negatives (cosine logits over a
  temperature).

The train step's objective is ``denoise_mse + weight * consistency``
(``training/denoise.py``).  Everything here is float32 and differentiable.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from glom_tpu_torch.ops.consensus import l2_normalize


def pooled_level_embedding(all_levels: torch.Tensor, timestep: int, level: int) -> torch.Tensor:
    """``(T+1, b, n, L, d)`` return_all stack -> ``(b, d)``: ``level`` at
    ``timestep``, mean-pooled over the columns."""
    return torch.mean(all_levels[timestep, :, :, level], dim=1)


def pooled_state_embedding(state: torch.Tensor, level: int) -> torch.Tensor:
    """``(b, n, L, d)`` state -> ``(b, d)``: ``level``, mean-pooled over the
    columns."""
    return torch.mean(state[:, :, level], dim=1)


def consistency_loss(z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
    """The MSE between two views' ``(b, d)`` embeddings, in float32."""
    return torch.mean((z1.float() - z2.float()) ** 2)


def infonce_loss(z1: torch.Tensor, z2: torch.Tensor, temperature: float = 0.1) -> torch.Tensor:
    """Symmetric InfoNCE: for each image the other view is the positive and
    the other images are the negatives, in both directions."""
    z1 = l2_normalize(z1.float())
    z2 = l2_normalize(z2.float())
    logits = z1 @ z2.T / temperature                    # (b, b)
    l12 = -torch.mean(torch.diagonal(F.log_softmax(logits, dim=-1)))
    l21 = -torch.mean(torch.diagonal(F.log_softmax(logits.T, dim=-1)))
    return 0.5 * (l12 + l21)


def regularizer(kind: str, all_levels_v1: torch.Tensor, all_levels_v2: torch.Tensor, *,
                timestep: int, level: int = -1, temperature: float = 0.1) -> torch.Tensor:
    """:func:`regularizer_from_state` on two return_all stacks at ``timestep``."""
    return regularizer_from_state(kind, all_levels_v1[timestep], all_levels_v2[timestep],
                                  level=level, temperature=temperature)


def regularizer_from_state(kind: str, state_v1: torch.Tensor, state_v2: torch.Tensor, *,
                           level: int = -1, temperature: float = 0.1) -> torch.Tensor:
    """``kind`` (``"mse"`` or ``"infonce"``) over two ``(b, n, L, d)``
    states, the train step's form: only the loss timestep's state exists."""
    z1 = pooled_state_embedding(state_v1, level)
    z2 = pooled_state_embedding(state_v2, level)
    if kind == "mse":
        return consistency_loss(z1, z2)
    if kind == "infonce":
        return infonce_loss(z1, z2, temperature)
    raise ValueError(f"unknown consistency kind {kind!r}")
