"""Consensus attention (``glom_tpu/ops/consensus.py``).

At every level each patch column attends over all columns at the same
level.  Queries and values are the raw level states, keys are the
L2-normalized states, the scale is ``d**-0.5``.  Two masks:

* self-exclusion is SOFT: the diagonal logit is set to ``-5e-4``
  (:data:`TOKEN_ATTEND_SELF_VALUE`), not -inf, so a column still gives
  itself close to uniform weight;
* the locality mask is HARD: blocked pairs get ``-finfo(float32).max``.

:func:`consensus_attention` is the plain version of the consensus kernel
(``glom_tpu_torch/kernels/consensus.py``).  It computes in float32, returns
the input's type, and also returns the per-row logsumexp of the masked
logits, ``(b, L, n, 1)`` float32, which the kernel emits for the backward.
"""

from __future__ import annotations

from typing import Optional

import torch

TOKEN_ATTEND_SELF_VALUE = -5e-4
MAX_NEG = -torch.finfo(torch.float32).max


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``x / max(||x||_2, eps)`` (torch ``F.normalize`` semantics)."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def consensus_attention(
    levels: torch.Tensor,
    *,
    attend_self: bool = False,
    non_local_mask: Optional[torch.Tensor] = None,
):
    """``(b, n, L, d) -> (out (b, n, L, d), lse (b, L, n, 1))``.

    ``non_local_mask``: optional ``(n, n)`` bool or int8, nonzero = blocked
    (from :func:`glom_tpu_torch.ops.masks.local_consensus_mask`)."""
    x = levels.float()
    n, d = x.shape[1], x.shape[-1]
    k = l2_normalize(x)
    sim = torch.einsum("bild,bjld->blij", x, k) * (d ** -0.5)
    if not attend_self:
        eye = torch.eye(n, dtype=torch.bool, device=x.device)
        sim = sim.masked_fill(eye, TOKEN_ATTEND_SELF_VALUE)
    if non_local_mask is not None:
        sim = sim.masked_fill(non_local_mask.to(device=x.device, dtype=torch.bool), MAX_NEG)
    attn = torch.softmax(sim, dim=-1)
    lse = torch.logsumexp(sim, dim=-1, keepdim=True)
    out = torch.einsum("blij,bjld->bild", attn, x)
    return out.to(levels.dtype), lse
