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

:func:`consensus_dkv` and :func:`consensus_dq` are the plain versions of the
backward kernels K6 and K7 (``glom_tpu/kernels/consensus_pallas.py::
_bwd_dkv_kernel`` and ``::_bwd_dq_kernel``): they recompute the masked logits
as the forward does and apply the flash-attention formulas with the
forward's ``lse`` and ``delta = rowsum(dO * O)``, in float32, writing the
``(b, L, n, n)`` probabilities the kernels never write.  K6 also hands K7
the scaled logit gradient it forms, and K7 is a product of it and the levels;
their plain twins are :func:`consensus_ds` and :func:`consensus_dq_from_ds`.

Each takes ``width``, the width whose ``d**-0.5`` scales the logits (default:
the levels' own): the kernels run a narrow model on levels zero-padded to a
multiple of 128 and take the model's width, and on such levels these
functions with that ``width`` compute what the kernels do.
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


def _scale(x: torch.Tensor, width: Optional[int]) -> float:
    """The logits' ``d**-0.5``: of ``width``, or of ``x``'s own width."""
    return (x.shape[-1] if width is None else width) ** -0.5


def _masked_logits(x: torch.Tensor, k: torch.Tensor, attend_self: bool,
                   non_local_mask: Optional[torch.Tensor], width: Optional[int] = None):
    """``(sim (b, L, n, n), self-mask or None)`` of float32 queries ``x`` and
    normalized keys ``k``, both ``(b, n, L, d)``."""
    n = x.shape[1]
    sim = torch.einsum("bild,bjld->blij", x, k) * _scale(x, width)
    eye = None
    if not attend_self:
        eye = torch.eye(n, dtype=torch.bool, device=x.device)
        sim = sim.masked_fill(eye, TOKEN_ATTEND_SELF_VALUE)
    if non_local_mask is not None:
        sim = sim.masked_fill(non_local_mask.to(device=x.device, dtype=torch.bool), MAX_NEG)
    return sim, eye


def consensus_attention(
    levels: torch.Tensor,
    *,
    attend_self: bool = False,
    non_local_mask: Optional[torch.Tensor] = None,
    width: Optional[int] = None,
):
    """``(b, n, L, d) -> (out (b, n, L, d), lse (b, L, n, 1))``.

    ``non_local_mask``: optional ``(n, n)`` bool or int8, nonzero = blocked
    (from :func:`glom_tpu_torch.ops.masks.local_consensus_mask`)."""
    x = levels.float()
    sim, _ = _masked_logits(x, l2_normalize(x), attend_self, non_local_mask, width)
    attn = torch.softmax(sim, dim=-1)
    lse = torch.logsumexp(sim, dim=-1, keepdim=True)
    out = torch.einsum("blij,bjld->bild", attn, x)
    return out.to(levels.dtype), lse


def _probs_and_ds(levels, dout, lse, delta, attend_self, non_local_mask, width=None):
    """``(x, dO, P, dS)`` in float32: ``P = exp(S - lse)``, ``dS = P * (dO V^T -
    delta)``, zero on the diagonal under the soft self-mask (the diagonal
    logit is a constant there)."""
    x = levels.float()
    do = dout.to(levels.dtype).float()
    sim, eye = _masked_logits(x, l2_normalize(x), attend_self, non_local_mask, width)
    p = torch.exp(sim - lse)
    ds = p * (torch.einsum("bild,bjld->blij", do, x) - delta)
    if eye is not None:
        ds = ds.masked_fill(eye, 0.0)
    return x, do, p, ds


def l2_normalize_vjp(x: torch.Tensor, dk: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """The VJP of :func:`l2_normalize` along the last axis:
    ``dk / |x| - x (x . dk) / |x|^3`` where ``|x| > eps``, else ``dk / eps``."""
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    m = torch.clamp(norm, min=eps)
    dot = torch.sum(x * dk, dim=-1, keepdim=True)
    return dk / m - torch.where(norm > eps, x * (dot / (m * m * norm)), torch.zeros_like(x))


def consensus_dkv_terms(levels, dout, lse, delta, *, attend_self=False, non_local_mask=None,
                        width=None):
    """K6's two terms in float32: the key term ``normalize_vjp(dS^T Q
    scale)`` and the value term ``P^T dO``."""
    x, do, p, ds = _probs_and_ds(levels, dout, lse, delta, attend_self, non_local_mask, width)
    dv = torch.einsum("blij,bild->bjld", p, do)
    dk = torch.einsum("blij,bild->bjld", ds, x) * _scale(x, width)
    return l2_normalize_vjp(x, dk), dv


def consensus_dkv(levels, dout, lse, delta, *, attend_self=False, non_local_mask=None,
                  width=None):
    """K6's plain version: ``normalize_vjp(dS^T Q scale) + P^T dO``, the
    gradient through the keys and values, in ``levels``' type.  ``lse`` and
    ``delta`` are ``(b, L, n, 1)`` float32."""
    dk, dv = consensus_dkv_terms(levels, dout, lse, delta, attend_self=attend_self,
                                 non_local_mask=non_local_mask, width=width)
    return (dk + dv).to(levels.dtype)


def ds_columns(n: int) -> int:
    """The row length of dS': ``n`` rounded up to the 32 keys of a K6 block."""
    return -(-n // 32) * 32


def consensus_ds(levels, dout, lse, delta, *, attend_self=False, non_local_mask=None,
                 width=None):
    """What K6 hands K7: ``dS'_ij = dS_ij kscale_j`` with ``kscale_j =
    d^-1/2 / max(|x_j|, 1e-12)``, float32 ``(b, L, n, ds_columns(n))``, zero
    past n (and wherever dS is)."""
    x, _, _, ds = _probs_and_ds(levels, dout, lse, delta, attend_self, non_local_mask, width)
    n = x.shape[1]
    norm = torch.sqrt(torch.sum(x * x, dim=-1))                 # (b, n, L)
    kscale = _scale(x, width) / torch.clamp(norm, min=1e-12)
    ds = ds * kscale.permute(0, 2, 1)[:, :, None, :]
    return torch.nn.functional.pad(ds, (0, ds_columns(n) - n))


def consensus_dq_from_ds(levels, ds):
    """K7's plain version on K6's dS' (:func:`consensus_ds`): ``dS' V``, the
    gradient through the queries, in ``levels``' type."""
    n = levels.shape[1]
    dq = torch.einsum("blij,bjld->bild", ds[..., :n].float(), levels.float())
    return dq.to(levels.dtype)


def consensus_dq(levels, dout, lse, delta, *, attend_self=False, non_local_mask=None,
                 width=None):
    """K7's plain version: ``dS K scale``, the gradient through the queries,
    in ``levels``' type."""
    x, _, _, ds = _probs_and_ds(levels, dout, lse, delta, attend_self, non_local_mask, width)
    dq = torch.einsum("blij,bjld->bild", ds, l2_normalize(x)) * _scale(x, width)
    return dq.to(levels.dtype)
