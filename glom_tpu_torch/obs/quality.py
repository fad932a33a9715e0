"""The quality plane's traced math (``glom_tpu/obs/quality.py``, its
``agreement_maps`` and ``agreement_stats``).

Both the quality post-pass and the parse post-pass
(``hierarchy/parse.py``) build on :func:`agreement_maps`, one cast and
neighbour-cosine computation, so the two can never differ on what
"agreement" means.

The rest of ``glom_tpu``'s module (``QualityPlane``, the sketches, the
credit sampler and ``make_quality_fn``) waits for the quality plane's
serving port (ROADMAP queue 1, item 4.6); until then ``obs/slo.py`` keeps
its own copy of the metric names.
"""

from __future__ import annotations

import torch

from glom_tpu_torch.models.islands import neighbor_agreement


def agreement_maps(levels: torch.Tensor, side: int):
    """``(b, n, L, d)`` column state -> ``(levels_f32, agree)``, ``agree``
    the ``(b, L, side, side)`` neighbour-cosine agreement grid, computed in
    float32."""
    levels = levels.float()
    return levels, neighbor_agreement(levels, side)


def agreement_stats(agree: torch.Tensor, log_n: float):
    """``(b, L, s, s)`` agreement maps -> ``(agreement, entropy)``, both
    ``(b, L)``: the mean neighbour cosine, and the normalized entropy of the
    agreement mass over patches (cosine shifted to [0, 1] mass; the eps keeps
    a uniform -1 map finite)."""
    flat = agree.reshape(agree.shape[0], agree.shape[1], -1)
    agreement = flat.mean(dim=-1)
    w = (flat + 1.0) * 0.5 + 1e-6
    p = w / w.sum(dim=-1, keepdim=True)
    entropy = -(p * torch.log(p)).sum(dim=-1) / log_n
    return agreement, entropy
