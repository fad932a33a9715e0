"""The train step's NaN/Inf summary (``glom_tpu/obs/monitors.py::numerics_metrics``)."""

from __future__ import annotations

from typing import Dict, Iterable

import torch


def numerics_metrics(grads: Iterable[torch.Tensor], loss: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Device scalars of one step: ``nonfinite_grads``, the count of
    non-finite gradient elements over every leaf (0 on a healthy step), and
    ``loss_nonfinite``, 1.0 when the loss is NaN or Inf.  float32, as the JAX
    package counts (exact up to 2**24 bad elements)."""
    counts = [(~torch.isfinite(g.float())).sum().float() for g in grads]
    nonfinite = torch.stack(counts).sum() if counts else torch.zeros((), device=loss.device)
    loss_bad = (~torch.isfinite(loss.float())).float()
    return {"nonfinite_grads": nonfinite, "loss_nonfinite": loss_bad}
