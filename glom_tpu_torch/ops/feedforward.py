"""Grouped per-level feed-forward nets (``glom_tpu/ops/feedforward.py``).

Group ``g`` applies its own MLP ``d -> mult*d -> d`` with the exact-erf GELU
(torch ``nn.GELU()``'s default).  Weights are stacked ``w1 (g, d, h)``,
``b1 (g, h)``, ``w2 (g, h, d)``, ``b2 (g, d)``, the JAX package's layout.

:func:`grouped_ff_apply` is the plain version of the grouped-FF kernel
(``glom_tpu_torch/kernels/ff.py``): it computes in float32 whatever the
input type and returns the input's type, as the kernel does.  It writes the
``(b, n, g, h)`` hidden to memory; the kernel never does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from glom_tpu_torch.ops.patch import uniform


def grouped_ff_init(generator: torch.Generator, dim: int, groups: int,
                    mult: int = 4, dtype=torch.float32) -> dict:
    """torch grouped-Conv1d default init: ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``
    with fan_in ``dim`` for the first layer and ``mult*dim`` for the second."""
    hidden = dim * mult
    b1 = dim ** -0.5
    b2 = hidden ** -0.5
    return {
        "w1": uniform(generator, (groups, dim, hidden), b1, dtype),
        "b1": uniform(generator, (groups, hidden), b1, dtype),
        "w2": uniform(generator, (groups, hidden, dim), b2, dtype),
        "b2": uniform(generator, (groups, dim), b2, dtype),
    }


def grouped_ff_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``(b, n, g, d) -> (b, n, g, d)``."""
    xf = x.float()
    h = torch.einsum("bngd,gdh->bngh", xf, params["w1"].float()) + params["b1"].float()
    h = F.gelu(h, approximate="none")
    y = torch.einsum("bngh,ghd->bngd", h, params["w2"].float()) + params["b2"].float()
    return y.to(x.dtype)
