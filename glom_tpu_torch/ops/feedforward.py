"""Grouped per-level feed-forward nets (``glom_tpu/ops/feedforward.py``).

Group ``g`` applies its own MLP ``d -> mult*d -> d`` with the exact-erf GELU
(torch ``nn.GELU()``'s default).  Weights are stacked ``w1 (g, d, h)``,
``b1 (g, h)``, ``w2 (g, h, d)``, ``b2 (g, d)``, the JAX package's layout.

:func:`grouped_ff_apply` is the plain version of the grouped-FF kernel
(``glom_tpu_torch/kernels/ff.py``): it computes in float32 whatever the
input type and returns the input's type, as the kernel does.  It writes the
``(b, n, g, h)`` hidden to memory; the kernel never does.

:func:`grouped_ff_dx` and :func:`grouped_ff_dw` are the plain versions of the
backward kernels K2 and K3 (``glom_tpu/kernels/ff_pallas.py::_bwd_dx_kernel``
and ``::_bwd_dw_kernel``): the formulas of ``_recompute_dh`` written out in
float32, with the cotangent cast to ``x``'s type first and the results in
``x``'s and the weights' types, as the TPU kernels return them.
:func:`grouped_ff_dw` is the reference of K3's function.  On the card K2
also hands K3 the hidden it forms, and K3 reduces over rows what it is
given; their twins are :func:`grouped_ff_hidden` (the ``(hid, dh)`` K2
stores) and :func:`grouped_ff_dw_from_hidden` (K3's products on them).
"""

from __future__ import annotations

import math

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


def _recompute_dh(params: dict, x: torch.Tensor, g: torch.Tensor):
    """``(x, dO, gelu(pre), dH)`` in float32, ``pre = x W1 + b1`` and
    ``dH = (dO W2^T) * gelu'(pre)``; ``dO`` is ``g`` cast to ``x``'s type."""
    xf = x.float()
    go = g.to(x.dtype).float()
    pre = torch.einsum("bngd,gdh->bngh", xf, params["w1"].float()) + params["b1"].float()
    cdf = 0.5 * (1.0 + torch.erf(pre * 2.0 ** -0.5))
    pdf = torch.exp(-0.5 * pre * pre) * (1.0 / math.sqrt(2.0 * math.pi))
    dh = torch.einsum("bngd,ghd->bngh", go, params["w2"].float()) * (cdf + pre * pdf)
    return xf, go, pre * cdf, dh


def grouped_ff_dx(params: dict, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K2's plain version: ``dX = dH W1^T`` in ``x``'s type."""
    _, _, _, dh = _recompute_dh(params, x, g)
    return torch.einsum("bngh,gdh->bngd", dh, params["w1"].float()).to(x.dtype)


def grouped_ff_hidden(params: dict, x: torch.Tensor, g: torch.Tensor):
    """The twin of the hidden K2 hands K3: ``(hid, dh)``, each
    ``(groups, rows, h)`` float32 (rows = b * n), ``hid = gelu(pre)`` and
    ``dh = (dO W2^T) * gelu'(pre)``, in float32 whatever ``x``'s type, as
    ``_recompute_dh`` keeps them."""
    _, _, h, dh = _recompute_dh(params, x, g)
    b, n, gr, hidden = h.shape
    return (h.reshape(b * n, gr, hidden).transpose(0, 1).contiguous(),
            dh.reshape(b * n, gr, hidden).transpose(0, 1).contiguous())


def grouped_ff_dw_from_hidden(x: torch.Tensor, g: torch.Tensor, hid: torch.Tensor,
                              dh: torch.Tensor, dtype):
    """The twin of K3 on a given hidden: ``(dW1 = X^T dH, db1 = 1^T dH,
    dW2 = H^T dO)`` summed over every row in float32, returned in
    ``dtype``; ``hid`` and ``dh`` as :func:`grouped_ff_hidden` gives them,
    ``dO`` is ``g`` cast to ``x``'s type."""
    b, n, gr, d = x.shape
    xf = x.float().reshape(b * n, gr, d)
    go = g.to(x.dtype).float().reshape(b * n, gr, d)
    return (torch.einsum("rgd,grh->gdh", xf, dh).to(dtype),
            dh.sum(dim=1).to(dtype),
            torch.einsum("grh,rgd->ghd", hid, go).to(dtype))


def grouped_ff_dw(params: dict, x: torch.Tensor, g: torch.Tensor):
    """K3's plain version: ``(dW1 = X^T dH, db1 = 1^T dH, dW2 = gelu(pre)^T dO)``
    summed over every row, in the weights' type."""
    xf, go, h, dh = _recompute_dh(params, x, g)
    dt = params["w1"].dtype
    return (torch.einsum("bngd,bngh->gdh", xf, dh).to(dt),
            dh.sum(dim=(0, 1)).to(dt),
            torch.einsum("bngh,bngd->ghd", h, go).to(dt))
