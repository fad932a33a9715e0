"""Decoder heads (``glom_tpu/models/heads.py``).

``"linear"`` is the reference recipe's ``patches_to_images``: one
``Linear(dim, p*p*c)`` on one level, then the inverse patch rearrange.  The
others strengthen only the decode path: ``"mlp"`` (2-layer exact-erf GELU
MLP on one level), ``"linear_all"`` and ``"mlp_all"`` (on the concat of all
L levels).  Weights are stored ``(in, out)``, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from glom_tpu_torch.config import DECODER_ARCHS, GlomConfig
from glom_tpu_torch.ops.patch import uniform, unpatchify


def _linear_init(generator, fan_in: int, fan_out: int, dtype) -> dict:
    bound = fan_in ** -0.5
    return {
        "w": uniform(generator, (fan_in, fan_out), bound, dtype),
        "b": uniform(generator, (fan_out,), bound, dtype),
    }


def decoder_param_shapes(config: GlomConfig, *, arch: str = "linear",
                         hidden_mult: int = 2) -> dict:
    """The tree of parameter shapes of a :data:`DECODER_ARCHS` head."""
    if arch not in DECODER_ARCHS:
        raise ValueError(f"unknown decoder arch {arch!r}; one of {DECODER_ARCHS}")
    in_dim = config.dim * (config.levels if arch.endswith("_all") else 1)
    if arch in ("linear", "linear_all"):
        return {"w": (in_dim, config.patch_dim), "b": (config.patch_dim,)}
    hidden = hidden_mult * config.dim
    return {"w1": (in_dim, hidden), "b1": (hidden,),
            "w2": (hidden, config.patch_dim), "b2": (config.patch_dim,)}


def decoder_init(generator: torch.Generator, config: GlomConfig, *,
                 arch: str = "linear", hidden_mult: int = 2,
                 dtype=torch.float32) -> dict:
    """Params of a :data:`DECODER_ARCHS` head, torch ``nn.Linear`` init."""
    shapes = decoder_param_shapes(config, arch=arch, hidden_mult=hidden_mult)
    if "w" in shapes:
        return _linear_init(generator, *shapes["w"], dtype)
    l1 = _linear_init(generator, *shapes["w1"], dtype)
    l2 = _linear_init(generator, *shapes["w2"], dtype)
    return {"w1": l1["w"], "b1": l1["b"], "w2": l2["w"], "b2": l2["b"]}


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` in the promoted type of ``x`` and ``w``, as ``jnp``
    computes it (a bfloat16 state against float32 weights decodes in
    float32); torch's matmul takes one type."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt) + b.to(dt)


def decoder_apply(params: dict, state: torch.Tensor, config: GlomConfig, *,
                  arch: str = "linear", level: int = -1) -> torch.Tensor:
    """``(b, n, L, dim)`` level state -> ``(b, c, H, W)`` reconstruction."""
    if arch.endswith("_all"):
        b, n = state.shape[:2]
        tokens = state.reshape(b, n, config.levels * config.dim)
    else:
        tokens = state[:, :, level]
    if arch in ("linear", "linear_all"):
        patches = _dense(tokens, params["w"], params["b"])
    else:
        h = F.gelu(_dense(tokens, params["w1"], params["b1"]), approximate="none")
        patches = _dense(h, params["w2"], params["b2"])
    return unpatchify(patches, config.patch_size, config.image_size, config.channels)
