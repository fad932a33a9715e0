"""Patchification and patch embedding (``glom_tpu/ops/patch.py``).

Within a patch the flattened feature order is ``(p1 p2 c)`` — row, then
column, then channel — the reference's ``image_to_tokens`` rearrange.  The
weight converter and the decoder heads depend on that order.
"""

from __future__ import annotations

import torch
from einops import rearrange


def patchify(img: torch.Tensor, patch_size: int) -> torch.Tensor:
    """``(b, c, H, W) -> (b, n, p*p*c)``."""
    return rearrange(
        img, "b c (h p1) (w p2) -> b (h w) (p1 p2 c)", p1=patch_size, p2=patch_size
    )


def unpatchify(patches: torch.Tensor, patch_size: int, image_size: int,
               channels: int = 3) -> torch.Tensor:
    """``(b, n, p*p*c) -> (b, c, H, W)``, the inverse of :func:`patchify`."""
    return rearrange(
        patches,
        "b (h w) (p1 p2 c) -> b c (h p1) (w p2)",
        p1=patch_size,
        p2=patch_size,
        h=image_size // patch_size,
        c=channels,
    )


def uniform(generator: torch.Generator, shape, bound: float, dtype) -> torch.Tensor:
    """``U(-bound, bound)`` drawn on the CPU from ``generator``."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (u * (2 * bound) - bound).to(dtype)


def patch_embed_init(generator: torch.Generator, patch_dim: int, dim: int,
                     dtype=torch.float32) -> dict:
    """``Linear(patch_dim, dim)`` with torch's default init, stored
    ``w (patch_dim, dim)`` as the JAX package stores it."""
    bound = patch_dim ** -0.5
    return {
        "w": uniform(generator, (patch_dim, dim), bound, dtype),
        "b": uniform(generator, (dim,), bound, dtype),
    }


def patch_embed_apply(params: dict, img: torch.Tensor, patch_size: int) -> torch.Tensor:
    """``(b, c, H, W) -> (b, n, dim)`` tokens."""
    return patchify(img, patch_size) @ params["w"] + params["b"]
