"""Functional GLOM model: ``init`` / ``apply`` (``glom_tpu/models/glom.py``).

The iteration is a Python loop over one update step (the JAX package
traces it as a ``lax.scan``):
  * the image tokens are re-attached at the bottom every iteration;
  * bottom-up FF over entries [0..L-1] of the (tokens + levels) stack;
  * top-down FF over entries [2..L] plus the positional embeddings, with a
    zero term at the top level; ``pos_emb`` enters only the top-down input;
  * consensus attention over the PREVIOUS iteration's state;
  * the equal-weight mean with divisors [4, ..., 4, 3].

``ff_impl`` / ``attention_impl`` select the implementation: ``"dense"`` is
the plain PyTorch ops (``glom_tpu_torch.ops``), ``"pallas"`` the port's
hand-written CUDA kernels (``glom_tpu_torch.kernels``), which take the plain
ops for CPU tensors.  :func:`apply` runs under autograd: the kernels'
gradients are their backward kernels (``ff_fused_bwd`` picks K2 + K3 or the
plain VJP for the FF, as in the JAX package; consensus always takes K6 +
K7).

The training-side knobs of the JAX config: ``scan_unroll`` is accepted and
changes nothing here (it unrolls XLA's scan; this loop is eager Python);
``remat`` and ``fuse_ff`` are refused by the train step
(``glom_tpu_torch.training.denoise``) and ignored by the serving forward.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.kernels.consensus import consensus_attention as consensus_kernel
from glom_tpu_torch.kernels.ff import grouped_ff
from glom_tpu_torch.ops.consensus import consensus_attention
from glom_tpu_torch.ops.feedforward import grouped_ff_apply, grouped_ff_init
from glom_tpu_torch.ops.masks import local_consensus_mask
from glom_tpu_torch.ops.patch import patch_embed_apply, patch_embed_init


def init(generator: torch.Generator, config: GlomConfig, device=None) -> dict:
    """The parameter tree, with the names and shapes of the JAX package:
      patch_embed/{w (p*p*c, d), b (d,)}, pos_emb (n, d) ~ N(0, 1),
      init_levels (L, d) ~ N(0, 1),
      bottom_up/{w1, b1, w2, b2} (L groups), top_down/{...} (L-1 groups).
    Drawn on the CPU from ``generator`` (a ``torch.Generator`` gives other
    numbers than ``jax.random`` from the same seed), then moved to
    ``device`` (default: the CPU)."""
    c = config
    dt = c.param_dtype
    params = {
        "patch_embed": patch_embed_init(generator, c.patch_dim, c.dim, dt),
        "pos_emb": torch.randn((c.num_patches, c.dim), generator=generator).to(dt),
        "init_levels": torch.randn((c.levels, c.dim), generator=generator).to(dt),
        "bottom_up": grouped_ff_init(generator, c.dim, c.levels, c.ff_mult, dt),
        "top_down": grouped_ff_init(generator, c.dim, c.levels - 1, c.ff_mult, dt),
    }
    return tree_map(lambda t: t.to(device), params) if device is not None else params


def param_shapes(config: GlomConfig) -> dict:
    """The tree of parameter shapes :func:`init` makes."""
    c = config
    h = c.dim * c.ff_mult

    def ff(g):
        return {"w1": (g, c.dim, h), "b1": (g, h), "w2": (g, h, c.dim), "b2": (g, c.dim)}

    return {
        "patch_embed": {"w": (c.patch_dim, c.dim), "b": (c.dim,)},
        "pos_emb": (c.num_patches, c.dim),
        "init_levels": (c.levels, c.dim),
        "bottom_up": ff(c.levels),
        "top_down": ff(c.levels - 1),
    }


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def param_count(params) -> int:
    return sum(int(p.numel()) for p in tree_leaves(params))


def make_ff_fn(config: GlomConfig):
    """The grouped-FF implementation: the CUDA kernels (``"pallas"``, with
    ``ff_fused_bwd`` choosing the backward) or the plain ops (``"dense"``)."""
    if config.ff_impl == "pallas":
        return functools.partial(grouped_ff, fused_bwd=config.ff_fused_bwd)
    if config.ff_impl == "dense":
        return grouped_ff_apply
    raise NotImplementedError(
        f"ff_impl={config.ff_impl!r} is not in the port yet: the fused "
        f"level-update kernel (K8) is first in ROADMAP queue 2; use 'pallas' "
        f"or 'dense'"
    )


def resolve_locality_mask(config: GlomConfig, device=None) -> Optional[torch.Tensor]:
    """Boolean ``(n, n)`` blocked-pair mask when ``local_consensus_radius > 0``,
    else None."""
    if config.local_consensus_radius > 0:
        mask = local_consensus_mask(config.num_patches_side, config.local_consensus_radius)
        return torch.from_numpy(mask).to(device)
    return None


def make_consensus_fn(config: GlomConfig, device=None):
    """``levels -> consensus`` for the config's ``attention_impl``: the CUDA
    kernel (``"pallas"``) or the plain ops (``"dense"``)."""
    impl = config.attention_impl
    if impl == "pallas":
        attend = consensus_kernel
    elif impl == "dense":
        attend = consensus_attention
    elif impl == "auto":
        raise NotImplementedError(
            "attention_impl='auto' picks by a crossover measured on the TPU; "
            "the port has no H100 crossover yet (ROADMAP queue 1, item 1). "
            "Use 'pallas' or 'dense'"
        )
    else:
        raise NotImplementedError(
            f"attention_impl={impl!r} needs the multi-GPU port "
            f"(ROADMAP queue 1, item 6); use 'pallas' or 'dense'"
        )
    mask = resolve_locality_mask(config, device)

    def f(levels):
        out, _ = attend(levels, attend_self=config.consensus_self, non_local_mask=mask)
        return out

    return f


def validate_img(img: torch.Tensor, config: GlomConfig) -> None:
    c = config
    if img.dim() != 4 or tuple(img.shape[1:]) != (c.channels, c.image_size, c.image_size):
        raise ValueError(
            f"img must be (batch, {c.channels}, {c.image_size}, {c.image_size}) "
            f"for this config, got {tuple(img.shape)}"
        )


def cast_for_compute(params: dict, img: torch.Tensor, config: GlomConfig):
    """Apply the config's compute dtype to the image and the parameters;
    returns ``(params, img, compute_dtype)``."""
    dt = config.resolved_compute_dtype
    if img.dtype != dt:
        img = img.to(dt)
    if dt != config.param_dtype:
        params = tree_map(lambda p: p.to(dt), params)
    return params, img, dt


def update_divisors(config: GlomConfig, dtype, device=None) -> torch.Tensor:
    """``(L, 1)`` divisors [4, ..., 4, 3]: the top level has no top-down term."""
    divisors = torch.full((config.levels, 1), 4.0, dtype=torch.float32)
    divisors[-1] = 3.0
    return divisors.to(device=device, dtype=dtype)


def embed_inputs(params, img, config: GlomConfig):
    """``(tokens (b, n, d), pos_embs (1, n, 1, d))``."""
    tokens = patch_embed_apply(params["patch_embed"], img, config.patch_size)
    return tokens, params["pos_emb"][None, :, None, :]


def initial_levels(params, b: int, config: GlomConfig, dtype) -> torch.Tensor:
    """The learned per-level init state, materialized as ``(b, n, L, d)``."""
    c = config
    init_levels = params["init_levels"].to(dtype)
    return init_levels[None, None].expand(b, c.num_patches, c.levels, c.dim).contiguous()


def _update_step(params, bottom_level, pos_embs, divisors, consensus_fn, ff_fn, levels):
    """One GLOM iteration as a function of the carried ``levels``."""
    # (b, n, L+1, d): the tokens re-attached at the bottom
    levels_with_input = torch.cat([bottom_level, levels], dim=-2)
    # a strided view: the FF kernel reads it through its strides
    bottom_up_out = ff_fn(params["bottom_up"], levels_with_input[..., :-1, :])
    top_down_out = ff_fn(params["top_down"], levels_with_input[..., 2:, :] + pos_embs)
    top_down_out = F.pad(top_down_out, (0, 0, 0, 1))   # zero at the top level
    consensus = consensus_fn(levels)
    return (levels + bottom_up_out + top_down_out + consensus) / divisors


def apply(
    params: dict,
    img: torch.Tensor,
    *,
    config: GlomConfig,
    iters: Optional[int] = None,
    levels: Optional[torch.Tensor] = None,
    return_all: bool = False,
    capture_timestep: Optional[int] = None,
    consensus_fn=None,
    ff_fn=None,
):
    """Forward pass, ``Glom.forward(img, iters, levels, return_all)``.

    Returns ``(b, n, L, d)`` or, with ``return_all``, ``(iters+1, b, n, L, d)``
    including the t=0 state.  ``capture_timestep=t`` returns
    ``(final, state_after_t_iterations)`` (t=0 is the initial state).
    ``consensus_fn`` / ``ff_fn`` override the config's implementations."""
    c = config
    validate_img(img, c)
    if levels is not None and tuple(levels.shape) != (
        img.shape[0], c.num_patches, c.levels, c.dim
    ):
        raise ValueError(
            f"carried levels must be ({img.shape[0]}, {c.num_patches}, "
            f"{c.levels}, {c.dim}), got {tuple(levels.shape)}"
        )
    if iters is None:
        iters = c.default_iters
    if capture_timestep is not None and not 0 <= capture_timestep <= iters:
        raise ValueError(f"capture_timestep {capture_timestep} outside [0, {iters}]")
    params, img, dt = cast_for_compute(params, img, c)

    tokens, pos_embs = embed_inputs(params, img, c)
    bottom_level = tokens[:, :, None, :]
    if levels is None:
        levels = initial_levels(params, tokens.shape[0], c, dt)
    else:
        levels = levels.to(dt)
    if consensus_fn is None:
        consensus_fn = make_consensus_fn(c, img.device)
    if ff_fn is None:
        ff_fn = make_ff_fn(c)
    step = functools.partial(
        _update_step, params, bottom_level, pos_embs,
        update_divisors(c, dt, img.device), consensus_fn, ff_fn,
    )

    states = [levels] if return_all else None
    captured = levels if capture_timestep == 0 else None
    for t in range(1, iters + 1):
        levels = step(levels)
        if return_all:
            states.append(levels)
        if capture_timestep == t:
            captured = levels
    if capture_timestep is not None:
        return levels, captured
    if return_all:
        return torch.stack(states)
    return levels
