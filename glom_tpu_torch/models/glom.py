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
ops for CPU tensors.  ``ff_impl="fused"`` is a step-level choice: when
:func:`fused_update_supported` holds and the caller injects no
``consensus_fn`` / ``ff_fn``, the whole iteration runs as one call of the
fused level-update kernels (``kernels/fused_update.py``, K8); otherwise it
falls back to the grouped-FF kernel with the attention chosen by the
``"auto"`` policy.  ``attention_impl="auto"`` picks the consensus kernels on
a CUDA device of the kernels' compute capability above the measured
crossover (:data:`ATTENTION_CROSSOVER_N`) and the plain ops otherwise.  :func:`apply` runs under autograd: the
kernels' gradients are their backward kernels (``ff_fused_bwd`` picks K2 +
K3 or the plain VJP for the FF, as in the JAX package; consensus always
takes K6 + K7; K8 differentiates the unfused composition of those).

Every caller's iteration comes from one place, :func:`make_step_builder`:
the serving forward and the train step both go through :func:`apply`, so
``fuse_ff`` (both nets as one grouped call of 2L-1 groups) and ``remat``
(``torch.utils.checkpoint`` around one step, keeping the matrix products'
outputs under ``remat_policy="dots"``) mean the same in both.
``scan_unroll`` is accepted and changes nothing here (it unrolls XLA's
scan; this loop is eager Python).
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                     create_selective_checkpoint_contexts, noop_context_fn)

from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.kernels import fused_update
from glom_tpu_torch.kernels._common import MAX_DIM
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
    ``ff_fused_bwd`` choosing the backward) or the plain ops (``"dense"``).
    ``"fused"`` resolves to the same grouped-FF kernel: the whole-update
    fusion is a step-level choice (:func:`make_fused_update_fn` through
    :func:`make_step_builder`), and this kernel is its fallback when
    :func:`fused_update_supported` fails."""
    if config.ff_impl in ("pallas", "fused"):
        return functools.partial(grouped_ff, fused_bwd=config.ff_fused_bwd)
    return grouped_ff_apply


def fused_update_supported(config: GlomConfig, device=None) -> bool:
    """True when ``ff_impl="fused"`` takes this model shape on ``device``
    (``kernels/fused_update.py::supports_config``).  ``fuse_ff`` defeats it:
    that knob concatenates the two nets into one grouped call, another
    fusion, and the two do not compose."""
    if config.ff_impl != "fused" or config.fuse_ff:
        return False
    return fused_update.supports_config(config, device)


def make_fused_update_fn(config: GlomConfig, device=None):
    """The fused level update (K8) bound to this config:
    ``f(bu_params, td_params, levels, bottom_level, pos_embs) -> new_levels``
    (``kernels/fused_update.py``).  :func:`make_step_builder` consumes it."""
    mask = resolve_locality_mask(config, device)

    def f(bu_params, td_params, levels, bottom_level, pos_embs):
        return fused_update.fused_level_update(
            bu_params, td_params, levels, bottom_level, pos_embs,
            attend_self=config.consensus_self, non_local_mask=mask,
            ff_fused_bwd=config.ff_fused_bwd,
        )

    return f


def resolve_locality_mask(config: GlomConfig, device=None) -> Optional[torch.Tensor]:
    """Boolean ``(n, n)`` blocked-pair mask when ``local_consensus_radius > 0``,
    else None."""
    if config.local_consensus_radius > 0:
        mask = local_consensus_mask(config.num_patches_side, config.local_consensus_radius)
        return torch.from_numpy(mask).to(device)
    return None


# Measured dense -> pallas crossover per GPU generation: at n <= entry the
# plain consensus matched or beat the CUDA kernels (K4 forward, K6 + K7
# backward) in the real train step, or, where the kernels won at every
# measured n, the entry sits one below the smallest n measured; above it the
# kernels are chosen.  One row per generation with its measurement;
# ``python -m glom_tpu_torch.tools.crossover`` measures again and prints the
# row for the card it runs on.
ATTENTION_CROSSOVER_N = {
    # NVIDIA H100 80GB HBM3, 700.00 W; the tool's run of this row's commit
    # (--sizes 56 112 224 336 448), flagship width, b=8, f32, FF on its
    # kernels in both legs, images/s dense against pallas: n=16 386.1 /
    # 592.3, n=64 361.1 / 418.2, n=256 128.0 / 136.7, n=576 54.54 / 58.46,
    # n=1024 29.36 / 31.04.  The kernels win at every measured n (by 53 % to
    # 6 %; before K6 hands K7 its dS', PERF.md, the plain ops won at 576 and
    # 1024 and the row was 1024), so the row sits below the smallest, 16;
    # n < 16 was not measured.
    "H100": 15,
}
# an unmeasured generation whose compute capability the kernels are built
# for borrows the H100's row, with a warning
_CROSSOVER_FALLBACK_N = ATTENTION_CROSSOVER_N["H100"]
# the compute capability of the kernels' build (sm_90a, kernels/_build.py):
# on any other card "auto" is "dense"
KERNELS_CAPABILITY = (9, 0)


def gpu_generation(device=None) -> str:
    """The key of :data:`ATTENTION_CROSSOVER_N` for a CUDA device: the model
    name in ``torch.cuda.get_device_name`` ("NVIDIA H100 80GB HBM3" ->
    "H100"), or the whole name when it has no such word."""
    name = torch.cuda.get_device_name(device)
    for word in name.split():
        if len(word) > 1 and word[0].isalpha() and word[1:].isdigit():
            return word
    return name


def resolve_auto_attention(config: GlomConfig, device=None) -> str:
    """What ``attention_impl="auto"`` means on ``device``: ``"pallas"`` on a
    CUDA device the kernels are built for when ``num_patches`` exceeds the
    generation's measured crossover and the kernels take the width,
    ``"dense"`` otherwise (every CPU run and every card of another compute
    capability included).  An unmeasured generation of the kernels' compute
    capability warns and borrows the H100's row."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type != "cuda" or torch.cuda.get_device_capability(dev) != KERNELS_CAPABILITY:
        return "dense"
    gen = gpu_generation(dev)
    crossover = ATTENTION_CROSSOVER_N.get(gen)
    if crossover is None:
        crossover = _CROSSOVER_FALLBACK_N
        warnings.warn(
            f"attention_impl='auto': no measured dense/pallas crossover for {gen!r}; using "
            f"n>{_CROSSOVER_FALLBACK_N} from the H100. Run python -m "
            f"glom_tpu_torch.tools.crossover on this card and add the row to "
            f"glom_tpu_torch.models.glom.ATTENTION_CROSSOVER_N", stacklevel=3)
    takes_width = config.dim % 128 == 0 and config.dim <= MAX_DIM
    return "pallas" if config.num_patches > crossover and takes_width else "dense"


def make_consensus_fn(config: GlomConfig, device=None):
    """``levels -> consensus`` for the config's ``attention_impl``: the CUDA
    kernels (``"pallas"``), the plain ops (``"dense"``), or whichever of the
    two :func:`resolve_auto_attention` picks for ``device`` (``"auto"``)."""
    impl = config.attention_impl
    if impl == "auto":
        impl = resolve_auto_attention(config, device)
    if impl == "pallas":
        attend = consensus_kernel
    elif impl == "dense":
        attend = consensus_attention
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
    return fused_update.update_divisors(config.levels, dtype, device)


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


def _update_step_fused(cat_params, levels_count, bottom_level, pos_embs, divisors,
                       consensus_fn, ff_fn, levels):
    """The math of :func:`_update_step` with both nets as ONE grouped call of
    ``2L-1`` groups (``cat_params``: the two nets' weights concatenated along
    the group axis, once per :func:`apply`).  The groups are independent, so
    this is exact; it changes how many FF launches an iteration issues."""
    L = levels_count
    levels_with_input = torch.cat([bottom_level, levels], dim=-2)
    bu_in = levels_with_input[..., :-1, :]
    td_in = levels_with_input[..., 2:, :] + pos_embs
    fused_out = ff_fn(cat_params, torch.cat([bu_in, td_in], dim=-2))
    bottom_up_out = fused_out[..., :L, :]
    top_down_out = F.pad(fused_out[..., L:, :], (0, 0, 0, 1))
    consensus = consensus_fn(levels)
    return (levels + bottom_up_out + top_down_out + consensus) / divisors


def make_step_builder(params, config: GlomConfig, pos_embs, divisors, consensus_fn, ff_fn,
                      fused_fn=None):
    """``build(bottom_level) -> step`` where ``step(levels)`` is one GLOM
    iteration honouring the config's ``fuse_ff`` and ``remat``.  The one
    place an iteration is put together, for serving and training alike.

    ``fused_fn`` (:func:`make_fused_update_fn`) replaces the whole body with
    the fused level update; ``consensus_fn`` / ``ff_fn`` are then unused.

    ``remat`` wraps the step in ``torch.utils.checkpoint`` (non-reentrant;
    the step draws no random numbers, so no RNG state is kept), as
    :func:`_with_remat` says; both policies give the gradients of the
    unwrapped step."""
    c = config
    if fused_fn is not None:
        def build_fused(bottom_level):
            def fused_step(levels):
                return fused_fn(params["bottom_up"], params["top_down"], levels, bottom_level,
                                pos_embs)

            return _with_remat(fused_step, c)

        return build_fused
    if c.fuse_ff:
        # one weight concat per apply (outside the loop), 2L-1 groups
        cat_params = {k: torch.cat([params["bottom_up"][k], params["top_down"][k]], dim=0)
                      for k in params["bottom_up"]}

    def build(bottom_level):
        if c.fuse_ff:
            step = functools.partial(_update_step_fused, cat_params, c.levels, bottom_level,
                                     pos_embs, divisors, consensus_fn, ff_fn)
        else:
            step = functools.partial(_update_step, params, bottom_level, pos_embs, divisors,
                                     consensus_fn, ff_fn)
        return _with_remat(step, c)

    return build


# the matrix products "dots" keeps, as jax.checkpoint_policies.checkpoint_dots
# keeps dot_general's outputs
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the output of a matrix product that
    autograd records, recompute everything else.  A kernel's autograd
    Function runs its forward with grad mode off, so the products of its
    plain version on the CPU are not kept, and on the card its launches are
    no aten op at all: the Function is opaque, as a ``pallas_call`` is to
    ``checkpoint_dots``, and on the kernel paths "dots" saves what "full"
    does, as in ``glom_tpu``."""
    if op in _DOTS and torch.is_grad_enabled():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _with_remat(step, config: GlomConfig):
    """``step`` under activation checkpointing when ``config.remat`` and
    autograd is recording; unchanged otherwise.  ``"full"`` saves only the
    step's input and runs the whole step again in the backward.  ``"dots"``
    also keeps the outputs of the plain path's matrix products
    (:func:`_save_dots`, through selective checkpointing) and recomputes the
    elementwise work around them, as ``glom_tpu`` does with
    ``checkpoint_dots``."""
    if not config.remat:
        return step
    context_fn = (functools.partial(create_selective_checkpoint_contexts, _save_dots)
                  if config.remat_policy == "dots" else noop_context_fn)

    def remat_step(levels):
        if torch.is_grad_enabled():
            return checkpoint(step, levels, use_reentrant=False, preserve_rng_state=False,
                              context_fn=context_fn)
        return step(levels)

    return remat_step


def resolve_step_fns(config: GlomConfig, device=None, *, consensus_fn=None, ff_fn=None,
                     fused_fn=None):
    """``(consensus_fn, ff_fn, fused_fn)`` as :func:`apply` runs them on
    ``device``, by the precedence of ``glom_tpu``'s ``apply``: an injected
    ``fused_fn`` is kept; with ``ff_impl="fused"``, no injected function and
    :func:`fused_update_supported`, the fused step is built and the other two
    stay None; otherwise the unfused halves are resolved, and on that fallback
    a default ``attention_impl="dense"`` resolves by the ``"auto"`` policy."""
    c = config
    if (fused_fn is None and consensus_fn is None and ff_fn is None
            and fused_update_supported(c, device)):
        fused_fn = make_fused_update_fn(c, device)
    if fused_fn is None:
        if consensus_fn is None:
            cc = c
            if c.ff_impl == "fused" and c.attention_impl == "dense":
                cc = dataclasses.replace(c, attention_impl="auto")
            consensus_fn = make_consensus_fn(cc, device)
        if ff_fn is None:
            ff_fn = make_ff_fn(c)
    return consensus_fn, ff_fn, fused_fn


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
    fused_fn=None,
):
    """Forward pass, ``Glom.forward(img, iters, levels, return_all)``.

    Returns ``(b, n, L, d)`` or, with ``return_all``, ``(iters+1, b, n, L, d)``
    including the t=0 state.  ``capture_timestep=t`` returns
    ``(final, state_after_t_iterations)`` (t=0 is the initial state).
    ``consensus_fn`` / ``ff_fn`` override the config's implementations;
    ``fused_fn`` replaces the whole update body with the fused level update
    (resolved from ``ff_impl="fused"`` when :func:`fused_update_supported`
    holds and neither override is injected: injected functions win).  When
    ``ff_impl="fused"`` falls back, a default ``attention_impl="dense"`` is a
    leftover, not a choice, and resolves by the ``"auto"`` policy; an explicit
    ``"auto"`` / ``"pallas"`` is honoured."""
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
    consensus_fn, ff_fn, fused_fn = resolve_step_fns(
        c, img.device, consensus_fn=consensus_fn, ff_fn=ff_fn, fused_fn=fused_fn)
    step = make_step_builder(params, c, pos_embs, update_divisors(c, dt, img.device),
                             consensus_fn, ff_fn, fused_fn=fused_fn)(bottom_level)

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
