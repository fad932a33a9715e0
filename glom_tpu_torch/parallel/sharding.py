"""The sharding rules: how GLOM's params and activations lie on the mesh
(``glom_tpu/parallel/sharding.py``).

A spec is a tuple with one entry a dimension: the mesh axis that dimension
is split over, or None; ``()`` replicates a leaf whatever its rank.  Entry by
entry these are ``glom_tpu``'s ``PartitionSpec``s:

  * **data** -- the batch dimension of images and state (pure DP);
  * **model** -- the tensor-parallel axis: the ``mult*dim`` hidden of every
    per-level MLP (w1 by columns, w2 by rows), or under ``"ep"`` whole
    level-MLPs (:func:`level_sharded_pspecs`);
  * **seq** -- the ``n`` patch columns of the state, exchanged by the ring
    or the Ulysses consensus (``parallel/ring.py``, ``parallel/ulysses.py``).
"""

from __future__ import annotations

import warnings
from typing import Optional

from glom_tpu_torch.config import GlomConfig

REPLICATED = ()


def _ff_tp(model_axis: str) -> dict:
    return {
        "w1": (None, None, model_axis),   # (g, d, h): shard h
        "b1": (None, model_axis),         # (g, h)
        "w2": (None, model_axis, None),   # (g, h, d): shard h (contracting)
        "b2": (None, None),               # (g, d) replicated
    }


def _embeddings() -> dict:
    return {"patch_embed": {"w": (None, None), "b": (None,)}, "pos_emb": (None, None),
            "init_levels": (None, None)}


def param_pspecs(config: GlomConfig, *, model_axis: str = "model") -> dict:
    """The spec tree of ``models/glom.py::init``'s tree under TP: the FF
    hidden over ``model_axis``, everything else replicated."""
    return {**_embeddings(), "bottom_up": _ff_tp(model_axis), "top_down": _ff_tp(model_axis)}


def replicated_pspecs(config: GlomConfig) -> dict:
    """The spec tree with every leaf replicated (``param_sharding="replicated"``)."""
    def rep(tree):
        return {k: rep(v) for k, v in tree.items()} if isinstance(tree, dict) else REPLICATED

    return rep(param_pspecs(config))


def level_sharded_pspecs(config: GlomConfig, *, axis_size: int, model_axis: str = "model",
                         extra_axes: Optional[dict] = None) -> dict:
    """The EP layout: a rank owns whole level-MLPs (the group axis is split).
    ``levels`` (bottom-up groups) and ``levels - 1`` (top-down) are coprime,
    so no one axis above one splits both: a net is split over the largest
    candidate axis whose size divides its group count
    (:func:`pick_expert_axis`), and replicated, with a warning, when none
    does.  ``extra_axes`` maps further mesh axes to their sizes (factored
    expert axes: a 3x2 factoring covers the coprime pair at levels=3)."""
    candidates = [(model_axis, axis_size)]
    if extra_axes:
        candidates += list(extra_axes.items())
    any_capacity = any(size > 1 for _, size in candidates)

    def ff(name: str, groups: int) -> dict:
        g_axis = pick_expert_axis(groups, candidates)
        if any_capacity and g_axis is None:
            warnings.warn(
                f"param_sharding='ep': {name} has {groups} groups, not divisible "
                f"by any expert-axis size ({dict(candidates)}) — replicating it "
                f"(no memory saving on this net)",
                stacklevel=3,
            )
        return {"w1": (g_axis, None, None), "b1": (g_axis, None),
                "w2": (g_axis, None, None), "b2": (g_axis, None)}

    return {**_embeddings(), "bottom_up": ff("bottom_up", config.levels),
            "top_down": ff("top_down", config.levels - 1)}


def pick_expert_axis(groups: int, candidates) -> Optional[str]:
    """The one expert-axis rule, shared by :func:`level_sharded_pspecs` (the
    params' placement) and ``parallel/ff_shard.py`` (the FF's dispatch), so
    the two never disagree: the largest candidate axis whose size divides
    ``groups``, ties in the given order; None when none does.
    ``candidates`` is ``[(axis_name, size), ...]``."""
    for axis, size in sorted(candidates, key=lambda kv: -kv[1]):
        if size > 1 and groups % size == 0:
            return axis
    return None


def batch_pspec(data_axis: str = "data") -> tuple:
    """Images ``(b, c, H, W)``: the batch split."""
    return (data_axis,)


def state_pspec(data_axis: str = "data", seq_axis: str = "seq") -> tuple:
    """Level state ``(b, n, L, d)``: batch over data, columns over seq."""
    return (data_axis, seq_axis)


def decoder_pspecs(arch: str = "linear") -> dict:
    """Replicated specs of ``models/heads.py::decoder_init``'s tree (the
    decoder is small; it never shards)."""
    if arch in ("mlp", "mlp_all"):
        return {"w1": (None, None), "b1": (None,), "w2": (None, None), "b2": (None,)}
    return {"w": (None, None), "b": (None,)}
