"""The fused level update per data shard (``glom_tpu/parallel/fused_shard.py``).

K8's one-shot consensus needs a whole ``(n, d)`` K/V row per (batch, level)
and its weight blocks whole per-level nets, so it takes a batch shard only:
under pure DP (or replicated params with no seq axis) each rank runs it on
its rows, with no collective, the level update having no cross-batch term.
``glom_tpu`` wraps its kernel in ``shard_map`` for that; a rank here already
holds only its rows, so the kernel's function is the model's own.  Any other
mesh runs the sharded unfused pair (``parallel/ff_shard.py`` and the ring or
Ulysses consensus), with ``glom_tpu``'s warning.
"""

from __future__ import annotations

import warnings
from typing import Optional

from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.models.glom import fused_update_supported, make_fused_update_fn


def make_sharded_fused_update(config: GlomConfig, device=None, *, seq_size: int = 1,
                              params_sharded: bool = False) -> Optional[object]:
    """``f(bu_params, td_params, levels, bottom_level, pos_embs)`` -- the
    contract of :func:`~glom_tpu_torch.models.glom.make_fused_update_fn` --
    on this rank's ``(b/D, n, L, d)`` rows under ``ff_impl="fused"``, when
    the mesh splits the batch only (``seq_size`` 1, no params split) and
    the kernel takes the config; else None, warning under
    ``ff_impl="fused"`` that the step falls back to the sharded unfused FF."""
    if config.ff_impl != "fused":
        return None
    if fused_update_supported(config, device) and seq_size == 1 and not params_sharded:
        return make_fused_update_fn(config, device)
    warnings.warn(
        "ff_impl='fused' does not support this mesh/shape "
        "(seq- or model-sharded, or supports_config failed); "
        "falling back to the sharded unfused pallas FF",
        stacklevel=4)
    return None
