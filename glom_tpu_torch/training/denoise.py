"""The parts of ``glom_tpu/training/denoise.py`` that serving needs: which
timestep the decoder reads, and the loader of a self-describing checkpoint
directory.  The train step itself is the training slice's work."""

from __future__ import annotations

import json
import os
from typing import Optional

from glom_tpu_torch import checkpoint as ckpt_lib
from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.convert import params_from_numpy
from glom_tpu_torch.models.glom import param_shapes, tree_map
from glom_tpu_torch.models.heads import decoder_param_shapes


def resolve_loss_timestep(train: TrainConfig, iters: int) -> int:
    """The iteration whose state feeds the decoder: ``train.loss_timestep``
    when set (0 is the initial state), else ``iters // 2 + 1`` (the
    reference recipe reads the state after 7 of 12 iterations)."""
    t = train.loss_timestep if train.loss_timestep is not None else iters // 2 + 1
    if not 0 <= t <= iters:
        raise ValueError(f"loss_timestep {t} outside [0, {iters}]")
    return t


def checkpoint_shapes(config: GlomConfig, train: TrainConfig) -> dict:
    """The shapes of the ``params`` tree a trainer checkpoint holds."""
    return {
        "glom": param_shapes(config),
        "decoder": decoder_param_shapes(
            config, arch=train.decoder, hidden_mult=train.decoder_hidden_mult),
    }


def load_checkpoint_state(directory: str, *, step: Optional[int] = None, device=None):
    """``(step, config, train_cfg, params)`` from a checkpoint directory
    written by ``glom_tpu``'s Trainer or by this package: ``config.json``
    gives the configs, the npz the ``{"glom": ..., "decoder": ...}`` tree,
    returned as tensors on ``device`` in ``config.param_dtype``.  With
    ``step=None`` the manifest's step loads.  A corrupt artifact raises
    :class:`~glom_tpu_torch.checkpoint.CorruptCheckpointError`; a tree that
    does not match the recorded config raises ``ValueError``."""
    with open(os.path.join(directory, "config.json")) as f:
        payload = json.load(f)
    config = GlomConfig.from_json_dict(payload["glom"])
    train_cfg = TrainConfig.from_json_dict(payload.get("train") or {})
    if step is None:
        step = ckpt_lib.latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint manifest in {directory}")
    tree = ckpt_lib.load_tree(directory, step, "params")
    want = checkpoint_shapes(config, train_cfg)
    got = {k: tree_map(lambda a: tuple(a.shape), tree[k]) if k in tree else None
           for k in want}
    if got != want:
        raise ValueError(
            f"checkpoint step {step} in {directory} does not match its "
            f"config.json: parameter shapes {got} vs {want}"
        )
    return step, config, train_cfg, params_from_numpy(tree, config, device)
