"""The data-parallel forward (``glom_tpu/parallel/inference.py``).

Every rank along the data axis holds the whole parameter tree and runs
:func:`glom_tpu_torch.models.glom.apply` on its rows of the batch, the
config's kernels dispatched as there (``ff_impl="fused"`` runs K8); the
rows are then all-gathered, so every rank returns the whole batch's states.
:func:`pad_batch` is the one batch-padding rule, shared with the serving
compile cache's bucket padding (``serving/compile_cache.py::pad_to_bucket``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.models import glom as glom_model
from glom_tpu_torch.models.glom import tree_leaves
from glom_tpu_torch.parallel.comm import gather_from
from glom_tpu_torch.parallel.mesh import Mesh


def pad_batch(imgs, target: int):
    """Zero-pad the batch axis up to ``target`` images (``imgs`` itself when
    it is already there).  THE batch-padding rule: a numpy batch pads on the
    host (the padded array is what crosses to the device), a tensor on its
    own device."""
    if not isinstance(imgs, torch.Tensor):
        imgs = np.asarray(imgs)
    b = imgs.shape[0]
    if b > target:
        raise ValueError(f"batch {b} exceeds pad target {target}")
    if b == target:
        return imgs
    if isinstance(imgs, torch.Tensor):
        return torch.cat([imgs, imgs.new_zeros((target - b,) + tuple(imgs.shape[1:]))])
    return np.concatenate([imgs, np.zeros((target - b,) + imgs.shape[1:], imgs.dtype)])


def make_data_parallel_forward(
    mesh: Mesh,
    config: GlomConfig,
    *,
    iters: Optional[int] = None,
    return_all: bool = False,
    data_axis: str = "data",
    consensus_fn=None,
):
    """``fn(params, imgs) -> states`` with the params replicated and the batch
    split over ``data_axis``; every rank calls it with the whole batch and
    gets the whole result.  A batch the data size does not divide is
    zero-padded up to the next multiple and the output sliced back: each
    image's states are independent of the padding rows.  A numpy batch goes
    to the params' device."""
    axis = mesh.axis(data_axis)
    n_data = mesh.shape[data_axis]

    def wrapped(params, imgs):
        b = imgs.shape[0]
        if b == 0:
            raise ValueError("cannot run the forward on an empty batch")
        pad = (-b) % n_data
        if pad:
            imgs = pad_batch(imgs, b + pad)
        if not isinstance(imgs, torch.Tensor):
            imgs = torch.from_numpy(np.ascontiguousarray(imgs)).to(tree_leaves(params)[0].device)
        per = (b + pad) // n_data
        mine = imgs[axis.index * per:(axis.index + 1) * per]
        out = glom_model.apply(params, mine, config=config, iters=iters, return_all=return_all,
                               consensus_fn=consensus_fn)
        # the batch axis follows the time axis under return_all
        out = gather_from(out, axis, dim=1 if return_all else 0)
        if pad:
            out = out[:, :b] if return_all else out[:b]
        return out

    return wrapped
