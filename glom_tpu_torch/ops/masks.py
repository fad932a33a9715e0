"""Set-up-time attention masks: the port's own copy of
``glom_tpu/ops/masks.py``.

The ``local_consensus_radius`` machinery of the reference's
``ConsensusAttention.__init__``: a euclidean distance over the patch grid,
thresholded at the radius.
"""

from __future__ import annotations

import numpy as np


def local_consensus_mask(num_patches_side: int, radius: float) -> np.ndarray:
    """Boolean ``(n, n)`` mask, True where patches are FURTHER apart than
    ``radius`` (attention between them is blocked): meshgrid 'ij' ->
    ``(h w)`` coordinates -> distance > r."""
    side = np.arange(num_patches_side)
    hh, ww = np.meshgrid(side, side, indexing="ij")
    coords = np.stack([hh.reshape(-1), ww.reshape(-1)], axis=-1).astype(np.float32)
    diff = coords[:, None, :] - coords[None, :, :]
    dist = np.sqrt((diff ** 2).sum(-1))
    return dist > radius
