"""Ulysses (all-to-all) sequence-parallel consensus (``glom_tpu/parallel/ulysses.py``).

GLOM's ``levels`` axis plays the part Ulysses gives to attention heads.  The
state arrives split over columns, ``(b, n/S, L, d)``; one tiled all-to-all
trades columns for levels, ``(b, n, L/S, d)``; each rank runs the dense
consensus (``ops/consensus.py``) on its levels over all columns; the inverse
all-to-all restores the column split.  Two exchanges of the state a call
against the ring's ``S - 1`` shifts of K/V, and the ``(n, n)`` logits exist
per local level.

``L % S != 0`` is zero-padded to the next multiple of ``S`` and sliced back:
the consensus has no cross-level term, so padded levels interact with
nothing.  The all-to-all's backward is the inverse exchange
(``parallel/comm.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from glom_tpu_torch.ops.consensus import consensus_attention
from glom_tpu_torch.parallel.comm import all_to_all
from glom_tpu_torch.parallel.mesh import AxisGroup, Mesh
from glom_tpu_torch.parallel.ring import check_columns


def ulysses_consensus_attention(levels: torch.Tensor, *, axis: Optional[AxisGroup],
                                attend_self: bool = False,
                                non_local_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(b, n/S, L, d)`` in and out, ``L`` a multiple of ``axis.size``."""
    x = all_to_all(levels, axis, split_dim=2, concat_dim=1)     # (b, n, L/S, d)
    out, _ = consensus_attention(x, attend_self=attend_self, non_local_mask=non_local_mask)
    return all_to_all(out, axis, split_dim=1, concat_dim=2)     # (b, n/S, L, d)


def make_ulysses_consensus(mesh: Mesh, *, attend_self: bool = False,
                           non_local_mask: Optional[torch.Tensor] = None,
                           seq_axis: str = "seq", num_patches: Optional[int] = None):
    """A consensus fn of this rank's state ``(b/D, n/S, L, d)`` exchanged over
    ``seq_axis`` by all-to-all, each rank running the dense consensus on
    ``L/S`` levels (the level axis zero-padded to a multiple of ``S``)."""
    if num_patches is not None:
        check_columns(num_patches, mesh, seq_axis)
    axis = mesh.axis(seq_axis) if seq_axis in mesh.shape else None
    s = mesh.size(seq_axis)

    def consensus_fn(levels: torch.Tensor) -> torch.Tensor:
        L = levels.shape[2]
        pad = (-L) % s
        if pad:
            levels = F.pad(levels, (0, 0, 0, pad))
        out = ulysses_consensus_attention(levels, axis=axis, attend_self=attend_self,
                                          non_local_mask=non_local_mask)
        return out[:, :, :L] if pad else out

    return consensus_fn
