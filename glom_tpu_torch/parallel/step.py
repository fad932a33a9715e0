"""A rank's part of the denoising train step and the PSNR eval on a mesh.

:func:`glom_tpu_torch.training.denoise.make_step_fn` and
:func:`glom_tpu_torch.training.eval.make_psnr_fn` run on a mesh of ranks
through a :class:`MeshShard`.  Every rank holds the whole global batch, as
one process would draw it from the seed, and draws the noise of each
microbatch from its generator exactly as one process draws it; then it
takes its slice: the rows ``d`` of ``D`` of each microbatch (the data axis)
and the patch columns ``s`` of ``S`` (the seq axis, ``apply(columns=...)``),
so that a mesh step equals a one-rank step on the same seed.

Each rank's loss is the MSE over its rows and columns.  The ranks along
``model`` (and the extra expert axes) compute the same loss on the same
data: the sharded FF's collectives (``parallel/ff_shard.py``) make each
rank's gradient exact for the shard it holds, so no gradient is reduced over
them.  Along data and seq the losses are parts of the whole: every
gradient, sharded or not, is averaged over the data and seq groups (a seq
rank's loss covers its columns only, and the ring's or Ulysses' backward
hands each rank the part of the other ranks' losses that flows through its
keys and values).  The logged loss is the same average.

The global gradient norm (``grad_clip_norm``, the logged ``grad_norm``) sums
each sharded leaf's squares over the axes it is split over, and counts a
replicated leaf once; ``nonfinite_grads`` is counted the same way.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.models.glom import tree_leaves
from glom_tpu_torch.parallel.comm import gather_sum, raw_all_reduce
from glom_tpu_torch.parallel.mesh import Mesh
from glom_tpu_torch.parallel.placement import sharded_axes


def column_slice(config: GlomConfig, mesh: Mesh, seq_axis: Optional[str]) -> Optional[slice]:
    """This rank's patch columns along ``seq_axis``; None for one rank."""
    s = mesh.size(seq_axis) if seq_axis else 1
    if s == 1:
        return None
    n = config.num_patches
    if n % s:
        raise ValueError(f"n={n} patch columns not divisible by seq-axis size {s}")
    width = n // s
    i = mesh.index(seq_axis)
    return slice(i * width, (i + 1) * width)


def make_gathered_consensus(consensus_fn, mesh: Mesh, seq_axis: str):
    """The consensus of a rank's columns through a consensus of all ``n``
    (``consensus_fn``: the dense ops or the kernels): the columns of every
    seq rank gathered, the whole consensus taken, this rank's columns kept.
    What GSPMD does for ``glom_tpu`` when a dense or Pallas consensus meets
    a seq-split state; the ring and Ulysses avoid the gather."""
    axis = mesh.axis(seq_axis)

    def gathered(levels: torch.Tensor) -> torch.Tensor:
        n_local = levels.shape[1]
        out = consensus_fn(gather_sum(levels, axis, dim=1))
        return out.narrow(1, axis.index * n_local, n_local)

    return gathered


class MeshShard:
    """A rank's rows and columns of the batch, and the reductions of a mesh
    step (:class:`~glom_tpu_torch.training.denoise.WholeBatch`'s contract):
    means over the data and seq groups, and sums over the axes a leaf is
    split over (``specs``: the params' spec tree)."""

    def __init__(self, config: GlomConfig, mesh: Mesh, specs: dict, data_axis: str,
                 seq_axis: Optional[str]):
        self.mesh = mesh
        self.data_axis = data_axis
        self.columns = column_slice(config, mesh, seq_axis)
        self.parts = [mesh.axis(a) for a in (data_axis, seq_axis)
                      if a is not None and mesh.size(a) > 1]
        self.count = int(np.prod([a.size for a in self.parts])) if self.parts else 1
        self.leaf_axes = [tuple(a for a in sharded_axes(s) if mesh.size(a) > 1)
                          for s in tree_leaves(specs)]

    def rows(self, n: int) -> slice:
        """This rank's part of ``n`` batch rows along the data axis."""
        per = n // self.mesh.size(self.data_axis)
        i = self.mesh.index(self.data_axis)
        return slice(i * per, (i + 1) * per)

    def mean(self, tensors: list) -> list:
        """Each tensor averaged over the data and seq groups, in one flat
        buffer a group."""
        if not self.parts:
            return tensors
        dt = torch.promote_types(tensors[0].dtype, torch.float32)
        flat = torch.cat([t.reshape(-1).to(dt) for t in tensors])
        for axis in self.parts:
            flat = raw_all_reduce(flat, axis)
        flat = flat / self.count
        out, at = [], 0
        for t in tensors:
            out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
            at += t.numel()
        return out

    def leaf_sum(self, values: list) -> torch.Tensor:
        """``sum(values)`` (one scalar a params leaf, in ``tree_leaves``
        order), each first summed over the mesh axes its leaf is split
        over."""
        total = None
        for key in sorted(set(self.leaf_axes)):
            part = torch.stack([v for v, a in zip(values, self.leaf_axes) if a == key]).sum()
            for name in key:
                part = raw_all_reduce(part, self.mesh.axis(name))
            total = part if total is None else total + part
        return total
