"""Ring (sequence-parallel) consensus attention (``glom_tpu/parallel/ring.py``).

The ``n`` patch columns are split over the mesh's ``seq`` axis.  Each rank
keeps its queries resident and passes (L2-normalised key, value) blocks
around the ring, one :func:`~glom_tpu_torch.parallel.comm.shift` a step, with
an online (running max, weighted sum) softmax, so the ``(n, n)`` logits never
exist anywhere: ``S - 1`` shifts for ``S`` ranks, the rank's own block first.
As in ``glom_tpu``, a block moves to the rank behind (``ppermute`` with
``r -> r - 1``), so at step ``s`` rank ``i`` holds the block of rank
``(i + s) mod S``.

The numerics are ``ops/consensus.py``'s: the soft ``-5e-4`` self-mask where
global ``i == j``, and the hard locality mask sliced per (my block, incoming
block) out of the whole ``(n, n)`` mask.  The body is plain differentiable
torch, as ``glom_tpu`` writes it in ``jnp``; the shift's backward sends each
block's gradient back along the ring.  The running max is held out of
autograd: the output does not depend on it.
"""

from __future__ import annotations

from typing import Optional

import torch

from glom_tpu_torch.ops.consensus import MAX_NEG, TOKEN_ATTEND_SELF_VALUE, l2_normalize
from glom_tpu_torch.parallel.comm import shift
from glom_tpu_torch.parallel.mesh import AxisGroup, Mesh


def ring_consensus_attention(levels: torch.Tensor, *, axis: Optional[AxisGroup],
                             attend_self: bool = False,
                             non_local_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The consensus of this rank's columns, ``(b, n/S, L, d)`` in and out,
    with the blocks of every rank along ``axis`` (None: one rank)."""
    b, n_local, L, d = levels.shape
    size = 1 if axis is None else axis.size
    me = 0 if axis is None else axis.index
    dev = levels.device
    q = levels
    scale = d ** -0.5
    i_global = me * n_local + torch.arange(n_local, device=dev)
    mask_rows = None
    if non_local_mask is not None:
        mask_rows = non_local_mask.to(device=dev, dtype=torch.bool)[i_global]   # (n_local, n)

    acc = torch.zeros((b, L, n_local, d), dtype=torch.float32, device=dev)
    m = torch.full((b, L, n_local), float("-inf"), dtype=torch.float32, device=dev)
    den = torch.zeros((b, L, n_local), dtype=torch.float32, device=dev)

    def block_update(acc, m, den, k, v, src):
        sim = torch.einsum("bild,bjld->blij", q, k).float() * scale
        if not attend_self:
            j_global = src * n_local + torch.arange(n_local, device=dev)
            eye = i_global[:, None] == j_global[None, :]
            sim = sim.masked_fill(eye, TOKEN_ATTEND_SELF_VALUE)
        if mask_rows is not None:
            sim = sim.masked_fill(mask_rows[:, src * n_local:(src + 1) * n_local], MAX_NEG)
        m_new = torch.maximum(m, sim.detach().amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(sim - m_new[..., None])
        acc = acc * corr[..., None] + torch.einsum("blij,bjld->blid", p, v.float())
        den = den * corr + p.sum(dim=-1)
        return acc, m_new, den

    kv = torch.stack([l2_normalize(levels), levels])
    acc, m, den = block_update(acc, m, den, kv[0], kv[1], me)
    for s in range(1, size):
        # one shift a step carries both blocks
        kv = shift(kv, axis, -1)
        acc, m, den = block_update(acc, m, den, kv[0], kv[1], (me + s) % size)
    out = acc / den[..., None]
    return out.permute(0, 2, 1, 3).to(levels.dtype)


def check_columns(num_patches: int, mesh: Mesh, seq_axis: str) -> None:
    """Refuse a column count the seq axis does not divide."""
    s = mesh.size(seq_axis)
    if num_patches % s:
        raise ValueError(f"n={num_patches} patch columns not divisible by seq-axis size {s}")


def make_ring_consensus(mesh: Mesh, *, attend_self: bool = False,
                        non_local_mask: Optional[torch.Tensor] = None, seq_axis: str = "seq",
                        num_patches: Optional[int] = None):
    """A consensus fn of this rank's state ``(b/D, n/S, L, d)`` that runs the
    ring over ``seq_axis`` (each of this rank's batch rows runs its own
    ring).  With ``num_patches`` it refuses a column count the axis
    does not divide, as ``glom_tpu``'s does at call time on the global
    state."""
    if num_patches is not None:
        check_columns(num_patches, mesh, seq_axis)
    axis = mesh.axis(seq_axis) if seq_axis in mesh.shape else None

    def consensus_fn(levels: torch.Tensor) -> torch.Tensor:
        return ring_consensus_attention(levels, axis=axis, attend_self=attend_self,
                                        non_local_mask=non_local_mask)

    return consensus_fn
