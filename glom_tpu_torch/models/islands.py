"""Island analysis: inspecting emergent part-whole structure
(``glom_tpu/models/islands.py``).

Per-level neighbour-agreement maps (how strongly each patch column agrees
with its grid neighbours; islands appear as high-agreement regions) and a
threshold-based island labelling.  The agreement math is torch (batched, on
the state's device); the labelling is a host-side NumPy flood fill (data
dependent and tiny).  ``hierarchy/parse.py`` gives the same labelling as a
fixed-trip device computation.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from glom_tpu_torch.ops.consensus import l2_normalize

# the four grid neighbours as (dy, dx) roll shifts
_SHIFTS = ((0, 1), (0, -1), (1, 0), (-1, 0))


def neighbor_agreement(levels: torch.Tensor, num_patches_side: int) -> torch.Tensor:
    """Mean cosine similarity of each column to its 4-neighbours, per level.

    ``levels``: ``(b, n, L, d)`` state.  Returns ``(b, L, side, side)``
    agreement maps in [-1, 1]; edge cells average over their in-grid
    neighbours only (the rolled-around edges are masked)."""
    b, n, L, d = levels.shape
    side = num_patches_side
    if side * side != n:
        raise ValueError(f"n={n} is not {side}x{side}")

    grid = l2_normalize(levels, dim=-1).reshape(b, side, side, L, d)
    counts = torch.zeros((side, side), dtype=grid.dtype, device=grid.device)
    total = torch.zeros((b, side, side, L), dtype=grid.dtype, device=grid.device)
    for dy, dx in _SHIFTS:
        shifted = torch.roll(grid, shifts=(dy, dx), dims=(1, 2))
        sim = (grid * shifted).sum(dim=-1)
        valid = torch.ones((side, side), dtype=torch.bool, device=grid.device)
        if dy == 1:
            valid[0, :] = False
        elif dy == -1:
            valid[-1, :] = False
        if dx == 1:
            valid[:, 0] = False
        elif dx == -1:
            valid[:, -1] = False
        total = total + sim * valid[None, :, :, None]
        counts = counts + valid
    return (total / counts[None, :, :, None]).permute(0, 3, 1, 2)


def label_islands(agreement: np.ndarray, threshold: float = 0.9
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Connected-component labelling of high-agreement regions.

    ``agreement``: one ``(side, side)`` map (a slice of
    :func:`neighbor_agreement`, as numpy).  Returns ``(labels, sizes)``:
    labels ``(side, side)`` int32 (0 below threshold, islands numbered from 1
    in row-major first-encounter order) and ``sizes[k]`` the cell count of
    island ``k+1``."""
    agreement = np.asarray(agreement)
    side = agreement.shape[0]
    mask = agreement >= threshold
    labels = np.zeros((side, side), np.int32)
    sizes = []
    current = 0
    for y in range(side):
        for x in range(side):
            if not mask[y, x] or labels[y, x]:
                continue
            current += 1
            stack = [(y, x)]
            labels[y, x] = current
            count = 0
            while stack:
                cy, cx = stack.pop()
                count += 1
                for ny, nx in ((cy + 1, cx), (cy - 1, cx), (cy, cx + 1), (cy, cx - 1)):
                    if 0 <= ny < side and 0 <= nx < side and mask[ny, nx] and not labels[ny, nx]:
                        labels[ny, nx] = current
                        stack.append((ny, nx))
            sizes.append(count)
    return labels, np.asarray(sizes, np.int64)


def island_summary(all_levels: torch.Tensor, num_patches_side: int,
                   threshold: float = 0.9) -> dict:
    """Per-(timestep, level) island statistics over a ``return_all`` stack
    ``(T, b, n, L, d)``: mean agreement and island count of batch item 0.
    Returns ``{"mean_agreement": (T, L), "num_islands": (T, L)}``."""
    T, L = all_levels.shape[0], all_levels.shape[3]
    mean_agreement = np.zeros((T, L))
    num_islands = np.zeros((T, L), np.int64)
    for t in range(T):
        # only batch item 0 is summarized: slice before the agreement
        maps = neighbor_agreement(all_levels[t, :1], num_patches_side).detach().cpu().numpy()
        for level in range(L):
            mean_agreement[t, level] = maps[0, level].mean()
            _, sizes = label_islands(maps[0, level], threshold)
            num_islands[t, level] = len(sizes)
    return {"mean_agreement": mean_agreement, "num_islands": num_islands}
