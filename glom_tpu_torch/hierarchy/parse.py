"""The islanding post-pass (``glom_tpu/hierarchy/parse.py``).

The reference labelling (:func:`glom_tpu_torch.models.islands.label_islands`)
is a host-side flood fill: data-dependent control flow.  This module
computes the SAME labelling on the state's device as a fixed-trip min-index
label propagation:

  1. every above-threshold cell starts labelled with its own row-major flat
     index (below-threshold cells carry the sentinel ``n``);
  2. ``n`` propagation steps take the min over the cell and its masked
     4-neighbours; after ``n`` steps (the longest possible in-component
     path) every cell holds the min flat index of its component;
  3. components are renumbered 1..K by the rank of their root index: the
     reference's row-major first-encounter order, so the two labellings are
     bitwise identical (the tests pin it).

The trip count is fixed, not "until nothing changes", so the post-pass
never reads a value back to the host mid-way and can be captured as one
CUDA graph per bucket.  All ``(b, L)`` maps propagate at once, batched
where ``glom_tpu`` maps with ``vmap``.  It is torch code, not a kernel: no
TPU kernel computes it.

Output is one packed float32 row per image (labels, counts, sizes,
per-island mean embeddings), as ``glom_tpu`` packs it.  Sizes and means are
segment sums (``scatter_add_``): the sizes are exact; on the card the means'
summation order is the atomics', so they match ``glom_tpu``'s within a
float32 tolerance, not bitwise.  Host-side helpers (threshold grammar, row
unpacking, frame-to-frame island deltas) are numpy-only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from glom_tpu_torch.models import glom as glom_model
from glom_tpu_torch.obs.quality import agreement_maps

#: default agreement threshold when the operator gives none (the
#: models/islands.py default), one value broadcast across levels
DEFAULT_THRESHOLD = 0.9


def parse_thresholds(spec: Union[None, float, str, Sequence[float]],
                     levels: int) -> Tuple[float, ...]:
    """The threshold grammar: ``None`` -> the default broadcast per level; a
    float (or one numeric string) -> broadcast; a comma list
    (``"0.95,0.9,0.8"``) or sequence -> one threshold per level,
    length-checked.  Cosine agreement lives in [-1, 1]; values outside are
    configuration errors, not clamps."""
    if spec is None:
        vals = [DEFAULT_THRESHOLD] * levels
    elif isinstance(spec, str):
        parts = [p.strip() for p in spec.split(",") if p.strip()]
        if not parts:
            raise ValueError(f"empty threshold spec {spec!r}")
        try:
            vals = [float(p) for p in parts]
        except ValueError:
            raise ValueError(
                f"bad threshold spec {spec!r}: want a float or a "
                f"comma-separated list of floats")
        if len(vals) == 1:
            vals = vals * levels
    elif isinstance(spec, (int, float)):
        vals = [float(spec)] * levels
    else:
        vals = [float(v) for v in spec]
    if len(vals) != levels:
        raise ValueError(
            f"threshold spec has {len(vals)} values for {levels} levels")
    for v in vals:
        if not -1.0 <= v <= 1.0:
            raise ValueError(
                f"threshold {v} outside cosine range [-1, 1]")
    return tuple(vals)


def parse_row_width(levels: int, side: int, dim: int) -> int:
    """Packed-row column count: per level, ``side*side`` labels + 1 island
    count + ``n`` island sizes + ``n * dim`` island means (both padded to the
    ``n``-island maximum so the row shape is static)."""
    n = side * side
    return levels * (n + 1 + n + n * dim)


# -- the device islanding ----------------------------------------------------

def _island_labels(mask: torch.Tensor, side: int):
    """``(..., side, side)`` bool masks -> ``(labels, count)``: labels int32
    of the mask's shape, 0 below threshold and islands numbered from 1 in
    row-major first-encounter order (bitwise
    :func:`~glom_tpu_torch.models.islands.label_islands` on the same mask),
    and ``count (...)`` int32 islands per map."""
    n = side * side
    lead = tuple(mask.shape[:-2])
    dev = mask.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    sentinel = torch.full((), n, dtype=torch.int32, device=dev)
    # the labels live inside a border of sentinels: the neighbours' min is
    # four shifted views, with no wrap and no edge case
    padded = torch.full(lead + (side + 2, side + 2), n, dtype=torch.int32, device=dev)
    lab = padded[..., 1:-1, 1:-1]
    torch.where(mask, idx.reshape(side, side), sentinel, out=lab)
    vert = torch.empty(lead + (side, side), dtype=torch.int32, device=dev)
    horiz = torch.empty_like(vert)
    # n steps bound the longest shortest path inside any 4-connected
    # component of an n-cell grid, so the fixed trip always converges
    for _ in range(n):
        torch.minimum(padded[..., :-2, 1:-1], padded[..., 2:, 1:-1], out=vert)
        torch.minimum(padded[..., 1:-1, :-2], padded[..., 1:-1, 2:], out=horiz)
        torch.minimum(vert, horiz, out=vert)
        torch.minimum(vert, lab, out=vert)
        torch.where(mask, vert, sentinel, out=lab)
    root = lab.reshape(lead + (n,))
    flat_mask = mask.reshape(lead + (n,))
    is_root = flat_mask & (root == idx)
    rank = torch.cumsum(is_root, dim=-1, dtype=torch.int32)        # 1-based at roots
    rank_ext = torch.cat([rank, torch.zeros(lead + (1,), dtype=torch.int32, device=dev)], -1)
    labels = torch.where(flat_mask, torch.gather(rank_ext, -1, root.long()), 0)
    return labels.reshape(lead + (side, side)), rank[..., n - 1]


def make_pack_fn(config, thresholds: Sequence[float]):
    """``(b, n, L, d)`` column state -> ``(b, F)`` packed parse rows, the
    islanding post-pass (:func:`parse_row_width` columns a row): per level
    the labels, then the counts, the sizes and the means, each block
    level-major, as ``glom_tpu`` lays it out."""
    side = config.image_size // config.patch_size
    n = side * side
    # float32 thresholds, as glom_tpu holds them; compared as scalars, so the
    # post-pass copies nothing from the host
    thr = tuple(float(np.float32(t)) for t in thresholds)
    if len(thr) != config.levels:
        raise ValueError(f"{len(thr)} thresholds for {config.levels} levels")

    def pack_batch(levels: torch.Tensor) -> torch.Tensor:
        levels32, agree = agreement_maps(levels, side)        # (b, n, L, d), (b, L, s, s)
        b, _, L, d = levels32.shape
        mask = torch.stack([agree[:, lv] >= t for lv, t in enumerate(thr)], dim=1)
        labels, count = _island_labels(mask, side)            # (b, L, s, s), (b, L)
        seg = labels.reshape(b, L, n).long()
        sizes = torch.zeros((b, L, n + 1), dtype=torch.float32, device=agree.device)
        sizes.scatter_add_(-1, seg, torch.ones_like(sizes[..., 1:]))
        sums = torch.zeros((b, L, n + 1, d), dtype=torch.float32, device=agree.device)
        sums.scatter_add_(2, seg[..., None].expand(b, L, n, d), levels32.transpose(1, 2))
        sizes, sums = sizes[..., 1:], sums[:, :, 1:]
        means = sums / sizes.clamp(min=1.0)[..., None]
        return torch.cat([labels.reshape(b, -1).float(), count.float(),
                          sizes.reshape(b, -1), means.reshape(b, -1)], dim=1)

    return pack_batch


#: the packer's older name, kept as ``glom_tpu`` keeps it
_make_packer = make_pack_fn


def make_index_fn(config, iters: Optional[int], *, ff_fn=None, fused_fn=None,
                  consensus_fn=None, apply_fn=None):
    """``(params, imgs) -> (b, n, L, d)`` float32 column state, the bulk
    ``transform: "index"`` forward (``params``: ``{"glom": ...}``).  The cast
    is part of the function: the index files are float32 by layout whatever
    the compute dtype.  The step functions, when given, are
    ``models/glom.py::resolve_step_fns``'s (the serving engine resolves them
    once, outside its graphs); ``apply_fn`` stands for ``models/glom.py::apply``
    (a mesh rank's: ``serving/sharded.py::make_sharded_apply``)."""
    apply_fn = apply_fn or glom_model.apply

    def f(params, imgs):
        levels = apply_fn(params["glom"], imgs, config=config, iters=iters,
                          consensus_fn=consensus_fn, ff_fn=ff_fn, fused_fn=fused_fn)
        return levels.float()

    return f


# -- host-side unpacking / deltas -------------------------------------------

def unpack_parse(row: Sequence[float], levels: int, side: int,
                 dim: int) -> List[Dict[str, object]]:
    """One packed parse row -> per-level island dicts with the padding
    trimmed: ``labels`` (side x side ints, 0 = below threshold),
    ``num_islands``, ``sizes`` / ``means`` sliced to the real island count
    (island ``k`` is row ``k-1``)."""
    n = side * side
    row = np.asarray(row, np.float32).reshape(-1)
    want = parse_row_width(levels, side, dim)
    if row.shape[0] != want:
        raise ValueError(
            f"parse row has {row.shape[0]} columns, expected {want}")
    off = 0
    labels = np.rint(row[off:off + levels * n]).astype(np.int32)
    labels = labels.reshape(levels, side, side)
    off += levels * n
    counts = np.rint(row[off:off + levels]).astype(np.int32)
    off += levels
    sizes = np.rint(row[off:off + levels * n]).astype(np.int32)
    sizes = sizes.reshape(levels, n)
    off += levels * n
    means = row[off:].reshape(levels, n, dim)
    out: List[Dict[str, object]] = []
    for lv in range(levels):
        k = int(counts[lv])
        out.append({
            "labels": labels[lv].tolist(),
            "num_islands": k,
            "sizes": sizes[lv, :k].tolist(),
            "means": [[float(v) for v in means[lv, i]] for i in range(k)],
        })
    return out


def island_deltas(prev_labels: Optional[np.ndarray],
                  cur_labels: np.ndarray) -> List[Dict[str, List[int]]]:
    """Frame-to-frame island diff, per level.  Current islands are matched
    to the previous frame's island with the largest patch overlap (ties
    break to the smallest previous label):

      * ``appeared`` — current islands overlapping no previous island;
      * ``stable``   — matched with an identical patch set;
      * ``moved``    — matched but the patch set changed;
      * ``vanished`` — previous islands no current island matched.

    ``prev_labels`` ``None`` (a cold frame) makes every current island
    ``appeared``.  Island ids are per-frame labels, not identities across
    frames."""
    cur_labels = np.asarray(cur_labels)
    out: List[Dict[str, List[int]]] = []
    for lv in range(cur_labels.shape[0]):
        c = cur_labels[lv]
        p = (None if prev_labels is None
             else np.asarray(prev_labels)[lv])
        deltas: Dict[str, List[int]] = {
            "appeared": [], "vanished": [], "moved": [], "stable": []}
        cur_ids = [int(i) for i in np.unique(c) if i > 0]
        if p is None:
            deltas["appeared"] = cur_ids
            out.append(deltas)
            continue
        matched: set = set()
        for k in cur_ids:
            cells = c == k
            overlap = np.bincount(p[cells].ravel())
            if overlap.size:
                overlap[0] = 0          # below-threshold is not an island
            best = int(overlap.argmax()) if overlap.size else 0
            if best == 0 or overlap[best] == 0:
                deltas["appeared"].append(k)
                continue
            matched.add(best)
            same = bool(np.array_equal(cells, p == best))
            (deltas["stable"] if same else deltas["moved"]).append(k)
        deltas["vanished"] = [int(i) for i in np.unique(p)
                              if i > 0 and int(i) not in matched]
        out.append(deltas)
    return out
