"""Placement of whole training states on the mesh (``glom_tpu/parallel/placement.py``).

One spec tree for the *params* places any state tree: the optimizer's
moments mirror the params' tree under a prefix (``mu/glom/bottom_up/w1``), so
a leaf's spec is the one whose key path is the longest suffix of the leaf's
(:func:`resolve_pspec`); scalars and unmatched leaves are replicated.

Where ``glom_tpu`` places a global array with a ``NamedSharding``, a rank
here holds its own slice: :func:`shard_tree` cuts it from the whole tree
every rank draws from one seed (or loads from one checkpoint), and
:func:`gather_to_host` all-gathers the slices back into the float32 numpy
arrays ``checkpoint.py`` writes.  :func:`replica_tile` names the slices a
rank writes in a sharded save (``checkpoint.save_sharded``), one rank a tile.
"""

from __future__ import annotations

from typing import Any

import torch

from glom_tpu_torch.parallel.comm import raw_all_gather
from glom_tpu_torch.parallel.mesh import Mesh


def _is_spec(x) -> bool:
    return isinstance(x, tuple)


def flatten_specs(spec_tree: Any, prefix: tuple = ()) -> dict:
    """``{key path: spec}`` of a spec tree (nested dicts, tuple leaves)."""
    if _is_spec(spec_tree):
        return {prefix: spec_tree}
    flat = {}
    for k, v in spec_tree.items():
        flat.update(flatten_specs(v, prefix + (str(k),)))
    return flat


def resolve_pspec(path_key: tuple, flat_specs: dict, ndim: int) -> tuple:
    """The spec whose key path is the longest suffix of ``path_key`` and
    whose rank fits the leaf's; replication when none is."""
    best, best_len = None, -1
    for key, spec in flat_specs.items():
        if len(key) <= len(path_key) and path_key[-len(key):] == key and len(key) > best_len:
            if len(spec) <= ndim:
                best, best_len = spec, len(key)
    return best if best is not None else ()


def state_shardings(tree: Any, param_spec_tree: Any) -> Any:
    """A spec tree mirroring ``tree`` (nested dicts of tensors, arrays or
    scalars), each leaf's spec resolved by its key path's suffix; a scalar's
    is ``()``."""
    flat = flatten_specs(param_spec_tree)

    def place(node, path):
        if isinstance(node, dict):
            return {k: place(v, path + (str(k),)) for k, v in node.items()}
        ndim = len(getattr(node, "shape", ()))
        return resolve_pspec(path, flat, ndim) if ndim else ()

    return place(tree, ())


def sharded_axes(spec: tuple) -> tuple:
    """The mesh axes a spec splits over, in dimension order."""
    return tuple(a for a in spec if a is not None)


def local_slice(x: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of the whole ``x`` under ``spec``."""
    for dim, axis in enumerate(spec):
        if axis is None or mesh.size(axis) == 1:
            continue
        size = mesh.size(axis)
        if x.shape[dim] % size:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split over the "
                             f"{size} ranks of mesh axis {axis!r}")
        width = x.shape[dim] // size
        x = x.narrow(dim, mesh.index(axis) * width, width)
    return x.contiguous()


def replica_tile(x: torch.Tensor, spec: tuple, mesh: Mesh):
    """``(x, start)`` when this rank is replica 0 of its slice ``x`` under
    ``spec`` (its coordinate is 0 along every mesh axis of size above one
    that the spec does not split), else None: ``start`` is the slice's
    offset in the whole tensor, one entry a dimension.  Across the mesh the
    replica-0 tiles cover every element once, as ``glom_tpu``'s
    ``addressable_shards`` with ``replica_id == 0`` do."""
    split = set(sharded_axes(spec))
    if any(mesh.index(a) for a in mesh.axis_names if a not in split and mesh.size(a) > 1):
        return None
    start = [0] * x.dim()
    for dim, axis in enumerate(spec):
        if axis is not None and mesh.size(axis) > 1:
            start[dim] = mesh.index(axis) * x.shape[dim]
    return x, start


def tree_map_specs(fn, tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over a tree and its spec tree."""
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, tree[k], specs[k]) for k in tree}
    return fn(tree, specs)


def shard_tree(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """Each tensor leaf's local slice (:func:`local_slice`)."""
    return tree_map_specs(
        lambda x, s: local_slice(x, s, mesh) if isinstance(x, torch.Tensor) else x, tree, specs)


def gather_leaf(x: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """The whole tensor of which ``x`` is this rank's slice under ``spec``
    (every rank along the spec's axes takes part)."""
    for dim, axis in enumerate(spec):
        if axis is not None and mesh.size(axis) > 1:
            x = raw_all_gather(x, mesh.axis(axis), dim)
    return x


def gather_to_host(tree: Any, mesh: Mesh, specs: Any) -> Any:
    """The whole tree as float32 numpy arrays on every rank: each sharded leaf
    all-gathered over its spec's axes, then copied to the host."""
    def leaf(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        return gather_leaf(x.detach(), spec, mesh).to("cpu", torch.float32, copy=True).numpy()

    return tree_map_specs(leaf, tree, specs)
