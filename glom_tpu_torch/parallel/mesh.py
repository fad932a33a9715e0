"""The mesh: a grid of ``torch.distributed`` ranks (``glom_tpu/parallel/mesh.py``).

``glom_tpu``'s mesh is a ``jax.sharding.Mesh`` of the devices one process
drives through ``shard_map``.  PyTorch's idiom is one process per device, so
here the mesh is a grid of ranks over axes ``(data, model, seq)`` (and, under
``param_sharding="ep"``, extra expert axes): rank ``r`` sits at the row-major
coordinate of ``r`` in ``mesh_shape``, as ``glom_tpu`` reshapes its device
list, owns one device (``cuda:<local rank>`` on a card, or the CPU when the
caller asks for it), and holds one process subgroup per axis of size above
one: the ranks that differ from it only along that axis.

The backend follows the device, never what happens to be installed: NCCL for
CUDA tensors, gloo for the CPU.  gloo for CUDA tensors is taken only when the
caller names it (two ranks sharing one card, which NCCL refuses); then the
collectives gloo does not take on CUDA tensors go through pinned host copies
(``parallel/comm.py``).  Every group carries the timeout it was started with:
a collective that fails or hangs is an error, never a silent one-rank run.

A mesh may cover a prefix of the world's ranks (:func:`make_elastic_mesh`,
``glom_tpu``'s device prefix): then its axes' subgroups and its own group
(``Mesh.barrier``) hold only its ranks, so that nothing on its path waits for
a rank it leaves out; every rank of the world still starts them, in one
order.  :func:`elastic_mesh_shape` is ``glom_tpu``'s re-plan arithmetic, and
:func:`make_hybrid_mesh` its fallback for a topology without slice metadata
(ranks carry none): a flat mesh of the same total shape.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_AXES = ("data", "model", "seq")

#: Every mesh-axis name a module of the port splits over: the default axes
#: and ``"pipe"``, the pipeline's stage axis (``parallel/pipeline.py``),
#: whose meshes callers build with ``make_mesh(..., axis_names=...)``.
MESH_AXES = DEFAULT_AXES + ("pipe",)

#: Seconds a collective may wait before it raises.
DEFAULT_TIMEOUT_S = 600.0

def backend_for(device) -> str:
    """The backend of ``device``'s tensors: NCCL for CUDA, gloo otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_method(coordinator_address: str) -> str:
    """``host:port`` as ``tcp://host:port``; an address with a scheme
    (``tcp://``, ``file://``) is kept as it is."""
    return coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> Optional[torch.device]:
    """Multi-process bring-up: ``--coordinator host:port --num-processes N
    --process-id i`` is ``init_process_group(init_method="tcp://host:port",
    world_size=N, rank=i)``.  Returns this rank's device: ``device`` when
    given (``"cuda"`` becomes ``cuda:<i mod the cards on this host>``),
    else that CUDA device; the backend is :func:`backend_for` it unless
    ``backend`` names one.

    As in ``glom_tpu``, one process with no coordinator is a no-op (returns
    None); naming a coordinator starts a group even of one, so that one card
    runs the production backend's start-up and collectives."""
    if (num_processes is None or num_processes <= 1) and coordinator_address is None:
        return None
    if coordinator_address is None:
        raise ValueError(f"num_processes={num_processes} needs a coordinator address")
    world = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    if not 0 <= rank < world:
        raise ValueError(f"process_id {process_id} outside [0, {world})")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or backend_for(dev),
                            init_method=init_method(coordinator_address), world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return dev


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One mesh axis as this rank sees it: the process subgroup of the ranks
    along it (None for an axis of one), their global ranks in axis order,
    and this rank's index among them."""

    name: str
    group: Optional[object]
    ranks: tuple
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


class Mesh:
    """A grid of ranks: ``shape`` maps each axis name to its size, in order.
    ``axis(name)`` is this rank's :class:`AxisGroup` along it.  ``group`` is
    the process group of a mesh over a prefix of the world's ranks (None when
    the mesh is the whole world, or one rank)."""

    def __init__(self, shape: Dict[str, int], rank: int, axes: Dict[str, AxisGroup],
                 backend: Optional[str], group: Optional[object] = None):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.rank = rank
        self.world_size = int(np.prod(list(shape.values())))
        self.backend = backend
        self.group = group
        self._axes = axes

    def axis(self, name: str) -> AxisGroup:
        return self._axes[name]

    def size(self, name: str) -> int:
        return self.shape.get(name, 1)

    def index(self, name: str) -> int:
        return self._axes[name].index if name in self._axes else 0

    @property
    def coords(self) -> dict:
        return {a: self.index(a) for a in self.axis_names}

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        """Wait for every rank of the mesh (a no-op without a process group,
        and for a mesh of one rank inside a larger world)."""
        if self.group is not None:
            dist.barrier(group=self.group)
        elif dist.is_available() and dist.is_initialized() and (
                self.world_size == dist.get_world_size()):
            dist.barrier()

    def leader_value(self, value: int, device) -> int:
        """Rank 0's ``value`` on every rank of the mesh (a collective of the
        mesh's ranks; ``device`` is where the backend takes tensors)."""
        if self.world_size == 1:
            return int(value)
        t = torch.tensor([int(value)], dtype=torch.int64, device=device)
        dist.broadcast(t, src=0, group=self.group)
        return int(t.item())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, backend={self.backend})"


def make_mesh(
    mesh_shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = DEFAULT_AXES,
    *,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> Mesh:
    """The mesh of the initialized process group (a world of one without
    one).  ``mesh_shape=None`` puts every rank on the first (data) axis;
    one ``-1`` is inferred.  Every rank must call this, in the same order as
    its peers: it starts the axes' subgroups, each with ``timeout_s``."""
    initialized = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if initialized else 1
    if mesh_shape is None:
        mesh_shape = (n,) + (1,) * (len(axis_names) - 1)
    mesh_shape = [int(s) for s in mesh_shape]
    if len(mesh_shape) != len(axis_names):
        raise ValueError(f"mesh_shape {tuple(mesh_shape)} does not match axis_names "
                         f"{tuple(axis_names)}")
    if -1 in mesh_shape:
        known = int(np.prod([s for s in mesh_shape if s != -1]))
        mesh_shape[mesh_shape.index(-1)] = n // known
    if int(np.prod(mesh_shape)) != n:
        raise ValueError(f"mesh_shape {tuple(mesh_shape)} does not cover {n} devices")
    return _mesh_over_prefix(mesh_shape, axis_names, timeout_s)


def _mesh_over_prefix(mesh_shape: list, axis_names: Sequence[str],
                      timeout_s: float) -> Optional[Mesh]:
    """The mesh of ``mesh_shape`` over the world's first ``prod(mesh_shape)``
    ranks; None on a rank it leaves out.  Every rank of the world starts
    every subgroup, in one order (``new_group`` is collective over the
    world); only the mesh's ranks use them."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    size = int(np.prod(mesh_shape))
    timeout = datetime.timedelta(seconds=timeout_s)
    member = rank < size
    shape = dict(zip(axis_names, mesh_shape))
    mine = np.unravel_index(rank, mesh_shape) if member else None
    axes = {}
    for k, name in enumerate(axis_names):
        if mesh_shape[k] == 1:
            if member:
                axes[name] = AxisGroup(name, None, (rank,), 0)
            continue
        others = [range(s) if j != k else [0] for j, s in enumerate(mesh_shape)]
        # every rank starts every line's group, in one order
        for base in itertools.product(*others):
            ranks = []
            for i in range(mesh_shape[k]):
                coord = list(base)
                coord[k] = i
                ranks.append(int(np.ravel_multi_index(coord, mesh_shape)))
            group = dist.new_group(ranks, timeout=timeout)
            if rank in ranks:
                axes[name] = AxisGroup(name, group, tuple(ranks), int(mine[k]))
    whole = None
    if size < world and size > 1:
        whole = dist.new_group(list(range(size)), timeout=timeout)
    if not member:
        return None
    return Mesh(shape, rank, axes, dist.get_backend() if initialized else None, group=whole)


def make_hybrid_mesh(
    ici_shape: Sequence[int],
    dcn_data_parallelism: int = 1,
    axis_names: Sequence[str] = DEFAULT_AXES,
) -> Mesh:
    """``glom_tpu``'s multi-slice mesh: ``dcn_data_parallelism`` slices on
    the data axis, ``ici_shape`` within each.  Ranks carry no slice
    metadata, so this is ``glom_tpu``'s fallback for such a topology: a flat
    :func:`make_mesh` of ``(ici_shape[0] * dcn_data_parallelism,
    *ici_shape[1:])``, the same logical axes with no placement to
    optimize."""
    total = (ici_shape[0] * dcn_data_parallelism,) + tuple(ici_shape[1:])
    return make_mesh(total, axis_names)


def elastic_mesh_shape(
    host_count: int,
    devices_per_host: int = 1,
    *,
    model: int = 1,
    seq: int = 1,
    axis_names: Sequence[str] = DEFAULT_AXES,
) -> tuple:
    """``glom_tpu``'s re-plan arithmetic for an elastic restart (pure: it
    touches no rank): the data axis absorbs the host-count change, the model
    and seq axes are kept, so a shrink degrades throughput and never changes
    the parameter partitioning a checkpoint was written under.  Raises when
    the new total cannot cover the fixed model x seq block."""
    if host_count < 1 or devices_per_host < 1:
        raise ValueError(
            f"host_count ({host_count}) and devices_per_host "
            f"({devices_per_host}) must be >= 1"
        )
    total = host_count * devices_per_host
    fixed = model * seq
    if total % fixed != 0:
        raise ValueError(
            f"{host_count} hosts x {devices_per_host} devices = {total} "
            f"devices cannot preserve the model x seq = {model}x{seq} "
            f"block; re-plan only re-derives the data axis"
        )
    shape = [total // fixed, model, seq]
    # trailing axes past (data, model, seq) (expert factors) replicate
    shape += [1] * (len(axis_names) - len(shape))
    shape = tuple(shape[: len(axis_names)])
    if int(np.prod(shape)) != total:
        # fewer axis names than factors: truncating would drop a model or
        # seq factor and under-cover the owned devices
        raise ValueError(
            f"axis_names {tuple(axis_names)} cannot carry the re-planned "
            f"shape (data={total // fixed}, model={model}, seq={seq}) over "
            f"{total} devices"
        )
    return shape


# (shape, axis names, timeout) -> (the world's default group, this rank's mesh)
_ELASTIC_MESHES: dict = {}


def make_elastic_mesh(
    host_count: int,
    devices_per_host: int = 1,
    *,
    model: int = 1,
    seq: int = 1,
    axis_names: Sequence[str] = DEFAULT_AXES,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> Optional[Mesh]:
    """An elastic re-plan's mesh (:func:`elastic_mesh_shape`) over the
    world's first ``host_count * devices_per_host`` ranks, as ``glom_tpu``
    takes a device prefix: a shrunk job owns fewer ranks than the world
    has.  Every rank of the world must call it, in one order; a rank the
    prefix leaves out gets None.  A shape already made in this world is
    returned again, with its process groups, so a job that restarts many
    times holds one set of groups a shape it has run on."""
    shape = elastic_mesh_shape(
        host_count, devices_per_host, model=model, seq=seq,
        axis_names=axis_names,
    )
    n = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if world < n:
        raise ValueError(
            f"re-planned mesh {shape} needs {n} devices; only "
            f"{world} visible"
        )
    here = dist.group.WORLD if world > 1 else None
    key = (shape, tuple(axis_names), float(timeout_s))
    made = _ELASTIC_MESHES.get(key)
    if made is not None and made[0] is here:
        return made[1]
    for stale in [k for k, (w, _) in _ELASTIC_MESHES.items() if w is not here]:
        del _ELASTIC_MESHES[stale]     # groups of a world that was torn down
    mesh = _mesh_over_prefix(list(shape), axis_names, timeout_s)
    _ELASTIC_MESHES[key] = (here, mesh)
    return mesh
