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

``make_hybrid_mesh``, ``elastic_mesh_shape`` and ``make_elastic_mesh`` (the
multi-slice and elastic meshes) are ROADMAP queue 1, item 6b, and refuse by
name.
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

ITEM_6B = "ROADMAP queue 1, item 6b"


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
    ``axis(name)`` is this rank's :class:`AxisGroup` along it."""

    def __init__(self, shape: Dict[str, int], rank: int, axes: Dict[str, AxisGroup],
                 backend: Optional[str]):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.rank = rank
        self.world_size = int(np.prod(list(shape.values())))
        self.backend = backend
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
        """Wait for every rank (a no-op without a process group)."""
        if dist.is_available() and dist.is_initialized():
            dist.barrier()

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
    rank = dist.get_rank() if initialized else 0
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
    shape = dict(zip(axis_names, mesh_shape))
    mine = np.unravel_index(rank, mesh_shape)
    axes = {}
    for k, name in enumerate(axis_names):
        size = mesh_shape[k]
        if size == 1:
            axes[name] = AxisGroup(name, None, (rank,), 0)
            continue
        others = [range(s) if j != k else [0] for j, s in enumerate(mesh_shape)]
        # every rank starts every line's group, in one order
        for base in itertools.product(*others):
            ranks = []
            for i in range(size):
                coord = list(base)
                coord[k] = i
                ranks.append(int(np.ravel_multi_index(coord, mesh_shape)))
            group = dist.new_group(ranks, timeout=datetime.timedelta(seconds=timeout_s))
            if rank in ranks:
                axes[name] = AxisGroup(name, group, tuple(ranks), int(mine[k]))
    return Mesh(shape, rank, axes, dist.get_backend() if initialized else None)


def _refused(name: str):
    def refuse(*args, **kwargs):
        raise NotImplementedError(f"parallel.mesh.{name} is not in the port yet ({ITEM_6B})")

    refuse.__name__ = name
    refuse.__doc__ = f"``glom_tpu``'s ``{name}``: refused by name ({ITEM_6B})."
    return refuse


make_hybrid_mesh = _refused("make_hybrid_mesh")
elastic_mesh_shape = _refused("elastic_mesh_shape")
make_elastic_mesh = _refused("make_elastic_mesh")
