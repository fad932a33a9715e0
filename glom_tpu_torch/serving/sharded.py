"""Mesh-sharded serving: placement, kernel dispatch, and the leader/follower
dispatch of a mesh of ranks (``glom_tpu/serving/sharded.py``).

An engine built with a ``mesh_shape`` runs as one rank of a
``torch.distributed`` world (one process a device; ``glom_tpu`` drives every
device from one process).  Every rank holds its shard of the parameters and
computes its rows of each served bucket on the hand kernels; rank 0 is the
**leader**, which alone serves requests.  What lives here, shared by
start-up and every reload:

  * **mesh resolution** -- :func:`resolve_mesh`, a ``parallel/mesh.py`` mesh
    over the world's ranks, refused by name when the world's size is not
    ``prod(mesh_shape)``;
  * **placement** -- :func:`param_shardings`, the spec tree of the
    *quantized* tree from the training rules (``parallel/sharding.py``):
    int8 ``{int8_q, int8_scale}`` records take their weight's spec with any
    axis that no longer divides its dimension dropped (:func:`_sanitize_spec`:
    a ``(g, 1, d)`` scale replicates), the decoder replicated;
    :func:`batch_shardings`, this rank's rows of a bucket;
  * **kernel dispatch** -- :func:`resolve_sharded_kernels`, ``glom_tpu``'s
    rule: K8 per rank under a pure-DP mesh, otherwise the grouped-FF kernel
    per shard (``parallel/ff_shard.py``) with ``glom_tpu``'s warning when
    ``"fused"`` falls back; under a seq axis the rank's patch columns and a
    consensus of the gathered ``n`` (:func:`make_sharded_apply`);
  * **the dispatch** -- :class:`MeshDispatch`.  It has no counterpart in
    ``glom_tpu``, where one process drives every device.  Every mesh call is
    announced by the leader over a gloo group of all ranks, as a small
    header: ``RUN`` (a set, a graph family, the real rows, eager or not;
    the images follow), ``LOAD`` (a reload or a stage: restore a step into a
    new set and capture it), ``ACK`` (all ranks hold a loaded set: the
    leader learns a follower's failure before it serves the set), ``DROP``
    (the leader freed a set: after a commit, an abort, a finalize or a
    rollback), ``PING`` (a heartbeat while idle: a follower never waits past
    the group's timeout, and the leader finds a dead one) and ``STOP``.  A
    commit, a rollback or a swap needs no header: every ``RUN`` names the set
    it runs on.  The followers run a loop (:meth:`MeshDispatch.follow`) that
    makes the same cache call on their shard.

Every rank must issue the mesh's collectives in the same order, and the
leader serves from several threads (a worker an endpoint, the quality
post-pass, the reload watcher, the heartbeat).  So each leader call holds
one lock from its header to the end of its collectives.  A collective that
fails or outlives the group's timeout fails the mesh: the request raises,
every later call raises at once, and ``/healthz`` says so.

A pure-DP mesh has no collective inside the forward: each rank replays its
own bucket graphs and the rows are gathered outside them.  A forward with
collectives inside (TP, EP, seq) runs eagerly (:func:`eager_reason`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import itertools
import threading
import time
import warnings
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.models import glom as glom_model
from glom_tpu_torch.parallel import mesh as mesh_lib
from glom_tpu_torch.parallel.comm import raw_all_gather
from glom_tpu_torch.parallel.ff_shard import make_sharded_ff, make_sharded_ff_pallas
from glom_tpu_torch.parallel.fused_shard import make_sharded_fused_update
from glom_tpu_torch.parallel.mesh import Mesh
from glom_tpu_torch.parallel.sharding import level_sharded_pspecs, param_pspecs
from glom_tpu_torch.parallel.step import column_slice, make_gathered_consensus

PARAM_SHARDINGS = ("replicated", "tp", "ep")

#: What a mesh above one rank does not carry yet (the engine refuses each by
#: name): sessions, extra models, the bulk tier, /similar's index, deploys.
ITEM_1B = "ROADMAP queue 1, item 6b-rest 1b"


def resolve_mesh(mesh_shape: Sequence[int], axis_names: Sequence[str] = mesh_lib.DEFAULT_AXES,
                 *, timeout_s: Optional[float] = None) -> Mesh:
    """A serving mesh over the world's ranks, ``axis_names`` in order.

    ``glom_tpu`` takes the first ``prod(mesh_shape)`` devices of its one
    process; here one process is one rank, so the world must have exactly
    ``prod(mesh_shape)`` of them.  Every rank calls this in the same order
    (it starts the axes' groups, each with ``timeout_s``, by default
    ``parallel/mesh.py::DEFAULT_TIMEOUT_S`` as it stands at the call)."""
    shape = tuple(int(s) for s in mesh_shape)
    names = tuple(axis_names)
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh_shape entries must be >= 1, got {shape}")
    if len(names) != len(shape):
        raise ValueError(f"mesh_axis_names {names} do not name the {len(shape)} axes of "
                         f"mesh_shape {shape}")
    n = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if n != world:
        raise ValueError(
            f"mesh_shape {shape} needs {n} ranks; this world has {world} (one process a "
            f"rank: start {n}, each with the coordinator, --num-processes {n} and its "
            f"--process-id)")
    timeout = mesh_lib.DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s
    return mesh_lib.make_mesh(shape, names, timeout_s=timeout)


def mesh_axes_dict(mesh: Optional[Mesh]) -> Optional[dict]:
    """``{"data": 4, "model": 2, ...}``: the ``/healthz`` and snapshot label."""
    if mesh is None:
        return None
    return {name: int(size) for name, size in mesh.shape.items()}


def _sanitize_spec(spec: tuple, shape: Tuple[int, ...], mesh: Mesh) -> tuple:
    """``spec`` with every axis that does not divide its dimension dropped:
    the one rule that lets an int8 record follow its weight's spec (a scale's
    contracted dimension is 1, so its model entry drops and it replicates)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries[:len(shape)]):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        size = int(np.prod([mesh.size(a) for a in axes]))
        out.append(entry if size > 0 and dim % size == 0 else None)
    return tuple(out)


def _lookup(spec_tree, path: tuple) -> Optional[tuple]:
    """The spec at ``path`` of a nested-dict spec tree; None when the path
    leaves the tree (such a leaf is replicated)."""
    node = spec_tree
    for key in path:
        if not isinstance(node, dict) or key not in node:
            return None
        node = node[key]
    return node if isinstance(node, tuple) else None


def param_shardings(mesh: Mesh, config: GlomConfig, quantized_params, *,
                    param_sharding: str = "replicated", model_axis: str = "model") -> dict:
    """The spec tree of ``quantized_params`` (the engine's ``{"glom",
    "decoder"}`` tree after ``serving/quant.py::quantize_tree``): the glom
    subtree by ``parallel/sharding.py::param_pspecs`` (``"tp"``) or
    ``::level_sharded_pspecs`` (``"ep"``), the decoder and any leaf the rules
    do not name replicated, and every spec sanitized against its leaf's
    shape, so an int8 record's ``int8_q`` and ``int8_scale`` take the
    weight's spec where it still divides."""
    if param_sharding not in PARAM_SHARDINGS:
        raise ValueError(f"unknown param_sharding {param_sharding!r}; one of {PARAM_SHARDINGS}")
    if param_sharding == "tp":
        glom_specs = param_pspecs(config, model_axis=model_axis)
    elif param_sharding == "ep":
        glom_specs = level_sharded_pspecs(config, axis_size=mesh.size(model_axis),
                                          model_axis=model_axis)
    else:
        glom_specs = {}
    spec_tree = {"glom": glom_specs}

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        # an int8 record sits one level below its weight's spec
        lookup = path[:-1] if path and path[-1] in ("int8_q", "int8_scale") else path
        return _sanitize_spec(_lookup(spec_tree, lookup) or (), tuple(node.shape), mesh)

    return walk(quantized_params, ())


def batch_shardings(mesh: Mesh, *, data_axis: str = "data") -> Callable[[int], slice]:
    """``glom_tpu``'s pair of batch shardings as one rank sees them: the
    images and every per-image output split their batch axis over
    ``data_axis``, so one function of the bucket gives this rank's rows of
    the padded batch, the images it computes and the output rows it holds."""
    d, i = mesh.size(data_axis), mesh.index(data_axis)

    def rows(bucket: int) -> slice:
        per = bucket // d
        return slice(i * per, (i + 1) * per)

    return rows


def validate_buckets(buckets: Sequence[int], mesh: Mesh, *, data_axis: str = "data") -> None:
    """Every bucket must divide over the data axis (``glom_tpu``'s message)."""
    n_data = mesh.size(data_axis)
    if n_data <= 1:
        return
    bad = [b for b in buckets if b % n_data]
    if bad:
        raise ValueError(
            f"buckets {bad} are not divisible by the mesh's data axis "
            f"({data_axis}={n_data}); every bucket must be a multiple so "
            f"each device holds an equal batch shard"
        )


def params_sharded(mesh: Mesh, param_sharding: str, model_axis: str = "model") -> bool:
    return param_sharding != "replicated" and mesh.size(model_axis) > 1


def eager_reason(mesh: Mesh, param_sharding: str, *, model_axis: str = "model",
                 seq_axis: str = "seq") -> Optional[str]:
    """Why this mesh's forward cannot be a CUDA graph (None when it can: a
    pure-DP forward has no collective inside it)."""
    if not (params_sharded(mesh, param_sharding, model_axis) or mesh.size(seq_axis) > 1):
        return None
    return ("collectives inside the forward (model- or seq-sharded): gloo stages them "
            "through the host, which a CUDA graph cannot hold, and NCCL's capture needs a "
            f"card a rank ({ITEM_1B})")


def resolve_sharded_kernels(mesh: Mesh, config: GlomConfig, device=None, *,
                            param_sharding: str = "replicated", data_axis: str = "data",
                            model_axis: str = "model", seq_axis: str = "seq"):
    """``(consensus_fn, ff_fn, fused_fn)`` for ``models/glom.py::apply`` on
    this rank's shard, the contract of ``models/glom.py::resolve_step_fns``
    on one card, by ``glom_tpu``'s rule:

      * dense FF: the plain ops on the shard (the plain grouped FF through
        ``parallel/ff_shard.py`` when the params are split);
      * ``"fused"`` on a pure-DP mesh with the shape supported: K8 on the
        rank's rows (``parallel/fused_shard.py``);
      * ``"pallas"``, or ``"fused"`` on a model- or seq-sharded mesh (with
        ``glom_tpu``'s warning): K1 per shard (``parallel/ff_shard.py``);
      * a seq axis above one: the consensus of the gathered ``n``
        (``parallel/step.py::make_gathered_consensus``; K4 under
        ``"pallas"``), what GSPMD does for ``glom_tpu``'s opaque
        ``pallas_call``, and :func:`make_sharded_apply` for the columns.

    ``data_axis`` needs no function of its own: a rank computes its rows,
    and with nothing else split a rank runs the one-card step on them."""
    del data_axis
    seq_sharded = mesh.size(seq_axis) > 1
    split = params_sharded(mesh, param_sharding, model_axis)
    fused = config.ff_impl == "fused" and glom_model.fused_update_supported(config, device)
    if config.ff_impl == "fused" and (seq_sharded or split or not fused):
        warnings.warn(
            "serving ff_impl='fused' does not support this mesh (seq- or "
            "model-sharded, or supports_config failed); falling back to "
            "the sharded unfused pallas FF",
            stacklevel=2,
        )
    if not (seq_sharded or split):
        if fused:
            return None, None, make_sharded_fused_update(config, device)
        return glom_model.resolve_step_fns(config, device)
    consensus_fn = None
    if seq_sharded:
        cc = config
        if config.ff_impl == "fused" and config.attention_impl == "dense":
            # the one-card rule: "fused"'s leftover dense default resolves by "auto"
            cc = dataclasses.replace(config, attention_impl="auto")
        consensus_fn = make_gathered_consensus(glom_model.make_consensus_fn(cc, device), mesh,
                                               seq_axis)
    if config.ff_impl in ("pallas", "fused"):
        ff_fn = make_sharded_ff_pallas(mesh, param_sharding=param_sharding,
                                       model_axis=model_axis, fused_bwd=config.ff_fused_bwd)
    else:
        ff_fn = make_sharded_ff(mesh, param_sharding=param_sharding,
                                model_axis=model_axis) if split else None
    return glom_model.resolve_step_fns(config, device, consensus_fn=consensus_fn, ff_fn=ff_fn)


def make_sharded_apply(mesh: Mesh, config: GlomConfig, seq_axis: str = "seq"):
    """``models/glom.py::apply`` on this rank's patch columns along
    ``seq_axis`` (``parallel/step.py::column_slice``), each returned state
    gathered back over the axis, so that every seq rank holds the whole
    ``(b, n, L, d)`` of its rows (what the embedding's mean, the decoder and
    the islanding pack read); ``apply`` itself under one seq rank."""
    cols = column_slice(config, mesh, seq_axis)
    if cols is None:
        return glom_model.apply
    axis = mesh.axis(seq_axis)

    def apply(params, img, **kw):
        out = glom_model.apply(params, img, columns=cols, **kw)
        if isinstance(out, tuple):
            return tuple(raw_all_gather(o, axis, 1) for o in out)
        return raw_all_gather(out, axis, 1)

    return apply


# -- the leader/follower dispatch ---------------------------------------------

RUN, LOAD, ACK, DROP, PING, STOP = range(1, 7)
#: graph families a RUN header may name (the cache keys of a mesh engine's set)
FAMILIES = ("embed", "reconstruct", "index", "parse", "quality")
_HEADER = 8       # int64 slots: kind, then the kind's fields


class MeshFailed(RuntimeError):
    """The mesh lost a rank or a collective failed: nothing more is served."""


class MeshDispatch:
    """The control plane of a mesh engine: the leader's headers and batches
    over a gloo group of every rank, the row gather over a gloo group along
    the data axis, the lock that keeps every rank's collectives in one order,
    and the followers' loop.

    Both groups are gloo whatever the mesh's own backend (the headers and
    rows are host data); every rank makes them, in one order, with
    ``timeout_s`` (default ``parallel/mesh.py::DEFAULT_TIMEOUT_S`` as it
    stands at the call).  The leader's heartbeat runs every quarter of it
    while no call does."""

    def __init__(self, mesh: Mesh, *, data_axis: str = "data",
                 timeout_s: Optional[float] = None):
        self.mesh = mesh
        self.is_leader = mesh.rank == 0
        self.timeout_s = float(mesh_lib.DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s)
        timeout = datetime.timedelta(seconds=self.timeout_s)
        self._control = dist.new_group(list(range(mesh.world_size)), backend="gloo",
                                       timeout=timeout)
        self._rows_group, self._rows_size = None, mesh.size(data_axis)
        if self._rows_size > 1:
            names = list(mesh.shape)
            sizes = [mesh.shape[a] for a in names]
            k = names.index(data_axis)
            lines = sorted({tuple(int(np.ravel_multi_index(c[:k] + (i,) + c[k + 1:], sizes))
                                  for i in range(sizes[k]))
                            for c in itertools.product(*[range(s) for s in sizes])})
            for line in lines:       # every rank makes every line's group, in one order
                group = dist.new_group(list(line), backend="gloo", timeout=timeout)
                if mesh.rank in line:
                    self._rows_group = group
        self._rows = batch_shardings(mesh, data_axis=data_axis)
        self._lock = threading.Lock()
        self._next_id = 1               # set 0 is the one every rank builds at start-up
        self._live = {0}
        self._released: list = []
        # reentrant: a set's finalizer may run inside any allocation, this
        # lock's own critical sections on this thread included
        self._released_lock = threading.RLock()
        self._last = time.monotonic()
        self._beat_stop = threading.Event()
        self._beat: Optional[threading.Thread] = None
        self.failed: Optional[str] = None
        self.stopped = False
        self.calls = 0

    # -- shared by both roles ------------------------------------------------
    def local_rows(self, bucket: int) -> int:
        return bucket // self._rows_size

    def rows(self, bucket: int) -> slice:
        return self._rows(bucket)

    def gather(self, host: np.ndarray) -> np.ndarray:
        """Every data rank's rows of one call's output, in rank order: the
        whole bucket's (each rank along the other axes gathers its own line's
        copy)."""
        if self._rows_group is None:
            return host
        t = torch.from_numpy(np.ascontiguousarray(host))
        parts = [torch.empty_like(t) for _ in range(self._rows_size)]
        dist.all_gather(parts, t, group=self._rows_group)
        return torch.cat(parts).numpy()

    def agree_step(self, step: Optional[int]) -> int:
        """The leader's start-up step on every rank (the leader passes the
        step it loaded, -1 when its load failed)."""
        t = torch.tensor([-1 if step is None else int(step)], dtype=torch.int64)
        dist.broadcast(t, 0, group=self._control)
        if int(t[0]) < 0:
            raise MeshFailed("the leader could not load its start-up checkpoint")
        return int(t[0])

    def _header(self, kind: int, *fields) -> None:
        h = torch.zeros(_HEADER, dtype=torch.int64)
        h[0] = kind
        for i, v in enumerate(fields):
            h[1 + i] = int(v)
        dist.broadcast(h, 0, group=self._control)

    def _agree(self, ok: bool) -> bool:
        t = torch.tensor([1 if ok else 0], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self._control)
        return bool(int(t[0]))

    # -- the leader ----------------------------------------------------------
    def _check(self) -> None:
        if self.failed is not None:
            raise MeshFailed(f"the mesh failed: {self.failed}")
        if self.stopped:
            raise MeshFailed("the mesh is stopped")

    @contextlib.contextmanager
    def _call(self):
        """The leader's critical section: checked, released sets dropped
        first, any error inside fails the mesh."""
        with self._lock:
            self._check()
            try:
                self._flush_released()
                yield
            except BaseException as e:
                self._fail(e)
                raise
            finally:
                self._last = time.monotonic()

    def _fail(self, e: BaseException) -> None:
        if self.failed is None:
            self.failed = f"{type(e).__name__}: {e}"
        self._beat_stop.set()

    @contextlib.contextmanager
    def announce(self, set_id: int, family: str, imgs: np.ndarray, eager: bool):
        """Around one cache call of set ``set_id``: on the leader, under the
        lock, the ``RUN`` header and the images go to every follower first;
        on a follower (already inside its ``RUN``) nothing."""
        if not self.is_leader:
            yield
            return
        x = torch.from_numpy(np.array(imgs, dtype=np.float32))
        with self._call():
            self._header(RUN, set_id, FAMILIES.index(family), x.shape[0], int(eager),
                         *x.shape[1:])
            dist.broadcast(x, 0, group=self._control)
            self.calls += 1
            yield

    def load(self, step: int) -> int:
        """Announce a new set of ``step`` (each follower restores and warms
        it before its next header); returns the set's id."""
        with self._call():
            set_id = self._next_id
            self._next_id += 1
            self._header(LOAD, set_id, step)
            with self._released_lock:
                self._live.add(set_id)
            return set_id

    def confirm(self, set_id: int) -> None:
        """Every rank holds set ``set_id`` (the leader has built its own);
        raises, and drops the set, when a follower could not load it."""
        with self._call():
            self._header(ACK, set_id)
            ok = self._agree(True)
        if not ok:
            self.release(set_id)
            raise RuntimeError(f"a follower rank could not load set {set_id}")

    def release(self, set_id: int) -> None:
        """The leader freed set ``set_id``: its followers drop it at the next
        call.  Safe from a finalizer on any thread (it takes no dispatch
        lock)."""
        with self._released_lock:
            if set_id in self._live:
                self._live.discard(set_id)
                self._released.append(set_id)

    def _flush_released(self) -> None:
        with self._released_lock:
            ids, self._released = self._released, []
        for set_id in ids:
            self._header(DROP, set_id)

    def start_heartbeat(self) -> None:
        if not self.is_leader or self._beat is not None:
            return
        self._beat = threading.Thread(target=self._beat_loop, name="glom-torch-mesh-heartbeat",
                                      daemon=True)
        self._beat.start()

    def _beat_loop(self) -> None:
        interval = self.timeout_s / 4
        while not self._beat_stop.wait(interval / 4):
            if time.monotonic() - self._last < interval:
                continue
            try:
                with self._call():
                    self._header(PING)
                    self._agree(True)
            except Exception:  # recorded by _call as the mesh's failure
                return

    def stop(self) -> None:
        """End the followers' loops (the leader's drain).  Idempotent; a
        failed mesh sends nothing."""
        self._beat_stop.set()
        with self._lock:
            if self.failed is None and not self.stopped:
                try:
                    self._flush_released()
                    self._header(STOP)
                except Exception as e:  # a follower already gone
                    self._fail(e)
            self.stopped = True
        if self._beat is not None:
            self._beat.join(timeout=5.0)

    def status(self) -> dict:
        return {"rank": self.mesh.rank, "world": self.mesh.world_size, "calls": self.calls,
                "failed": self.failed, "stopped": self.stopped,
                "timeout_s": self.timeout_s}

    # -- a follower ----------------------------------------------------------
    def follow(self, engine) -> int:
        """A follower's loop: each header's work on this rank, until
        ``STOP``; returns the calls run.  ``engine`` answers
        ``follow_run(set_id, family, imgs, eager)``, ``follow_load(set_id,
        step)``, ``follow_drop(set_id)`` and ``follow_has(set_id)``.  An
        error, a lost leader or a header overdue past the group's timeout
        raises out of the loop."""
        if self.is_leader:
            raise RuntimeError("rank 0 leads the mesh; only a follower rank follows")
        h = torch.zeros(_HEADER, dtype=torch.int64)
        while True:
            dist.broadcast(h, 0, group=self._control)
            kind, f = int(h[0]), [int(v) for v in h[1:]]
            if kind == RUN:
                x = torch.empty((f[2],) + tuple(f[4:7]), dtype=torch.float32)
                dist.broadcast(x, 0, group=self._control)
                engine.follow_run(f[0], FAMILIES[f[1]], x.numpy(), bool(f[3]))
                self.calls += 1
            elif kind == LOAD:
                engine.follow_load(f[0], f[1])
            elif kind == ACK:
                self._agree(engine.follow_has(f[0]))
            elif kind == DROP:
                engine.follow_drop(f[0])
            elif kind == PING:
                self._agree(True)
            elif kind == STOP:
                self.stopped = True
                return self.calls
            else:
                raise MeshFailed(f"unknown header kind {kind}")


@dataclasses.dataclass(frozen=True)
class SetShard:
    """What one set's graph caches need on a mesh: the dispatch and the set's
    id (which every ``RUN`` header names)."""

    dispatch: MeshDispatch
    set_id: int

    def local_rows(self, bucket: int) -> int:
        return self.dispatch.local_rows(bucket)

    def rows(self, bucket: int) -> slice:
        return self.dispatch.rows(bucket)

    def gather(self, host: np.ndarray) -> np.ndarray:
        return self.dispatch.gather(host)

    def announce(self, family: str, imgs: np.ndarray, eager: bool):
        return self.dispatch.announce(self.set_id, family, imgs, eager)
