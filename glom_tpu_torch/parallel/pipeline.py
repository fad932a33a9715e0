"""GPipe pipeline parallelism over the GLOM iteration loop (``glom_tpu/parallel/pipeline.py``).

GLOM's depth is its weight-tied iteration loop, so a stage owns a contiguous
chunk of ``k = iters / S`` iterations, not a chunk of weights: every rank
holds the whole parameter tree, and only the ``(mb, n, L, d)`` level state
flows from stage to stage.  The schedule is plain GPipe, as ``glom_tpu``'s:
microbatch ``m`` enters stage 0 at step ``m``, stage ``s`` runs microbatch
``t - s`` at step ``t`` of ``T = M + S - 1``, and the bubble is
``(S - 1) / (M + S - 1)`` of the steps.

``glom_tpu`` writes the schedule as one ``shard_map`` + ``lax.scan`` and
lets ``jax.grad`` transpose it.  Eager PyTorch has no static schedule and
its collectives have no autograd, so here:

  * the forward is a Python loop over the steps on every rank of the pipe
    axis.  A stage computes on its active steps only, through the same
    ``make_step_builder`` the sequential forward uses (``fuse_ff`` and
    ``remat`` hold per stage), and its state reaches stage ``s + 1`` by
    :func:`~glom_tpu_torch.parallel.comm.raw_send_recv` at the next step.
    A link carries a microbatch or is skipped by both of its ranks, so
    every send meets its receive and the ranks stay in lockstep;
  * the backward is :class:`_Pipeline`, an ``autograd.Function`` whose
    forward runs the schedule and keeps each (stage, microbatch) chunk's
    graph, and whose backward runs the schedule in reverse with explicit
    sends of the cotangents.  Leaving the sends to ``loss.backward()``
    would hang: a rank whose loss does not depend on what it sent (stage 0,
    which owns no output) never runs that send's backward, and its peer
    blocks in the receive.

Every rank returns the whole tensor a ``glom_tpu`` caller gets, so the train
step on top (``training/denoise.py::make_step_fn(..., apply_fn=)``) is the
one-process step on every rank, on the whole batch.

The fused level update (K8) never runs in a stage: ``glom_tpu`` builds its
stage step without ``fused_fn`` (its ``pipeline.py:203``), so under
``ff_impl="fused"`` a stage runs the grouped-FF kernel (K1; K2 and K3 in the
backward with ``ff_fused_bwd``) beside the config's consensus.
"""

from __future__ import annotations

from typing import Optional

import torch

from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.models import glom as glom_model
from glom_tpu_torch.parallel.comm import (raw_all_gather, raw_all_reduce, raw_broadcast,
                                          raw_send_recv)
from glom_tpu_torch.parallel.ff_shard import make_sharded_ff
from glom_tpu_torch.parallel.mesh import Mesh
from glom_tpu_torch.parallel.ring import make_ring_consensus

NETS = ("bottom_up", "top_down")
FF_KEYS = ("w1", "b1", "w2", "b2")
# the dimension of each FF leaf split over the model axis: the hidden (b2 is whole)
TP_DIMS = {"w1": 2, "b1": 1, "w2": 1}


class _Schedule:
    """One call's schedule as this rank runs it: ``S`` stages, ``M``
    microbatches of ``mb`` rows, ``k`` iterations a chunk; this rank's
    stage, rows (data axis) and columns (seq axis); the capture's stage and
    offset; the outputs the call returns."""

    def __init__(self, mesh: Mesh, axes: dict, config: GlomConfig, consensus_fn, ff_fn, *,
                 M: int, b: int, iters: int, capture: Optional[int], want_traj: bool):
        self.c = config
        self.pipe, self.data, self.seq, self.model = (
            mesh.axis(axes[a]) if axes[a] else None for a in ("pipe", "data", "seq", "model"))
        self.consensus_fn, self.ff_fn = consensus_fn, ff_fn
        self.S, self.M, self.b, self.iters = self.pipe.size, M, b, iters
        self.k, self.mb, self.T = iters // self.S, b // M, M + self.S - 1
        self.s = self.pipe.index
        self.n = config.num_patches
        per = self.mb // (self.data.size if self.data else 1)
        i = self.data.index if self.data else 0
        self.rows = slice(i * per, (i + 1) * per)
        width = self.n // (self.seq.size if self.seq else 1)
        j = self.seq.index if self.seq else 0
        self.cols = slice(j * width, (j + 1) * width)
        self.local = (per, width, config.levels, config.dim)
        # capture point: stage cap_stage's iteration cap_off (1-based in its
        # chunk) is the state after `capture` iterations (t=0: no stage)
        self.cap_stage = (capture - 1) // self.k if capture else None
        self.cap_off = capture - self.cap_stage * self.k if capture else None
        self.want_traj = want_traj

    def active(self, m: int) -> bool:
        return 0 <= m < self.M

    def kept(self, stage: int) -> set:
        """The states of a chunk of ``stage`` that reach an output (0-based
        iteration indices)."""
        if self.want_traj:
            return set(range(self.k))
        keep = {self.k - 1}
        if stage == self.cap_stage:
            keep.add(self.cap_off - 1)
        return keep

    def _tp_slice(self, key: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of an FF leaf along the model axis, contiguous
        (the kernels take contiguous weights); its gradient is the slice's,
        zero elsewhere."""
        if key not in TP_DIMS or self.model is None or self.model.size == 1:
            return x
        dim = TP_DIMS[key]
        width = x.shape[dim] // self.model.size
        return x.narrow(dim, self.model.index * width, width).contiguous()

    def _whole(self, local: torch.Tensor, row_dim: int) -> torch.Tensor:
        """``local`` gathered over seq (the dimension after ``row_dim``) and
        data (``row_dim``) from the ranks of this stage."""
        x = raw_all_gather(local, self.seq, row_dim + 1)
        return raw_all_gather(x, self.data, row_dim)

    def _replicate(self, parts: dict, owner: int, like: torch.Tensor) -> torch.Tensor:
        """The owner stage's ``(b, n, L, d)`` output on every rank: gathered
        over data and seq on the owner's ranks, then broadcast over pipe
        (``glom_tpu``'s masked ``psum``)."""
        c = self.c
        shape = (self.b, self.n, c.levels, c.dim)
        if self.s == owner:
            whole = self._whole(torch.stack([parts[m] for m in range(self.M)]), 1)
            whole = whole.reshape(shape).contiguous()
        else:
            whole = torch.empty(shape, dtype=like.dtype, device=like.device)
        return raw_broadcast(whole, self.pipe, owner)

    def run(self, inputs, record: bool):
        """The forward schedule.  ``inputs``: the tokens ``(b, n, d)``,
        ``pos_emb``, ``init_levels`` and the two nets' leaves (``NETS`` x
        ``FF_KEYS``).  Returns the outputs (whole, on every rank) and, when
        ``record``, the live leaves and each chunk's graph for
        :meth:`backward`."""
        c, S, k, s = self.c, self.S, self.k, self.s
        if record:
            inputs = [x.detach().requires_grad_() for x in inputs]
        tokens, pos_emb, init_levels, *leaves = inputs
        dev, dt = tokens.device, tokens.dtype
        nets = {net: {key: self._tp_slice(key, leaves[4 * i + j]) for j, key in enumerate(FF_KEYS)}
                for i, net in enumerate(NETS)}
        pos = pos_emb[self.cols][None, :, None, :]
        build = glom_model.make_step_builder(nets, c, pos, glom_model.update_divisors(c, dt, dev),
                                             self.consensus_fn, self.ff_fn)
        toks = tokens.view(self.M, self.mb, self.n, c.dim)
        init = init_levels.to(dt)[None, None].expand(self.local)
        keep = self.kept(s)
        cur, chunks, finals, caps, trajs = None, {}, {}, {}, {}
        for t in range(self.T):
            m = t - s
            # the link from stage s to s + 1 carries what s finished at t - 1
            recv = raw_send_recv(cur, self.pipe,
                                 send_to=s + 1 if s < S - 1 and self.active(m - 1) else None,
                                 recv_from=s - 1 if s > 0 and self.active(m) else None,
                                 like=init)
            if not self.active(m):
                continue
            inp = init.contiguous() if s == 0 else recv.requires_grad_(record)
            step = build(toks[m, self.rows, self.cols][:, :, None, :])
            states, x = {}, inp
            for j in range(k):
                x = step(x)
                if j in keep:
                    states[j] = x
            cur = x.detach()
            if s == S - 1:
                finals[m] = cur
            if s == self.cap_stage:
                caps[m] = states[self.cap_off - 1].detach()
            if self.want_traj:
                trajs[m] = torch.stack([states[j].detach() for j in range(k)])
            if record:
                chunks[m] = (inp, states)
        if self.want_traj:
            whole = self._whole(torch.stack([trajs[m] for m in range(self.M)]), 2)
            whole = raw_all_gather(whole[None], self.pipe, 0)    # (S, M, k, mb, n, L, d)
            outs = [whole.transpose(1, 2).reshape(self.iters, self.b, self.n, c.levels, c.dim)]
        else:
            outs = [self._replicate(finals, S - 1, init)]
            if self.cap_stage is not None:
                outs.append(self._replicate(caps, self.cap_stage, init))
        return outs, (inputs if record else None), chunks

    def backward(self, live: list, chunks: dict, grads: tuple) -> list:
        """The reverse schedule; returns each input's gradient."""
        c, S, M, k, s = self.c, self.S, self.M, self.k, self.s
        g_traj = grads[0] if self.want_traj else None
        g_final = None if self.want_traj else grads[0]
        g_cap = grads[1] if self.cap_stage is not None else None
        full = (M, self.mb, self.n, c.levels, c.dim)

        def needs(stage: int) -> bool:
            """Whether a chunk of ``stage`` gets a cotangent (the same answer on
            every rank: the cotangents' presence is replicated)."""
            return (g_final is not None or g_traj is not None
                    or (g_cap is not None and stage <= self.cap_stage))

        like = live[2].detach()[None, None].expand(self.local)
        g_in = None
        for t in reversed(range(self.T)):
            m = t - s
            # the link from stage s to s - 1 carries the input cotangent s
            # found at t + 1
            recv = raw_send_recv(
                g_in, self.pipe,
                send_to=s - 1 if s > 0 and needs(s) and self.active(m + 1) else None,
                recv_from=s + 1 if s < S - 1 and needs(s + 1) and self.active(m) else None,
                like=like)
            if not (self.active(m) and needs(s)):
                continue
            inp, states = chunks.pop(m)
            cots = {}

            def add(j, g):
                cots[j] = g if j not in cots else cots[j] + g

            if recv is not None:
                add(k - 1, recv)
            if g_final is not None and s == S - 1:
                add(k - 1, g_final.view(full)[m, self.rows, self.cols])
            if g_cap is not None and s == self.cap_stage:
                add(self.cap_off - 1, g_cap.view(full)[m, self.rows, self.cols])
            if g_traj is not None:
                traj = g_traj.view(S, k, *full)
                for j in range(k):
                    add(j, traj[s, j, m, self.rows, self.cols])
            order = sorted(cots)
            # the chunks share the nets' slices and the step builder's
            # tensors, so each chunk's backward keeps the graph it shares
            torch.autograd.backward([states[j] for j in order],
                                    [cots[j].to(states[j].dtype) for j in order],
                                    retain_graph=True)
            g_in = inp.grad if s > 0 else None
            del inp, states
        return self.reduce(live)

    def reduce(self, live: list) -> list:
        """Each leaf's gradient summed over the ranks that hold parts of it.

        A stage adds only its own iterations' terms, a data rank only its
        rows' and a seq rank only its columns' (the tokens' and ``pos_emb``'s
        only at those rows and columns), so every leaf is summed over pipe,
        data and seq.  The ranks along model run the same stage on the same
        rows: the FF's collectives (``parallel/ff_shard.py``'s tp path) give
        each of them the whole gradient of every replicated leaf, so those
        are not summed over model, while each rank's gradient of a split
        leaf (``TP_DIMS``) is zero outside its slice, and those are.  The
        caller's loss is read from the replicated outputs the same way on
        every rank, so these sums are the gradients of that one loss; the
        decoder after the outputs is differentiated on every rank alike and
        sums over nothing."""
        grads = [x.grad if x.grad is not None else torch.zeros_like(x) for x in live]
        acc = torch.promote_types(grads[0].dtype, torch.float32)

        def summed(idx: list, axes) -> None:
            flat = torch.cat([grads[i].reshape(-1).to(acc) for i in idx])
            for axis in axes:
                flat = raw_all_reduce(flat, axis)
            at = 0
            for i in idx:
                n = grads[i].numel()
                grads[i] = flat[at:at + n].reshape(grads[i].shape).to(grads[i].dtype)
                at += n

        summed(list(range(len(grads))), (self.pipe, self.data, self.seq))
        if self.model is not None and self.model.size > 1:
            summed([3 + 4 * i + j for i in range(len(NETS)) for j, key in enumerate(FF_KEYS)
                    if key in TP_DIMS], (self.model,))
        return grads


class _Pipeline(torch.autograd.Function):
    """The pipelined forward as one autograd node: its forward runs the
    schedule keeping each chunk's graph, its backward the reverse schedule
    (:meth:`_Schedule.backward`) and the sums of :meth:`_Schedule.reduce`.
    Every rank must run the backward, reading the outputs the same way."""

    @staticmethod
    def forward(ctx, schedule, *inputs):
        ctx.set_materialize_grads(False)
        with torch.enable_grad():
            outs, ctx.live, ctx.chunks = schedule.run(inputs, record=True)
        ctx.schedule = schedule
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        live, chunks = ctx.live, ctx.chunks
        ctx.live = ctx.chunks = None
        return (None, *ctx.schedule.backward(live, chunks, grads))


def make_pipelined_apply(
    mesh: Mesh,
    config: GlomConfig,
    *,
    pipe_axis: str = "pipe",
    data_axis: Optional[str] = None,
    model_axis: Optional[str] = None,
    seq_axis: Optional[str] = None,
    num_microbatches: Optional[int] = None,
    consensus_fn=None,
    ff_fn=None,
):
    """``apply(params, img, *, iters=None, capture_timestep=None,
    return_all=False)`` running the iteration loop as an S-stage GPipe
    pipeline over ``pipe_axis``, with ``glom_tpu``'s contract: the final
    ``(b, n, L, d)`` state; with ``capture_timestep=t`` (any ``t`` in
    ``[0, iters]``, mid-chunk too) the tuple ``(final,
    state_after_t_iterations)``, the contract
    ``training.denoise.make_loss_fn(apply_fn=...)`` expects; or with
    ``return_all`` the ``(iters+1, b, n, L, d)`` trajectory in time order.
    ``capture_timestep`` takes precedence over ``return_all``.  Every rank
    of the mesh calls it with the whole ``params`` and ``img`` and gets the
    whole result.

    ``data_axis``: each microbatch's rows split over it.  ``model_axis``:
    each stage's grouped FFs tensor-parallel over it (w1 by columns, w2 by
    rows, one all-reduce a call, b2 added once: ``parallel/ff_shard.py``'s
    tp path around ``ff_fn``).  ``seq_axis``: the ``n`` columns split over
    it, and the default consensus the ring over it; an explicit
    ``consensus_fn`` there must be a collective one over ``seq_axis``
    (``parallel/ring.py`` or ``parallel/ulysses.py``'s), since a dense one
    would attend over this rank's ``n/SP`` columns only.

    Refused, with ``glom_tpu``'s messages: ``iters`` off a multiple of S,
    a batch off a multiple of ``num_microbatches`` (default S), a
    microbatch off a multiple of the data size, ``n`` off a multiple of the
    seq size, the FF hidden width off a multiple of the model size, and a
    capture outside ``[0, iters]``."""
    c = config
    S = mesh.shape[pipe_axis]
    D = mesh.shape[data_axis] if data_axis else 1
    SP = mesh.shape[seq_axis] if seq_axis else 1
    TP = mesh.shape[model_axis] if model_axis else 1
    M = num_microbatches or S
    axes = {"pipe": pipe_axis, "data": data_axis, "seq": seq_axis, "model": model_axis}
    if consensus_fn is None and seq_axis is not None:
        consensus_fn = make_ring_consensus(mesh, attend_self=c.consensus_self,
                                           non_local_mask=glom_model.resolve_locality_mask(c),
                                           seq_axis=seq_axis)
    elif consensus_fn is None:
        glom_model.make_consensus_fn(c)      # refuses "ring" / "ulysses" here, as glom_tpu's
    if ff_fn is None:
        # under "fused" this is the grouped-FF kernel: no stage builds fused_fn
        ff_fn = glom_model.make_ff_fn(c)
    if model_axis is not None:
        hidden = c.dim * c.ff_mult
        if hidden % TP != 0:
            raise ValueError(f"FF hidden width {hidden} not divisible by model-axis size {TP}")
        ff_fn = make_sharded_ff(mesh, param_sharding="tp", model_axis=model_axis, ff=ff_fn)
    def apply(params, img, *, iters: Optional[int] = None,
              capture_timestep: Optional[int] = None, return_all: bool = False):
        glom_model.validate_img(img, c)
        if iters is None:
            iters = c.default_iters
        if iters % S != 0:
            raise ValueError(f"iters {iters} not divisible by {S} pipeline stages")
        if capture_timestep is not None and not 0 <= capture_timestep <= iters:
            raise ValueError(f"capture_timestep {capture_timestep} outside [0, {iters}]")
        b = img.shape[0]
        if b % M != 0:
            raise ValueError(f"batch {b} not divisible by {M} microbatches")
        mb = b // M
        if mb % D != 0:
            raise ValueError(
                f"microbatch size {mb} (batch {b} / {M} microbatches) not "
                f"divisible by data-axis size {D}"
            )
        if c.num_patches % SP != 0:
            raise ValueError(
                f"n={c.num_patches} patch columns not divisible by seq-axis size {SP}")
        want_traj = return_all and capture_timestep is None

        params_c, img_c, dt = glom_model.cast_for_compute(params, img, c)
        tokens, _ = glom_model.embed_inputs(params_c, img_c, c)
        # "auto" and the locality mask resolve on the batch's device
        consensus = consensus_fn or glom_model.make_consensus_fn(c, img.device)
        schedule = _Schedule(mesh, axes, c, consensus, ff_fn, M=M, b=b, iters=iters,
                             capture=capture_timestep, want_traj=want_traj)
        inputs = [tokens, params_c["pos_emb"], params_c["init_levels"]] + [
            params_c[net][key] for net in NETS for key in FF_KEYS]
        if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
            outs = _Pipeline.apply(schedule, *inputs)
        else:
            with torch.no_grad():
                outs, _, _ = schedule.run(inputs, record=False)
        if want_traj:
            t0 = glom_model.initial_levels(params_c, b, c, dt)
            return torch.cat([t0[None], outs[0]])
        if capture_timestep is None:
            return outs[0]
        if capture_timestep == 0:
            # t=0 is the initial state: no stage computes it
            return outs[0], glom_model.initial_levels(params_c, b, c, dt)
        return outs[0], outs[1]

    return apply
