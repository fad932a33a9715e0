"""The grouped FF per mesh shard (``glom_tpu/parallel/ff_shard.py``).

``glom_tpu`` runs its Pallas FF inside ``shard_map`` so that each device
computes on its own shard; here each rank already holds only its shard, and
the function runs the port's kernels on it (``kernels/ff.py``: K1 forward;
with ``fused_bwd`` K2 and K3 in its backward, at the shard's shapes) with
the one collective the math needs.  Per ``param_sharding`` (the specs of
``parallel/sharding.py``):

  * **replicated** (pure DP) -- the kernel on the rank's (data, seq) shard,
    no collective;
  * **tp** -- W1 by columns and W2 by rows over ``model``: each rank's
    partial product with ``b2 = 0``, one all-reduce over the model group,
    then ``b2`` added once.  The input's gradient is summed over the group
    (:func:`~glom_tpu_torch.parallel.comm.copy_to`) and the all-reduce's is
    passed through (:func:`~glom_tpu_torch.parallel.comm.reduce_from`): the
    cotangent downstream is replicated, and summing it would count it once
    per rank;
  * **ep** -- whole level groups on the expert axis :func:`pick_expert_axis`
    picks for the net's group count; each rank runs its groups, and the
    activations leave all-gathered, never split over an expert axis.  A net
    no axis divides keeps its replicated params and runs as under DP.

``make_sharded_ff`` takes any per-shard FF (the plain op under
``ff_impl="dense"``, where ``glom_tpu`` leaves the partitioning to GSPMD);
:func:`make_sharded_ff_pallas` is it on the kernels.
"""

from __future__ import annotations

import functools

import torch

from glom_tpu_torch.kernels.ff import grouped_ff
from glom_tpu_torch.ops.feedforward import grouped_ff_apply
from glom_tpu_torch.parallel.comm import copy_to, gather_from, reduce_from
from glom_tpu_torch.parallel.mesh import Mesh
from glom_tpu_torch.parallel.sharding import pick_expert_axis


def make_sharded_ff(mesh: Mesh, *, param_sharding: str = "replicated", model_axis: str = "model",
                    extra_expert_axes: tuple = (), ff=grouped_ff_apply):
    """``ff_fn(params, x)`` over this rank's shard of ``params`` (as
    :func:`~glom_tpu_torch.parallel.placement.shard_tree` cut it) and its
    ``(b/D, n/S, g, d)`` activations; ``ff`` computes one shard."""
    if param_sharding == "tp":
        model = mesh.axis(model_axis)

        def tp_fn(params, x):
            local = dict(params, b2=torch.zeros_like(params["b2"]))
            part = ff(local, copy_to(x, model))
            return reduce_from(part, model) + params["b2"]   # b2 added once

        return tp_fn

    if param_sharding == "ep":
        candidates = [(model_axis, mesh.size(model_axis))] + [
            (a, mesh.size(a)) for a in extra_expert_axes]

        def ep_fn(params, x):
            groups = x.shape[-2]
            axis = pick_expert_axis(groups, candidates)
            if axis is None:
                # no axis divides this net's groups: its params are replicated
                return ff(params, x)
            ag = mesh.axis(axis)
            per = groups // ag.size
            mine = copy_to(x, ag)[..., ag.index * per:(ag.index + 1) * per, :]
            return gather_from(ff(params, mine), ag, dim=-2)

        return ep_fn

    if param_sharding != "replicated":
        raise ValueError(f"unknown param_sharding {param_sharding!r}; 'tp', 'ep' or 'replicated'")
    return ff


def make_sharded_ff_pallas(mesh: Mesh, *, param_sharding: str = "replicated",
                           model_axis: str = "model", fused_bwd: bool = False,
                           extra_expert_axes: tuple = ()):
    """:func:`make_sharded_ff` on the grouped-FF kernels (K1; K2 and K3 in the
    backward with ``fused_bwd``), as ``glom_tpu``'s runs its Pallas kernel."""
    return make_sharded_ff(mesh, param_sharding=param_sharding, model_axis=model_axis,
                           extra_expert_axes=extra_expert_axes,
                           ff=functools.partial(grouped_ff, fused_bwd=fused_bwd))
