"""Parallelism over ``torch.distributed`` ranks (``glom_tpu/parallel/``).

``glom_tpu`` runs one process per host, which drives its devices through
``shard_map``; PyTorch's idiom is one process per device.  So the port's
mesh is a grid of ranks, each owning one device, with a process subgroup
per mesh axis:

  * ``mesh.py`` -- :func:`make_mesh` over an initialized process group and
    :func:`initialize_distributed` (the JAX CLI's coordinator flags);
  * ``comm.py`` -- the collectives the mesh path differentiates through,
    and the host staging of those gloo does not take on CUDA tensors;
  * ``sharding.py`` -- the spec tables (each spec a tuple of axis names per
    dimension, as ``glom_tpu``'s ``PartitionSpec``);
  * ``placement.py`` -- a rank's slice of a tree by its specs, and
    :func:`~glom_tpu_torch.parallel.placement.gather_to_host`;
  * ``ring.py`` / ``ulysses.py`` -- the sequence-parallel consensus;
  * ``ff_shard.py`` / ``fused_shard.py`` -- the grouped FF and the fused
    level update per shard, on the port's kernels;
  * ``step.py`` -- a rank's part of the train step and the eval: its rows
    and columns of the global batch, the gradient reductions and the global
    norm;
  * ``pipeline.py`` -- GPipe pipeline parallelism over the weight-tied
    iteration loop: stages own iteration chunks, the state flows from rank
    to rank, and the reverse schedule is the pipeline's own autograd node;
  * ``inference.py`` -- the data-parallel forward and ``pad_batch``, the one
    batch-padding rule.
"""

from glom_tpu_torch.parallel.mesh import Mesh, initialize_distributed, make_mesh
from glom_tpu_torch.parallel.pipeline import make_pipelined_apply
from glom_tpu_torch.parallel.sharding import batch_pspec, param_pspecs, state_pspec

__all__ = ["Mesh", "make_mesh", "initialize_distributed", "make_pipelined_apply",
           "param_pspecs", "batch_pspec", "state_pspec"]
