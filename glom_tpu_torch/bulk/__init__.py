"""Bulk inference tier: the offline job store + exactly-once cursor
(``glom_tpu/bulk/``).

A bulk job is (model, version, dataset, transform, sink) with progress
tracked as a checkpointed global-slot cursor.  Execution is the scavenger
class in :mod:`glom_tpu_torch.serving.bulk`; this package is the durable
half, stdlib and numpy only.
"""

from glom_tpu_torch.bulk.jobs import (  # noqa: F401
    BulkJobSpec,
    ChunkSink,
    JobStore,
    SlotDataset,
    partition_range,
)

__all__ = ["BulkJobSpec", "ChunkSink", "JobStore", "SlotDataset",
           "partition_range"]
