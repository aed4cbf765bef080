"""Mesh and collectives on ``torch.distributed``, and the parallelism axes
beyond the reference: sequence (ring attention), pipeline (GPipe), with
expert parallelism in ``ccv_tpu_torch.nn.moe`` and tensor parallelism in
``models.transformer`` (counterpart of ccv_tpu/parallel)."""

from ccv_tpu_torch.parallel.mesh import (
    comm_allreduce,
    comm_broadcast,
    comm_reduce,
    data_parallel_mesh,
    device_count,
    make_mesh,
    shard_batch,
    replicate,
)

__all__ = [
    "comm_allreduce", "comm_broadcast", "comm_reduce", "data_parallel_mesh",
    "device_count", "make_mesh", "shard_batch", "replicate",
]
