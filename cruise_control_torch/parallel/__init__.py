"""The partition-axis mesh (the JAX package's parallel/): the mesh and the
placement of the static context and the aggregates on it
(parallel/sharding.py), the explicit SPMD kernels that run on it
(parallel/spmd.py), and the host-side shape helpers of the partition and
broker axes."""

from cruise_control_torch.parallel.sharding import (
    PARTITION_AXIS,
    make_mesh,
    pad_partitions,
    place_aggregates,
    place_static,
    shard_model,
)

__all__ = [
    "PARTITION_AXIS",
    "make_mesh",
    "pad_partitions",
    "place_aggregates",
    "place_static",
    "shard_model",
]
