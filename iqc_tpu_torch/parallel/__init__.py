"""Multi-device runs on ``torch.distributed``: one process per rank, the
mesh, sharding and the collectives of the sharded paths
(``parallel/mesh.py``)."""

from iqc_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshSpec,
    all_gather_rows,
    all_reduce_sum,
    create_mesh,
    cross_replica_mean,
    data_parallel_sharding,
    distributed_init,
    replicate,
    shard_batch,
)
