"""Several GPUs: the data axis (an ensemble split over cards, one
process) and the node axis of the general engine and of the fast path
(SPMD ranks on ``torch.distributed``), the port of
``hpa2_tpu/parallel/``."""

from hpa2_tpu_torch.parallel.sharding import (
    DataMesh,
    DataShardedCudaEngine,
    DataShardedLaneSession,
    GridEngine,
    Mesh,
    NodeShardedCudaEngine,
    NodeShardedEngine,
    NodeShardedLaneSession,
    build_node_sharded_run,
    make_data_mesh,
    make_mesh,
    state_specs,
)

__all__ = [
    "DataMesh",
    "DataShardedCudaEngine",
    "DataShardedLaneSession",
    "GridEngine",
    "Mesh",
    "NodeShardedCudaEngine",
    "NodeShardedEngine",
    "NodeShardedLaneSession",
    "build_node_sharded_run",
    "make_data_mesh",
    "make_mesh",
    "state_specs",
]
