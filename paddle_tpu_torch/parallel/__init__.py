"""Parallel execution: the port's multi-GPU machinery (counterpart of
paddle_tpu/parallel/).

Reference components replaced here (see SURVEY.md §2.4):
  * ParallelExecutor + SSA graph + NCCL op-handles
    (paddle/fluid/framework/parallel_executor.cc:57) →
    :class:`ParallelExecutor` — every rank of a ``torch.distributed``
    world runs the program on its block of the batch; gradients are
    averaged (AllReduce) or reduce-scattered to ZeRO slices (Reduce).
  * BuildStrategy/ExecutionStrategy → :class:`BuildStrategy`,
    :class:`ExecutionStrategy`.
  * DistributeTranspiler + the pserver tier → :class:`DistributeTranspiler`
    producing sharding plans.
  * gen_nccl_id multi-node bootstrap → :func:`init_distributed`.

  * the model-parallel axes: ``pipeline.gpipe`` (the pipeline over
    ``pp``), :func:`ring_attention` (``ring_attention.py``,
    sequence parallelism over ``sp``), :func:`sharded_lookup` (the
    distributed lookup table over ``ep``).

The mesh/sharding layer lives in ``paddle_tpu_torch.sharding``; the
names re-exported here keep working.
"""

from .mesh import (DeviceMesh, make_mesh, data_parallel_mesh, current_mesh,
                   mesh_scope, sharding_for, local_batch_slice)
from .strategy import BuildStrategy, ExecutionStrategy, ReduceStrategy
from .parallel_executor import ParallelExecutor
from .transpiler import (DistributeTranspiler, DistributeTranspilerConfig,
                         ShardingPlan)
from .env import (DistributedInitError, init_distributed,
                  num_trainers, trainer_id)
from .sharded_embedding import (ShardedEmbedding, sharded_lookup,
                                shard_table_rows)
from .ring_attention import ring_attention

__all__ = [
    "DeviceMesh", "make_mesh", "data_parallel_mesh", "current_mesh",
    "mesh_scope", "sharding_for", "local_batch_slice",
    "BuildStrategy", "ExecutionStrategy", "ReduceStrategy",
    "ParallelExecutor",
    "DistributeTranspiler", "DistributeTranspilerConfig", "ShardingPlan",
    "DistributedInitError",
    "init_distributed", "trainer_id", "num_trainers",
    "ring_attention", "ShardedEmbedding", "sharded_lookup",
    "shard_table_rows",
]
