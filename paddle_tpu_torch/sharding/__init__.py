"""paddle_tpu_torch.sharding — the named-mesh SPMD sharding pass over the
Program IR (counterpart of paddle_tpu/sharding/):

  * mesh      — named meshes of a ``torch.distributed`` world's ranks
    (``data``/``fsdp``/``tp`` training axes + the legacy ``dp``/``pp``/
    ``sp``/``ep``/``mp`` family);
  * rules     — ordered regex partition rules mapping names to specs,
    and the canonical :class:`SpecLayout` placements;
  * plan      — :func:`shard_program`, the rewrite pass (annotations,
    constraint ops, the ZeRO resolution of optimizer state, the
    compile-cache stamp), and the :class:`ShardingPlan` the executor
    runs through;
  * embedding — the row-sharded distributed lookup table;
  * comm, spmd — the port's own: the collectives, and the sharded run
    of a program on each rank.

Entry points: ``parallel.init_distributed()`` on every rank, then
``mesh = sharding.training_mesh(data=2, fsdp=2, tp=1)``;
``sharding.shard_program(program, mesh)`` before ``minimize``; then run
through the ordinary :class:`paddle_tpu_torch.Executor`. A 1-device
mesh is byte-identical to not calling the pass at all.
"""

from .mesh import (AXIS_ORDER, DATA_AXIS, DeviceMesh, FSDP_AXIS, TP_AXIS,
                   current_mesh, data_parallel_mesh, local_batch_slice,
                   make_mesh, mesh_scope, sharding_for, training_mesh)
from .rules import (Rule, SpecLayout, clean_spec, default_rules,
                    match_partition_rules, resolve_sharding, rules_digest,
                    shard_count)
from .plan import ShardingPlan, shard_program, strip_sharding
from .embedding import ShardedEmbedding, shard_table_rows, sharded_lookup

__all__ = [
    "AXIS_ORDER", "DATA_AXIS", "FSDP_AXIS", "TP_AXIS",
    "DeviceMesh", "Rule", "ShardedEmbedding", "ShardingPlan",
    "SpecLayout", "clean_spec", "current_mesh", "data_parallel_mesh",
    "default_rules", "local_batch_slice", "make_mesh",
    "match_partition_rules", "mesh_scope", "resolve_sharding",
    "rules_digest", "shard_count", "shard_program", "shard_table_rows",
    "sharded_lookup", "sharding_for", "strip_sharding", "training_mesh",
]
