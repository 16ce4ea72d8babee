"""The row-sharded distributed lookup table, re-exported from
paddle_tpu_torch.sharding.embedding (the counterpart of
paddle_tpu/parallel/sharded_embedding.py's compatibility shim)."""

from __future__ import annotations

from ..sharding.embedding import (  # noqa: F401
    ShardedEmbedding, _local_lookup, shard_table_rows, sharded_lookup)
