"""Slot-based paged KV-cache management — the host-side half of the
decode subsystem (counterpart of paddle_tpu/decoding/cache.py).

The device holds fixed ``[num_blocks, block_size, heads, head_dim]``
pools per attention layer (rewrite.py); this module owns WHICH pool
blocks belong to WHICH live sequence: a LIFO free-list allocator,
worst-case admission (a sequence reserves
``ceil((prompt + max_new) / block_size)`` blocks up front, so a growing
generation can never deadlock the pool mid-stream) and the padded
per-sequence block-table rows the programs consume (width
``max_blocks_per_seq`` always, ``-1`` for unassigned slots).

Not ported yet: prefix caching (content-hash block sharing), int8 pools,
span export/import for migration, and the fault hooks.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.enforce import enforce


class CacheConfig:
    """Geometry of the paged KV cache.

    num_blocks: pool blocks per layer (total KV memory / block).
    block_size: tokens per block.
    max_blocks_per_seq: block-table width — the max context per
        sequence is ``block_size * max_blocks_per_seq``.
    kv_dtype / prefix_cache: accepted only at their defaults (None,
        False); int8 pools and prefix caching are not ported yet.
    """

    def __init__(self, num_blocks: int = 64, block_size: int = 16,
                 max_blocks_per_seq: int = 8,
                 kv_dtype: Optional[str] = None,
                 prefix_cache: bool = False):
        if kv_dtype is not None:
            raise NotImplementedError(
                "CacheConfig(kv_dtype=%r): int8 KV pools are not ported "
                "yet" % (kv_dtype,))
        if prefix_cache:
            raise NotImplementedError(
                "CacheConfig(prefix_cache=True): prefix caching is not "
                "ported yet")
        enforce(num_blocks >= 1 and block_size >= 1
                and max_blocks_per_seq >= 1,
                "CacheConfig extents must be >= 1")
        enforce(max_blocks_per_seq <= num_blocks,
                "max_blocks_per_seq cannot exceed num_blocks")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.max_blocks_per_seq = int(max_blocks_per_seq)

    @property
    def max_context(self) -> int:
        return self.block_size * self.max_blocks_per_seq

    def blocks_for(self, tokens: int) -> int:
        """Blocks covering ``tokens`` positions."""
        return -(-int(tokens) // self.block_size)

    def empty_table_row(self) -> np.ndarray:
        """A padding block-table row (all -1 = unassigned)."""
        return np.full((self.max_blocks_per_seq,), -1, np.int32)

    def __repr__(self):
        return (f"CacheConfig(num_blocks={self.num_blocks}, "
                f"block_size={self.block_size}, "
                f"max_blocks_per_seq={self.max_blocks_per_seq})")


class KVCacheManager:
    """Free-list block allocator + per-sequence block tables.

    Host-side only (numpy). Single-threaded by design: the continuous
    batcher's worker is the only caller."""

    def __init__(self, config: CacheConfig):
        self.config = config
        # LIFO free list: recently-freed blocks are reused first
        self._free: List[int] = list(range(config.num_blocks - 1, -1, -1))
        self._tables: Dict[int, List[int]] = {}  # seq id -> blocks
        self._next_id = 0

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.config.num_blocks - len(self._free)

    @property
    def live_sequences(self) -> int:
        return len(self._tables)

    def can_admit(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Worst-case admission check: would the full generation fit?"""
        total = int(prompt_len) + int(max_new_tokens)
        if total > self.config.max_context:
            return False  # never admittable at this geometry
        return self.config.blocks_for(total) <= len(self._free)

    def admit(self, prompt_len: int,
              max_new_tokens: int) -> Optional[int]:
        """Reserve the worst-case block span for one sequence; returns
        its cache id, or None when the pool cannot hold it right now.
        Raises (via enforce) when the request can NEVER fit — callers
        must reject those instead of queueing them forever."""
        total = int(prompt_len) + int(max_new_tokens)
        enforce(prompt_len >= 1, "empty prompt")
        enforce(total <= self.config.max_context,
                "request needs %d positions but max_context is %d "
                "(block_size %d x max_blocks_per_seq %d) — raise the "
                "cache geometry or cap max_new_tokens"
                % (total, self.config.max_context, self.config.block_size,
                   self.config.max_blocks_per_seq))
        n = self.config.blocks_for(total)
        if n > len(self._free):
            return None
        sid = self._next_id
        self._next_id += 1
        self._tables[sid] = [self._free.pop() for _ in range(n)]
        return sid

    def release(self, sid: int) -> None:
        """Return a retired sequence's blocks to the free list."""
        for b in reversed(self._tables.pop(sid, ())):
            self._free.append(b)

    def table_row(self, sid: int) -> np.ndarray:
        """The padded ``[max_blocks_per_seq]`` int32 table row for one
        sequence (-1 = unassigned; the programs drop/mask those)."""
        row = self.config.empty_table_row()
        blocks = self._tables[sid]
        row[:len(blocks)] = blocks
        return row

    def empty_row(self) -> np.ndarray:
        """A padding row (all -1): batch rows with no live sequence."""
        return self.config.empty_table_row()
