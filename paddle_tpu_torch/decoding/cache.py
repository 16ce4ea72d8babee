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

**Prefix caching** (``CacheConfig(prefix_cache=True)``): full prompt
blocks are content-addressed by a CHAIN hash (block i's key digests
every prompt token through block i, so a key identifies the whole
prefix) and refcount-shared across sequences — a system prompt shared
by thousands of requests holds its K/V blocks once, and later
admissions reserve only their un-cached suffix. Only FULL blocks
strictly before the last prompt position are shared, decode appends
land after the prompt and the suffix prefill starts at the first
un-cached position, so no live sequence ever writes into a shared
block. Released blocks stay cached with refcount 0 on an LRU list and
are reclaimed the moment a fresh reservation needs them.

Blocks become shareable only after :meth:`KVCacheManager.commit_prefix`
— called by the batcher AFTER the prefill that wrote them succeeded, so
a failed or aborted prefill never publishes garbage K/V.

Not ported yet: the ``decoding.prefix_commit`` fault guard of the JAX
package (it waits for the port of ``resilience/``); until then a commit
publishes without it.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.enforce import enforce


class CacheConfig:
    """Geometry of the paged KV cache.

    num_blocks: pool blocks per layer (total KV memory / block).
    block_size: tokens per block.
    max_blocks_per_seq: block-table width — the max context per
        sequence is ``block_size * max_blocks_per_seq``.
    kv_dtype: None (default) stores pools in the model's K/V stream
        dtype; ``"int8"`` stores int8 codes with per-slot f32 scales —
        one byte per element instead of four (f32) or two (bf16), plus
        eight bytes per slot of scales. Changes the digest.
    prefix_cache: enable content-hash prefix-block sharing (host-side
        only: the device programs are unchanged, so the digest does not
        depend on it).

    Combining both: under ``kv_dtype="int8"`` a cache-miss prefill
    attends over the exact fresh K/V stream while a cache-hit suffix
    prefill reads the dequantized pool, so hit and miss prefills of the
    same prompt differ within quantization error — deterministic, but
    hit/miss-dependent.
    """

    def __init__(self, num_blocks: int = 64, block_size: int = 16,
                 max_blocks_per_seq: int = 8,
                 kv_dtype: Optional[str] = None,
                 prefix_cache: bool = False):
        enforce(num_blocks >= 1 and block_size >= 1
                and max_blocks_per_seq >= 1,
                "CacheConfig extents must be >= 1")
        enforce(max_blocks_per_seq <= num_blocks,
                "max_blocks_per_seq cannot exceed num_blocks")
        enforce(kv_dtype in (None, "int8"),
                "kv_dtype must be None or 'int8', got %r" % (kv_dtype,))
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.kv_dtype = kv_dtype
        self.prefix_cache = bool(prefix_cache)

    @property
    def max_context(self) -> int:
        return self.block_size * self.max_blocks_per_seq

    def blocks_for(self, tokens: int) -> int:
        """Blocks covering ``tokens`` positions."""
        return -(-int(tokens) // self.block_size)

    def digest(self) -> str:
        """Stable identity of everything that changes the device
        programs (geometry, pool dtype) and nothing that does not
        (prefix_cache); it seeds the prefix chain keys."""
        base = (f"paged{self.num_blocks}x{self.block_size}"
                f"x{self.max_blocks_per_seq}")
        if self.kv_dtype:
            base += f"-{self.kv_dtype}kv"
        return base

    def empty_table_row(self) -> np.ndarray:
        """A padding block-table row (all -1 = unassigned)."""
        return np.full((self.max_blocks_per_seq,), -1, np.int32)

    def __repr__(self):
        extra = ""
        if self.kv_dtype:
            extra += f", kv_dtype={self.kv_dtype!r}"
        if self.prefix_cache:
            extra += ", prefix_cache=True"
        return (f"CacheConfig(num_blocks={self.num_blocks}, "
                f"block_size={self.block_size}, "
                f"max_blocks_per_seq={self.max_blocks_per_seq}{extra})")


class KVCacheManager:
    """Free-list block allocator + per-sequence block tables (+ the
    refcounted content-hash prefix index when the config enables it).

    Host-side only (numpy). Single-threaded by design: the continuous
    batcher's worker is the only caller. ``metrics`` (optional, a
    :class:`~paddle_tpu_torch.serving.metrics.DecodeMetrics`) receives
    the prefix-block eviction counter."""

    def __init__(self, config: CacheConfig, metrics=None):
        self.config = config
        self.metrics = metrics
        # LIFO free list: recently-freed blocks are reused first
        self._free: List[int] = list(range(config.num_blocks - 1, -1, -1))
        self._tables: Dict[int, List[int]] = {}  # seq id -> blocks
        self._next_id = 0
        # prefix-cache state (all empty unless config.prefix_cache)
        self._by_key: Dict[str, int] = {}        # chain key -> block
        self._block_key: Dict[int, str] = {}     # cached block -> key
        self._ref: Dict[int, int] = {}           # cached block -> refs
        self._evictable: "OrderedDict[int, None]" = OrderedDict()
        self._pending: Dict[int, List[Tuple[str, int]]] = {}
        self._seq_shared: Dict[int, List[int]] = {}

    # ------------------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.config.num_blocks - len(self._free)

    @property
    def live_sequences(self) -> int:
        return len(self._tables)

    @property
    def cached_blocks(self) -> int:
        """Blocks currently holding committed shared-prefix content."""
        return len(self._block_key)

    @property
    def evictable_blocks(self) -> int:
        """Cached blocks with no live reference (reclaimable on demand,
        LRU order)."""
        return len(self._evictable)

    @property
    def reclaimable_blocks(self) -> int:
        """Free + evictable: what a new reservation can draw on. With no
        live sequences this equals ``num_blocks`` (no refcount leak)."""
        return len(self._free) + len(self._evictable)

    def can_admit(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Worst-case admission check: would the full generation fit?
        (Ignores prefix sharing — a conservative answer.)"""
        total = int(prompt_len) + int(max_new_tokens)
        if total > self.config.max_context:
            return False  # never admittable at this geometry
        return self.config.blocks_for(total) <= self.reclaimable_blocks

    # ------------------------------------------------------- prefix hash
    def _chain_keys(self, tokens: Sequence[int],
                    n_blocks: int) -> List[str]:
        """Chain hash of the first ``n_blocks`` FULL prompt blocks: key
        i is the sha256 hex digest of the config digest followed by
        tokens[0 : (i+1)*block_size] as little-endian int64 bytes."""
        bs = self.config.block_size
        h = hashlib.sha256(self.config.digest().encode())
        keys = []
        for i in range(n_blocks):
            blk = np.asarray(tokens[i * bs:(i + 1) * bs], "<i8")
            h.update(blk.tobytes())
            keys.append(h.hexdigest())
        return keys

    def _cacheable_blocks(self, prompt_len: int) -> int:
        """How many leading FULL blocks of this prompt are shareable:
        strictly before the last prompt position (the final position is
        always computed fresh, so the next-token logits exist and decode
        writes never land in a shared block)."""
        if not self.config.prefix_cache:
            return 0
        return min((int(prompt_len) - 1) // self.config.block_size,
                   self.config.max_blocks_per_seq)

    def prefix_keys(self, tokens: Sequence[int]) -> List[str]:
        """The prompt's cacheable-span chain keys — a pure function of
        (tokens, config); the batcher computes them once per request and
        passes them back via ``keys=``."""
        return self._chain_keys(tokens,
                                self._cacheable_blocks(len(tokens)))

    def match_prefix(self, tokens: Sequence[int],
                     keys: Optional[List[str]] = None) -> int:
        """Longest committed cached prefix of this prompt, in TOKENS
        (a block multiple, never the whole prompt). Read-only."""
        if keys is None:
            keys = self.prefix_keys(tokens)
        matched = 0
        for key in keys:
            if key not in self._by_key:
                break
            matched += 1
        return matched * self.config.block_size

    def _take_fresh(self) -> int:
        """One un-cached block: free list first, then evict the LRU
        cached block (dropping its index entry)."""
        if self._free:
            return self._free.pop()
        b, _ = self._evictable.popitem(last=False)
        key = self._block_key.pop(b)
        del self._by_key[key]
        self._ref.pop(b, None)
        if self.metrics is not None:
            self.metrics.inc("prefix_blocks_evicted_total")
        return b

    # ------------------------------------------------------- admission
    def _check_fits(self, prompt_len: int, total: int) -> None:
        enforce(prompt_len >= 1, "empty prompt")
        enforce(total <= self.config.max_context,
                "request needs %d positions but max_context is %d "
                "(block_size %d x max_blocks_per_seq %d) — raise the "
                "cache geometry or cap max_new_tokens"
                % (total, self.config.max_context, self.config.block_size,
                   self.config.max_blocks_per_seq))

    def admit(self, prompt_len: int,
              max_new_tokens: int) -> Optional[int]:
        """Reserve the worst-case block span for one sequence; returns
        its cache id, or None when the pool cannot hold it right now.
        Raises (via enforce) when the request can NEVER fit — callers
        must reject those instead of queueing them forever."""
        total = int(prompt_len) + int(max_new_tokens)
        self._check_fits(prompt_len, total)
        n = self.config.blocks_for(total)
        if n > self.reclaimable_blocks:
            return None
        blocks = [self._take_fresh() for _ in range(n)]
        sid = self._next_id
        self._next_id += 1
        self._tables[sid] = blocks
        return sid

    def admit_tokens(self, tokens: Sequence[int], max_new_tokens: int,
                     keys: Optional[List[str]] = None
                     ) -> Optional[Tuple[int, int]]:
        """Prefix-aware admission: reserve the worst case NET of the
        committed shared prefix. Returns ``(sid, cached_tokens)`` —
        ``cached_tokens`` positions already hold valid K/V and only the
        suffix needs a prefill — or None when the pool cannot hold the
        reservation right now. Without ``prefix_cache`` this is plain
        :meth:`admit` with ``cached_tokens = 0``."""
        prompt_len = len(tokens)
        if not self.config.prefix_cache:
            sid = self.admit(prompt_len, max_new_tokens)
            return None if sid is None else (sid, 0)
        total = prompt_len + int(max_new_tokens)
        self._check_fits(prompt_len, total)
        n_cacheable = self._cacheable_blocks(prompt_len)
        if keys is None:
            keys = self._chain_keys(tokens, n_cacheable)
        shared: List[Tuple[str, int]] = []
        for key in keys:
            b = self._by_key.get(key)
            if b is None:
                break
            shared.append((key, b))
        shared_set = {b for _, b in shared}
        need = self.config.blocks_for(total) - len(shared)
        avail = len(self._free) + sum(
            1 for b in self._evictable if b not in shared_set)
        if need > avail:
            return None
        # take refs FIRST so the fresh-block evictions below can never
        # reclaim a block this very admission is sharing
        for _, b in shared:
            self._ref[b] = self._ref.get(b, 0) + 1
            self._evictable.pop(b, None)
        fresh = [self._take_fresh() for _ in range(need)]
        blocks = [b for _, b in shared] + fresh
        sid = self._next_id
        self._next_id += 1
        self._tables[sid] = blocks
        self._seq_shared[sid] = [b for _, b in shared]
        # the fresh blocks completing the cacheable span publish their
        # chain keys at commit (after the prefill that writes them)
        self._pending[sid] = [(keys[j], blocks[j])
                              for j in range(len(shared), n_cacheable)]
        return sid, len(shared) * self.config.block_size

    def _publish(self, sid: int, pairs) -> None:
        if not pairs:
            return
        shared = self._seq_shared.setdefault(sid, [])
        for key, b in pairs:
            self._by_key[key] = b
            self._block_key[b] = key
            self._ref[b] = self._ref.get(b, 0) + 1
            shared.append(b)

    def commit_prefix(self, sid: int) -> None:
        """Publish the sequence's freshly-written full-prefix blocks
        into the content index. Call ONLY after the prefill/extend that
        wrote them succeeded; first publisher wins (a same-prompt
        sequence admitted before this commit keeps its private copy).
        Publishes without the JAX package's fault guard (not ported)."""
        pending = self._pending.pop(sid, ())
        self._publish(sid, [(k, b) for k, b in pending
                            if k not in self._by_key])

    def publish_prefix(self, sid: int, tokens: Sequence[int]) -> int:
        """Share a LIVE sequence's full written-prefix blocks under the
        chain keys of ``tokens`` (its prompt plus every token generated
        so far): only full blocks strictly before the last position of
        ``tokens`` are published, all written before its latest token
        was emitted. Returns the number of newly-published blocks;
        first publisher wins."""
        if not self.config.prefix_cache:
            return 0
        blocks = self._tables.get(sid)
        if not blocks:
            return 0
        n = min(self._cacheable_blocks(len(tokens)), len(blocks))
        if n <= 0:
            return 0
        keys = self._chain_keys(tokens, n)
        shared = self._seq_shared.setdefault(sid, [])
        fresh = [(keys[j], blocks[j]) for j in range(n)
                 if blocks[j] not in shared
                 and keys[j] not in self._by_key]
        self._publish(sid, fresh)
        # a still-pending admission-time publish is superseded (same
        # leading keys)
        self._pending.pop(sid, None)
        return len(fresh)

    # ---------------------------------------------- migration adoption
    def export_span(self, tokens: Sequence[int]):
        """The committed leading chain span of ``tokens`` as
        ``[(chain key, pool block)]`` pairs, in chain order; the walk
        stops at the first uncommitted key (a chain is only restorable
        as a contiguous prefix)."""
        out = []
        for key in self.prefix_keys(list(tokens)):
            b = self.cached_block(key)
            if b is None:
                break
            out.append((key, b))
        return out

    def import_span(self, keys: Sequence[str]):
        """Adopt pool blocks for a chain-key span, in order. Keys
        already committed are skipped; the walk stops at the first key
        that cannot be adopted. Returns ``[(chain key, adopted block)]``
        for the keys the caller must fill. Never raises."""
        out = []
        for key in keys:
            if self.cached_block(key) is not None:
                continue
            b = self.adopt_cached_block(key)
            if b is None:
                break
            out.append((key, b))
        return out

    def cached_block(self, key: str) -> Optional[int]:
        """Pool block committed under this chain key, or None."""
        return self._by_key.get(key)

    def adopt_cached_block(self, key: str) -> Optional[int]:
        """Reserve one pool block and commit it under ``key`` without a
        local prefill (the caller writes the K/V rows). The block enters
        the index at refcount 0 on the LRU list. Returns None when the
        key is already committed, prefix caching is off, or no block is
        reclaimable."""
        if not self.config.prefix_cache or key in self._by_key:
            return None
        if self.reclaimable_blocks <= 0:
            return None
        b = self._take_fresh()
        self._by_key[key] = b
        self._block_key[b] = key
        self._evictable[b] = None
        return b

    # --------------------------------------------------------- release
    def release(self, sid: int) -> None:
        """Return a retired sequence's blocks: shared blocks drop one
        reference (and park on the LRU evictable list at zero), private
        blocks go back to the free list. An un-committed pending publish
        is dropped (abort before commit leaks nothing)."""
        self._pending.pop(sid, None)
        blocks = self._tables.pop(sid, None)
        if not blocks:
            self._seq_shared.pop(sid, None)
            return
        shared = set(self._seq_shared.pop(sid, ()))
        for b in reversed(blocks):
            if b in shared:
                self._ref[b] -= 1
                if self._ref[b] <= 0:
                    del self._ref[b]
                    self._evictable[b] = None  # cached, LRU-reclaimable
            else:
                self._free.append(b)

    def drop_prefix_cache(self) -> int:
        """Evict every unreferenced cached block back to the free list;
        returns the number reclaimed."""
        n = 0
        while self._evictable:
            b, _ = self._evictable.popitem(last=False)
            del self._by_key[self._block_key.pop(b)]
            self._ref.pop(b, None)
            self._free.append(b)
            n += 1
        return n

    # ----------------------------------------------------------- tables
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
