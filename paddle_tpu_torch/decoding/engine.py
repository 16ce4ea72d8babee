"""DecodeEngine: the execution layer of the decode subsystem
(counterpart of paddle_tpu/decoding/engine.py).

Owns the derived prefill/decode Program pair (rewrite.py), the executor
that runs them, and the bucket discipline that keeps every call on a
fixed set of shapes:

* prefill executes at ``(prefill_batch_bucket, prompt_bucket)`` shapes —
  prompts pad up to the next prompt bucket, rows pad with block-table
  ``-1`` rows whose cache writes are dropped;
* decode executes at ``decode_bucket`` batch shapes with ``T = 1`` —
  inactive rows carry ``positions = -1``.

``warm_up()`` runs every bucket once with inert feeds, which builds the
kernel and allocates on the card before traffic arrives.

Threading contract: single-threaded execution — the DecodeSession's
worker is the only caller after ``warm_up``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..core.enforce import enforce
from ..core.scope import global_scope
from ..executor import Executor
from ..serving.metrics import DecodeMetrics
from .cache import CacheConfig
from .rewrite import (BLOCK_TABLES, NEXT_TOKENS, POSITIONS, SEQ_LENS,
                      derive_decode_programs)


def _pow2_buckets(lo: int, hi: int) -> List[int]:
    out = []
    b = lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return sorted(set(out))


class DecodingConfig:
    """Knobs for the decode stack (engine + batcher + session), with the
    JAX package's defaults.

    cache: the paged-pool geometry (CacheConfig).
    prompt_buckets: prompt lengths prefill runs at; prompts pad up to
        the next bucket. Default: powers of two from ``block_size`` to
        ``max_context``.
    decode_buckets: decode-step batch sizes; the largest is the
        continuous batcher's ``max_active`` slot count.
    prefill_batch_buckets: how many admissions one prefill executes.
    max_new_tokens: default generation budget per request.
    queue_capacity / default_deadline_ms / warm_up: the session's
        backpressure bound, default deadline and start-up warm-up.

    Not ported yet (raise when set): ``sampling``, ``speculate_k``,
    ``suffix_buckets``, ``breaker``, ``degrade``, ``autotune``.
    """

    def __init__(self, cache: Optional[CacheConfig] = None,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 decode_buckets: Sequence[int] = (1, 2, 4, 8),
                 prefill_batch_buckets: Sequence[int] = (1,),
                 suffix_buckets: Optional[Sequence[int]] = None,
                 sampling: bool = False,
                 speculate_k: int = 0,
                 max_new_tokens: int = 32,
                 queue_capacity: int = 256,
                 default_deadline_ms: Optional[float] = None,
                 warm_up: bool = True,
                 breaker=None,
                 degrade=None,
                 autotune: bool = False):
        not_ported = {"sampling": sampling, "speculate_k": speculate_k,
                      "suffix_buckets": suffix_buckets,
                      "breaker": breaker, "degrade": degrade,
                      "autotune": autotune}
        for name, value in not_ported.items():
            if value:
                raise NotImplementedError(
                    "DecodingConfig(%s=%r) is not ported yet" % (name, value))
        self.cache = cache or CacheConfig()
        mc = self.cache.max_context
        if prompt_buckets:
            self.prompt_buckets = sorted(set(int(b)
                                             for b in prompt_buckets))
            enforce(self.prompt_buckets[0] >= 1, "prompt buckets >= 1")
            enforce(self.prompt_buckets[-1] <= mc,
                    "prompt bucket %d exceeds max_context %d"
                    % (self.prompt_buckets[-1], mc))
        else:
            self.prompt_buckets = _pow2_buckets(
                min(self.cache.block_size, mc), mc)
        self.decode_buckets = sorted(set(int(b) for b in decode_buckets))
        enforce(self.decode_buckets[0] >= 1, "decode buckets >= 1")
        self.prefill_batch_buckets = sorted(
            set(int(b) for b in prefill_batch_buckets))
        enforce(self.prefill_batch_buckets[0] >= 1,
                "prefill batch buckets >= 1")
        self.max_new_tokens = int(max_new_tokens)
        self.queue_capacity = int(queue_capacity)
        self.default_deadline_ms = default_deadline_ms
        self.warm_up = bool(warm_up)

    @property
    def max_active(self) -> int:
        """Decode slot count = the largest decode bucket."""
        return self.decode_buckets[-1]

    @property
    def max_prefill_batch(self) -> int:
        return self.prefill_batch_buckets[-1]


def _bucket_for(buckets: Sequence[int], n: int) -> Optional[int]:
    for b in buckets:
        if b >= n:
            return b
    return None


class DecodeEngine:
    """Executes the prefill/decode programs at bucketed shapes on one
    place (default ``CUDAPlace(0)``)."""

    def __init__(self, program, token_name: str, logits_name: str,
                 scope=None, config: Optional[DecodingConfig] = None,
                 place=None, metrics: Optional[DecodeMetrics] = None):
        self.config = config or DecodingConfig()
        self.metrics = metrics or DecodeMetrics()
        self._exe = Executor(place)
        self.device = self._exe.device
        self.pair = derive_decode_programs(
            program, token_name, logits_name, self.config.cache)
        self.scope = scope if scope is not None else global_scope()
        self.pair.init_scope(self.scope, self.device)
        self._token_dtype = self.pair.prefill.global_block().var(
            token_name).dtype

    @property
    def cache_config(self) -> CacheConfig:
        return self.config.cache

    def warm_bucket_count(self) -> int:
        return (len(self.config.prefill_batch_buckets)
                * len(self.config.prompt_buckets)
                + len(self.config.decode_buckets))

    def prompt_bucket_for(self, length: int) -> Optional[int]:
        return _bucket_for(self.config.prompt_buckets, length)

    def warm_up(self) -> int:
        """Run every (prefill batch x prompt) and decode bucket once with
        inert feeds (block tables all -1, so every cache write drops and
        warm-up cannot disturb live pools). Returns the bucket count."""
        cfg = self.config
        for pb in cfg.prefill_batch_buckets:
            for tb in cfg.prompt_buckets:
                rows = [np.zeros(tb, np.int64)] * pb
                self.prefill(rows, np.stack([self._empty_row()] * pb),
                             np.zeros(pb, np.int32), _warm=True)
        for db in cfg.decode_buckets:
            self.decode(np.zeros(db, np.int64), np.full(db, -1, np.int32),
                        np.stack([self._empty_row()] * db), _warm=True)
        return self.warm_bucket_count()

    def _empty_row(self) -> np.ndarray:
        return self.cache_config.empty_table_row()

    def prefill(self, token_rows: Sequence[np.ndarray],
                tables: np.ndarray, seq_lens: np.ndarray,
                _warm: bool = False) -> np.ndarray:
        """Run one prefill for ``len(token_rows)`` sequences: pads the
        batch to the next prefill batch bucket and every prompt to the
        next prompt bucket, writes the prompt K/V into the pools at the
        table slots, returns the first generated token per row."""
        n = len(token_rows)
        enforce(n >= 1, "prefill needs at least one row")
        pb = _bucket_for(self.config.prefill_batch_buckets, n)
        enforce(pb is not None,
                "prefill batch %d exceeds the largest prefill batch "
                "bucket %d" % (n, self.config.max_prefill_batch))
        longest = max(len(r) for r in token_rows)
        tb = self.prompt_bucket_for(longest)
        enforce(tb is not None,
                "prompt length %d exceeds the largest prompt bucket %d"
                % (longest, self.config.prompt_buckets[-1]))
        tokens = np.zeros((pb, tb), dtype=self._token_dtype)
        for i, r in enumerate(token_rows):
            tokens[i, :len(r)] = np.asarray(r)
        mb = self.cache_config.max_blocks_per_seq
        tab = np.full((pb, mb), -1, np.int32)
        tab[:n] = np.asarray(tables, np.int32)
        lens = np.zeros(pb, np.int32)
        lens[:n] = np.asarray(seq_lens, np.int32)
        feed = {self.pair.token_name: tokens, BLOCK_TABLES: tab,
                SEQ_LENS: lens}
        with self.metrics.timer(None if _warm else "prefill_ms"):
            out, = self._exe.run(self.pair.prefill, feed=feed,
                                 fetch_list=[NEXT_TOKENS], scope=self.scope)
        return out[:n]

    def decode(self, tokens: np.ndarray, positions: np.ndarray,
               tables: np.ndarray, _warm: bool = False) -> np.ndarray:
        """One decode step for ``len(tokens)`` sequences (their latest
        token, its position and their table rows); pads the batch to the
        next decode bucket with inactive rows. Returns the next token
        per row."""
        n = len(tokens)
        enforce(n >= 1, "decode needs at least one row")
        db = _bucket_for(self.config.decode_buckets, n)
        enforce(db is not None,
                "active set %d exceeds the largest decode bucket %d"
                % (n, self.config.max_active))
        toks = np.zeros((db, 1), dtype=self._token_dtype)
        toks[:n, 0] = np.asarray(tokens)
        pos = np.full(db, -1, np.int32)
        pos[:n] = np.asarray(positions, np.int32)
        mb = self.cache_config.max_blocks_per_seq
        tab = np.full((db, mb), -1, np.int32)
        tab[:n] = np.asarray(tables, np.int32)
        feed = {self.pair.token_name: toks, BLOCK_TABLES: tab,
                POSITIONS: pos}
        with self.metrics.timer(None if _warm else "decode_step_ms"):
            out, = self._exe.run(self.pair.decode, feed=feed,
                                 fetch_list=[NEXT_TOKENS], scope=self.scope)
        return out[:n]
