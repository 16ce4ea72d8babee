"""paddle_tpu_torch.decoding — autoregressive decode with a paged KV
cache and continuous batching, served on one card::

    session = serve_decoding(program, "tokens", logits.name,
                             scope=scope, config=DecodingConfig())
    tokens = session.generate([3, 1, 4], max_new_tokens=16)
    session.shutdown()                      # graceful drain

A graph-level rewrite derives a prefill/decode program pair from the
causal forward Program (attention ops gain persistable
``[num_blocks, block_size, heads, head_dim]`` KV pools), a slot-based
``KVCacheManager`` admits sequences against fixed pools, a
``ContinuousBatcher`` admits and retires per decode step, and
``DecodeSession`` serves it with streaming callbacks, deadlines and
graceful drain. With ``CacheConfig(prefix_cache=True)`` requests that
share committed prompt blocks are admitted net of them and prefill only
their suffix through the EXTEND program; ``CacheConfig(kv_dtype="int8")``
keeps the pools as int8 codes with per-slot scales. Every decode and
extend window attention runs the hand-written paged-attention kernel
(ops/paged_attention.py), which dequantizes int8 pools as it gathers.

``DecodingConfig(sampling=True)`` serves seeded per-request
:class:`SamplingParams` (temperature, top-k, top-p; keys from the torch
threefry, bit-equal to ``jax.random``), and
``serve_decoding(..., draft_program=...)`` speculative decoding: a draft
model proposes ``speculate_k`` tokens, the target verifies them in one
window step. On a card every bucket runs as a captured CUDA graph
(``warm_up`` captures them all).
"""

from .batcher import ContinuousBatcher
from .cache import CacheConfig, KVCacheManager
from .engine import DecodeEngine, DecodingConfig
from .rewrite import (BLOCK_TABLES, CACHED_LENS, NEXT_LOGITS, NEXT_TOKENS,
                      POSITIONS, SEQ_LENS, STEP_TOKENS, DecodePair,
                      derive_decode_programs)
from .sampling import GREEDY, SAMPLING_FEEDS, SamplingParams
from .session import DecodeSession, GenerationRequest, serve_decoding

__all__ = [
    "BLOCK_TABLES",
    "CACHED_LENS",
    "NEXT_LOGITS",
    "NEXT_TOKENS",
    "POSITIONS",
    "SEQ_LENS",
    "STEP_TOKENS",
    "CacheConfig",
    "ContinuousBatcher",
    "DecodeEngine",
    "DecodePair",
    "DecodeSession",
    "DecodingConfig",
    "GREEDY",
    "GenerationRequest",
    "KVCacheManager",
    "SAMPLING_FEEDS",
    "SamplingParams",
    "derive_decode_programs",
    "serve_decoding",
]
