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
graceful drain. Every decode step's window attention runs the
hand-written paged-attention kernel (ops/paged_attention.py).
"""

from .batcher import ContinuousBatcher
from .cache import CacheConfig, KVCacheManager
from .engine import DecodeEngine, DecodingConfig
from .rewrite import (BLOCK_TABLES, NEXT_LOGITS, NEXT_TOKENS, POSITIONS,
                      SEQ_LENS, DecodePair, derive_decode_programs)
from .session import DecodeSession, GenerationRequest, serve_decoding

__all__ = [
    "CacheConfig",
    "ContinuousBatcher",
    "DecodeEngine",
    "DecodePair",
    "DecodeSession",
    "DecodingConfig",
    "GenerationRequest",
    "KVCacheManager",
    "derive_decode_programs",
    "serve_decoding",
]
