"""paddle_tpu_torch.compile_cache — the persistent content-addressed
store (counterpart of paddle_tpu/compile_cache).

Ported so far: :mod:`store`, the on-disk store with its atomic publish,
verified reads and LRU gc, which the kernel-tuning store builds on. The
compilation fingerprint, the runtime that loads or compiles through the
store, the ``compile_cache_dir`` flag and the ``tools/cache.py`` CLI
come with ROADMAP Queue A step (f2).
"""

from .store import CacheEntry, CacheStore

__all__ = ["CacheEntry", "CacheStore"]
