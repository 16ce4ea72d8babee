"""paddle_tpu_torch.compile_cache — the persistent, content-addressed
cache of exported graphs (counterpart of paddle_tpu/compile_cache).

What the port compiles that a later process can reuse is the
``torch.export`` of each bucket of ``io.save_inference_model`` and of
``io.save_trainable_program``'s step (BERT-base's 7-bucket export is
minutes of host time). With the ``compile_cache_dir`` flag set (or the
``PDTPU_COMPILE_CACHE_DIR`` env var), each export is keyed by a
canonical fingerprint of its program, shapes, site config and
environment (:mod:`fingerprint`), and its ``.pt2`` bytes are stored in
the same on-disk layout the JAX package uses (:mod:`store`), so a
re-export or a second process writes the stored file instead of
tracing again (:func:`runtime.cached_export`)::

    from paddle_tpu_torch.core import flags
    flags.set_flags({"compile_cache_dir": "/var/cache/pdtpu"})

The executor's captured CUDA graphs hold device addresses and persist
nothing; with the flag set they are only fingerprinted into
:func:`recent_fingerprints`, the program stamps of flight-recorder
bundles. The native predictor loads exported files and compiles
nothing, so the JAX package's ``load_or_compile_hlo`` has no
counterpart. With the flag unset nothing here runs and the artifacts
are what they were. Inspect and maintain a store with
``python -m paddle_tpu_torch.tools.cache {stats,ls,verify,gc,clear}``.
"""

from .fingerprint import (CompilationUnit, environment_signature,
                          module_fingerprint)
from .runtime import (active_store, cache_metrics, recent_fingerprints,
                      reset_cache_metrics)
from .store import CacheEntry, CacheStore

__all__ = [
    "CacheEntry",
    "CacheStore",
    "CompilationUnit",
    "active_store",
    "cache_metrics",
    "environment_signature",
    "module_fingerprint",
    "recent_fingerprints",
    "reset_cache_metrics",
]
