"""Program passes of paddle_tpu_torch (counterpart of paddle_tpu/passes).

Only ``memory_optimize`` and ``release_memory`` are ported; the pass
manager, the registry and the other passes are not (ROADMAP Queue A 8).
"""

from .transforms import memory_optimize, release_memory

__all__ = ["memory_optimize", "release_memory"]
