"""The transpiler's entry points, kept where the reference had them
(counterpart of paddle_tpu/memory_optimization_transpiler.py): both live
in ``paddle_tpu_torch.passes.transforms``."""

from __future__ import annotations

from .passes.transforms import memory_optimize, release_memory  # noqa: F401

__all__ = ["memory_optimize", "release_memory"]
