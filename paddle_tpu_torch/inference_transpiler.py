"""The inference-time rewrites under their legacy module name
(counterpart of paddle_tpu/inference_transpiler.py): conv+BN fold and
the bf16 parameter cast, the registered ``conv_bn_fold`` and
``cast_params_bf16`` passes of ``passes/transforms.py``, re-exported
unchanged."""

from __future__ import annotations

from .passes.transforms import (InferenceTranspiler,  # noqa: F401
                                transpile_to_bfloat16)

__all__ = ["InferenceTranspiler", "transpile_to_bfloat16"]
