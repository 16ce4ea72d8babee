"""DEPRECATION SHIM (counterpart of paddle_tpu/quantize_transpiler.py) —
moved to ``paddle_tpu_torch.passes``.

The QAT flow that lived here — ``QuantizeTranspiler.training_transpile``
(STE fake-quant insertion before ``minimize``) and ``freeze_program``
(the registered ``quantize_inference`` pass) — lives in
``paddle_tpu_torch/passes/quantize.py`` beside the post-training int8
path (``calibrate_program`` + the ``ptq_int8`` pass /
``quantize_for_serving``), which quantizes a trained f32 program for
serving without any QAT retraining. This re-export keeps the old entry
point working unchanged."""

from __future__ import annotations

from .passes.quantize import QuantizeTranspiler  # noqa: F401

__all__ = ["QuantizeTranspiler"]
