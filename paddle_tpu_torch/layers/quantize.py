"""Fake-quantization layers for quantization-aware training
(counterpart of paddle_tpu/layers/quantize.py): the abs-max and
range-abs-max quantizers and the dequantizer.

The quantize-dequantize round trip runs in the step, so training sees
the quantization error; the rounding's gradient passes straight through
(``x + (round(x) - x).detach()``; both packages round half to even).
The clip to ``[-bound, bound]`` is ``minimum(bound, maximum(-bound,
.))``, as ``jnp.clip`` is, so a value at the bound gets half the
gradient, as there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import dtype_utils, unique_name
from ..layer_helper import LayerHelper


def _ste_round(x):
    """round (half to even) with a straight-through gradient."""
    return x + (torch.round(x) - x).detach()


def _quantize(x, s, bound):
    """``x`` scaled by ``bound / s``, clipped to +-bound and rounded."""
    y = x / s * bound
    y = torch.maximum(torch.full_like(y, -bound), y)
    return _ste_round(torch.minimum(torch.full_like(y, bound), y))


def _floor_max(t):
    """``maximum(max(t), 1e-8)``, with ``jnp.maximum``'s gradient."""
    m = t.max()
    return torch.maximum(m, torch.full((), 1e-8, dtype=m.dtype,
                                       device=m.device))


def fake_quantize_abs_max(input, bit_length: int = 8):
    """Per-tensor abs-max fake quantization. Returns (quantized out,
    scale)."""
    helper = LayerHelper("fake_quantize_abs_max")
    out = helper.create_tmp_variable(input.dtype)
    scale = helper.create_tmp_variable(input.dtype)
    bound = float(2 ** (bit_length - 1) - 1)

    def fn(x):
        s = _floor_max(torch.abs(x))
        return _quantize(x, s, bound), s

    helper.append_op(type="fake_quantize_abs_max",
                     inputs={"X": [input.name]},
                     outputs={"Out": [out.name], "OutScale": [scale.name]},
                     attrs={"bit_length": bit_length}, fn=fn)
    out.shape = input.shape
    return out, scale


def fake_quantize_range_abs_max(input, bit_length: int = 8,
                                window_size: int = 10000,
                                is_test: bool = False):
    """Range (windowed max) fake quantization: persistable state keeps
    the last ``window_size`` abs-maxima in a circular buffer and a step
    count, and the scale is the window's max, so it can shrink as the
    activations settle. ``is_test`` (an op attribute, set by
    ``Program.clone(for_test=True)``) reads the window without writing
    it. Returns (out, scale)."""
    helper = LayerHelper("fake_quantize_range_abs_max")
    gb = helper.main_program.global_block()

    def _state(stem, shape, value, dtype):
        name = unique_name.generate(stem)
        gb.create_var(name=name, shape=shape, dtype=dtype, persistable=True)
        sb = helper.startup_program.global_block()
        sb.create_var(name=name, shape=shape, dtype=dtype, persistable=True)
        tdt = dtype_utils.to_torch(dtype)
        sb.append_op(type="fill_constant", inputs={},
                     outputs={"Out": [name]}, attrs={"value": value},
                     fn=lambda: torch.full(shape, value, dtype=tdt))
        return name

    scales_name = _state("quant_range_window", (window_size,), 0.0,
                         input.dtype)
    iter_name = _state("quant_range_iter", (), 0, "int32")

    out = helper.create_tmp_variable(input.dtype)
    scale = helper.create_tmp_variable(input.dtype)
    bound = float(2 ** (bit_length - 1) - 1)

    def fn(x, scales, it, is_test=False):
        if not is_test:
            slot = torch.arange(window_size, device=x.device) == (
                it % window_size)
            # the scale's gradient reaches x through this run's entry,
            # as through the JAX package's scatter; the state written
            # back is detached
            scales = torch.where(slot, _floor_max(torch.abs(x)), scales)
            it = it + 1
        s = _floor_max(scales)
        return _quantize(x, s, bound), s, scales.detach(), it

    helper.append_op(
        type="fake_quantize_range_abs_max",
        inputs={"X": [input.name], "InScales": [scales_name],
                "Iter": [iter_name]},
        outputs={"Out": [out.name], "OutScale": [scale.name],
                 "OutScales": [scales_name], "IterOut": [iter_name]},
        attrs={"bit_length": bit_length, "window_size": window_size,
               "is_test": is_test, "_fn_attrs": ["is_test"]},
        fn=fn)
    out.shape = input.shape
    scale.shape = ()
    return out, scale


def fake_dequantize_max_abs(input, scale, max_range: float):
    """``x * scale / max_range``, the division a product with the f32
    reciprocal, as XLA compiles it (and on every device alike)."""
    helper = LayerHelper("fake_dequantize_max_abs")
    out = helper.create_tmp_variable(input.dtype)
    recip = float(np.float32(1.0) / np.float32(max_range))
    helper.append_op(type="fake_dequantize_max_abs",
                     inputs={"X": [input.name], "Scale": [scale.name]},
                     outputs={"Out": [out.name]},
                     attrs={"max_range": max_range},
                     fn=lambda x, s: x * s * recip)
    out.shape = input.shape
    return out


__all__ = ["fake_quantize_abs_max", "fake_quantize_range_abs_max",
           "fake_dequantize_max_abs"]
