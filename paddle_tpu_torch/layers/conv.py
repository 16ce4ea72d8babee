"""Normalization layers (counterpart of paddle_tpu/layers/conv.py): the
layer norm the causal LM reaches."""

from __future__ import annotations

import numpy as np
import torch

from ..core import initializer as init
from ..layer_helper import LayerHelper


def layer_norm(input, scale: bool = True, shift: bool = True,
               begin_norm_axis: int = 1, epsilon: float = 1e-5,
               param_attr=None, bias_attr=None, act=None, name=None):
    """Layer normalization over the axes from ``begin_norm_axis`` on."""
    helper = LayerHelper("layer_norm")
    dtype = input.dtype
    norm_shape = input.shape[begin_norm_axis:]
    nelem = int(np.prod(norm_shape))
    inputs = {"X": [input.name]}
    if scale:
        g = helper.create_parameter(param_attr, [nelem], dtype,
                                    default_initializer=init.Constant(1.0))
        inputs["Scale"] = [g.name]
    if shift:
        b = helper.create_parameter(bias_attr, [nelem], dtype, is_bias=True)
        inputs["Bias"] = [b.name]
    out = helper.create_tmp_variable(dtype)

    def fn(x, *sb):
        # stats in f32 even for a bf16 activation stream; output returns
        # to the input dtype
        xf = x.to(torch.float32)
        ax = tuple(range(begin_norm_axis, x.dim()))
        mean = torch.mean(xf, dim=ax, keepdim=True)
        var = torch.var(xf, dim=ax, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + epsilon)
        tail = x.shape[begin_norm_axis:]
        i = 0
        if scale:
            y = y * sb[i].reshape(tail).to(torch.float32)
            i += 1
        if shift:
            y = y + sb[i].reshape(tail).to(torch.float32)
        return y.to(x.dtype)

    helper.append_op(type="layer_norm", inputs=inputs,
                     outputs={"Y": [out.name]},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis}, fn=fn)
    return helper.append_activation(out, act)
