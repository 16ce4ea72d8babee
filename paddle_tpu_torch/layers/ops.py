"""Elementwise / activation ops (counterpart of paddle_tpu/layers/ops.py):
the ones the causal LM reaches."""

from __future__ import annotations

import torch

from ..core.program import Variable
from ..layer_helper import LayerHelper


def _unary(name, fn, x, attrs=None):
    helper = LayerHelper(name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type=name, inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs=attrs, fn=fn)
    return out


def relu(x, name=None):
    """max(0, x)"""
    return _unary("relu", torch.relu, x)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, name=None):
    if bias_after_scale:
        fn = lambda v: v * scale + bias
    else:
        fn = lambda v: (v + bias) * scale
    return _unary("scale", fn, x)


def _elementwise(name, tfn, x, y, axis=-1, act=None):
    helper = LayerHelper(name)
    if not isinstance(y, Variable):
        const = y

        def fn(xv):
            return tfn(xv, const)

        out = helper.create_tmp_variable(x.dtype)
        helper.append_op(type=name, inputs={"X": [x.name]},
                         outputs={"Out": [out.name]}, fn=fn)
        return helper.append_activation(out, act)

    def fn(xv, yv):
        if axis != -1 and yv.dim() < xv.dim():
            # reference broadcast rule: align y's dims starting at `axis`
            shape = [1] * xv.dim()
            for i in range(yv.dim()):
                shape[axis + i] = yv.shape[i]
            yv = torch.reshape(yv, shape)
        return tfn(xv, yv)

    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type=name, inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]}, fn=fn)
    return helper.append_activation(out, act)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", torch.add, x, y, axis, act)
