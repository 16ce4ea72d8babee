"""Tensor creation and manipulation layers (counterpart of
paddle_tpu/layers/tensor.py).

Index outputs (``argmin``, ``argsort``'s indices, ``shape``) are int64,
the dtype their variables declare; the JAX package's are int32 unless
jax runs in 64-bit mode.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core import dtype_utils
from ..core import initializer as init
from ..core.program import (Variable, default_main_program,
                            default_startup_program)
from ..layer_helper import LayerHelper


def _full(shape, value, dtype):
    tgt = dtype_utils.to_torch(dtype)
    return lambda: torch.full(tuple(shape), value, dtype=tgt)


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor")
    return helper.block.create_var(name=name or helper.unique_out(),
                                   dtype=dtype, persistable=persistable)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A global variable the startup program fills with ``value``."""
    helper = LayerHelper("global_var")
    gb = default_main_program().global_block()
    var = gb.create_var(name=name or helper.unique_out(), shape=shape,
                        dtype=dtype, persistable=persistable)
    sb = default_startup_program().global_block()
    sb.create_var(name=var.name, shape=shape, dtype=dtype,
                  persistable=persistable)
    sb.append_op(type="fill_constant", inputs={},
                 outputs={"Out": [var.name]},
                 attrs={"shape": shape, "value": value},
                 fn=_full(shape, float(value), dtype))
    return var


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    """A tensor of ``shape`` (``[]`` for a 0-d one) filled with
    ``value``."""
    helper = LayerHelper("fill_constant")
    out = out or helper.create_tmp_variable(dtype, shape=tuple(shape))
    helper.append_op(type="fill_constant", inputs={},
                     outputs={"Out": [out.name]},
                     attrs={"shape": tuple(shape), "value": value},
                     fn=_full(shape, value, dtype))
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_tmp_variable(dtype)
    tgt = dtype_utils.to_torch(dtype)

    def fn(ref):
        s = list(shape)
        s[output_dim_idx] = ref.shape[input_dim_idx]
        return torch.full(tuple(s), value, dtype=tgt, device=ref.device)

    helper.append_op(type="fill_constant_batch_size_like",
                     inputs={"Input": [input.name]},
                     outputs={"Out": [out.name]}, fn=fn)
    return out


def cast(x, dtype):
    """``x`` converted to ``dtype`` (a numpy dtype name or
    ``"bfloat16"``)."""
    helper = LayerHelper("cast")
    out = helper.create_tmp_variable(dtype)
    tgt = dtype_utils.to_torch(dtype)
    helper.append_op(type="cast", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"dtype": str(dtype)},
                     fn=lambda v: v.to(tgt))
    return out


def assign(input, output: Optional[Variable] = None):
    """A copy of a variable, or a constant from a numpy array."""
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        output = output or helper.create_tmp_variable(input.dtype)
        helper.append_op(type="assign", inputs={"X": [input.name]},
                         outputs={"Out": [output.name]}, fn=lambda v: v)
        return output
    arr = np.asarray(input)
    if arr.dtype == np.float64:  # the JAX package's 32-bit mode
        arr = arr.astype(np.float32)
    elif arr.dtype == np.int64:
        arr = arr.astype(np.int32)
    output = output or helper.create_tmp_variable(str(arr.dtype))
    helper.append_op(type="assign_value", inputs={},
                     outputs={"Out": [output.name]},
                     fn=lambda: torch.as_tensor(arr))
    return output


def sums(input: List[Variable], out=None):
    helper = LayerHelper("sum")
    out = out or helper.create_tmp_variable(input[0].dtype)
    helper.append_op(type="sum", inputs={"X": [v.name for v in input]},
                     outputs={"Out": [out.name]},
                     fn=lambda *vs: sum(vs))
    return out


def increment(x, value: float = 1.0, in_place: bool = True):
    """``x + value``, written back to ``x`` itself by default: a
    persistable counter is state, which ``Executor.run`` writes to the
    scope and a captured ``run_steps`` graph to its buffer each step
    (as the learning-rate schedules' counter)."""
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_tmp_variable(x.dtype)
    helper.append_op(type="increment", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     fn=lambda v: v + torch.full((), value, dtype=v.dtype,
                                                 device=v.device))
    return out


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def argmin(x, axis=0):
    helper = LayerHelper("arg_min")
    out = helper.create_tmp_variable("int64")
    helper.append_op(type="arg_min", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     fn=lambda v: torch.argmin(v, dim=axis))
    return out


def cumsum(x, axis=-1):
    helper = LayerHelper("cumsum")
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="cumsum", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     fn=lambda v: torch.cumsum(v, dim=axis))
    return out


def shape(x):
    """The shape of ``x`` as a 1-D int64 tensor."""
    helper = LayerHelper("shape")
    out = helper.create_tmp_variable("int64")
    helper.append_op(type="shape", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     fn=lambda v: torch.tensor(tuple(v.shape),
                                               dtype=torch.int64,
                                               device=v.device))
    return out


def argsort(input, axis: int = -1, name=None):
    """Sorted values and the permutation, stable (equal values keep
    their order), as ``jnp.argsort(stable=True)``."""
    helper = LayerHelper("argsort")
    out = helper.create_tmp_variable(input.dtype)
    ids = helper.create_tmp_variable(np.int64)

    def fn(x):
        idx = torch.argsort(x, dim=axis, stable=True)
        return torch.take_along_dim(x, idx, dim=axis), idx

    helper.append_op(type="argsort", inputs={"X": [input.name]},
                     outputs={"Out": [out.name], "Indices": [ids.name]},
                     attrs={"axis": axis}, fn=fn)
    out.shape = input.shape
    ids.shape = input.shape
    return out, ids


def reverse(x, axis):
    """Flip along the given axis or axes."""
    helper = LayerHelper("reverse")
    out = helper.create_tmp_variable(x.dtype)
    axes = [axis] if isinstance(axis, int) else list(axis)
    helper.append_op(type="reverse", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": axes},
                     fn=lambda v: torch.flip(v, dims=axes))
    out.shape = x.shape
    return out


def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias: bool = False, default_initializer=None):
    """A bare trainable parameter."""
    from ..param_attr import ParamAttr

    helper = LayerHelper("create_parameter")
    attr = ParamAttr._to_attr(attr)
    if name is not None and attr.name is None:
        attr.name = name
    if default_initializer is None:
        default_initializer = (init.Constant(0.0) if is_bias
                               else init.Xavier())
    return helper.create_parameter(attr, list(shape), dtype,
                                   is_bias=is_bias,
                                   default_initializer=default_initializer)
