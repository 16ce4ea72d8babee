"""LayerHelper: shared plumbing for layer functions (counterpart of
paddle_tpu/layer_helper.py), weight normalization included."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .core import dtype_utils, flags
from .core import initializer as init
from .core import unique_name
from .core.program import (Parameter, Variable, default_main_program,
                           default_startup_program)
from .param_attr import ParamAttr, WeightNormParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.layer_type = layer_type
        self.kwargs = kwargs

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def unique_out(self, suffix: str = "tmp") -> str:
        return unique_name.generate(f"{self.layer_type}.{suffix}")

    def create_parameter(self, attr, shape: Sequence[int], dtype,
                         is_bias: bool = False,
                         default_initializer=None) -> Parameter:
        attr = ParamAttr._to_attr(attr)
        if isinstance(attr, WeightNormParamAttr):
            return self._create_weight_normed(attr, shape, dtype,
                                              default_initializer)
        if (dtype_utils.name(dtype) in ("bfloat16", "float16")
                and flags.bf16_stream()):
            # master weights stay f32 under the bf16 activation stream:
            # the layer's input dtype does not leak into parameter storage
            dtype = "float32"
        if attr.name is None:
            suffix = "b" if is_bias else "w"
            attr.name = unique_name.generate(f"{self.layer_type}.{suffix}")
        if default_initializer is None:
            default_initializer = (init.Constant(0.0) if is_bias
                                   else init.Xavier())
        initializer = attr.initializer or default_initializer
        gb = self.main_program.global_block()
        if attr.name in gb.vars and isinstance(gb.vars[attr.name], Parameter):
            return gb.vars[attr.name]  # shared parameter by name
        p = gb.create_parameter(
            shape=shape, dtype=dtype, name=attr.name,
            initializer=initializer, trainable=attr.trainable,
            regularizer=attr.regularizer, gradient_clip=attr.gradient_clip,
            optimize_attr={"learning_rate": attr.learning_rate})
        if attr.sharding is not None:
            p.sharding_spec = tuple(attr.sharding)
        return p

    def _create_weight_normed(self, attr, shape, dtype,
                              default_initializer):
        """Weight normalization, w = g * v / ||v||: ``v`` (direction)
        and ``g`` (scale) are the trainable Parameters, and the weight
        the layer consumes is the output of a ``weight_norm`` op, so
        autograd reaches g and v through the norm. ``g`` starts at
        ||v|| (a startup op after v's initializer), so the initial w
        equals v. The norm runs over every axis but ``dim`` (None: one
        global scalar g). Under the bf16 activation stream g, v and w
        stay f32, as every master weight does."""
        dim = attr.dim
        if dim is not None and dim < 0:
            dim = dim % len(shape)
        if (dtype_utils.name(dtype) in ("bfloat16", "float16")
                and flags.bf16_stream()):
            dtype = "float32"
        name = attr.name or unique_name.generate(f"{self.layer_type}.w")
        gb = self.main_program.global_block()
        if name in gb.vars:
            return gb.vars[name]  # a weight-normed parameter shared by name
        v = self.create_parameter(
            ParamAttr(name=name + ".w_v", initializer=attr.initializer,
                      learning_rate=attr.learning_rate,
                      regularizer=attr.regularizer,
                      trainable=attr.trainable,
                      gradient_clip=attr.gradient_clip,
                      sharding=attr.sharding),
            shape, dtype, default_initializer=default_initializer)
        g_shape = (int(shape[dim]),) if dim is not None else ()
        g = gb.create_parameter(
            shape=g_shape, dtype=dtype, name=name + ".w_g",
            initializer=None, trainable=attr.trainable,
            regularizer=attr.regularizer, gradient_clip=attr.gradient_clip,
            optimize_attr={"learning_rate": attr.learning_rate})
        if attr.sharding is not None and dim is not None:
            g.sharding_spec = (tuple(attr.sharding)[dim],)

        def _norm(vv):
            if dim is None:
                return torch.sqrt(torch.sum(torch.square(vv)))
            axes = tuple(i for i in range(vv.dim()) if i != dim)
            return torch.sqrt(torch.sum(torch.square(vv), dim=axes))

        sb = self.startup_program.global_block()
        sb.create_var(name=g.name, shape=g_shape, dtype=dtype,
                      persistable=True)
        sb.append_op(type="weight_norm_init_g", inputs={"V": [v.name]},
                     outputs={"Out": [g.name]}, fn=_norm)
        w = gb.create_var(name=name, shape=tuple(shape), dtype=dtype)
        bshape = tuple(int(shape[dim]) if i == dim else 1
                       for i in range(len(shape)))

        def w_fn(vv, gg):
            scale = gg / torch.clamp(_norm(vv), min=1e-12)
            return vv * (scale if dim is None else scale.reshape(bshape))

        self.append_op(type="weight_norm",
                       inputs={"V": [v.name], "G": [g.name]},
                       outputs={"Out": [w.name]}, fn=w_fn)
        return w

    def create_variable_for_type_inference(self, dtype,
                                           shape=None) -> Variable:
        return self.block.create_var(
            name=self.unique_out(), dtype=dtype, shape=shape)

    create_tmp_variable = create_variable_for_type_inference

    def append_op(self, **kw):
        return self.block.append_op(**kw)

    def append_activation(self, out: Variable,
                          act: Optional[str]) -> Variable:
        if act is None:
            return out
        from . import layers

        fn = getattr(layers, act, None)
        if fn is None:
            raise ValueError(f"Unknown activation {act!r}")
        return fn(out)
