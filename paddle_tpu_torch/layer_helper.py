"""LayerHelper: shared plumbing for layer functions (counterpart of
paddle_tpu/layer_helper.py, without weight normalization)."""

from __future__ import annotations

from typing import Optional, Sequence

from .core import dtype_utils, flags
from .core import initializer as init
from .core import unique_name
from .core.program import (Parameter, Variable, default_main_program,
                           default_startup_program)
from .param_attr import ParamAttr


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
