"""Tensor creation and conversion layers (counterpart of
paddle_tpu/layers/tensor.py): the cast the Transformer path reaches."""

from __future__ import annotations

from ..core import dtype_utils
from ..layer_helper import LayerHelper


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
