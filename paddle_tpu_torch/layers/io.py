"""Data-input layers (counterpart of paddle_tpu/layers/io.py)."""

from __future__ import annotations

from typing import Sequence

from ..core.enforce import enforce
from ..core.program import default_main_program


def data(name: str, shape: Sequence[int], dtype="float32",
         append_batch_size: bool = True, lod_level: int = 0, type=None):
    """Declare an input variable. With ``append_batch_size=True`` the
    batch dimension is prepended as -1. Sequence (``lod_level > 0``)
    inputs are not ported yet."""
    enforce(lod_level == 0,
            "data(lod_level=%d): sequence inputs are not ported yet"
            % lod_level)
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = default_main_program().current_block()
    return block.create_var(name=name, shape=shape, dtype=dtype,
                            lod_level=lod_level, is_data=True,
                            stop_gradient=True)
