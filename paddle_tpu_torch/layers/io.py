"""Data-input layers (counterpart of paddle_tpu/layers/io.py)."""

from __future__ import annotations

from typing import Sequence

from ..core.enforce import enforce
from ..core.program import default_main_program


def data(name: str, shape: Sequence[int], dtype="float32",
         append_batch_size: bool = True, lod_level: int = 0, type=None):
    """Declare an input variable. With ``append_batch_size=True`` the
    batch dimension is prepended as -1.

    A sequence input (``lod_level`` 1 or 2) is a padded dense array with
    length companions, as in the JAX package: ``lod_level=1`` gains the
    leading dims ``[-1, -1]`` (batch, time) and declares ``<name>@LEN``
    ([B] int32 lengths); ``lod_level=2`` gains ``[-1, -1, -1]`` (batch,
    inner sequences, time), ``<name>@LEN`` holds the inner lengths
    ``[B, S]`` and ``<name>@LEN0`` the inner-sequence counts ``[B]``.
    ``DataFeeder`` pads ragged rows and fills both."""
    enforce(lod_level <= 2,
            "lod_level=%d unsupported: the padded layout carries at most 2 "
            "nesting levels ([batch, n_seqs, time, ...]); reshape deeper "
            "nestings into explicit dims" % lod_level)
    shape = list(shape)
    if append_batch_size:
        shape = [-1] * (1 + min(lod_level, 2)) + shape
    block = default_main_program().current_block()
    v = block.create_var(name=name, shape=shape, dtype=dtype,
                         lod_level=lod_level, is_data=True,
                         stop_gradient=True)
    if lod_level > 0:
        block.create_var(name=name + "@LEN",
                         shape=[-1, -1] if lod_level >= 2 else [-1],
                         dtype="int32", is_data=True, stop_gradient=True)
        v.seq_length_name = name + "@LEN"
        if lod_level >= 2:
            block.create_var(name=name + "@LEN0", shape=[-1], dtype="int32",
                             is_data=True, stop_gradient=True)
            v.seq_outer_length_name = name + "@LEN0"
    return v
