"""DataFeeder: host rows to a feed dict (counterpart of
paddle_tpu/data_feeder.py; reference: python/paddle/fluid/data_feeder.py:81
DataFeeder, feed :165, feed_parallel :197).

Each row of a minibatch is a tuple with one slot per feed variable; a
slot's column is stacked into a numpy array of the variable's dtype,
with trailing size-1 axes added up to its declared rank. Sequence slots
(``lod_level > 0``), which the JAX package pads to a bucketed length,
raise: the port has no sequence inputs (``layers.data`` refuses them).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .core.enforce import enforce, not_ported
from .core.program import Program, Variable, default_main_program


class DataFeeder:
    def __init__(self, feed_list: Sequence, place=None,
                 program: Optional[Program] = None):
        program = program or default_main_program()
        self.feed_vars: List[Variable] = []
        for f in feed_list:
            v = f if isinstance(f, Variable) else \
                program.global_block().var(f)
            if v.lod_level > 0:
                raise not_ported("DataFeeder of sequence slot %r (lod_level "
                                 "%d)" % (v.name, v.lod_level), "Queue A 7")
            self.feed_vars.append(v)
        self.place = place

    @property
    def feed_names(self) -> tuple:
        """The feed variables' names in slot order."""
        return tuple(v.name for v in self.feed_vars)

    def feed(self, iterable) -> Dict[str, np.ndarray]:
        """Rows of tuples (one slot per feed variable) to a feed dict."""
        rows = list(iterable)
        enforce(rows, "empty minibatch")
        out: Dict[str, np.ndarray] = {}
        for i, var in enumerate(self.feed_vars):
            arr = np.asarray([r[i] for r in rows])
            if var.shape is not None and len(var.shape) > arr.ndim:
                arr = arr.reshape(arr.shape + (1,) *
                                  (len(var.shape) - arr.ndim))
            # numpy has no bfloat16: such a slot stays float32 here and
            # the executor casts it on the card
            out[var.name] = arr.astype(var.dtype if isinstance(
                var.dtype, np.dtype) else np.float32)
        return out

    def feed_parallel(self, iterable_list, num_places=None):
        """One feed dict per device (reference: data_feeder.py:197)."""
        return [self.feed(it) for it in iterable_list]
