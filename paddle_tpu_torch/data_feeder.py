"""DataFeeder: host rows to a feed dict (counterpart of
paddle_tpu/data_feeder.py; reference: python/paddle/fluid/data_feeder.py:81
DataFeeder, feed :165, feed_parallel :197).

Each row of a minibatch is a tuple with one slot per feed variable; a
slot's column is stacked into a numpy array of the variable's dtype,
with trailing size-1 axes added up to its declared rank.

A sequence slot (``lod_level > 0``) holds one ragged sequence a row
(``lod_level=2``: a list of sequences, or a one-example 2-level
``LoDTensor``). Its column is padded to the batch's longest sequence
rounded up to a multiple of ``PAD_BUCKET`` (the inner-sequence count of
a 2-level slot to a multiple of 4), as the JAX package pads it, so the
padded shapes — and with them the captured graphs a shape keys — are
the reference's; ``<name>@LEN`` (and ``<name>@LEN0``) get the lengths.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .core.enforce import enforce
from .core.program import Program, Variable, default_main_program

PAD_BUCKET = 16  # pad targets round up to a multiple of this


def _round_up(n: int, m: int = PAD_BUCKET) -> int:
    return ((n + m - 1) // m) * m if n > 0 else m


class DataFeeder:
    def __init__(self, feed_list: Sequence, place=None,
                 program: Optional[Program] = None):
        program = program or default_main_program()
        self.feed_vars: List[Variable] = []
        for f in feed_list:
            v = f if isinstance(f, Variable) else \
                program.global_block().var(f)
            self.feed_vars.append(v)
        self.place = place

    @property
    def feed_names(self) -> tuple:
        """The feed variables' names in slot order (without the
        ``@LEN`` companions)."""
        return tuple(v.name for v in self.feed_vars)

    def feed(self, iterable) -> Dict[str, np.ndarray]:
        """Rows of tuples (one slot per feed variable) to a feed dict."""
        rows = list(iterable)
        enforce(rows, "empty minibatch")
        out: Dict[str, np.ndarray] = {}
        for i, var in enumerate(self.feed_vars):
            col = [r[i] for r in rows]
            if var.lod_level >= 2:
                padded, lens1, lens0 = self._pad_nested(col, var)
                out[var.name] = padded
                out[var.name + "@LEN"] = lens1
                out[var.name + "@LEN0"] = lens0
                continue
            if var.lod_level > 0:
                out[var.name], out[var.name + "@LEN"] = self._pad(col, var)
                continue
            arr = np.asarray(col)
            if var.shape is not None and len(var.shape) > arr.ndim:
                arr = arr.reshape(arr.shape + (1,) *
                                  (len(var.shape) - arr.ndim))
            out[var.name] = arr.astype(_host_dtype(var))
        return out

    def _pad(self, col, var):
        """A 1-level slot: ``[B, T, ...]`` zero-padded to the bucketed
        longest length, and the lengths ``[B]`` int32. Ids declared with
        a per-step ``[1]`` shape get that trailing axis."""
        seqs = [np.asarray(s) for s in col]
        maxlen = _round_up(max(s.shape[0] for s in seqs))
        tail = seqs[0].shape[1:]
        if not tail and var.shape is not None and len(var.shape) >= 3:
            tail = (1,)
            seqs = [s.reshape(-1, 1) for s in seqs]
        padded = np.zeros((len(seqs), maxlen) + tail, dtype=_host_dtype(var))
        lens = np.zeros((len(seqs),), np.int32)
        for j, s in enumerate(seqs):
            padded[j, :s.shape[0]] = s
            lens[j] = s.shape[0]
        return padded, lens

    def _pad_nested(self, col, var):
        """A 2-level slot: each row holds a list of sequences (or a
        one-example 2-level LoDTensor). Pads to ``[B, S, T, ...]``, S
        rounded up to a multiple of 4 and T to a multiple of
        ``PAD_BUCKET``, and fills both length companions."""
        from .lod_tensor import LoDTensor, pad_nested_groups

        groups = []
        for ex in col:
            if isinstance(ex, LoDTensor):
                enforce(ex.lod_level == 2,
                        "2-level feed slot needs 2-level LoDTensors")
                enforce(ex.data.shape[0] == 1,
                        "a 2-level LoDTensor fed as one row must hold "
                        "exactly one example (got batch %d); feed a "
                        "whole-batch LoDTensor directly, not via "
                        "DataFeeder rows" % ex.data.shape[0])
                n = int(ex.outer_lengths[0])
                groups.append([np.asarray(ex.data[0, s, :ex.lengths[0, s]])
                               for s in range(n)])
            else:
                groups.append([np.asarray(s) for s in ex])
        flat = [s for ex in groups for s in ex]
        enforce(flat, "empty 2-level minibatch")
        if not flat[0].shape[1:] and var.shape is not None \
                and len(var.shape) >= 4:
            groups = [[s.reshape(-1, 1) for s in ex] for ex in groups]
        return pad_nested_groups(
            groups, dtype=_host_dtype(var),
            s_max=_round_up(max(len(ex) for ex in groups), 4),
            t_max=_round_up(max(s.shape[0] for s in flat)))

    def feed_parallel(self, iterable_list, num_places=None):
        """One feed dict per device (reference: data_feeder.py:197)."""
        return [self.feed(it) for it in iterable_list]


def _host_dtype(var):
    """numpy has no bfloat16: such a slot stays float32 on the host and
    the executor casts it on the card."""
    return var.dtype if isinstance(var.dtype, np.dtype) else np.float32
