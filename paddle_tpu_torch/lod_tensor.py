"""LoDTensor helpers (counterpart of paddle_tpu/lod_tensor.py, a copy of
its numpy code; reference: python/paddle/fluid/lod_tensor.py
create_lod_tensor/create_random_int_lodtensor and the LoDTensor type,
framework/lod_tensor.h:110, whose ``LoD`` is a vector of offset levels).

Ragged data lives as a padded dense array plus length companions (the
``@LEN``/``@LEN0`` vars the DataFeeder fills):

* level-1: data [B, T, ...] + lengths [B]
* level-2: data [B, S, T, ...] + (outer_lengths [B] — inner sequences
  per example — and inner lengths [B, S], zero past outer_lengths[b]).

``LoDTensor`` is the host-side carrier of these pairs/triples, accepted
by feeds wherever they are expected; ``lod()`` converts back to the
reference's offset-table convention (level 0 offsets index into level 1,
level 1 offsets into the flat token axis)."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["LoDTensor", "LoDTensorArray", "create_lod_tensor",
           "create_random_int_lodtensor"]


class LoDTensor:
    """Padded array + per-level length companions.

    Depth-N carrier (reference ``LoD`` nests arbitrarily,
    framework/lod_tensor.h:58): ``level_lengths[i]`` has shape
    ``[B, S1..Si]`` and holds child counts (levels 0..N-2) or leaf
    sequence lengths (level N-1). The common 1/2-level cases keep the
    ``lengths`` / ``outer_lengths`` field names the DataFeeder and
    sequence ops consume; deeper nesting is a host-side data-carrier
    capability (build/convert/feed through ``__array__``) — the sequence
    OP tier operates on <=2 levels by design."""

    def __init__(self, data: np.ndarray, lengths: Sequence[int],
                 outer_lengths: Optional[Sequence[int]] = None,
                 level_lengths: Optional[List[np.ndarray]] = None):
        self.data = np.asarray(data)
        if level_lengths is not None:
            self.level_lengths = [np.asarray(l, np.int32)
                                  for l in level_lengths]
            self.lengths = self.level_lengths[-1]
            self.outer_lengths = (self.level_lengths[0]
                                  if len(self.level_lengths) == 2 else None)
            return
        self.lengths = np.asarray(lengths, np.int32)
        self.outer_lengths = (None if outer_lengths is None
                              else np.asarray(outer_lengths, np.int32))
        if self.outer_lengths is not None and self.lengths.ndim != 2:
            raise ValueError(
                "2-level LoDTensor needs lengths shaped [B, S] "
                f"(got {self.lengths.shape})")
        self.level_lengths = ([self.lengths] if self.outer_lengths is None
                              else [self.outer_lengths, self.lengths])

    @property
    def lod_level(self) -> int:
        return len(self.level_lengths)

    def _valid_indices(self, level: int):
        """Index tuples of the ragged-valid nodes at ``level`` (padding
        slots past a parent's count are excluded)."""
        if level == 0:
            return [(b,) for b in range(self.level_lengths[0].shape[0])]
        out = []
        for idx in self._valid_indices(level - 1):
            for j in range(int(self.level_lengths[level - 1][idx])):
                out.append(idx + (j,))
        return out

    def lod(self) -> List[List[int]]:
        """Offset-table view (reference LoD convention: each level's
        offsets index into the next level's entries,
        framework/lod_tensor.h:58 — any depth)."""
        tables = []
        for level in range(len(self.level_lengths)):
            offs = [0]
            for idx in self._valid_indices(level):
                offs.append(offs[-1] + int(self.level_lengths[level][idx]))
            tables.append(offs)
        return tables

    def recursive_sequence_lengths(self) -> List[List[int]]:
        return [[int(self.level_lengths[level][idx])
                 for idx in self._valid_indices(level)]
                for level in range(len(self.level_lengths))]

    def __array__(self, dtype=None):
        return self.data.astype(dtype) if dtype else self.data

    def shape(self):
        return tuple(self.data.shape)

    def __repr__(self):
        if self.outer_lengths is None:
            return (f"LoDTensor(shape={tuple(self.data.shape)}, "
                    f"lengths={list(map(int, self.lengths))})")
        return (f"LoDTensor(shape={tuple(self.data.shape)}, "
                f"outer={list(map(int, self.outer_lengths))})")


LoDTensorArray = list    # reference: vector<LoDTensor>; plain list here


def _pad_level1(seqs, dtype=None):
    lens = [len(s) for s in seqs]
    maxlen = max(lens) if lens else 0
    tail = seqs[0].shape[1:] if seqs else ()
    padded = np.zeros((len(seqs), maxlen) + tail,
                      seqs[0].dtype if seqs else (dtype or np.float32))
    for i, s in enumerate(seqs):
        padded[i, : len(s)] = s
    return padded, lens


def pad_nested_groups(groups, dtype=None, s_max=None, t_max=None):
    """Shared 2-level padding: ``groups`` is a list (per example) of
    lists of sequences. Returns (padded [B, S, T, *tail],
    inner_lengths [B, S] int32, outer_lengths [B] int32). ``s_max`` /
    ``t_max`` override the batch maxima (the DataFeeder bucket-rounds
    them, so padded shapes and captured graphs repeat)."""
    flat = [s for ex in groups for s in ex]
    B = len(groups)
    S = s_max if s_max is not None else max(
        (len(ex) for ex in groups), default=0)
    T = t_max if t_max is not None else max(
        (len(s) for s in flat), default=0)
    tail = flat[0].shape[1:] if flat else ()
    dt = dtype if dtype is not None else (
        flat[0].dtype if flat else np.float32)
    padded = np.zeros((B, S, T) + tail, dt)
    lens1 = np.zeros((B, S), np.int32)
    lens0 = np.zeros((B,), np.int32)
    for b, ex in enumerate(groups):
        lens0[b] = len(ex)
        for s, seq in enumerate(ex):
            padded[b, s, : len(seq)] = seq
            lens1[b, s] = len(seq)
    return padded, lens1, lens0


def pad_nested_any(data, levels: int, dtype=None):
    """Depth-N generalization of :func:`pad_nested_groups`: ``data`` is a
    depth-``levels`` nested list whose leaves are sequences. Returns
    (padded [B, S1..S_{N-1}, T, *tail], level_lengths) matching the
    :class:`LoDTensor` layout."""
    maxs = [0] * (levels + 1)
    leaves: List[np.ndarray] = []

    def walk(node, d):
        if d == levels:
            arr = np.asarray(node)
            leaves.append(arr)
            maxs[levels] = max(maxs[levels], arr.shape[0])
            return
        maxs[d] = max(maxs[d], len(node))
        for c in node:
            walk(c, d + 1)

    for ex in data:
        walk(ex, 1)
    B = len(data)
    dims = [B] + [maxs[d] for d in range(1, levels + 1)]
    tail = leaves[0].shape[1:] if leaves else ()
    dt = dtype if dtype is not None else (
        leaves[0].dtype if leaves else np.float32)
    padded = np.zeros(tuple(dims) + tail, dt)
    lens = [np.zeros(tuple(dims[:i + 1]), np.int32)
            for i in range(levels)]

    def fill(node, d, idx):
        if d == levels:
            arr = np.asarray(node)
            padded[idx + (slice(0, arr.shape[0]),)] = arr
            lens[levels - 1][idx] = arr.shape[0]
            return
        lens[d - 1][idx] = len(node)
        for j, c in enumerate(node):
            fill(c, d + 1, idx + (j,))

    for b, ex in enumerate(data):
        fill(ex, 1, (b,))
    return padded, lens


def _unflatten_by_levels(flat_seqs, level_counts):
    """Regroup a flat sequence list by per-level counts (outermost
    first): the inverse of the reference's flattened-LoD layout."""
    seqs = flat_seqs
    for counts in reversed(level_counts):
        grouped, k = [], 0
        for c in counts:
            grouped.append(seqs[k:k + int(c)])
            k += int(c)
        seqs = grouped
    return seqs


def create_lod_tensor(data, recursive_seq_lens, place=None) -> LoDTensor:
    """reference: lod_tensor.py create_lod_tensor — build from nested
    sequence lists (any depth) or a flat array + per-level lengths."""
    levels = len(recursive_seq_lens)
    if levels >= 2:
        if isinstance(data, (list, tuple)):
            nested = data
        else:
            flat = np.asarray(data)
            flat_seqs, off = [], 0
            for n in list(recursive_seq_lens[-1]):
                flat_seqs.append(flat[off:off + n])
                off += n
            # group by every level above the innermost (outermost first)
            nested = _unflatten_by_levels(flat_seqs,
                                          recursive_seq_lens[:-1])
        padded, lens = pad_nested_any(nested, levels)
        return LoDTensor(padded, None, level_lengths=lens)

    lens = list(recursive_seq_lens[-1])
    if isinstance(data, (list, tuple)):
        padded, lens = _pad_level1([np.asarray(s) for s in data])
        return LoDTensor(padded, lens)
    flat = np.asarray(data)
    maxlen = max(lens) if lens else 0
    tail = flat.shape[1:]
    padded = np.zeros((len(lens), maxlen) + tail, flat.dtype)
    off = 0
    for i, n in enumerate(lens):
        padded[i, :n] = flat[off:off + n]
        off += n
    return LoDTensor(padded, lens)


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place,
                                low, high) -> LoDTensor:
    """reference: lod_tensor.py create_random_int_lodtensor."""
    rng = np.random.RandomState(0)
    if len(recursive_seq_lens) >= 2:
        seqs = [rng.randint(low, high + 1,
                            size=(n,) + tuple(base_shape)).astype("int64")
                for n in recursive_seq_lens[-1]]
        nested = _unflatten_by_levels(seqs, recursive_seq_lens[:-1])
        return create_lod_tensor(nested, recursive_seq_lens, place)
    lens = list(recursive_seq_lens[-1])
    seqs = [rng.randint(low, high + 1,
                        size=(n,) + tuple(base_shape)).astype("int64")
            for n in lens]
    return create_lod_tensor(seqs, recursive_seq_lens, place)
