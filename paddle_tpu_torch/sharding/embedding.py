"""Sharded embedding tables — the distributed lookup table (counterpart
of paddle_tpu/sharding/embedding.py).

The table's *rows* are split over a mesh axis (``ep`` by default). A
lookup is, on each rank: mask the ids whose rows live here, gather them
from the local rows, and sum the partial results over the axis — each
id lives on exactly one rank, so the sum is the whole lookup. The JAX
package runs that body under ``shard_map`` with a ``psum``; the port's
ranks run it as they are, the sum an all-reduce whose backward passes
the (replicated) gradient through, so each rank's table gradient is
the scatter-add of its own rows.
"""

from __future__ import annotations

import torch

from .comm import ReduceFromGroup
from .mesh import DeviceMesh


def _local_lookup(table_shard, ids, mesh: DeviceMesh, axis_name: str):
    """This rank's share of the lookup: its rows for the ids it holds,
    zeros elsewhere, summed over ``axis_name``."""
    idx, _ = mesh.index((axis_name,))
    rows = table_shard.shape[0]
    local = ids.to(torch.int64) - idx * rows
    hit = (local >= 0) & (local < rows)
    got = table_shard[local.clamp(0, rows - 1)]
    got = torch.where(hit[..., None], got, torch.zeros((), dtype=got.dtype,
                                                       device=got.device))
    return ReduceFromGroup.apply(got, mesh.group(axis_name))


def sharded_lookup(table, ids, mesh: DeviceMesh, ep_axis: str = "ep",
                   dp_axis: str = "dp"):
    """Lookup ``ids`` in ``table``: on a live mesh whose ``ep_axis`` has
    more than one rank, ``table`` is this rank's block of rows (padded
    to equal blocks, :func:`shard_table_rows`) and the result is the
    whole lookup; elsewhere a plain take. Differentiable. The ids are
    this rank's (its block of the batch over ``dp_axis``, when the
    caller split it), so the lookup never gathers the batch."""
    del dp_axis
    if mesh is None or mesh.size(ep_axis) <= 1 or not mesh.live:
        return table[ids.to(torch.int64)]
    scalar = ids.dim() == 0
    if scalar:
        ids = ids[None]
    out = _local_lookup(table, ids, mesh, ep_axis)
    return out[0] if scalar else out


def shard_table_rows(vocab_size: int, mesh: DeviceMesh,
                     ep_axis: str = "ep") -> int:
    """Padded row count (tables are padded so every shard is equal-sized
    — the reference's block slicing, slice_variable
    distribute_transpiler.py:67, made static)."""
    n = max(1, mesh.size(ep_axis)) if mesh is not None else 1
    return -(-vocab_size // n) * n


class ShardedEmbedding:
    """A padded row-sharded table paired with its lookup; the
    pserver-tier 'distributed lookup table' as one object. ``table``
    holds this rank's rows on a live mesh, all of them elsewhere."""

    def __init__(self, vocab_size: int, dim: int, mesh: DeviceMesh,
                 ep_axis: str = "ep", dtype=torch.float32,
                 init_scale: float = 0.02, seed: int = 0):
        self.mesh = mesh
        self.ep_axis = ep_axis
        self.vocab_size = vocab_size
        self.padded_rows = shard_table_rows(vocab_size, mesh, ep_axis)
        gen = torch.Generator().manual_seed(int(seed))
        table = torch.randn((self.padded_rows, dim), generator=gen,
                            dtype=torch.float32).to(dtype) * init_scale
        if mesh is not None and mesh.size(ep_axis) > 1 and mesh.live:
            idx, n = mesh.index((ep_axis,))
            per = self.padded_rows // n
            table = table[idx * per:(idx + 1) * per].clone()
        self.table = table

    def lookup(self, ids):
        return sharded_lookup(self.table, ids, self.mesh, self.ep_axis)
