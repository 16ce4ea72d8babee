"""Named device meshes over the ranks of a ``torch.distributed`` world
(counterpart of paddle_tpu/sharding/mesh.py).

The JAX package names its parallelism axes on a ``jax.sharding.Mesh``
of devices that one process drives. The port is multi-controller: one
process per card, every process runs the same program, and a mesh is a
row-major grid of the world's ranks. Rank ``r`` sits at the coordinate
the JAX package gives device ``r`` of its device list, so a spec
resolves to the same block of a tensor on both. The process groups
(one per axis) come from ``torch.distributed.device_mesh.
init_device_mesh`` the first time a sharded run needs them; until then
a mesh is a shape, which is all spec resolution, the compile-cache
stamp and the liveness report read — so a mesh of any size can be
built (``make_mesh(..., devices=range(8))``) in one process.

Canonical axis names (used throughout the framework):
  ``data``  pure data parallel      (params replicated along it)
  ``fsdp``  fully-sharded data parallel (params and optimizer state
            sharded along it, gathered for compute)
  ``tp``    tensor parallel         (weight columns/rows sharded)
plus the legacy axes of the parallel/ tier: ``dp`` (data parallel),
``pp`` (pipeline), ``sp`` (sequence), ``ep`` (expert/embedding) and
``mp`` (the tensor-parallel axis of ``models.transformer(tp=True)``).

A sharding is a :class:`Layout`: the mesh and a PartitionSpec-style
tuple (axis names, tuples of axis names, or None per dimension).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..core.trace_ctx import current_mesh, mesh_scope  # noqa: F401

# outer -> inner, as the JAX package lays its device grid out: tp
# innermost (its collectives between neighbouring ranks), pp outermost
AXIS_ORDER = ("pp", "data", "dp", "ep", "sp", "fsdp", "tp")

# the axes of the canonical DP x FSDP x TP training mesh
DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TP_AXIS = "tp"


class Layout:
    """Where a tensor lives on a mesh: ``spec`` holds one entry per
    leading dimension (an axis name, a tuple of axis names whose product
    splits the dimension, first name major, or None), the port's
    ``NamedSharding``."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: "DeviceMesh", spec: Sequence = ()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __eq__(self, other):
        return (isinstance(other, Layout) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __hash__(self):
        return hash((id(self.mesh), self.spec))

    def __repr__(self):
        return "Layout(%r)" % (self.spec,)


def _world() -> Tuple[int, int]:
    """(world size, rank) of the initialized default group, else (1, 0)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DeviceMesh:
    """A named mesh of ranks plus convenience layout constructors."""

    def __init__(self, names: Sequence[str], sizes: Sequence[int],
                 devices: Sequence):
        self._names = tuple(names)
        self._sizes = tuple(int(s) for s in sizes)
        self.devices = tuple(devices)
        self._torch_mesh = None

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self._names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self._names, self._sizes))

    def size(self, axis: Optional[str] = None) -> int:
        if axis is None:
            return int(np.prod(self._sizes, dtype=np.int64))
        return self.shape.get(axis, 1)

    def sharding(self, *spec) -> Layout:
        """A Layout from a spec, dropping axes this mesh lacks."""
        clean = []
        for entry in spec:
            if entry is None:
                clean.append(None)
            elif isinstance(entry, (tuple, list)):
                kept = tuple(a for a in entry if a in self._names)
                clean.append(kept if kept else None)
            else:
                clean.append(entry if entry in self._names else None)
        return Layout(self, clean)

    def replicated(self) -> Layout:
        return Layout(self, ())

    def data_axes(self) -> Tuple[str, ...]:
        """The data-like axes present (``data``, ``dp``, ``fsdp``): a
        batch is split over them jointly, in this order."""
        return tuple(a for a in (DATA_AXIS, "dp", FSDP_AXIS)
                     if a in self._names)

    def data_sharding(self, ndim: int = 1) -> Layout:
        """Batch-dim layout over all data-like axes present: leading dim
        split, rest replicated (under FSDP the batch is split over data
        x fsdp jointly, the ZeRO convention)."""
        axes = self.data_axes()
        return Layout(self, [axes if axes else None] + [None] * (ndim - 1))

    def batch_size_multiple(self) -> int:
        """Product of the data-like axis sizes — global batch extents
        must be divisible by this for the batch sharding to apply."""
        return int(np.prod([self.size(a)
                            for a in (DATA_AXIS, "dp", FSDP_AXIS)]))

    # -- the ranks' side ------------------------------------------------
    @property
    def live(self) -> bool:
        """Whether this process runs as one rank of the mesh: a
        ``torch.distributed`` world of exactly the mesh's ranks."""
        world, _ = _world()
        return world > 1 and world == self.size() \
            and tuple(self.devices) == tuple(range(world))

    def coordinate(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Axis -> index of ``rank`` (default: this process's)."""
        if rank is None:
            rank = _world()[1]
        idx = np.unravel_index(self.devices.index(rank), self._sizes)
        return {a: int(i) for a, i in zip(self._names, idx)}

    def index(self, axes: Sequence[str],
              rank: Optional[int] = None) -> Tuple[int, int]:
        """(index, count) of this rank's block along ``axes`` taken
        jointly, the first axis major — the block a spec entry naming
        ``axes`` gives it."""
        coord = self.coordinate(rank)
        idx, count = 0, 1
        for a in axes:
            idx = idx * self.size(a) + coord.get(a, 0)
            count *= self.size(a)
        return idx, count

    @property
    def torch_mesh(self):
        """The ``torch.distributed.device_mesh.DeviceMesh`` of this
        mesh's process groups, made on first use (every rank must reach
        it: making the groups is collective)."""
        if self._torch_mesh is None:
            import torch.distributed as dist
            from torch.distributed.device_mesh import init_device_mesh

            if not self.live:
                raise RuntimeError(
                    "mesh %s needs a torch.distributed world of %d ranks "
                    "(call parallel.init_distributed first)"
                    % (self.shape, self.size()))
            kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
            self._torch_mesh = init_device_mesh(
                kind, self._sizes, mesh_dim_names=self._names)
        return self._torch_mesh

    def group(self, axis: str):
        """The process group of this rank's neighbours along ``axis``."""
        return self.torch_mesh.get_group(axis)

    def __repr__(self):
        return f"DeviceMesh({self.shape})"

    def __enter__(self):
        self._cm = mesh_scope(self)
        return self._cm.__enter__()

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None,
              **axis_sizes: int) -> DeviceMesh:
    """Build a DeviceMesh. ``make_mesh(data=2, fsdp=2, tp=2)`` or
    ``make_mesh({"dp": 8})``.

    ``devices`` are the ranks (default: every rank of the initialized
    world, or one). Axis sizes must multiply to their count; a single
    ``-1`` axis absorbs the remainder. Axes are laid out in
    :data:`AXIS_ORDER` (custom axes last), rank order row-major over
    them, as the JAX package reshapes its device list."""
    sizes = dict(axes or {})
    sizes.update(axis_sizes)
    devs = list(devices if devices is not None
                else range(_world()[0]))
    n = len(devs)
    unknown = [a for a, s in sizes.items() if s == -1]
    known = int(np.prod([s for s in sizes.values() if s != -1])) if sizes else 1
    if unknown:
        if len(unknown) > 1:
            raise ValueError("at most one axis may be -1")
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[unknown[0]] = n // known
    elif not sizes:
        sizes = {"dp": n}
    total = int(np.prod(list(sizes.values())))
    if total != n:
        raise ValueError(f"mesh {sizes} needs {total} devices, have {n}")
    names = [a for a in AXIS_ORDER if a in sizes]
    names += [a for a in sizes if a not in names]  # custom axes last
    return DeviceMesh(names, [sizes[a] for a in names], devs)


def training_mesh(data: int = 1, fsdp: int = -1, tp: int = 1,
                  devices: Optional[Sequence] = None) -> DeviceMesh:
    """The canonical DP x FSDP x TP mesh for ``shard_program``. Default:
    all parallelism on the ``fsdp`` axis (ZeRO over every rank)."""
    return make_mesh({DATA_AXIS: data, FSDP_AXIS: fsdp, TP_AXIS: tp},
                     devices=devices)


def data_parallel_mesh(n_devices: Optional[int] = None) -> DeviceMesh:
    devs = list(range(_world()[0]))
    if n_devices is not None:
        devs = devs[:n_devices]
    return make_mesh({"dp": len(devs)}, devices=devs)


def sharding_for(x, *spec):
    """The JAX package pins ``x``'s layout here with
    ``with_sharding_constraint``; in the port a run's activations are
    already its rank's block (the batch split at the feed, the tensor-
    parallel ``fc`` outputs), so this returns ``x``."""
    del spec
    return x


def local_batch_slice(global_batch: int, mesh: DeviceMesh,
                      process_index: Optional[int] = None) -> slice:
    """Deterministic per-process shard of a global batch (the
    reference's split feeding, parallel_executor.cc:260-277
    FeedAndSplitTensorIntoLocalScopes). A process is one rank of
    ``mesh``: the batch is cut over the mesh's data-like axes only, so
    the ranks of its ``pp``, ``sp``, ``ep`` or tensor axes that share a
    data index get the same block. Without a mesh (or data axes) it is
    cut over the world's processes."""
    nproc, rank = _world()
    pid = rank if process_index is None else process_index
    if mesh is not None and mesh.data_axes():
        pid, nproc = mesh.index(mesh.data_axes(), pid)
    if global_batch % nproc:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{nproc} processes")
    per = global_batch // nproc
    return slice(pid * per, (pid + 1) * per)
