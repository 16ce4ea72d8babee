"""The port's one communication module: the collectives a sharded run
issues, each rank's block of a tensor under a spec, and the two
autograd functions of tensor parallelism.

The JAX package never issues a collective itself: XLA's SPMD
partitioner derives them from the layouts. The port is
multi-controller, so its sharded runs call these over the process
groups of a :class:`~.mesh.DeviceMesh` (one group per axis).

Backends. NCCL takes every collective natively, and so does gloo with
tensors on a card (two ranks sharing one card, where NCCL refuses a
duplicate GPU) for the three used here. Gloo has no averaging
reduction, so a mean is always a sum and a division.

A permute (the JAX package's ``lax.ppermute``: the pipeline's
activations stage to stage, and their gradients back) is one collective every rank of the axis enters
together (:func:`route`, :func:`permute`), so no order of blocking sends
and receives can deadlock: over NCCL a batch of point-to-point sends
and receives, elsewhere an all-gather from which each rank keeps the
block meant for it (:func:`permute_transport` says which; the
all-gather moves the group's size times the bytes a point-to-point pair
would). Gloo's ``send`` of a CUDA tensor is no option: on the card it
aborted the process.

:data:`STATS` counts the collectives and the bytes each rank hands
them (its input tensors' bytes), by op, for the per-step traffic the
chip script prints; :func:`reset_stats` zeroes it.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Sequence, Tuple

import torch

# torch 2.13 renames the *_into_tensor / *_tensor collectives; the old
# names work on every version the port runs on
warnings.filterwarnings("ignore", message=r".*(all_gather_into_tensor|"
                        r"reduce_scatter_tensor).*deprecated")

STATS: Dict[str, List[int]] = {}


def reset_stats() -> None:
    STATS.clear()


def stats_bytes() -> int:
    """Bytes handed to collectives since the last :func:`reset_stats`."""
    return sum(v[1] for v in STATS.values())


def _note(op: str, t: torch.Tensor) -> None:
    entry = STATS.setdefault(op, [0, 0])
    entry[0] += 1
    entry[1] += t.numel() * t.element_size()


def permute_transport(group) -> str:
    """How :func:`permute` moves blocks over ``group``'s backend:
    ``"p2p"`` (NCCL's batched sends and receives) or ``"all_gather"``
    (gloo, and any other backend)."""
    import torch.distributed as dist

    return "p2p" if dist.get_backend(group) == "nccl" else "all_gather"


def route(t: torch.Tensor, group, dst: Sequence) -> torch.Tensor:
    """Every rank ``i`` of ``group`` hands ``t`` to rank ``dst[i]`` (None:
    to no one); returns the block handed to this rank, zeros when no
    rank hands it one (a new tensor). ``dst`` is the same on every rank,
    and every rank of the group must call it."""
    import torch.distributed as dist

    i = dist.get_rank(group)
    src = t.detach().contiguous()
    _note("permute", src)
    frm = dst.index(i) if i in dst else None
    if permute_transport(group) == "p2p":
        out = torch.zeros_like(src)
        ranks = dist.get_process_group_ranks(group)
        ops = []
        if dst[i] is not None:
            ops.append(dist.P2POp(dist.isend, src, ranks[dst[i]], group))
        if frm is not None:
            ops.append(dist.P2POp(dist.irecv, out, ranks[frm], group))
        for w in (dist.batch_isend_irecv(ops) if ops else ()):
            w.wait()
        return out
    flat = src.reshape(1, -1)
    everyone = torch.empty((len(dst), flat.shape[1]), dtype=src.dtype,
                           device=src.device)
    dist.all_gather_into_tensor(everyone, flat, group=group)
    if frm is None:
        return torch.zeros_like(src)
    return everyone[frm].reshape(src.shape).clone()


def permute(t: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """The block of the rank ``shift`` places before this one in
    ``group``'s order: every rank hands ``t`` to the rank ``shift`` after
    it (:func:`route`); a rank with no such neighbour receives zeros,
    and the blocks of the ranks with none after them go nowhere."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    dst = [i + shift if 0 <= i + shift < n else None for i in range(n)]
    return route(t, group, dst)


def all_reduce(t: torch.Tensor, group, mean: bool = False) -> torch.Tensor:
    """The sum (or mean) of ``t`` over ``group``, a new tensor."""
    import torch.distributed as dist

    out = t.detach().clone().contiguous()
    _note("all_reduce", out)
    dist.all_reduce(out, group=group)
    if mean:
        out.div_(dist.get_world_size(group))
    return out


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in group rank order."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    src = t.detach().movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _note("all_gather", src)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0,
                   mean: bool = False) -> torch.Tensor:
    """This rank's block (along ``dim``) of the sum (or mean) of ``t``
    over ``group``; ``t.shape[dim]`` must divide by the group's size."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    src = t.detach().movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _note("reduce_scatter", src)
    dist.reduce_scatter_tensor(out, src, group=group)
    if mean:
        out.div_(n)
    return out.movedim(0, dim)


# -- blocks of a tensor under a spec ---------------------------------------

def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def local_slices(shape: Sequence[int], spec: Sequence, mesh,
                 rank=None) -> Tuple[slice, ...]:
    """This rank's block of a tensor of ``shape`` under a cleaned
    ``spec``: one slice per dimension."""
    out = []
    for d, size in enumerate(shape):
        axes = _axes(spec[d]) if d < len(spec) else ()
        if not axes:
            out.append(slice(None))
            continue
        i, n = mesh.index(axes, rank)
        per = int(size) // n
        out.append(slice(i * per, (i + 1) * per))
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Sequence, mesh) -> tuple:
    out = []
    for d, size in enumerate(shape):
        axes = _axes(spec[d]) if d < len(spec) else ()
        n = 1
        for a in axes:
            n *= mesh.size(a)
        out.append(int(size) // n)
    return tuple(out)


def take_local(full: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """This rank's block of a whole tensor, as a tensor of its own (a
    copy: a view would keep the whole tensor alive, and could start off
    the 16-byte alignment of the kernels' vectors)."""
    if not any(spec):
        return full
    return full[local_slices(full.shape, spec, mesh)].clone()


def gather_full(local: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """The whole tensor from each rank's block under ``spec`` (one
    all-gather per sharded axis, innermost axis first)."""
    out = local
    for d, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            if mesh.size(a) > 1:
                out = all_gather(out, mesh.group(a), dim=d)
    return out


# -- tensor parallelism ----------------------------------------------------

class CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over the group. Where a
    replicated activation enters a column-parallel product, each rank's
    gradient for it holds only its columns' share."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class ReduceFromGroup(torch.autograd.Function):
    """The sum over the group forward (the partial products of a
    row-parallel product); identity backward, the gradient of a
    replicated output being the same on every rank."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class SumOverBatch(torch.autograd.Function):
    """The sum over a data-parallel group forward (a reduction of the
    rank's batch block made the whole batch's); the gradient times the
    group's size backward. The ranks' gradients are then averaged, so a
    term that depends on the batch gets the sum of the ranks' shares,
    and a term every rank computes alike (a penalty on the parameters
    alone) its own gradient once."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.n = dist.get_world_size(group)
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.n, None


class GatherFromGroup(torch.autograd.Function):
    """The ranks' blocks concatenated along ``dim`` forward (a
    column-parallel product whose whole output later ops read); the
    rank's block of the (replicated) gradient backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        import torch.distributed as dist

        ctx.dim = dim % x.dim()
        ctx.rank, ctx.size = dist.get_rank(group), x.shape[dim]
        return all_gather(x, group, ctx.dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size,
                        ctx.size).contiguous(), None, None


def tensor_axis(mesh):
    """``(axis, index, count)`` of the tensor-parallel axis of a live
    mesh (``mp``, else ``tp``) when it has more than one rank, else
    None."""
    if mesh is None or not mesh.live:
        return None
    for a in ("mp", "tp"):
        if mesh.size(a) > 1:
            i, n = mesh.index((a,))
            return a, i, n
    return None
