"""Pipeline parallelism over a ``pp`` mesh axis (counterpart of
paddle_tpu/parallel/pipeline.py).

Stage weights live stacked, their leading (layer) dimension split over
``pp``: the rank of stage ``s`` of ``S`` holds layers
``[s * L / S, (s + 1) * L / S)``. A GPipe schedule of ``M + S - 1``
ticks runs the microbatches through the stages, a neighbour permute
(``sharding/comm.py``) carrying each stage's output to the next stage
between ticks. The JAX package writes the schedule as a ``lax.scan``
and lets ``jax.grad`` reverse it; here the schedule is one autograd
function whose backward runs the reverse schedule itself — each tick's
stage backward, then the reverse permute of its input's gradient — so
every rank of the axis enters the same collectives in the same order
whatever order autograd would pick (a permute is one collective every
rank enters: a rank whose received block fed nothing would otherwise
never enter its backward, and its neighbour would wait for it).

A stage computes only at the ticks that carry one of its microbatches
(the JAX schedule also runs the stage body on the bubble's zeros and
discards the result). The last stage's outputs are handed to every
rank of the axis: the rest of the program runs alike on each of them,
as on the JAX side, and the gradient flowing back is that one copy's,
not the sum of the ranks' (which would count it ``S`` times). The
input's gradient, which only stage 0 computes, is summed over the axis,
so each rank's upstream gradient is one device's.

On a mesh without ``pp`` one :func:`_sequential` call over the whole
stack gives the same numbers: ``stage_fn`` folds its leading layer
dimension itself.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..sharding import comm


def _stage(mesh, axis):
    """(stage index, stage count, group) of this rank along ``axis``."""
    s, n = mesh.index((axis,))
    return s, n, mesh.group(axis)


class _GPipe(torch.autograd.Function):
    """The schedule on this rank: ``(sched, x_mb, n_params, *params,
    *sides)`` -> ``[M, mb, ...]``, the last stage's outputs on every
    rank. ``sched`` holds the stage function, the stage and the group."""

    @staticmethod
    def forward(ctx, sched, x_mb, n_params, *rest):
        fn, s, S, group = sched
        params = [p.detach().requires_grad_(p.requires_grad)
                  for p in rest[:n_params]]
        sides = rest[n_params:]
        M = x_mb.shape[0]
        ticks = []
        prev = None
        outs = []
        with torch.enable_grad():
            for t in range(M + S - 1):
                m = t - s
                out = None
                if 0 <= m < M:
                    src = x_mb[m] if s == 0 else prev
                    inp = src.detach().requires_grad_(
                        x_mb.requires_grad or s > 0)
                    out = fn(params, inp, *(sv[m] for sv in sides))
                    ticks.append((t, inp, out))
                    if s == S - 1:
                        outs.append(out.detach())
                if t < M + S - 2:
                    send = out.detach() if out is not None \
                        else torch.zeros_like(x_mb[0])
                    prev = comm.permute(send, group, 1)
        y = torch.stack(outs) if s == S - 1 else \
            torch.zeros_like(x_mb)
        y = comm.all_reduce(y, group)  # the last stage's, everywhere
        ctx.sched, ctx.ticks, ctx.params = sched, ticks, params
        ctx.n_params, ctx.x_shape = n_params, x_mb.shape
        ctx.x_grad = x_mb.requires_grad
        ctx.n_sides = len(sides)
        return y

    @staticmethod
    def backward(ctx, gy):
        _fn, s, S, group = ctx.sched
        ticks = {t: (inp, out) for t, inp, out in ctx.ticks}
        params = ctx.params
        M = ctx.x_shape[0]
        want = [p for p in params if p.requires_grad]
        pgrads = [None] * len(params)
        gx = torch.zeros(ctx.x_shape, dtype=gy.dtype, device=gy.device) \
            if ctx.x_grad else None
        g_inp = None  # this stage's input gradient from the tick after
        for t in reversed(range(M + S - 1)):
            g_out = None
            if t < M + S - 2:
                send = g_inp if g_inp is not None else torch.zeros(
                    ctx.x_shape[1:], dtype=gy.dtype, device=gy.device)
                g_out = comm.permute(send, group, -1)
            g_inp = None
            if t not in ticks:
                continue
            inp, out = ticks.pop(t)
            m = t - s
            if s == S - 1:
                g_out = gy[m]
            xs = [inp] if inp.requires_grad else []
            got = torch.autograd.grad(out, xs + want,
                                      g_out.to(out.dtype),
                                      allow_unused=True)
            if xs:
                g_inp = got[0]
                if s == 0 and gx is not None:
                    gx[m] = g_inp.to(gx.dtype)
                    g_inp = None
            k = len(xs)
            for j, p in enumerate(params):
                if not p.requires_grad:
                    continue
                g = got[k]
                k += 1
                if g is not None:
                    pgrads[j] = g if pgrads[j] is None else pgrads[j] + g
        if gx is not None:
            gx = comm.all_reduce(gx, group)
        pgrads = [torch.zeros_like(p) if g is None and p.requires_grad
                  else g for p, g in zip(params, pgrads)]
        ctx.ticks = None
        return (None, gx, None) + tuple(pgrads) + (None,) * ctx.n_sides


def gpipe(stage_fn: Callable, stacked_params, x_mb, mesh, axis: str = "pp",
          side_mb: Sequence = (), param_specs=None, local: bool = False):
    """Run ``S = mesh.size(axis)`` pipeline stages over microbatches.

    ``stage_fn(params, x, *side) -> y`` (shape-preserving on ``x``):
    ``params`` keep a leading layer dim ``[k, ...]`` and ``stage_fn``
    folds over it, which is what makes the no-pp fallback (one call
    with the whole stack) the same math as the schedule.
    ``stacked_params``: a sequence of tensors, each ``[L, ...]``;
    ``local=True`` when they are already this stage's blocks (a sharded
    run hands the pipelined encoder its blocks), else whole: each rank
    cuts its stage's block, and the whole tensor's gradient is summed
    over the axis. ``x_mb``: ``[M, mb, ...]`` (:func:`microbatch`);
    ``side_mb``: per-microbatch inputs ``[M, ...]`` without gradients
    (a mask, per-microbatch seeds). ``param_specs`` is the JAX
    package's: a rank holds its ``mp`` blocks already, so they pass
    through (the stage body runs the matching collectives).

    Returns ``[M, mb, ...]``. Without the axis (or off a live mesh) it
    is :func:`_sequential`."""
    del param_specs
    side_mb = tuple(side_mb)
    params = list(stacked_params) if isinstance(
        stacked_params, (list, tuple)) else [stacked_params]
    single = not isinstance(stacked_params, (list, tuple))
    if mesh is None or mesh.size(axis) <= 1 or not mesh.live:
        return _sequential(stage_fn, stacked_params, x_mb, side_mb)
    s, S, group = _stage(mesh, axis)
    if not local:
        blocks = []
        for p in params:
            k = p.shape[0] // S
            blocks.append(comm.CopyToGroup.apply(p, group)[s * k:(s + 1) * k])
        params = blocks

    def fn(ps, x, *side):
        return stage_fn(ps[0] if single else tuple(ps), x, *side)

    return _GPipe.apply((fn, s, S, group), x_mb, len(params), *params,
                        *side_mb)


def _sequential(stage_fn, stacked_params, x_mb, side_mb=()):
    """No-pp fallback: ``stage_fn`` folds its leading layer dim itself,
    so one call with the WHOLE stack per microbatch is the same math."""
    M = x_mb.shape[0]
    outs = [stage_fn(stacked_params, x_mb[m], *(sv[m] for sv in side_mb))
            for m in range(M)]
    return torch.stack(outs, dim=0)


def microbatch(x, n_microbatches: int):
    """``[B, ...]`` -> ``[M, B / M, ...]`` (the GPipe input layout)."""
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError(
            f"batch {B} not divisible by n_microbatches={n_microbatches}")
    return x.reshape((n_microbatches, B // n_microbatches)
                     + tuple(x.shape[1:]))


def unmicrobatch(y):
    return y.reshape((-1,) + tuple(y.shape[2:]))
