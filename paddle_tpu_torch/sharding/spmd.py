"""The sharded run of a program on each rank of a live mesh: the port's
counterpart of the JAX package's mesh-aware jit (``executor.py``'s plan
dispatch and ``parallel/parallel_executor.py``'s SPMD step), which one
process traces over the whole mesh and XLA partitions.

Here every rank runs the same program on its own block of the work,
with explicit collectives (``comm.py``), and keeps the JAX package's
contract: the same losses and updates as one device, within the
reduction order.

  * Feeds: a fed global batch is sliced per rank over the mesh's
    data-like axes (``data`` x ``fsdp``, or ``dp``) when every
    batch-like feed divides; otherwise every rank runs the whole batch
    (the JAX package's replicated fallback).
  * State: each rank holds its block of every tensor its layout shards
    (``spec``); a whole tensor found in the scope (after the startup
    program, a restore or ``set_var``) is placed — cut to the block and
    written back — on first use.
  * Forward and backward: parameters the forward reads are gathered
    whole (FSDP), the ops run on the rank's batch block. The weight of
    a tensor-parallel ``fc`` (``models.transformer(tp=True)``) is never
    gathered: the fc reads this rank's block of it (its columns or its
    rows over the tensor axis, cut from a replicated weight), computes
    its own columns or rows and sums over the tensor axis itself, and
    the weight's gradient is that block's.
  * Reductions over the batch: a ``mean``/``reduce_mean``/``reduce_sum``
    over every dimension of a value derived from the batch block is
    summed over the batch axes (a mean: summed and divided by their
    count) — an all-reduce whose backward multiplies the gradient by
    the ranks' count (``comm.SumOverBatch``) — so the loss is the whole
    batch's on every rank, as one device's (a token-weighted mean over
    ragged blocks included).
  * Gradients: the dense gradients are averaged over the batch axes. A
    term of the loss from the batch then gets the sum of the ranks'
    shares, and a term every rank computes alike (a penalty on the
    parameters alone, a scale applied after the reduction) its own
    gradient once. A row-sparse gradient's rows and values are
    concatenated over the batch axes, the values divided by the ranks'
    count. A loss no such reduction made global (a reduction the port
    does not know) is the rank's own: the averaged gradients are the
    data-parallel convention, and the fetched scalar is the mean of the
    ranks'.
  * Updates (ZeRO): an update op touching an accumulator held as a
    block runs on that block: its parameter and gradient are cut to
    the same block (a row-sparse gradient's rows re-based, the rows of
    other blocks dropped), and a parameter written in another layout is
    gathered and re-cut. With no such accumulator, an update of a
    parameter held as a block (a tensor-parallel weight) runs on the
    parameter's block. A flat group's update (``fuse_optimizer_state``)
    takes its gradient reduce-scattered and runs the fused kernel on
    the rank's slice of the flat buffers; the parameter slices are
    gathered back.

Each block is a tensor of its own, so a kernel's operands stay 16-byte
aligned whatever the block's offset in the whole tensor.

A mean over the batch counts each rank's block alike: blocks are equal
(the batch splits evenly or not at all), so it is the whole batch's.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..core.enforce import EnforceError, enforce
from ..core.trace_ctx import mesh_scope, remat_scope
from . import comm

_tls = threading.local()


def batch_block() -> Tuple[int, int]:
    """(index, count) of this rank's block of the batch in the active
    sharded run ((0, 1) outside one, or when the batch is whole on every
    rank): the dropout op offsets its mask by it."""
    return getattr(_tls, "batch", (0, 1))


class Resolver:
    """What a sharded run needs from its caller: the mesh, the data-like
    axes a batch splits over, and ``spec(name)`` — the cleaned spec
    each persistable is held in."""

    def __init__(self, mesh, batch_axes: Sequence[str],
                 spec: Callable[[str], tuple]):
        self.mesh = mesh
        self.batch_axes = tuple(a for a in batch_axes if mesh.size(a) > 1)
        self._spec = spec
        self._cache: Dict[str, tuple] = {}

    def spec(self, name: str) -> tuple:
        hit = self._cache.get(name)
        if hit is None:
            hit = self._cache[name] = tuple(self._spec(name))
        return hit


def _batchlike(var) -> bool:
    return var is None or var.is_data or (
        var.shape is not None and len(var.shape) > 0 and var.shape[0] == -1)


def _reduce_over(t, axes, mesh, mean):
    for a in axes:
        t = comm.all_reduce(t, mesh.group(a), mean=mean)
    return t


# full reductions a sharded run sums over the ranks' batch blocks
_SUM_REDUCTIONS = ("reduce_sum",)
_MEAN_REDUCTIONS = ("mean", "reduce_mean")


class _Run:
    """One sharded run's bookkeeping: ``env`` of values, ``local``:
    name -> spec of the values held as this rank's block, and ``full``:
    the whole tensor a block was cut from in this run."""

    def __init__(self, program, resolver: Resolver, env, split: bool):
        self.program = program
        self.gb = program.global_block()
        self.res = resolver
        self.mesh = resolver.mesh
        self.env = env
        self.local: Dict[str, tuple] = {}
        self.full: Dict[str, torch.Tensor] = {}
        self.split = split
        # values derived from this rank's batch block
        self.batch: set = set()

    def forward_post(self, op, out):
        """After a forward op: a full reduction of a batch-block value
        summed over the batch axes; which outputs derive from the batch
        block."""
        if not self.split or not any(n in self.batch
                                     for n in op.input_arg_names):
            return out
        names = op.output_arg_names
        one = len(names) == 1 and not isinstance(out, (tuple, list))
        vals = [out] if one else list(out)
        # a reduction over every dimension (``dim`` None), the batch's
        # among them
        if op.type in _SUM_REDUCTIONS + _MEAN_REDUCTIONS \
                and op.attrs.get("dim") is None \
                and all(isinstance(v, torch.Tensor) for v in vals):
            n = 1
            for a in self.res.batch_axes:
                n *= self.mesh.size(a)
            for k, v in enumerate(vals):
                for a in self.res.batch_axes:
                    v = comm.SumOverBatch.apply(v, self.mesh.group(a))
                vals[k] = v / n if op.type in _MEAN_REDUCTIONS else v
            return vals[0] if one else tuple(vals)
        self.batch.update(names)
        return out

    def var(self, name):
        return self.gb._find_var_recursive(name)

    def full_shape(self, name) -> Optional[tuple]:
        v = self.var(name)
        if v is None or v.shape is None or any(int(s) < 0 for s in v.shape):
            return None
        return tuple(int(s) for s in v.shape)

    def whole(self, name):
        """``env[name]`` whole (gathered when held as a block)."""
        from ..executor import _value

        v = _value(self.env, name)
        spec = self.local.pop(name, None)
        if spec is not None:
            v = self.env[name] = comm.gather_full(v, spec, self.mesh)
        return v

    def tp_layouts(self, fwd) -> Dict[str, tuple]:
        """name -> the block a tensor-parallel fc reads its weight in, as
        a cleaned spec (column-parallel: ``(None, axis)``, row-parallel:
        ``(axis,)``), for each weight the run holds before the forward
        and every forward reader of which is such an fc."""
        tp = comm.tensor_axis(self.mesh)
        if tp is None:
            return {}
        axis = tp[0]
        want: Dict[str, tuple] = {}
        other = set()
        for op in fwd:
            names = op.input_arg_names
            kind = op.attrs.get("_tp") if op.type == "mul" else None
            if kind in ("column", "row"):
                y = op.input("Y")[0]
                spec = (None, axis) if kind == "column" else (axis,)
                if want.setdefault(y, spec) != spec:
                    other.add(y)
                names = [n for n in names if n != y]
            other.update(names)
        return {n: s for n, s in want.items()
                if n not in other and n in self.env}

    def place(self, name, spec) -> None:
        """Hold ``env[name]`` as this rank's block under ``spec``: kept
        when held so already, else cut from the whole tensor (gathered
        first when held in another layout)."""
        if self.local.get(name) == spec:
            return
        shape = self.full_shape(name)
        enforce(shape is not None and all(
            size % n == 0 for size, n in zip(shape, (
                self.mesh.size(a) if a else 1 for a in spec))),
            "tensor-parallel weight %r of shape %s does not split into "
            "equal blocks %s over the mesh %s"
            % (name, shape, spec, self.mesh.shape))
        full = self.whole(name)
        self.env[name] = comm.take_local(full, spec, self.mesh)
        self.local[name] = spec
        self.full[name] = full

    # -- gradients -------------------------------------------------------
    def reduce_grads(self, bw, post) -> None:
        sites = bw.attrs.get("_sparse_sites", ())
        tables = list(dict.fromkeys(s[0] for s in sites))
        params = bw.input("Params")
        dense = [n for n in params if n not in tables]
        grads = bw.output("Grads")
        # gradients only a ZeRO flat group reads are reduce-scattered by
        # it; every other dense gradient is reduced here
        deferred = set()
        readers: Dict[str, int] = {}
        for op in post:
            for n in op.input_arg_names:
                readers[n] = readers.get(n, 0) + 1
            if self._flat_block(op) is not None:
                deferred.update(op.input("Grad"))
        deferred = {g for g in deferred if readers.get(g) == 1}
        axes = self.res.batch_axes if self.split else ()
        for p, g in zip(dense, grads[:len(dense)]):
            if g not in self.env:
                continue
            if p in self.local and tuple(self.env[g].shape) == tuple(
                    self.env[p].shape):
                # the gradient of the block the forward read
                self.local[g] = self.local[p]
            if g not in deferred:
                self.env[g] = _reduce_over(self.env[g], axes, self.mesh,
                                           True)
        if not axes:
            return
        n = 1
        for a in axes:
            n *= self.mesh.size(a)
        k = len(dense)
        for _ in tables:
            rows, vals = grads[k], grads[k + 1]
            self.env[rows] = comm.gather_full(self.env[rows], (axes,),
                                              self.mesh)
            self.env[vals] = comm.gather_full(self.env[vals], (axes,),
                                              self.mesh) / n
            k += 2

    # -- updates -----------------------------------------------------------
    def _acc_block(self, op) -> Optional[Tuple[str, tuple]]:
        """(name, spec) of the first accumulator ``op`` touches that this
        rank holds as a block."""
        for n in op.input_arg_names + op.output_arg_names:
            v = self.var(n)
            if n in self.local and getattr(v, "is_accumulator", False):
                return n, self.local[n]
        return None

    def _update_block(self, op) -> Optional[Tuple[str, tuple]]:
        """The block ``op`` runs on: its accumulator's, else its
        parameter's when this rank holds the parameter as a block."""
        blk = self._acc_block(op)
        if blk is None and "Param" in op.inputs:
            blk = next(((n, self.local[n]) for n in op.input("Param")
                        if n in self.local), None)
        return blk

    def _flat_block(self, op):
        if getattr(op.fn, "on_flat", None) is None:
            return None
        return self._acc_block(op)

    def run_update(self, op) -> None:
        from ..executor import run_program_ops

        if getattr(op.fn, "on_flat", None) is not None:
            blk = self._acc_block(op)
            if blk is not None:
                return self._run_flat(op, blk)
        blk = self._update_block(op)
        if blk is None:
            for n in op.input_arg_names:
                if n in self.local:
                    self.whole(n)
            run_program_ops([op], self.env)
            for n in op.output_arg_names:
                self.local.pop(n, None)
            return
        acc, spec = blk
        shape = self.full_shape(acc)
        lshape = comm.local_shape(shape, spec, self.mesh)
        ins = dict.fromkeys(op.input_arg_names)
        tmp = dict(self.env)
        values_of_rows = {}
        for n in ins:
            v = self.env.get(n)
            if not isinstance(v, torch.Tensor):
                continue
            if n in self.local:
                if self.local[n] != spec:
                    full = self.full.get(n)
                    if full is None:
                        full = comm.gather_full(v, self.local[n],
                                                self.mesh)
                    tmp[n] = comm.take_local(full, spec, self.mesh)
            elif tuple(v.shape) == shape:
                tmp[n] = comm.take_local(v, spec, self.mesh)
            elif n.endswith("@GRAD@ROWS") and spec and spec[0] is not None:
                values_of_rows[n] = n[:-len("ROWS")] + "VALUES"
        for rows_name, vals_name in values_of_rows.items():
            self._rebase_rows(op, tmp, rows_name, vals_name, spec, shape)
        run_program_ops([op], tmp)
        for n in op.output_arg_names:
            v = tmp[n]
            self.env[n] = v
            self.full.pop(n, None)
            if not isinstance(v, torch.Tensor) or tuple(v.shape) != lshape \
                    or lshape == shape:
                self.local.pop(n, None)
                continue
            if self.res.spec(n) == spec:
                self.local[n] = spec
            else:
                self.env[n] = comm.gather_full(v, spec, self.mesh)
                self.local.pop(n, None)

    def _rebase_rows(self, op, tmp, rows_name, vals_name, spec, shape):
        """A row-sparse gradient on this rank's block of a table's rows:
        rows re-based to the block, the rows of other blocks dropped (the
        fill row of ``Optimizer._merge_rows``, with zero values; a
        scatter-add takes them at row 0 with zero values)."""
        i, n = self.mesh.index(comm._axes(spec[0]))
        per = shape[0] // n
        rows = tmp[rows_name].to(torch.int64) - i * per
        mine = (rows >= 0) & (rows < per)
        fill = 0 if op.type == "sgd_sparse" else per
        tmp[rows_name] = torch.where(mine, rows,
                                     torch.full_like(rows, fill)) \
            .to(tmp[rows_name].dtype)
        if vals_name in tmp:
            vals = tmp[vals_name]
            tmp[vals_name] = torch.where(
                mine.view((-1,) + (1,) * (vals.dim() - 1)), vals,
                torch.zeros((), dtype=vals.dtype, device=vals.device))

    def _run_flat(self, op, blk) -> None:
        """A flat group's update on this rank's slice (ZeRO)."""
        acc, spec = blk
        axes = comm._axes(spec[0])
        pname = op.input("FlatParam")[0]
        total = self.full_shape(acc)[0]
        mesh = self.mesh
        p_flat = comm.take_local(self.whole(pname), spec, mesh)
        g_flat = torch.cat([self.env[g].reshape(-1)
                            for g in op.input("Grad")])
        # the batch axes the slice does not split are reduced whole;
        # those it does are reduce-scattered; any other axis of the
        # slice is cut from the (replicated) sum
        batch = self.res.batch_axes if self.split else ()
        rest = [a for a in batch if a not in axes]
        g_flat = _reduce_over(g_flat, rest, mesh, True)
        for a in reversed(axes):
            if a in batch:
                g_flat = comm.reduce_scatter(g_flat, mesh.group(a),
                                             mean=True)
            else:
                i, n = mesh.index((a,))
                per = g_flat.shape[0] // n
                g_flat = g_flat[i * per:(i + 1) * per].clone()
        slots = [s for s in op.inputs if s not in ("FlatParam", "Grad",
                                                   "LearningRate")]
        accs, shared = [], []
        for s in slots:
            for n in op.input(s):
                v = self.env[n]
                if n in self.local:
                    enforce(self.local[n] == spec,
                            "flat group %s: accumulator %s is held as %s, "
                            "its group as %s" % (pname, n, self.local[n],
                                                 spec))
                    accs.append(v)
                elif v.dim() and v.shape[0] == total:
                    accs.append(comm.take_local(v, spec, mesh))
                else:
                    shared.append(v)
        lr = self.env[op.input("LearningRate")[0]]
        outs = op.fn.on_flat(p_flat, g_flat, lr, accs, shared)
        names = op.output_arg_names
        enforce(len(outs) == len(names),
                "flat group %s: %d results for %d outputs"
                % (pname, len(outs), len(names)))
        for n, v in zip(names, outs):
            self.env[n] = v
            if n == pname:
                self.env[n] = comm.gather_full(v, spec, mesh)
                self.local.pop(n, None)
            elif self.full_shape(n) == (total,) and \
                    getattr(self.var(n), "is_accumulator", False):
                self.local[n] = spec


def run(exe, program, scope, feed: Dict, fetch_names: Tuple[str, ...],
        resolver: Resolver, remat=None):
    """One sharded run of ``program`` on this rank (the counterpart of
    one call of the JAX package's mesh-aware compiled step): returns the
    fetches as tensors, each the whole value on every rank."""
    from ..executor import (_resolve_donation,
                            _resolve_remat, _value, _written_persistables,
                            live_ops, run_program_ops, run_training_ops)

    mesh = resolver.mesh
    enforce(mesh.live, "a sharded run needs a torch.distributed world of "
            "the mesh's %d ranks (parallel.init_distributed)" % mesh.size())
    gb = program.global_block()
    device = exe.device
    state_names = exe._resolve_state_names(program, feed, fetch_names,
                                           scope)
    written = _written_persistables(program)
    views = getattr(program, "_flat_state_views", None) or {}
    copy = not _resolve_donation(program)

    # feeds: this rank's block of the batch when every batch-like feed
    # divides over the data-like axes
    vals = {n: exe._feed_tensor(gb._find_var_recursive(n), v)
            for n, v in feed.items()}
    axes = resolver.batch_axes
    b_idx, b_n = mesh.index(axes) if axes else (0, 1)
    batchlike = [n for n in vals if _batchlike(gb._find_var_recursive(n))]
    split = b_n > 1 and bool(batchlike) and all(
        vals[n].dim() > 0 and vals[n].shape[0] % b_n == 0
        for n in batchlike)
    env: Dict[str, torch.Tensor] = {}
    for n, v in vals.items():
        if split and n in batchlike:
            per = v.shape[0] // b_n
            v = v[b_idx * per:(b_idx + 1) * per]
        env[n] = v
    r = _Run(program, resolver, env, split)
    if split:
        r.batch.update(batchlike)

    # state: this rank's blocks, a whole tensor placed on first use
    for n in state_names:
        v = scope.get(n)
        spec = resolver.spec(n)
        if isinstance(v, torch.Tensor) and any(spec):
            shape = r.full_shape(n)
            if shape is not None and tuple(v.shape) == shape:
                v = comm.take_local(v.to(device), spec, mesh)
                scope.set_var(n, v)
            r.local[n] = spec
        env[n] = v.clone() if copy and n in written \
            and isinstance(v, torch.Tensor) else v

    ops = live_ops(program, fetch_names)
    at = [i for i, op in enumerate(ops) if op.type == "backward"]
    fwd = ops[:at[0]] if at else ops
    blocks = r.tp_layouts(fwd)
    for n in dict.fromkeys(x for op in fwd for x in op.input_arg_names):
        if n in blocks:
            r.place(n, blocks[n])
        elif n in r.local:
            r.whole(n)

    remat = _resolve_remat(program) if remat is None else remat
    prev = batch_block()
    _tls.batch = (b_idx, b_n) if split else (0, 1)
    try:
        with mesh_scope(mesh), remat_scope(remat):
            if at:
                def update(bw, post, e):
                    r.reduce_grads(bw, post)
                    for op in post:
                        if op.fn is not None:
                            r.run_update(op)

                run_training_ops(ops, env, device, remat=remat,
                                 keep=fetch_names, update=update,
                                 forward_post=r.forward_post)
            else:
                with torch.no_grad():
                    run_program_ops(ops, env, device=device,
                                    post_op=r.forward_post)
    finally:
        _tls.batch = prev

    with torch.no_grad():
        for n in written:
            if n in views and views[n][0] in written:
                continue
            v = _value(env, n)
            if not isinstance(v, torch.Tensor):
                continue
            v = v.detach()
            spec = resolver.spec(n)
            have = r.local.get(n)
            if have is not None and have != spec:
                v = comm.gather_full(v, have, mesh)
                have = None
            if have is None and any(spec):
                v = comm.take_local(v, spec, mesh)
            if scope.find_var(n) is not v:
                scope.set_var(n, v)
        if views:
            scope.adopt_flat_views({k: s for k, s in views.items()
                                    if not any(resolver.spec(s[0]))})
        fetches = []
        for n in fetch_names:
            enforce(n in env, "fetch target %r was not computed" % n)
            v = _value(env, n)
            if not isinstance(v, torch.Tensor):
                fetches.append(v)
                continue
            v = v.detach()
            var = gb._find_var_recursive(n)
            if n in r.local:
                v = comm.gather_full(v, r.local[n], mesh)
            elif n in r.batch:
                if v.numel() == 1:
                    v = _reduce_over(v, axes, mesh, True)
                elif v.dim() > 0:
                    v = comm.gather_full(v, (axes,), mesh)
            fetches.append(v)
    return fetches


def check_capturable(mesh, runner: str) -> None:
    """Raise :class:`GraphCaptureError` before any capture of a sharded
    step over the live ``mesh`` on a card (``run_steps``/``run_graph``;
    ``runner`` names what runs it step by step): over gloo a CUDA graph
    cannot capture the collectives, and capture over NCCL is not ported
    yet (ROADMAP Queue A 9, (g2))."""
    if mesh is None or not mesh.live:
        return
    import torch.distributed as dist

    from ..core.enforce import GraphCaptureError

    backend = dist.get_backend()
    if backend == "gloo":
        why = ("its collectives run over the gloo backend, which a CUDA "
               "graph cannot capture")
    else:
        why = ("capture over the %s backend is not ported yet (ROADMAP "
               "Queue A 9, (g2))" % backend)
    raise GraphCaptureError("cannot capture the sharded step as a CUDA "
                            "graph: %s; run it step by step with %s"
                            % (why, runner))


def check_not_live(mesh) -> None:
    """Refuse a mesh of several ranks outside a world of them: nothing
    runs single-device where a mesh was asked for."""
    if mesh.size() > 1 and not mesh.live:
        raise EnforceError(
            "the program is sharded over a mesh of %d ranks %s, but this "
            "process is not one rank of a torch.distributed world of "
            "that size: start the ranks (python -m "
            "paddle_tpu_torch.tools.launch --nproc %d ...) and call "
            "parallel.init_distributed() in each"
            % (mesh.size(), mesh.shape, mesh.size()))


def whole_state(program, scope, names=None) -> Dict[str, torch.Tensor]:
    """Every persistable of ``program`` the scope holds (or ``names``),
    whole: blocks of sharded state gathered from the ranks (collective:
    every rank calls it, in the same order). What a rank hands a
    checkpoint writer; the JAX package's global arrays read the same."""
    plan = getattr(program, "_sharding_plan", None)
    gb = program.global_block()
    if names is None:
        names = sorted(v.name for v in program.list_vars()
                       if v.persistable and scope.has_var(v.name))
    out = {}
    for n in names:
        v = scope.find_var(n)
        var = gb._find_var_recursive(n)
        if plan is not None and plan.mesh.live and isinstance(
                v, torch.Tensor) and var is not None and var.shape:
            spec = plan.spec_for(var, n)
            shape = tuple(int(s) for s in var.shape)
            if any(spec) and tuple(v.shape) != shape:
                v = comm.gather_full(v, spec, plan.mesh)
        out[n] = v
    return out
