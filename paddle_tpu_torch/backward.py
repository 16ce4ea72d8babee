"""Reverse-mode autodiff over a Program (counterpart of
paddle_tpu/backward.py).

``append_backward`` keeps the JAX package's programmatic contract: it
appends ONE ``backward`` op with the slots ``Params`` and ``Inputs`` ->
``Grads`` and the attr ``loss``, whose outputs are named
``<param>@GRAD``, so gradients can be fetched by name and optimizers
consume (param, grad) pairs.

How the gradient is taken differs. In the JAX package the op's fn
re-runs the forward slice inside ``jax.grad`` and XLA's CSE removes the
duplicate under ``jit``; eager torch has no such pass, and the literal
port would run every forward op twice per step. Here the Executor takes
the gradient from the forward pass it has just run (executor.py): it
runs the ops before ``backward`` with autograd on, over leaf aliases of
the ``Params``, then executes ``backward`` as
``torch.autograd.grad(loss, leaves)``. The op's fn is only its shape
function (for static analysis), and refuses to run anywhere else.

Row-sparse tables (``embedding(is_sparse=True)`` read only by local
lookups of fed ids) get the pair ``<table>@GRAD@ROWS`` (the looked-up
ids, int32, flattened) and ``<table>@GRAD@VALUES`` (the gradient at
each lookup's output, ``[n, D]``, zero at ``padding_idx``) instead of a
dense ``[V, D]`` gradient. The JAX package adds a zero probe to each
lookup output and differentiates with respect to it; here the
executor makes each lookup output an autograd leaf, which is the same
derivative, and the table itself is never differentiated.

Rematerialization (``memory_optimize(level>=1)``, the ``remat_policy``
pass) is the executor's too: it runs the forward slice, or each chosen
segment of :func:`remat_segment_plan`, under ``torch.utils.checkpoint``
so the backward pass recomputes it.

``calc_gradient`` takes gradients of targets with respect to arbitrary
program variables (intermediates too) as ONE ``calc_gradient`` op whose
fn re-runs the targets' forward slice under autograd with the inputs
pinned as leaves: the JAX package's contract, without the executor's
one-pass ``backward`` machinery (the slice runs twice in a step that
also fetches the targets).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .core.enforce import EnforceError, enforce
from .core.program import Program, Variable

GRAD_SUFFIX = "@GRAD"
ROWS_SUFFIX = "@GRAD@ROWS"
VALUES_SUFFIX = "@GRAD@VALUES"


def _grad_name(name: str) -> str:
    return name + GRAD_SUFFIX


class _ClipError(torch.autograd.Function):
    """Identity whose backward clips the cotangent to [mn, mx] — the
    ErrorClipByValue mechanism (``var.error_clip``)."""

    @staticmethod
    def forward(ctx, x, mn, mx):
        ctx.bounds = (mn, mx)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ct.clamp(*ctx.bounds), None, None


def clip_error(x, mn: float, mx: float):
    return _ClipError.apply(x, mn, mx)


def _error_clip_map(fwd_ops, gb):
    """name -> (min, max) for vars carrying an error_clip attr."""
    clips = {}
    for op in fwd_ops:
        for n in op.output_arg_names:
            v = gb._find_var_recursive(n)
            ec = getattr(v, "error_clip", None)
            if ec is not None:
                clips[n] = ec.bounds()
    return clips


def _sparse_sites(fwd_ops, param_names, gb, other_inputs):
    """Sparse-marked tables whose every use is a local sparse lookup of
    external ids — the tables the JAX package gives a row-sparse
    gradient."""
    sites = {}
    ext = set(other_inputs)
    for pn in param_names:
        v = gb._find_var_recursive(pn)
        if not getattr(v, "sparse_grad", False):
            continue
        uses = [op for op in fwd_ops if pn in op.input_arg_names]
        if uses and all(op.type == "lookup_table"
                        and op.attrs.get("is_sparse")
                        and not op.attrs.get("is_distributed")
                        and (op.input("Ids") or [None])[0] in ext
                        for op in uses):
            sites[pn] = uses
    return sites


def slice_ops(ops, target: str) -> List:
    """The ops of ``ops`` needed to produce ``target``, in order (a
    ``backward`` op never is)."""
    needed = {target}
    kept = []
    for op in reversed(ops):
        if op.type == "backward":
            continue
        if set(op.output_arg_names) & needed:
            kept.append(op)
            needed.update(op.input_arg_names)
    return list(reversed(kept))


def _forward_slice(program: Program, target: str):
    """Ops needed to produce `target`, plus their external input names
    (order-sensitive: a var read before any kept op produced it is
    external, even if a later op writes it)."""
    kept = slice_ops(program.global_block().ops, target)
    ext, produced = [], set()
    for op in kept:
        for n in op.input_arg_names:
            if n not in produced and n not in ext:
                ext.append(n)
        produced.update(op.output_arg_names)
    return kept, ext


def remat_segment_plan(fwd_ops, loss_name: str):
    """Partition a forward slice into contiguous remat segments.

    Ops annotated with ``op.attrs["_remat_segment"] = k`` (written by the
    ``remat_policy`` pass) group into maximal runs sharing one id;
    unannotated runs form ``None`` segments that are never checkpointed.
    For each segment the plan records the dataflow boundary the
    checkpointing (and ``analysis.liveness``'s static model of it)
    needs:

    - ``needed_in`` — names the segment reads that it does not define
      first (the values a checkpoint saves as its inputs),
    - ``keep_out`` — names the segment defines that a *later* segment or
      the loss reads (the values that cross the boundary forward).

    Returns ``[(segment_id, ops, needed_in, keep_out), ...]`` in program
    order with deterministic name ordering."""
    groups: List[Tuple[Optional[int], List]] = []
    for op in fwd_ops:
        sid = op.attrs.get("_remat_segment")
        if groups and groups[-1][0] == sid:
            groups[-1][1].append(op)
        else:
            groups.append((sid, [op]))
    needs_after = []
    acc = {loss_name}
    for sid, ops in reversed(groups):
        needs_after.append(frozenset(acc))
        for op in ops:
            acc.update(op.input_arg_names)
    needs_after.reverse()
    plan = []
    for (sid, ops), after in zip(groups, needs_after):
        defined: set = set()
        needed: List[str] = []
        for op in ops:
            for n in op.input_arg_names:
                if n not in defined and n not in needed:
                    needed.append(n)
            defined.update(op.output_arg_names)
        keep = [n for n in dict.fromkeys(
            o for op in ops for o in op.output_arg_names) if n in after]
        plan.append((sid, list(ops), tuple(needed), tuple(keep)))
    return plan


def _grad_shapes(param_names, input_names, dense_names, sites):
    """The backward op's fn: its shape function, and nothing more. On
    meta tensors (build-time and static shape inference) it returns
    tensors shaped as the JAX package's backward op returns them — a
    gradient like each dense parameter; per sparse table the rows
    (int32, one per looked-up id) and the values (one row per id). On
    any other tensor it raises: the Executor takes the gradient from
    the forward pass it has just run."""

    def fn(*vals):
        if not all(v.device.type == "meta" for v in vals):
            raise EnforceError(
                "the backward op is executed by Executor.run, which takes "
                "the gradient from the forward pass it has just run; it "
                "cannot run as a plain op")
        env = dict(zip(list(param_names) + list(input_names), vals))
        outs = [torch.empty_like(env[n]) for n in dense_names]
        for table in dict.fromkeys(s[0] for s in sites):
            n = sum(env[ids].numel() for t, ids, _, _ in sites
                    if t == table)
            outs.append(torch.empty((n,), dtype=torch.int32,
                                    device="meta"))
            outs.append(torch.empty((n, env[table].shape[-1]),
                                    dtype=env[table].dtype, device="meta"))
        return tuple(outs)

    return fn


def append_backward(loss: Variable,
                    parameter_list: Optional[Sequence[str]] = None,
                    no_grad_set: Optional[set] = None,
                    callbacks=None) -> List[Tuple[Variable, Variable]]:
    """Append the ``backward`` op for ``loss``; returns the (param,
    grad) pairs of the trainable parameters the loss depends on."""
    program = loss.block.program
    gb = program.global_block()
    no_grad_set = set(no_grad_set or ())

    fwd_ops, ext_inputs = _forward_slice(program, loss.name)
    enforce(fwd_ops, "loss %r is not produced by any op" % loss.name)

    if parameter_list is not None:
        param_names = [p if isinstance(p, str) else p.name
                       for p in parameter_list]
    else:
        param_names = [p.name for p in gb.all_parameters()
                       if p.trainable and p.name not in no_grad_set]
    # only params the loss actually depends on get gradients
    param_names = [n for n in param_names if n in ext_inputs]
    other_inputs = [n for n in ext_inputs if n not in param_names]

    # Stateful external inputs (read, then overwritten by a forward op,
    # e.g. dropout's RNG counter) reach the backward op as a snapshot
    # taken at program start, as in the JAX package. The gradient here
    # comes from the one forward pass, so the snapshot keeps the program
    # and its symbol table the same, not the numbers.
    written = set()
    for op in fwd_ops:
        written.update(op.output_arg_names)
    snapshot_map = {}
    for n in list(other_inputs):
        if n in written:
            pre = n + "@PRE_BW"
            src = gb.var(n)
            gb.create_var(name=pre, shape=src.shape, dtype=src.dtype)
            gb.prepend_op(type="snapshot", inputs={"X": [n]},
                          outputs={"Out": [pre]}, fn=lambda v: v)
            snapshot_map[n] = pre
    backward_input_names = [snapshot_map.get(n, n) for n in other_inputs]

    sparse_sites = _sparse_sites(fwd_ops, param_names, gb, other_inputs)
    sparse_names = [pn for pn in param_names if pn in sparse_sites]
    dense_names = [pn for pn in param_names if pn not in sparse_sites]
    grad_vars, out_names = {}, []
    for pn in dense_names:
        p = gb.var(pn)
        grad_vars[pn] = gb.create_var(name=_grad_name(pn), shape=p.shape,
                                      dtype=p.dtype)
        out_names.append(grad_vars[pn].name)
    for pn in sparse_names:
        p = gb.var(pn)
        rows = gb.create_var(name=pn + ROWS_SUFFIX, shape=(-1,),
                             dtype="int32")
        vals = gb.create_var(name=pn + VALUES_SUFFIX,
                             shape=(-1, p.shape[-1]), dtype=p.dtype)
        # the VALUES var stands in as the gradient downstream; the rows
        # ride along for the optimizers' sparse updates
        vals.is_sparse_rows = True
        vals.rows_var = rows
        grad_vars[pn] = vals
        out_names += [rows.name, vals.name]
    # (table, ids, lookup output, padding_idx) of every sparse lookup,
    # by name, so a clone of the program keeps them
    sites = [(pn, op.input("Ids")[0], op.output("Out")[0],
              op.attrs.get("padding_idx"))
             for pn in sparse_names for op in sparse_sites[pn]]
    gb.append_op(
        type="backward",
        inputs={"Params": list(param_names),
                "Inputs": list(backward_input_names)},
        outputs={"Grads": out_names},
        attrs={"loss": loss.name,
               "_error_clips": _error_clip_map(fwd_ops, gb),
               "_sparse_sites": sites},
        fn=_grad_shapes(param_names, backward_input_names, dense_names,
                        sites),
    )
    return [(gb.var(pn), grad_vars[pn]) for pn in param_names]


class _Pinned(dict):
    """An op environment whose pinned names are never overwritten (an
    op upstream of a ``calc_gradient`` input recomputes it, but the
    derivative is taken at the pinned value) and whose ``stop`` names
    are stored detached (``no_grad_set``)."""

    def __init__(self, pinned, stop):
        super().__init__()
        self.pinned, self.stop = pinned, stop

    def __setitem__(self, name, value):
        if name in self.pinned and name in self:
            return
        if name in self.stop and isinstance(value, torch.Tensor):
            value = value.detach()
        super().__setitem__(name, value)


def calc_gradient(targets, inputs, target_gradients=None,
                  no_grad_set=None) -> List[Variable]:
    """Gradients of ``targets`` with respect to ``inputs`` (Variables or
    names; intermediates too), as Variables named ``<input>@GRAD``.

    The sum of every element of every target is differentiated; where
    ``target_gradients`` gives a Variable for a target, that target is
    weighted by it element by element (the cotangent). Variables named
    in ``no_grad_set`` are held constant; an input in it gets a zero
    gradient."""
    targets = list(targets) if isinstance(targets, (list, tuple)) \
        else [targets]
    inputs = list(inputs) if isinstance(inputs, (list, tuple)) \
        else [inputs]
    program = targets[0].block.program
    gb = program.global_block()
    target_names = [t.name for t in targets]
    wrt = [i.name if isinstance(i, Variable) else str(i) for i in inputs]
    if target_gradients is None:
        target_gradients = [None] * len(targets)
    elif not isinstance(target_gradients, (list, tuple)):
        target_gradients = [target_gradients]
    enforce(len(target_gradients) == len(targets),
            "calc_gradient: %d target_gradients for %d targets"
            % (len(target_gradients), len(targets)))
    cot_names = [None if g is None else
                 (g.name if isinstance(g, Variable) else str(g))
                 for g in target_gradients]
    stop = {n.name if isinstance(n, Variable) else str(n)
            for n in (no_grad_set or ())}

    all_ops, all_ext = [], []
    for tn in target_names:
        ops, ext = _forward_slice(program, tn)
        all_ops += [op for op in ops if op not in all_ops]
        all_ext += [n for n in ext if n not in all_ext]
    others = [n for n in all_ext if n not in wrt]
    cots = [n for n in cot_names if n is not None]
    n_w, n_o = len(wrt), len(others)
    wrt_set = set(wrt)

    def grad_fn(*vals):
        from .executor import _value, run_program_ops

        leaves = [v.detach().requires_grad_(
            v.is_floating_point() and n not in stop)
            for n, v in zip(wrt, vals[:n_w])]
        cot_vals = dict(zip(cots, vals[n_w + n_o:]))
        with torch.enable_grad():
            env = _Pinned(wrt_set, stop)
            env.update(zip(others, vals[n_w:n_w + n_o]))
            for n, v in zip(wrt, leaves):
                env[n] = v
            run_program_ops(all_ops, env)
            total = 0
            for tn, cn in zip(target_names, cot_names):
                t = _value(env, tn)
                total = total + (t * cot_vals[cn] if cn is not None
                                 else t).sum()
            live = [v for v in leaves if v.requires_grad]
            grads = iter(torch.autograd.grad(total, live, allow_unused=True)
                         if live and total.requires_grad
                         else [None] * len(live))
        out = []
        for v in leaves:
            g = next(grads) if v.requires_grad else None
            out.append(torch.zeros_like(v) if g is None else g.detach())
        return tuple(out)

    grad_vars = []
    for n in wrt:
        v = gb.var(n)
        grad_vars.append(gb.create_var(name=_grad_name(n), shape=v.shape,
                                       dtype=v.dtype))
    gb.append_op(
        type="calc_gradient",
        inputs={"Params": list(wrt), "Inputs": list(others),
                "TargetGradients": cots},
        outputs={"Grads": [g.name for g in grad_vars]},
        attrs={"targets": target_names},
        fn=grad_fn)
    return grad_vars
