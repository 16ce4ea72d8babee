"""Optimizers (counterpart of paddle_tpu/optimizer.py): the base class
with the per-parameter and the flat-group update paths, the optimizer
family — SGD, Momentum, Adagrad, Adam, Adamax, DecayedAdagrad,
Adadelta, RMSProp, Ftrl, ProximalGD and ProximalAdagrad — with the
reference's aliases (``MomentumOptimizer``, ...), and the wrappers
``GradientAccumulation`` and ``ModelAverage``.

``minimize(loss)`` = ``append_backward`` + gradient clipping +
regularization + the update ops. Accumulators are named persistable
variables initialized by ``fill_constant`` ops in the startup program,
with the JAX package's names, so a state saved by either package loads
into the other (``convert.state_from_numpy``).

Update ops, per parameter: ``(param, grad, lr, *accumulators) ->
(new_param, *new_accumulators)``, run by the Executor with autograd off,
the persistable outputs written back to the scope. The dense math of
each optimizer is ``ops.fused_optimizer.plain_flat_update`` for its
kind: the per-parameter ops apply it to one parameter, and the group op
of ``fuse_optimizer_state`` to a whole flat group, through the
hand-written kernel on the card (``fused_flat_update``) — so the two
layouts give the same bits.

``fuse_optimizer_state``: the parameters of each (dtype, grad dtype, lr
scale) group and each of their moments are one flat persistable buffer
(``fused_param_storage_N``, ``fused_<key>_storage_N``). One
``unpack_flat_params`` op at the top of the block slices per-name views
for the forward pass, one ``<op>_fused`` op updates the group, and a
second ``unpack_flat_params`` after it re-slices the updated values.
Per-name access (fetch, save, load) goes through the scope's flat views
(``program._flat_state_views``).

Row-sparse gradients (``embedding(is_sparse=True)``): SGD scatter-adds
the rows, Adagrad and Adam ("lazy" Adam) update only the rows present,
after summing duplicate rows. These ops update the table and its
moments in place, so a step never copies a ``[V, D]`` table. The other
optimizers densify a sparse gradient, as in the JAX package.

``bf16_moments`` stores the moment accumulators in bf16; the update
arithmetic stays f32 and scalars (beta powers) stay f32.

Adam's two beta-power scalars (Adamax's one) are shared by every
parameter: exactly one update op (the owner's: the last parameter's, or
the last group's) advances them, and every other op reads the step-start
value, because ops run in program order.

Gated updates (:func:`mask_update_op`, shared by ``amp.decorate``'s
overflow skip and ``GradientAccumulation``): an update op gated on a
bool flag leaves every state it writes — parameters, moments, beta
powers — as it was where the flag is false. Each update op built here
takes the flag itself (its fn is marked ``takes_apply``), because the
row-sparse ops and the flat group op update in place and the input is
gone once they have written: the dense per-parameter ops select each
new tensor against its input with ``torch.where``; the row-sparse ops
select each row before it is written back (SGD adds ``-0.0`` instead of
its step, which leaves every value's bits), so the ``[V, D]`` table is
never copied; the flat group op hands the flag to the fused-update
kernel, which reads it on the card.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .backward import append_backward
from .core import dtype_utils, flags, unique_name
from .core.enforce import enforce
from .core.program import (Parameter, Program, Variable,
                           default_main_program, default_startup_program)
from .ops.fused_optimizer import fused_flat_update, plain_flat_update
from .regularizer import append_regularization_ops

# accumulator names eligible for bf16 storage under bf16_moments:
# EMA-style bounded accumulators only (an unbounded running sum would
# drop small increments once it grows)
_BF16_MOMENT_KEYS = ("moment", "moment1", "moment2", "velocity",
                     "inf_norm", "avg_squared_grad", "avg_squared_update",
                     "mean_square", "mean_grad", "momentum", "squared",
                     "linear")


def mask_update_op(op, apply_flag) -> None:
    """Gate an optimizer update op on a bool flag variable: every output
    falls back to its input where the flag is false, so parameters and
    accumulators (moments, beta powers) advance only on apply steps.
    The one conditional-update mechanism shared by
    ``GradientAccumulation`` (apply every k-th micro-step) and
    ``amp.decorate`` (skip overflowed steps). The flag is the op's last
    input, slot ``ApplyFlag``; the op's fn — an update op this module
    built — takes it as ``apply`` and gates its own update (in place
    where the op updates in place)."""
    enforce("ApplyFlag" not in op.inputs,
            "op %r is already gated by mask_update_op — a second wrap "
            "would consume a real input as the flag" % op.type)
    orig_fn = op.fn
    enforce(getattr(orig_fn, "takes_apply", False),
            "op %r is no update op of paddle_tpu_torch.optimizer: its fn "
            "takes no apply flag" % op.type)

    def fn(*args):
        return orig_fn(*args[:-1], apply=args[-1])

    op.inputs["ApplyFlag"] = [apply_flag.name]
    op.fn = fn
    op.block.program._bump()


def _moment_storage_dtype(key: str, dtype):
    """Storage dtype of one accumulator: the one home of the
    ``bf16_moments`` rule, shared by the per-parameter and flat
    layouts."""
    if (flags.get_flag("bf16_moments") and key in _BF16_MOMENT_KEYS
            and dtype_utils.name(dtype) in ("float32", "float64")):
        return "bfloat16"
    return dtype


class Optimizer:
    """Base class. An optimizer declares its dense update once, through
    ``_update_consts(scale)`` (the hyperparameters of its kind of
    ``plain_flat_update``) or by overriding ``_make_update_fn(scale,
    owns)``, and its accumulators through ``_FUSE_ACCS`` (per parameter)
    and ``_FUSE_SHARED`` (scalars shared by every parameter), as in the
    JAX package. Only an optimizer with ``_update_consts`` (a kind of
    ``ops.fused_optimizer.KINDS``) forms flat groups."""

    # (input_slot, output_slot, accumulator_key) — per-param accumulators,
    # in the order the update fn consumes them after (param, grad, lr)
    _FUSE_ACCS: tuple = ()
    # (input_slot, output_slot, accumulator_key, fill_attr) — scalar
    # accumulators shared across all params; only the owner's op
    # advances them
    _FUSE_SHARED: tuple = ()
    _OP_TYPE: str = "optimizer"

    def __init__(self, learning_rate, regularization=None, name=None):
        self.regularization = regularization
        self._name = name
        self._learning_rate = learning_rate
        self._learning_rate_var: Optional[Variable] = None
        self._accumulators: Dict[str, Dict[str, Variable]] = {}
        self._shared_scalars: Dict[str, Variable] = {}
        self._beta_pow_owner: Optional[str] = None
        # resolved in minimize() from loss.block.program and the
        # caller's startup program
        self._program: Optional[Program] = None
        self._startup: Optional[Program] = None

    def _target_programs(self) -> Tuple[Program, Program]:
        return (self._program or default_main_program(),
                self._startup or default_startup_program())

    def _create_persistable_state(self, name, shape, dtype, value):
        """Persistable var on the main program + its fill_constant init
        on the startup program."""
        shape = tuple(shape)
        main, startup = self._target_programs()
        var = main.global_block().create_var(
            name=name, shape=shape, dtype=dtype, persistable=True)
        sb = startup.global_block()
        sb.create_var(name=name, shape=shape, dtype=dtype,
                      persistable=True)
        tdt = dtype_utils.to_torch(dtype)
        sb.append_op(type="fill_constant", inputs={},
                     outputs={"Out": [name]},
                     attrs={"shape": shape, "value": value},
                     fn=lambda: torch.full(shape, value, dtype=tdt))
        return var

    # -- learning rate ------------------------------------------------------
    def _create_global_learning_rate(self):
        if self._learning_rate_var is not None:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_var = self._learning_rate
            return
        self._learning_rate_var = self._create_persistable_state(
            unique_name.generate("learning_rate"), (), "float32",
            float(self._learning_rate))

    @property
    def global_learning_rate(self) -> Variable:
        return self._learning_rate_var

    def _param_lr_scale(self, param: Parameter) -> float:
        return float(param.optimize_attr.get("learning_rate", 1.0))

    # -- accumulators -------------------------------------------------------
    def _add_accumulator(self, name: str, param: Parameter,
                         fill_value: float = 0.0, shape=None,
                         dtype=None) -> Variable:
        accs = self._accumulators.setdefault(name, {})
        enforce(param.name not in accs,
                "accumulator %s already exists for %s" % (name, param.name))
        shape = tuple(shape if shape is not None else param.shape)
        dtype = dtype or param.dtype
        if shape:  # scalars (beta powers) stay f32
            dtype = _moment_storage_dtype(name, dtype)
        var = self._create_persistable_state(
            unique_name.generate(f"{param.name}_{name}"), shape, dtype,
            float(fill_value))
        var.is_accumulator = True
        accs[param.name] = var
        return var

    def _get_accumulator(self, name: str, param: Parameter) -> Variable:
        accs = self._accumulators.get(name, {})
        if param.name in accs:
            return accs[param.name]
        if name in self._shared_scalars:
            return self._shared_scalars[name]
        return self._accumulators[name][param.name]  # KeyError with context

    def _create_shared_scalar_accumulators(self, parameters, specs):
        """One scalar accumulator per name, keyed to the first parameter
        and shared by all (``specs``: [(name, fill_value)...]); the last
        parameter owns its advance."""
        for name, fill in specs:
            shared = self._shared_scalars.get(name)
            for p in parameters:
                if shared is None:
                    shared = self._add_accumulator(name, p,
                                                   fill_value=fill,
                                                   shape=())
                    self._shared_scalars[name] = shared
                else:
                    self._accumulators.setdefault(name, {})[p.name] = \
                        shared
        if parameters:
            self._beta_pow_owner = parameters[-1].name

    def _create_accumulators(self, block, parameters):
        for _in, _out, key in self._FUSE_ACCS:
            for p in parameters:
                self._add_accumulator(key, p)
        if self._FUSE_SHARED:
            self._create_shared_scalar_accumulators(
                parameters, [(key, getattr(self, fill_attr))
                             for _in, _out, key, fill_attr
                             in self._FUSE_SHARED])

    # -- per-optimizer hooks ------------------------------------------------
    def _update_consts(self, scale) -> Optional[tuple]:
        """The Python-float hyperparameters of this optimizer's kind of
        ``plain_flat_update`` (``_OP_TYPE``), at lr scale ``scale``;
        None: no such kind."""
        return None

    def _make_update_fn(self, scale, owns):
        """The dense elementwise update ``fn(param, grad, lr,
        *accumulators, *shared_scalars) -> (new_param,
        *new_accumulators[, *advanced_scalars if owns])``."""
        consts = self._update_consts(scale)
        if consts is None:
            return None
        kind, n_acc = self._OP_TYPE, len(self._FUSE_ACCS)

        def fn(pv, gv, lr, *rest):
            return plain_flat_update(kind, pv, gv, lr, rest[:n_acc],
                                     rest[n_acc:], owns, consts)

        return fn

    # optimizers with a row-sparse update (lazy rows) override this;
    # None densifies the (rows, values) gradient
    _append_sparse_optimize_op = None

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        owns = bool(self._FUSE_SHARED) and p.name == self._beta_pow_owner
        fn = self._make_update_fn(self._param_lr_scale(p), owns)
        enforce(fn is not None,
                f"{type(self).__name__} defines no _make_update_fn")
        accs = [(s, self._get_accumulator(k, p))
                for s, _o, k in self._FUSE_ACCS]
        shared = [(s, self._get_accumulator(k, p))
                  for s, _o, k, _f in self._FUSE_SHARED]
        outs = [(o, self._get_accumulator(k, p))
                for _s, o, k in self._FUSE_ACCS]
        if owns:
            outs += [(o, self._get_accumulator(k, p))
                     for _s, o, k, _f in self._FUSE_SHARED]
        return self._append_update(block, self._OP_TYPE, p, g,
                                   accs + shared, fn, outs)

    # -- fused flat-state path (fuse_optimizer_state) -----------------------
    def _fusable(self, p, g) -> bool:
        return (g is not None
                and not getattr(g, "is_sparse_rows", False)
                # a sharded param (shard_program's rules, a tp ParamAttr)
                # keeps its own layout: the JAX package keeps it out of
                # the replicated flat storage
                and getattr(p, "sharding_spec", None) is None
                and p.shape is not None
                and all(int(s) >= 0 for s in p.shape)
                and (g.shape is None
                     or tuple(g.shape) == tuple(p.shape)))

    def _group_key(self, p, g):
        return (dtype_utils.name(p.dtype), dtype_utils.name(g.dtype),
                self._param_lr_scale(p))

    def _append_one_group(self, gb, pg, owns):
        """One flat group: the flat buffers and their startup pack, the
        unpack before the forward, the ``<op>_fused`` update op and the
        unpack after it, and the per-name views — with the JAX package's
        names, offsets and op types."""
        main, startup = self._target_programs()
        params = [p for p, _ in pg]
        grads = [g for _, g in pg]
        sizes = [int(np.prod(p.shape)) if p.shape else 1 for p in params]
        offs = [int(o) for o in np.cumsum([0] + sizes[:-1])]
        total = int(sum(sizes))
        pdtype = params[0].dtype
        scale = self._param_lr_scale(params[0])
        shapes = [tuple(p.shape) for p in params]
        names = [p.name for p in params]

        gname = unique_name.generate("fused_param_storage")
        flat_p = gb.create_var(name=gname, shape=(total,), dtype=pdtype,
                               persistable=True)
        # the startup program initializes the parameters per name; the
        # pack at its end makes the flat buffer the source of truth
        sb = startup.global_block()
        sb.create_var(name=gname, shape=(total,), dtype=pdtype,
                      persistable=True)
        sb.append_op(type="pack_flat_params", inputs={"Params": names},
                     outputs={"Flat": [gname]},
                     fn=lambda *ps: torch.cat([p.reshape(-1) for p in ps]))

        def unpack(flat):
            return tuple(flat[o:o + n].view(s)
                         for o, n, s in zip(offs, sizes, shapes))

        # the views precede every use; the executor does not write them
        # back (the flat buffer carries the state)
        gb.prepend_op(type="unpack_flat_params", inputs={"Flat": [gname]},
                      outputs={"Out": names}, fn=unpack)

        acc_vars, acc_views = [], {}
        for _in, _out, key in self._FUSE_ACCS:
            adtype = _moment_storage_dtype(key, pdtype)
            acc = self._create_persistable_state(
                unique_name.generate(f"fused_{key}_storage"), (total,),
                adtype, 0.0)
            acc.is_accumulator = True
            acc_vars.append(acc)
            # the per-parameter accumulator names, as views over the
            # flat buffer: symbol-table entries no op reads or writes,
            # so checkpoints interchange between the two layouts
            for p, o, n in zip(params, offs, sizes):
                vname = unique_name.generate(f"{p.name}_{key}")
                gb.create_var(name=vname, shape=tuple(p.shape),
                              dtype=adtype, persistable=True)
                acc_views[vname] = (acc.name, o, n, tuple(p.shape),
                                    dtype_utils.name(adtype))
        shared_vars = [self._shared_scalars[key]
                       for _in, _out, key, _f in self._FUSE_SHARED]

        kind, consts = self._OP_TYPE, self._update_consts(scale)
        n_g, n_a = len(grads), len(acc_vars)

        def group_fn(p_flat, *rest, apply=None):
            gs, lr = rest[:n_g], rest[n_g]
            accs, sh = rest[n_g + 1:n_g + 1 + n_a], rest[n_g + 1 + n_a:]
            g_flat = torch.cat([g.reshape(-1) for g in gs])
            return fused_flat_update(kind, p_flat, g_flat, lr, accs, sh,
                                     owns, consts, apply)

        group_fn.takes_apply = True

        def on_flat(p_flat, g_flat, lr, accs, sh, apply=None):
            return fused_flat_update(kind, p_flat, g_flat, lr, accs, sh,
                                     owns, consts, apply)

        # the update on a flat gradient: a ZeRO run (sharding/spmd.py)
        # calls it on its rank's slice of the group
        group_fn.on_flat = on_flat

        inputs = {"FlatParam": [gname], "Grad": [g.name for g in grads],
                  "LearningRate": [self._learning_rate_var.name]}
        for (slot, _o, _k), v in zip(self._FUSE_ACCS, acc_vars):
            inputs[slot] = [v.name]
        for (slot, _o, _k, _f), v in zip(self._FUSE_SHARED, shared_vars):
            inputs[slot] = [v.name]
        outputs = {"FlatParamOut": [gname]}
        for (_s, slot, _k), v in zip(self._FUSE_ACCS, acc_vars):
            outputs[slot] = [v.name]
        if owns:
            for (_s, slot, _k, _f), v in zip(self._FUSE_SHARED,
                                             shared_vars):
                outputs[slot] = [v.name]
        op = gb.append_op(type=self._OP_TYPE + "_fused", inputs=inputs,
                          outputs=outputs, fn=group_fn)
        # re-slice the per-name views from the updated buffer, so a
        # later reader (a fetch of a parameter) sees the new values, as
        # the per-parameter layout's ParamOut does
        gb.append_op(type="unpack_flat_params", inputs={"Flat": [gname]},
                     outputs={"Out": names}, fn=unpack)

        reg = dict(getattr(main, "_flat_state_views", None) or {})
        for p, o, n in zip(params, offs, sizes):
            reg[p.name] = (flat_p.name, o, n, tuple(p.shape),
                           dtype_utils.name(pdtype))
        reg.update(acc_views)
        main._flat_state_views = reg
        startup._flat_state_views = reg
        return op

    # -- sparse-gradient helpers ----------------------------------------------
    @staticmethod
    def _merge_rows(rows, vals, vocab):
        """Duplicate rows of a sparse gradient added together (the
        reference's MergeAdd), in the JAX package's static shapes:
        ``(u, summed)`` of n = len(rows) entries, the sorted unique rows
        first, then fill rows ``vocab`` (out of range) with zero sums.
        Nothing depends on the data's size, so there is no host sync and
        a CUDA graph captures it; :func:`_set_rows` drops the fill rows'
        writes. The sums accumulate through ``index_put_(accumulate=
        True)``, whose CUDA path sorts the indices and adds each row's
        entries in their order (``index_add_``'s atomics add them in
        whatever order the card runs them, so a resumed run would not
        repeat an uninterrupted one bit for bit); on the CPU both add in
        index order."""
        r = rows.reshape(-1).to(torch.int64)
        s, order = torch.sort(r, stable=True)
        first = torch.ones_like(s, dtype=torch.bool)
        first[1:] = s[1:] != s[:-1]
        group = torch.cumsum(first, 0) - 1  # each sorted id's unique row
        u = torch.full_like(s, vocab).scatter_(0, group, s)
        inv = torch.empty_like(group).scatter_(0, order, group)
        summed = torch.zeros((r.shape[0],) + tuple(vals.shape[1:]),
                             dtype=vals.dtype, device=vals.device)
        return u, summed.index_put_((inv,), vals, accumulate=True)

    def _densify_grad(self, block, param, grad):
        """For an optimizer without a row-sparse update: scatter the
        (rows, values) pair into a dense gradient (the ``[V, D]`` cost
        returns)."""
        warnings.warn(
            f"{type(self).__name__} has no sparse update path; densifying "
            f"the sparse gradient of {param.name!r}")
        dg = block.create_var(name=param.name + "@GRAD@DENSE",
                              shape=param.shape, dtype=param.dtype)

        def fn(pv, rv, vv):
            return torch.zeros_like(pv).index_add_(
                0, rv.to(torch.int64), vv.to(pv.dtype))

        block.append_op(type="sparse_to_dense",
                        inputs={"Param": [param.name],
                                "Rows": [grad.rows_var.name],
                                "Values": [grad.name]},
                        outputs={"Out": [dg.name]}, fn=fn)
        return dg

    def _create_optimization_pass(self, params_grads, loss,
                                  startup_program=None):
        self._program = loss.block.program
        if startup_program is not None:
            self._startup = startup_program
        gb = self._program.global_block()
        self._create_global_learning_rate()
        live = [(p, g) for p, g in params_grads if g is not None]

        per_param, groups = [], {}
        if (flags.get_flag("fuse_optimizer_state")
                and self._update_consts(1.0) is not None):
            for p, g in live:
                if self._fusable(p, g):
                    groups.setdefault(self._group_key(p, g),
                                      []).append((p, g))
                else:
                    per_param.append((p, g))
        else:
            per_param = live

        # only params that receive an update op get accumulators, so the
        # shared beta-pow owner's op exists; fused params get flat
        # accumulators in _append_one_group instead
        if groups and self._FUSE_SHARED:
            # the shared scalars first, keyed to the first live param:
            # the names the per-parameter layout gives them
            self._create_shared_scalar_accumulators(
                [live[0][0]], [(key, getattr(self, fill_attr))
                               for _i, _o, key, fill_attr
                               in self._FUSE_SHARED])
        self._create_accumulators(gb, [p for p, _ in per_param])
        if groups:
            # group ops run after every per-parameter op; the last group
            # owns the shared-scalar advance
            self._beta_pow_owner = None

        ops = []
        for p, g in per_param:
            if getattr(g, "is_sparse_rows", False):
                if self._append_sparse_optimize_op is not None:
                    ops.append(self._append_sparse_optimize_op(gb, (p, g)))
                    continue
                g = self._densify_grad(gb, p, g)
            ops.append(self._append_optimize_op(gb, (p, g)))
        glist = list(groups.values())
        for i, pg in enumerate(glist):
            ops.append(self._append_one_group(
                gb, pg, owns=bool(self._FUSE_SHARED) and i == len(glist) - 1))
        # a shared scalar no op advances would freeze bias correction
        if self._shared_scalars and ops:
            produced = set()
            for op in ops:
                produced.update(op.output_arg_names)
            for key, var in self._shared_scalars.items():
                enforce(var.name in produced,
                        f"shared accumulator {key!r} is never advanced by "
                        "any update op — bias correction would freeze")
        return ops

    def minimize(self, loss: Variable, startup_program=None,
                 parameter_list=None, no_grad_set=None
                 ) -> Tuple[list, List[Tuple[Variable, Variable]]]:
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        # the reference's order: clip, then regularize
        from .clip import append_gradient_clip_ops

        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        opt_ops = self._create_optimization_pass(params_grads, loss,
                                                 startup_program)
        return opt_ops, params_grads

    def _append_update(self, block, opt_name, param, grad, extra_in, fn,
                       extra_out=None):
        """The update op ``opt_name``: ``fn(param, grad, lr, *extra_in)``
        -> (new param, *extra_out), each output pinned to its declared
        dtype. The op takes the gate of :func:`mask_update_op`: a fn
        marked ``takes_apply`` (an in-place row update) gates itself;
        any other fn's new tensors are selected against the inputs of
        the same names, which it has left as they were."""
        lr = self._learning_rate_var
        inputs = {"Param": [param.name], "Grad": [grad.name],
                  "LearningRate": [lr.name]}
        for slot, var in extra_in:
            inputs[slot] = [var.name]
        outputs = {"ParamOut": [param.name]}
        for slot, var in (extra_out or []):
            outputs[slot] = [var.name]

        # pin every output to its declared storage dtype, so promotion
        # never flips a state variable's dtype between steps
        out_vars = [param] + [var for _, var in (extra_out or [])]
        out_dtypes = [dtype_utils.to_torch(var.dtype) for var in out_vars]
        in_names = [n for ns in inputs.values() for n in ns]
        in_pos = [in_names.index(var.name) for var in out_vars]
        gates_itself = getattr(fn, "takes_apply", False)

        def pinned(*args, apply=None):
            res = fn(*args, apply=apply) if gates_itself else fn(*args)
            one = not isinstance(res, (tuple, list))
            vals = (res,) if one else tuple(res)
            cast = tuple(v if v.dtype == dt else v.to(dt)
                         for v, dt in zip(vals, out_dtypes))
            if apply is not None and not gates_itself:
                cast = tuple(torch.where(apply, v, args[i])
                             for v, i in zip(cast, in_pos))
            return cast[0] if one else cast

        pinned.takes_apply = True
        return block.append_op(type=opt_name, inputs=inputs,
                               outputs=outputs, fn=pinned)


def _set_rows(table, rows, vals, vocab):
    """``table[rows] = vals`` in place, with the writes of fill rows
    (``rows == vocab``, from :meth:`Optimizer._merge_rows`) dropped, as
    the JAX package's ``.at[rows].set(vals, mode="drop")``: a fill row
    writes row ``rows[0]``'s new value to row ``rows[0]`` again (the
    fill rows sort last, so ``rows[0]`` is a real row whenever there is
    one), which changes nothing and needs no host sync. With no real row
    at all (a rank's block of a row-sharded table that none of the
    batch's ids fall in) every write puts the last row's own value
    back."""
    real = rows < vocab
    first = rows[:1].clamp(max=vocab - 1)
    idx = torch.where(real, rows, first)
    shape = (-1,) + (1,) * (vals.dim() - 1)
    fill = torch.where(real[:1].view(shape), vals[:1],
                       table.index_select(0, first).to(vals.dtype))
    vals = torch.where(real.view(shape), vals, fill)
    return table.index_copy_(0, idx, vals)


class SGD(Optimizer):
    """param - lr * grad."""

    _OP_TYPE = "sgd"

    def _update_consts(self, scale):
        return (scale,)

    def _append_sparse_optimize_op(self, block, param_and_grad):
        """Row-sparse apply: the rows scatter-add into the table in
        place (duplicates add one by one), so the result equals the
        dense update restricted to the touched rows."""
        p, g = param_and_grad
        scale = self._param_lr_scale(p)

        def fn(pv, gv, lr, rv, apply=None):
            step = -(lr * scale) * gv.to(pv.dtype)
            if apply is not None:
                # x + (-0.0) is x, bit for bit
                step = torch.where(apply, step, -0.0)
            return pv.index_add_(0, rv.to(torch.int64), step)

        fn.takes_apply = True
        return self._append_update(block, "sgd_sparse", p, g,
                                   [("Rows", g.rows_var)], fn)


class Adagrad(Optimizer):
    """m + g*g; param - lr * g / (sqrt(m) + eps)."""

    def __init__(self, learning_rate, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon

    _OP_TYPE = "adagrad"
    _FUSE_ACCS = (("Moment", "MomentOut", "moment"),)

    def _update_consts(self, scale):
        return (scale, self._epsilon)

    def _append_sparse_optimize_op(self, block, param_and_grad):
        """Lazy row update after the duplicate-row merge, in place."""
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        eps, scale = self._epsilon, self._param_lr_scale(p)

        def fn(pv, gv, lr, rv, mv, apply=None):
            vocab = pv.shape[0]
            u, gm = self._merge_rows(rv, gv.to(pv.dtype), vocab)
            uc = u.clamp(max=vocab - 1)  # safe reads; fill writes dropped
            m_old, p_old = mv[uc], pv[uc]
            m_rows = m_old.to(gm.dtype) + gm * gm
            p_rows = p_old - (lr * scale) * gm / (torch.sqrt(m_rows) + eps)
            m_rows = m_rows.to(mv.dtype)
            if apply is not None:
                p_rows = torch.where(apply, p_rows, p_old)
                m_rows = torch.where(apply, m_rows, m_old)
            return (_set_rows(pv, u, p_rows, vocab),
                    _set_rows(mv, u, m_rows, vocab))

        fn.takes_apply = True
        return self._append_update(block, "adagrad_sparse", p, g,
                                   [("Rows", g.rows_var), ("Moment", m)],
                                   fn, [("MomentOut", m)])


class Adam(Optimizer):
    """Adam with bias correction through the shared beta powers."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    _OP_TYPE = "adam"
    _FUSE_ACCS = (("Moment1", "Moment1Out", "moment1"),
                  ("Moment2", "Moment2Out", "moment2"))
    _FUSE_SHARED = (("Beta1Pow", "Beta1PowOut", "beta1_pow_acc", "_beta1"),
                    ("Beta2Pow", "Beta2PowOut", "beta2_pow_acc", "_beta2"))

    def _update_consts(self, scale):
        return (scale, self._beta1, self._beta2, self._epsilon)

    def _append_sparse_optimize_op(self, block, param_and_grad):
        """Lazy Adam: only the rows present in the gradient (after the
        duplicate-row merge) advance their moments and parameters, in
        place; the beta powers advance as in the dense update."""
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        scale = self._param_lr_scale(p)
        owns = p.name == self._beta_pow_owner

        def fn(pv, gv, lr, rv, m1v, m2v, b1pv, b2pv, apply=None):
            vocab = pv.shape[0]
            u, gm = self._merge_rows(rv, gv.to(pv.dtype), vocab)
            uc = u.clamp(max=vocab - 1)  # safe reads; fill writes dropped
            old = (pv[uc], m1v[uc], m2v[uc])
            m1r = b1 * old[1].to(gm.dtype) + (1 - b1) * gm
            m2r = b2 * old[2].to(gm.dtype) + (1 - b2) * gm * gm
            lr_t = (lr * scale) * torch.sqrt(1 - b2pv) / (1 - b1pv)
            p_rows = old[0] - lr_t * m1r / (torch.sqrt(m2r) + eps)
            rows = (p_rows, m1r.to(m1v.dtype), m2r.to(m2v.dtype))
            pows = (b1pv * b1, b2pv * b2)
            if apply is not None:
                rows = tuple(torch.where(apply, r, o)
                             for r, o in zip(rows, old))
                pows = (torch.where(apply, pows[0], b1pv),
                        torch.where(apply, pows[1], b2pv))
            out = tuple(_set_rows(t, u, r, vocab)
                        for t, r in zip((pv, m1v, m2v), rows))
            return (out + pows) if owns else out

        fn.takes_apply = True
        outs = [("Moment1Out", m1), ("Moment2Out", m2)]
        if owns:
            outs += [("Beta1PowOut", b1p), ("Beta2PowOut", b2p)]
        return self._append_update(
            block, "adam_sparse", p, g,
            [("Rows", g.rows_var), ("Moment1", m1), ("Moment2", m2),
             ("Beta1Pow", b1p), ("Beta2Pow", b2p)], fn, outs)


class Momentum(Optimizer):
    """v = mu*v + g; param - lr*v, or with Nesterov param - (g + mu*v)*lr."""

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    _OP_TYPE = "momentum"
    _FUSE_ACCS = (("Velocity", "VelocityOut", "velocity"),)

    def _update_consts(self, scale):
        return (scale, self._momentum, bool(self._use_nesterov))


class Adamax(Optimizer):
    """Adam with the infinity norm; bias correction through one shared
    beta1 power."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    _OP_TYPE = "adamax"
    _FUSE_ACCS = (("Moment", "MomentOut", "moment"),
                  ("InfNorm", "InfNormOut", "inf_norm"))
    _FUSE_SHARED = (("Beta1Pow", "Beta1PowOut", "beta1_pow_acc",
                     "_beta1"),)

    def _update_consts(self, scale):
        return (scale, self._beta1, self._beta2, self._epsilon)


class DecayedAdagrad(Optimizer):
    """m = decay*m + (1-decay)*g*g; param - lr*g / (sqrt(m) + eps)."""

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._epsilon = decay, epsilon

    _OP_TYPE = "decayed_adagrad"
    _FUSE_ACCS = (("Moment", "MomentOut", "moment"),)

    def _update_consts(self, scale):
        return (scale, self._decay, self._epsilon)


class Adadelta(Optimizer):
    """Running averages of the squared gradient and the squared update."""

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon, self._rho = epsilon, rho

    _OP_TYPE = "adadelta"
    _FUSE_ACCS = (("AvgSquaredGrad", "AvgSquaredGradOut",
                   "avg_squared_grad"),
                  ("AvgSquaredUpdate", "AvgSquaredUpdateOut",
                   "avg_squared_update"))

    def _update_consts(self, scale):
        return (scale, self._rho, self._epsilon)


class RMSProp(Optimizer):
    """RMSProp with momentum (lr folded into it), optionally centered."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    _OP_TYPE = "rmsprop"
    _FUSE_ACCS = (("Moment", "MomentOut", "momentum"),
                  ("MeanSquare", "MeanSquareOut", "mean_square"),
                  ("MeanGrad", "MeanGradOut", "mean_grad"))

    def _update_consts(self, scale):
        return (scale, self._rho, self._epsilon, self._momentum,
                bool(self._centered))


class Ftrl(Optimizer):
    """Follow-the-regularized-leader with L1/L2 terms."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    _OP_TYPE = "ftrl"
    _FUSE_ACCS = (("SquaredAccumulator", "SquaredAccumOut", "squared"),
                  ("LinearAccumulator", "LinearAccumOut", "linear"))

    def _update_consts(self, scale):
        return (scale, self._l1, self._l2, self._lr_power)


class ProximalGD(Optimizer):
    """prox = param - lr*g; sign(prox) * max(|prox| - lr*l1, 0) /
    (1 + lr*l2)."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._l1 = float(l1)
        self._l2 = float(l2)

    _OP_TYPE = "proximal_gd"

    def _update_consts(self, scale):
        return (scale, self._l1, self._l2)


class ProximalAdagrad(Optimizer):
    """m += g*g; the ProximalGD step at lr / sqrt(m + 1e-12)."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._l1 = float(l1)
        self._l2 = float(l2)

    _OP_TYPE = "proximal_adagrad"
    _FUSE_ACCS = (("Moment", "MomentOut", "moment"),)

    def _update_consts(self, scale):
        return (scale, self._l1, self._l2)


class ModelAverage(Optimizer):
    """Running parameter sums for an averaged model (reference:
    optimizer.py:1111 ModelAverage). ``apply_to(program)`` appends one
    ``model_average_accum`` op per trainable parameter, after the
    program's update ops, adding the parameter into its ``sum``
    accumulator and one into its ``num_accum`` counter;
    ``averaged_value`` reads ``sum / max(num, 1)``. As in the JAX
    package, the window arguments are kept but not applied, and no
    ``apply()``/``restore()`` context swaps the averages in."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, **kw):
        super().__init__(0.0, **kw)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self.params: List[Parameter] = []

    def apply_to(self, program: Program):
        """Append the averaging ops over every trainable parameter of
        ``program``."""
        self._program = program
        gb = program.global_block()
        self.params = [p for p in gb.all_parameters() if p.trainable]
        self._create_global_learning_rate()
        for p in self.params:
            s = self._add_accumulator("sum", p)
            n = self._add_accumulator("num_accum", p, shape=())

            def fn(pv, sv, nv):
                return sv + pv, nv + 1.0

            gb.append_op(type="model_average_accum",
                         inputs={"Param": [p.name], "Sum": [s.name],
                                 "Num": [n.name]},
                         outputs={"SumOut": [s.name], "NumOut": [n.name]},
                         fn=fn)

    def averaged_value(self, scope, param: Parameter):
        """``sum / max(num, 1)`` of ``param`` from ``scope`` (a tensor
        on the scope's device)."""
        s = scope.get(self._get_accumulator("sum", param).name)
        n = scope.get(self._get_accumulator("num_accum", param).name)
        return s / torch.clamp(n, min=1.0)


class GradientAccumulation(Optimizer):
    """Micro-batch gradient accumulation around an inner optimizer.
    Gradients add up in persistable ``grad_acc`` buffers for
    ``accumulate_steps`` steps; on the k-th the inner optimizer applies
    their mean, and the buffers reset. The apply predicate comes from a
    step counter on the card (``grad_accum_tick``), and the inner update
    ops are gated on it (:func:`mask_update_op`), so a step never waits
    for the host: k micro-steps at fixed parameters equal one inner step
    on their mean gradient (one step on the concatenated batch when the
    loss is a batch mean). Clipping and regularization apply to the
    mean. Row-sparse gradients are refused."""

    def __init__(self, inner_optimizer: Optimizer, accumulate_steps: int,
                 **kw):
        enforce(accumulate_steps >= 1, "accumulate_steps must be >= 1")
        super().__init__(inner_optimizer._learning_rate, **kw)
        self.inner = inner_optimizer
        self.k = int(accumulate_steps)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .clip import append_gradient_clip_ops

        if isinstance(self.inner._learning_rate, Variable):
            warnings.warn(
                "GradientAccumulation: LR-schedule counters advance once "
                "per MICRO-step (every exe.run), not per applied update — "
                "scale decay_steps by accumulate_steps to keep the "
                "schedule aligned with applied steps")
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        for p, g in params_grads:
            enforce(not getattr(g, "is_sparse_rows", False),
                    "GradientAccumulation does not support sparse "
                    "(rows, values) gradients; use a dense embedding "
                    f"for {p.name!r}")

        program = loss.block.program
        self._program = self.inner._program = program
        if startup_program is not None:
            self._startup = self.inner._startup = startup_program
        gb = program.global_block()
        k = self.k

        # the step counter and the apply flag, on the resolved programs
        counter = self._create_persistable_state(
            unique_name.generate("grad_accum_step"), (), "int32", 0)
        apply_flag = gb.create_var(
            name=unique_name.generate("grad_accum_apply"), shape=(),
            dtype="bool")

        def tick(c):
            c_new = c + 1
            return torch.remainder(c_new, k) == 0, c_new

        gb.append_op(type="grad_accum_tick",
                     inputs={"Counter": [counter.name]},
                     outputs={"Apply": [apply_flag.name],
                              "CounterOut": [counter.name]}, fn=tick)

        # acc += g; the mean acc / k feeds the inner optimizer; acc
        # resets on apply steps
        new_pg = []
        for p, g in params_grads:
            if g is None:
                new_pg.append((p, g))
                continue
            acc = self.inner._add_accumulator("grad_acc", p)
            avg = gb.create_var(name=g.name + "@ACCUM_AVG",
                                shape=g.shape, dtype=g.dtype)

            def acc_fn(gv, av, fl):
                a_new = av + gv
                return (torch.where(fl, torch.zeros_like(a_new), a_new),
                        a_new / k)

            gb.append_op(type="grad_accumulate",
                         inputs={"Grad": [g.name], "Acc": [acc.name],
                                 "Apply": [apply_flag.name]},
                         outputs={"AccOut": [acc.name],
                                  "Avg": [avg.name]}, fn=acc_fn)
            new_pg.append((p, avg))

        # clip and regularize the mean (clip(mean) != mean(clip)): the
        # combined-batch equivalence
        new_pg = append_gradient_clip_ops(new_pg)
        new_pg = append_regularization_ops(
            new_pg, self.regularization or self.inner.regularization)

        ops = self.inner._create_optimization_pass(new_pg, loss,
                                                   startup_program)
        for op in ops:
            mask_update_op(op, apply_flag)
        self._learning_rate_var = self.inner._learning_rate_var
        return ops, params_grads


# the reference's aliases
SGDOptimizer = SGD
MomentumOptimizer = Momentum
AdagradOptimizer = Adagrad
AdamOptimizer = Adam
AdamaxOptimizer = Adamax
DecayedAdagradOptimizer = DecayedAdagrad
AdadeltaOptimizer = Adadelta
RMSPropOptimizer = RMSProp
FtrlOptimizer = Ftrl
ProximalGDOptimizer = ProximalGD
ProximalAdagradOptimizer = ProximalAdagrad
