"""Optimizers (counterpart of paddle_tpu/optimizer.py): the base class
with the per-parameter update path, SGD and Adam.

``minimize(loss)`` = ``append_backward`` + gradient clipping +
regularization + one update op per parameter. Accumulators are named
persistable variables initialized by ``fill_constant`` ops in the
startup program, with the JAX package's names, so a state saved by
either package loads into the other (``convert.state_from_numpy``).
An update op's fn is ``(param, grad, lr, *accumulators) ->
(new_param, *new_accumulators)``; the Executor runs it with autograd
off and writes the persistable outputs back to the scope.

Adam's two beta-power scalars are shared by every parameter: exactly
one update op (the owner's, the last parameter's) advances them, and
every other op reads the step-start value, because ops run in program
order.

Not ported yet (they raise): the flat ``fuse_optimizer_state`` layout
and its fused update kernel, row-sparse updates (lazy Adam), bf16
moments, and the rest of the optimizer family.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .backward import append_backward
from .core import dtype_utils, flags, unique_name
from .core.enforce import enforce, not_ported
from .core.program import (Parameter, Program, Variable,
                           default_main_program, default_startup_program)
from .regularizer import append_regularization_ops


class Optimizer:
    """Base class. An optimizer declares its dense update once through
    ``_make_update_fn(scale, owns)`` and its accumulators through
    ``_FUSE_ACCS`` (per parameter) and ``_FUSE_SHARED`` (scalars shared
    by every parameter), as in the JAX package."""

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
        if flags.get_flag("bf16_moments"):
            raise not_ported("bf16 optimizer moments (bf16_moments)",
                             "Queue A 3, step 3: the bf16 flags")
        shape = tuple(shape if shape is not None else param.shape)
        var = self._create_persistable_state(
            unique_name.generate(f"{param.name}_{name}"), shape,
            dtype or param.dtype, float(fill_value))
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
    def _make_update_fn(self, scale, owns):
        """The dense elementwise update ``fn(param, grad, lr,
        *accumulators, *shared_scalars) -> (new_param,
        *new_accumulators[, *advanced_scalars if owns])``."""
        return None

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

    def _create_optimization_pass(self, params_grads, loss,
                                  startup_program=None):
        if flags.get_flag("fuse_optimizer_state"):
            raise not_ported("the flat optimizer-state layout "
                             "(fuse_optimizer_state)",
                             "Queue A 3, step 1, with Queue B 4")
        self._program = loss.block.program
        if startup_program is not None:
            self._startup = startup_program
        gb = self._program.global_block()
        self._create_global_learning_rate()
        live = [(p, g) for p, g in params_grads if g is not None]
        # only params that receive an update op get accumulators, so the
        # shared beta-pow owner's op exists
        self._create_accumulators(gb, [p for p, _ in live])
        ops = [self._append_optimize_op(gb, pg) for pg in live]
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
        out_dtypes = [dtype_utils.to_torch(var.dtype) for var in
                      [param] + [var for _, var in (extra_out or [])]]

        def pinned(*args):
            res = fn(*args)
            one = not isinstance(res, (tuple, list))
            vals = (res,) if one else tuple(res)
            cast = tuple(v if v.dtype == dt else v.to(dt)
                         for v, dt in zip(vals, out_dtypes))
            return cast[0] if one else cast

        return block.append_op(type=opt_name, inputs=inputs,
                               outputs=outputs, fn=pinned)


class SGD(Optimizer):
    """param - lr * grad."""

    _OP_TYPE = "sgd"

    def _make_update_fn(self, scale, owns):
        def fn(pv, gv, lr):
            return pv - (lr * scale) * gv

        return fn


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

    def _make_update_fn(self, scale, owns):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon

        def fn(pv, gv, lr, m1v, m2v, b1pv, b2pv):
            lr = lr * scale
            m1n = b1 * m1v + (1 - b1) * gv
            m2n = b2 * m2v + (1 - b2) * gv * gv
            lr_t = lr * torch.sqrt(1 - b2pv) / (1 - b1pv)
            p_new = pv - lr_t * m1n / (torch.sqrt(m2n) + eps)
            if owns:
                return p_new, m1n, m2n, b1pv * b1, b2pv * b2
            return p_new, m1n, m2n

        return fn


SGDOptimizer = SGD
AdamOptimizer = Adam
