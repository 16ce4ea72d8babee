"""``amp.decorate(optimizer)`` — autocast and loss scaling wired into
``minimize`` (counterpart of paddle_tpu/amp/decorator.py).

``minimize`` runs the JAX package's sequence:

  1. :func:`amp.rewrite_program` rewrites the forward graph, before
     autodiff: the gradient flows back through the inserted casts and
     reaches the f32 master weights in f32;
  2. the loss is multiplied by the persistable loss-scale scalar
     (``amp_scale_loss``) and ``append_backward`` runs on the scaled
     loss;
  3. ONE ``amp_check_finite_and_unscale`` op reduces the gradients'
     finiteness to one bool on the card and unscales them (a row-sparse
     gradient through its values; its rows are integers), writing
     ``FoundInf`` (persistable) and ``Ok``;
  4. gradient clipping and regularization run on the unscaled
     gradients, then the inner optimizer's update ops, each gated on
     ``Ok`` (``optimizer.mask_update_op``): an overflowed step advances
     nothing — parameters, moments, beta powers all hold;
  5. one ``amp_update_loss_scaling`` op applies the grow/backoff rule.

Parameters are created f32 and stay f32 in the scope — they ARE the
master copy. The rewrite's ``amp_cast_params`` op makes the step's bf16
working copy; moments and updates run f32 on the masters (bf16 moments
only under the ``bf16_moments`` flag), so checkpoints keep the
canonical f32 names and load into AMP and non-AMP programs alike.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..backward import append_backward
from ..core import unique_name
from ..core.enforce import enforce
from ..core.program import default_startup_program
from ..optimizer import Optimizer, mask_update_op
from ..regularizer import append_regularization_ops
from .policy import AmpPolicy
from .rewrite import rewrite_program
from .scaler import DynamicLossScaler, _persistable_state


def _unscale(*args):
    """``(grads..., scale) -> (grads / scale..., found_inf, ok)``: each
    gradient times ``1 / scale`` in its own dtype and the finiteness of
    the scaled gradients as one bool on the card, in one pass: one
    ``torch._amp_foreach_non_finite_check_and_unscale_`` launch per
    dtype, in place (the op's outputs are its gradient inputs). The
    multiplier is ``1 / scale`` rounded to the gradient's dtype, so each
    product rounds as the JAX package's ``g * inv.astype(g.dtype)``. A
    gradient listed twice is scaled once; one that is not contiguous (an
    expanded view) is copied first."""
    gs, sv = list(args[:-1]), args[-1]
    found = torch.zeros((), dtype=torch.float32, device=sv.device)
    inv = 1.0 / sv.float()
    outs, by_dtype, seen = [], {}, {}
    for g in gs:
        if id(g) not in seen:
            seen[id(g)] = g if g.is_contiguous() else g.contiguous()
            by_dtype.setdefault(g.dtype, []).append(seen[id(g)])
        outs.append(seen[id(g)])
    for dtype, group in by_dtype.items():
        torch._amp_foreach_non_finite_check_and_unscale_(
            group, found, inv.to(dtype).float())
    ok = found == 0
    return tuple(outs) + (torch.logical_not(ok), ok)


class OptimizerWithMixedPrecision:
    """Wraps a :class:`paddle_tpu_torch.optimizer.Optimizer`;
    ``minimize`` runs the five steps above. The inner optimizer's
    accumulators and update arithmetic stay f32."""

    def __init__(self, optimizer: Optimizer, policy: AmpPolicy,
                 scaler: DynamicLossScaler):
        enforce(isinstance(optimizer, Optimizer),
                "amp.decorate expects a paddle_tpu_torch optimizer instance")
        # a wrapper optimizer (GradientAccumulation) keeps its machinery
        # in its own minimize(), which this class would bypass
        enforce(type(optimizer).minimize is Optimizer.minimize,
                f"amp.decorate cannot wrap {type(optimizer).__name__}: "
                "its minimize() override would be bypassed. Decorate "
                "the plain optimizer (e.g. the one inside "
                "GradientAccumulation) instead")
        self.inner = optimizer
        self.policy = policy
        self.scaler = scaler

    @property
    def global_learning_rate(self):
        return self.inner.global_learning_rate

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from ..clip import append_gradient_clip_ops

        program = loss.block.program
        startup = startup_program or default_startup_program()
        gb = program.global_block()

        # 1. autocast rewrite of the forward graph
        rewrite_program(program, self.policy)
        program._amp_stamp += f"/scaler:{self.scaler.init_loss_scaling}"

        # 2. scaled loss
        self.scaler.attach(program, startup)
        scale_var = self.scaler.scale_var
        scaled = gb.create_var(
            name=unique_name.generate(loss.name + "@SCALED"), shape=(),
            dtype="float32")
        gb.append_op(
            type="amp_scale_loss",
            inputs={"X": [loss.name], "LossScaling": [scale_var.name]},
            outputs={"Out": [scaled.name]},
            fn=lambda lv, sv: lv * sv.to(lv.dtype))

        params_grads = append_backward(scaled, parameter_list, no_grad_set)
        live = [(p, g) for p, g in params_grads if g is not None]
        enforce(live, "amp.decorate: no trainable parameter receives a "
                      "gradient")

        # 3. one finiteness bool and the unscaled gradients; found_inf
        # is persistable with a startup init, so a save before the first
        # step finds it in the scope
        found_inf = _persistable_state(
            program, startup, unique_name.generate("amp_found_inf"),
            "bool", False)
        ok = gb.create_var(name=unique_name.generate("amp_ok"), shape=(),
                           dtype="bool")
        self.scaler.found_inf_var = found_inf
        grad_names = [g.name for _, g in live]
        gb.append_op(
            type="amp_check_finite_and_unscale",
            inputs={"Grads": list(grad_names),
                    "LossScaling": [scale_var.name]},
            outputs={"Out": list(grad_names),
                     "FoundInf": [found_inf.name], "Ok": [ok.name]},
            fn=_unscale)

        # 4. clip and regularize the unscaled gradients (the reference's
        # order), then the inner update pass, each op gated on ok
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(
            params_grads, self.inner.regularization)
        opt_ops = self.inner._create_optimization_pass(
            params_grads, loss, startup_program)
        for op in opt_ops:
            if op is not None:
                mask_update_op(op, ok)

        # 5. grow/backoff
        gb.append_op(
            type="amp_update_loss_scaling",
            inputs={"LossScaling": [scale_var.name],
                    "GoodSteps": [self.scaler.good_var.name],
                    "BadSteps": [self.scaler.bad_var.name],
                    "FoundInf": [found_inf.name]},
            outputs={"LossScalingOut": [scale_var.name],
                     "GoodStepsOut": [self.scaler.good_var.name],
                     "BadStepsOut": [self.scaler.bad_var.name]},
            fn=self.scaler.update_fn())
        return opt_ops, params_grads

    def get_loss_scaling(self, scope) -> float:
        return self.scaler.loss_scaling(scope)

    def found_overflow(self, scope) -> bool:
        return self.scaler.found_overflow(scope)


def decorate(optimizer: Optimizer,
             amp_policy: Optional[AmpPolicy] = None,
             init_loss_scaling: float = 2.0 ** 15,
             incr_every_n_steps: int = 1000,
             decr_every_n_nan_or_inf: int = 2,
             incr_ratio: float = 2.0,
             decr_ratio: float = 0.5,
             use_dynamic_loss_scaling: bool = True
             ) -> OptimizerWithMixedPrecision:
    """Wrap ``optimizer`` for graph-level automatic mixed precision:
    ``decorate(opt).minimize(loss)`` = autocast rewrite + scaled
    backward + finite-checked unscale + gated f32 updates + dynamic
    loss-scale maintenance."""
    scaler = DynamicLossScaler(
        init_loss_scaling=init_loss_scaling,
        incr_every_n_steps=incr_every_n_steps,
        decr_every_n_nan_or_inf=decr_every_n_nan_or_inf,
        incr_ratio=incr_ratio, decr_ratio=decr_ratio,
        use_dynamic_loss_scaling=use_dynamic_loss_scaling)
    return OptimizerWithMixedPrecision(optimizer,
                                       amp_policy or AmpPolicy(), scaler)
