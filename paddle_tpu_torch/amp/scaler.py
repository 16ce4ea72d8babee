"""Dynamic loss scaling: grow/backoff scale state, the overflow flag on
the card, update-skip gating (counterpart of paddle_tpu/amp/scaler.py).

Scale the loss before the backward pass so small gradients survive the
low-precision format, unscale before the update, skip the step and back
the scale off when any gradient overflows, grow it again after N clean
steps ("Mixed Precision Training", Micikevicius et al., ICLR 2018
§3.2). bf16 shares f32's 8-bit exponent, so overflow is rare; the scaler
is cheap insurance, and the skip path is the one a preempted step needs.

Everything stays on the device: the overflow predicate is one bool on
the card (:func:`device_all_finite`), the grow/backoff rule a
``torch.where`` tree over three scalars, and the gated update reads the
flag where it lies, so a step makes no host sync and a captured
``run_steps`` graph skips an overflowed step inside its replay. Only
:meth:`DynamicLossScaler.found_overflow` and
:meth:`DynamicLossScaler.loss_scaling` read a scalar back, on demand.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import dtype_utils, unique_name
from ..core.program import Program, Variable


def device_all_finite(vals) -> torch.Tensor:
    """ONE bool tensor on the tensors' device: whether every element of
    every float tensor in ``vals`` is finite; no host sync, capturable
    in a CUDA graph, and read-only. The reduction behind the executor's
    ``check_nan_inf`` sweep: each tensor's ``isfinite().all()``,
    stacked and reduced. (The scaler's unscale fuses its own check into
    the multiply: ``amp.decorator._unscale``.)"""
    floats = [v.detach() for v in vals
              if isinstance(v, torch.Tensor) and v.is_floating_point()]
    if not floats:
        return torch.ones((), dtype=torch.bool)
    return torch.stack([torch.isfinite(v).all() for v in floats]).all()


def _persistable_state(main: Program, startup: Program, name: str,
                       dtype, value) -> Variable:
    """A scalar persistable on ``main`` and its fill_constant init on
    ``startup`` (the optimizer accumulator pattern)."""
    var = main.global_block().create_var(name=name, shape=(), dtype=dtype,
                                         persistable=True)
    sb = startup.global_block()
    sb.create_var(name=name, shape=(), dtype=dtype, persistable=True)
    tdt = dtype_utils.to_torch(dtype)
    sb.append_op(type="fill_constant", inputs={},
                 outputs={"Out": [name]},
                 attrs={"shape": (), "value": value},
                 fn=lambda: torch.full((), value, dtype=tdt))
    return var


class DynamicLossScaler:
    """Grow/backoff loss-scale state as three persistable scalars
    (``loss_scaling`` f32, ``good_steps`` int32, ``bad_steps`` int32)
    and the update rule applied inside the step:

      * overflow step — ``bad_steps += 1``; when it reaches
        ``decr_every_n_nan_or_inf``, ``scale *= decr_ratio`` (floored at
        ``min_loss_scaling``) and both counters reset. The parameter
        update of that step is gated off (see ``amp.decorate``).
      * clean step — ``good_steps += 1``; when it reaches
        ``incr_every_n_steps``, ``scale *= incr_ratio`` and the counters
        reset.

    With ``use_dynamic_loss_scaling=False`` the scale stays at
    ``init_loss_scaling`` (overflow steps are still skipped)."""

    def __init__(self, init_loss_scaling: float = 2.0 ** 15,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 incr_ratio: float = 2.0,
                 decr_ratio: float = 0.5,
                 min_loss_scaling: float = 1.0,
                 use_dynamic_loss_scaling: bool = True):
        assert incr_ratio > 1.0 and 0.0 < decr_ratio < 1.0
        self.init_loss_scaling = float(init_loss_scaling)
        self.incr_every_n_steps = int(incr_every_n_steps)
        self.decr_every_n_nan_or_inf = int(decr_every_n_nan_or_inf)
        self.incr_ratio = float(incr_ratio)
        self.decr_ratio = float(decr_ratio)
        self.min_loss_scaling = float(min_loss_scaling)
        self.use_dynamic_loss_scaling = bool(use_dynamic_loss_scaling)
        self.scale_var: Optional[Variable] = None
        self.good_var: Optional[Variable] = None
        self.bad_var: Optional[Variable] = None
        self.found_inf_var: Optional[Variable] = None

    # -- program wiring -------------------------------------------------
    def attach(self, main: Program, startup: Program) -> None:
        """Create the scale and counter state on (main, startup), once
        per scaler."""
        if self.scale_var is not None:
            return
        base = unique_name.generate("loss_scaling")
        self.scale_var = _persistable_state(
            main, startup, base, "float32", self.init_loss_scaling)
        self.good_var = _persistable_state(
            main, startup, base + "_good_steps", "int32", 0)
        self.bad_var = _persistable_state(
            main, startup, base + "_bad_steps", "int32", 0)

    def update_fn(self):
        """``(scale, good, bad, found_inf) -> (scale', good', bad')``:
        the grow/backoff rule as one ``torch.where`` tree."""
        incr_n = self.incr_every_n_steps
        decr_n = self.decr_every_n_nan_or_inf
        incr, decr = self.incr_ratio, self.decr_ratio
        floor = self.min_loss_scaling
        dynamic = self.use_dynamic_loss_scaling

        def fn(s, g, b, fi):
            if not dynamic:
                return s, g, b
            b1 = torch.where(fi, b + 1, 0)
            g1 = torch.where(fi, 0, g + 1)
            shrink = b1 >= decr_n
            grow = torch.logical_and(torch.logical_not(fi), g1 >= incr_n)
            s1 = torch.where(shrink, torch.clamp(s * decr, min=floor),
                             torch.where(grow, s * incr, s))
            return (s1,
                    torch.where(torch.logical_or(grow, shrink), 0, g1),
                    torch.where(shrink, 0, b1))

        return fn

    # -- host-side views (each ONE scalar read) -------------------------
    def loss_scaling(self, scope) -> float:
        """The current scale (one scalar read)."""
        return float(scope.get(self.scale_var.name))

    def found_overflow(self, scope) -> bool:
        """Whether the LAST executed step saw a non-finite gradient: the
        one-bool read, on demand only."""
        if self.found_inf_var is None or \
                not scope.has_var(self.found_inf_var.name):
            return False
        return bool(scope.get(self.found_inf_var.name))

    def state_names(self):
        """The persistable scalars' names (checkpointed with the
        parameters, so a resumed run continues the grow/backoff
        trajectory exactly)."""
        return tuple(v.name for v in (self.scale_var, self.good_var,
                                      self.bad_var) if v is not None)
