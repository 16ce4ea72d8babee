"""Learning-rate schedules (counterpart of
paddle_tpu/layers/learning_rate_scheduler.py: the eight schedules and
``append_LARS``).

Each schedule creates the persistable ``@LR_DECAY_COUNTER@`` step
counter (once per program; an ``increment`` op advances it by one each
run of the program, before any schedule reads it) plus an op computing
the decayed learning rate from it. The result Variable is passed as
``learning_rate=`` to an optimizer. The counter and the rate are 0-d
float32 tensors on the executor's device, computed there: nothing
syncs the host and no host value is copied in, so a schedule runs
inside ``Executor.run_steps``' captured CUDA graph, and the fused
update kernel reads the rate through its device pointer.
"""

from __future__ import annotations

import math

import torch

from ..core.program import default_main_program, default_startup_program
from ..layer_helper import LayerHelper

COUNTER_NAME = "@LR_DECAY_COUNTER@"


def _global_step_counter():
    """The persistable float32 step counter, incremented each run."""
    gb = default_main_program().global_block()
    if COUNTER_NAME in gb.vars:
        return gb.vars[COUNTER_NAME]
    v = gb.create_var(name=COUNTER_NAME, shape=(), dtype="float32",
                      persistable=True)
    sb = default_startup_program().global_block()
    sb.create_var(name=COUNTER_NAME, shape=(), dtype="float32",
                  persistable=True)
    sb.append_op(type="fill_constant", inputs={},
                 outputs={"Out": [COUNTER_NAME]},
                 attrs={"shape": (), "value": 0.0},
                 fn=lambda: torch.zeros((), dtype=torch.float32))
    gb.append_op(type="increment", inputs={"X": [COUNTER_NAME]},
                 outputs={"Out": [COUNTER_NAME]}, fn=lambda c: c + 1.0)
    return v


def _schedule(name, fn):
    helper = LayerHelper(name)
    step = _global_step_counter()
    out = helper.block.create_var(name=helper.unique_out("lr"),
                                  shape=(), dtype="float32")
    helper.append_op(type=name, inputs={"Step": [step.name]},
                     outputs={"Out": [out.name]}, fn=fn)
    return out


def noam_decay(d_model, warmup_steps):
    """The Transformer's schedule: d_model^-0.5 * min(s^-0.5,
    s * warmup^-1.5) at s = step + 1."""
    return _schedule(
        "noam_decay",
        lambda s: (d_model ** -0.5) * torch.minimum(
            (s + 1.0) ** -0.5, (s + 1.0) * float(warmup_steps) ** -1.5))


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * decay_rate ^ (step / decay_steps), floored with
    ``staircase``."""

    def fn(s):
        e = s / decay_steps
        if staircase:
            e = torch.floor(e)
        return learning_rate * torch.pow(decay_rate, e)

    return _schedule("exponential_decay", fn)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * exp(-decay_rate * step / decay_steps)."""

    def fn(s):
        e = s / decay_steps
        if staircase:
            e = torch.floor(e)
        return learning_rate * torch.exp(-decay_rate * e)

    return _schedule("natural_exp_decay", fn)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """lr / (1 + decay_rate * step / decay_steps)."""

    def fn(s):
        e = s / decay_steps
        if staircase:
            e = torch.floor(e)
        return learning_rate / (1.0 + decay_rate * e)

    return _schedule("inverse_time_decay", fn)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4,
                     power=1.0, cycle=False):
    """(lr - end) * (1 - step / decay_steps) ^ power + end, the decay
    steps growing by whole periods with ``cycle``."""

    def fn(s):
        if cycle:
            div = torch.ceil(torch.clamp(s, min=1.0) / decay_steps)
            ds = decay_steps * torch.clamp(div, min=1.0)
        else:
            ds = float(decay_steps)
            s = torch.clamp(s, max=ds)
        return ((learning_rate - end_learning_rate) *
                torch.pow(1 - s / ds, power) + end_learning_rate)

    return _schedule("polynomial_decay", fn)


def piecewise_decay(boundaries, values):
    """values[i], i the number of boundaries the step has reached. The
    lookup is a chain of selects on the card (no host copy of the
    tables)."""
    bounds = [float(b) for b in boundaries]
    vals = [float(v) for v in values]

    def fn(s):
        idx = torch.zeros_like(s)
        for b in bounds:
            idx = idx + (s >= b).to(s.dtype)
        lr = torch.full_like(s, vals[0])
        for i, v in enumerate(vals[1:], 1):
            lr = torch.where(idx == i, torch.full_like(s, v), lr)
        return lr

    return _schedule("piecewise_decay", fn)


def cosine_decay(learning_rate, step_each_epoch, epochs):
    """lr * (cos(epoch * pi / epochs) + 1) / 2."""

    def fn(s):
        epoch = torch.floor(s / step_each_epoch)
        return learning_rate * 0.5 * (
            torch.cos(epoch * math.pi / epochs) + 1)

    return _schedule("cosine_decay", fn)


def append_LARS(params_grads, learning_rate, weight_decay):
    """Layer-wise adaptive rates: lr * |p| / (|g| + weight_decay * |p|
    + 1e-12) per parameter. Returns the per-parameter rate variables."""
    outs = []
    for p, g in params_grads:
        helper = LayerHelper("lars")
        out = helper.block.create_var(name=helper.unique_out("lars_lr"),
                                      shape=(), dtype="float32")

        def fn(lr, pv, gv):
            pn = torch.sqrt(torch.sum(torch.square(pv)))
            gn = torch.sqrt(torch.sum(torch.square(gv)))
            return lr * pn / (gn + weight_decay * pn + 1e-12)

        helper.append_op(type="lars",
                         inputs={"LR": [learning_rate.name],
                                 "Param": [p.name], "Grad": [g.name]},
                         outputs={"Out": [out.name]}, fn=fn)
        outs.append(out)
    return outs
