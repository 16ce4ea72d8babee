"""Mixture-of-experts FFN (counterpart of paddle_tpu/layers/moe.py): a
Switch-style top-1 routed expert FFN on one device.

* router: softmax(x @ Wr) in f32, top-1 expert per token;
* capacity C = ceil(capacity_factor * S / E); a token past its expert's
  capacity is dropped (its output row is 0; the caller's residual
  carries it), found with a running count per expert;
* dispatch ``[S, E, C]`` one-hot einsums in, the expert FFN (relu)
  batched over the ``[E]`` axis of the weights, combine einsums out
  weighted by the router probability;
* the Switch load-balancing loss ``E * sum_e f_e p_e`` (f_e the
  fraction of tokens routed to e, p_e the mean router probability),
  returned for the caller to add to the objective.

The expert weights ``[E, d, d_inner]`` / ``[E, d_inner, d]`` are
annotated ``sharding_spec = ("ep", None, None)`` as in the JAX package,
whose SPMD partitioner turns the einsums into all-to-alls on a mesh
with an ``ep`` axis. The port runs on one card: a ``mesh`` whose ``ep``
axis is larger than 1 is refused (ROADMAP Queue A 9).
"""

from __future__ import annotations

import math

import torch

from ..core import initializer as init
from ..core.enforce import enforce, not_ported
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr


def switch_moe(x, num_experts: int, d_inner: int, capacity_factor=1.25,
               param_attr=None, name=None, mesh=None):
    """Top-1 routed expert FFN: ``[B, T, d]`` to (``[B, T, d]``,
    aux_loss). ``param_attr`` governs every weight of the layer (names
    stay generated per weight). ``mesh`` (axis name -> size) may only
    have ``ep`` of 1 here."""
    if mesh is not None and int(dict(mesh).get("ep", 1)) > 1:
        raise not_ported("switch_moe over a mesh with ep=%d (expert "
                         "parallelism)" % int(dict(mesh)["ep"]),
                         "Queue A 9")
    helper = LayerHelper("switch_moe")
    d_model = int(x.shape[-1])
    E, F = int(num_experts), int(d_inner)
    enforce(E >= 2, "switch_moe needs at least 2 experts")
    base = ParamAttr._to_attr(param_attr)

    def param(shape, spec, is_bias=False):
        attr = ParamAttr(initializer=base.initializer,
                         learning_rate=base.learning_rate,
                         regularizer=base.regularizer,
                         trainable=base.trainable,
                         gradient_clip=base.gradient_clip)
        p = helper.create_parameter(
            attr, shape, x.dtype, is_bias=is_bias,
            default_initializer=None if is_bias else init.Xavier())
        p.sharding_spec = spec
        return p

    wr = param([d_model, E], None)
    w1 = param([E, d_model, F], ("ep", None, None))
    b1 = param([E, F], ("ep", None), is_bias=True)
    w2 = param([E, F, d_model], ("ep", None, None))
    b2 = param([E, d_model], ("ep", None), is_bias=True)

    out = helper.create_tmp_variable(x.dtype)
    aux = helper.create_tmp_variable("float32")
    cf = float(capacity_factor)

    def fn(xv, wrv, w1v, b1v, w2v, b2v):
        B, T, D = xv.shape
        S = B * T
        C = max(1, math.ceil(cf * S / E))
        xs = xv.reshape(S, D)
        # route (router math in f32 whatever the stream dtype)
        logits = xs.to(torch.float32) @ wrv.to(torch.float32)
        probs = torch.softmax(logits, -1)                      # [S, E]
        experts = torch.arange(E, device=xv.device)
        onehot = (probs.argmax(-1)[:, None] == experts).to(torch.float32)
        gate = (probs * onehot).sum(-1)                        # [S]
        # each token's place in its expert's queue; past capacity its
        # one-hot row over C is all zeros: the drop
        pos = ((torch.cumsum(onehot, 0) * onehot).sum(-1) - 1.0).to(
            torch.int64)
        pos_oh = (pos[:, None] == torch.arange(C, device=xv.device)).to(
            torch.float32)                                     # [S, C]
        dispatch = onehot[:, :, None] * pos_oh[:, None, :]     # [S, E, C]
        combine = dispatch * gate[:, None, None]
        xin = torch.einsum("sec,sd->ecd", dispatch.to(xv.dtype), xs)
        h = torch.relu(torch.einsum("ecd,edf->ecf", xin, w1v)
                       + b1v[:, None, :])
        xout = torch.einsum("ecf,efd->ecd", h, w2v) + b2v[:, None, :]
        ys = torch.einsum("sec,ecd->sd", combine.to(xv.dtype), xout)
        # Switch aux loss (load balance)
        aux_l = E * (onehot.mean(0) * probs.mean(0)).sum()
        return ys.reshape(B, T, D), aux_l

    helper.append_op(
        type="switch_moe",
        inputs={"X": [x.name], "RouterW": [wr.name],
                "W1": [w1.name], "B1": [b1.name],
                "W2": [w2.name], "B2": [b2.name]},
        outputs={"Out": [out.name], "AuxLoss": [aux.name]},
        attrs={"num_experts": E, "capacity_factor": cf}, fn=fn)
    out.shape = x.shape
    return out, aux


__all__ = ["switch_moe"]
