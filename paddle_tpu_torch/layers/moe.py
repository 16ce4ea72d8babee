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
with an ``ep`` axis. In the port's sharded run over such a mesh each
rank holds its block of E/ep experts (weights and biases) and the op
runs the same math explicitly:

* the routing, the capacity and the aux loss are computed alike on
  every rank of ``ep`` (its ranks hold the same tokens: ``ep`` is no
  batch axis), over the whole batch when ``dp`` splits it: each rank's
  queue positions are offset by the tokens earlier ``dp`` blocks routed
  to each expert (an all-gather of ``[E]`` counts), the capacity comes
  from the whole batch's token count, and the aux loss's means are sums
  over the batch axes — so the drops and the loss are one device's;
* each rank runs its experts on the tokens that chose them and the
  ranks' outputs are summed over ``ep`` (the tokens are already on
  every rank, so no all-to-all is needed); the tokens and the gate
  enter the expert part through ``comm.CopyToGroup``, whose backward
  sums their gradients over ``ep``, each rank having its experts'
  share.

``mesh`` (axis name -> size) is the JAX package's build-time check: a
mesh the program cannot run on is refused.
"""

from __future__ import annotations

import math

import torch

from ..core import initializer as init
from ..core.enforce import enforce
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr


def switch_moe(x, num_experts: int, d_inner: int, capacity_factor=1.25,
               param_attr=None, name=None, mesh=None):
    """Top-1 routed expert FFN: ``[B, T, d]`` to (``[B, T, d]``,
    aux_loss). ``param_attr`` governs every weight of the layer (names
    stay generated per weight). ``mesh`` (axis name -> size): its
    ``ep`` axis must divide ``num_experts``."""
    if mesh is not None:
        ep = int(dict(mesh).get("ep", 1))
        enforce(ep >= 1 and int(num_experts) % ep == 0,
                "switch_moe: %d experts do not split over ep=%d"
                % (int(num_experts), ep))
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
        from ..core.trace_ctx import current_mesh
        from ..sharding import comm

        B, T, D = xv.shape
        S = B * T
        xs = xv.reshape(S, D)
        lo, hi, group, batch = _expert_part(current_mesh(), w1v.shape[0], E)
        # the batch axes that split the tokens: counts, capacity and
        # means are the whole batch's
        n_b = 1
        for _a, _g, n in batch:
            n_b *= n
        C = max(1, math.ceil(cf * S * n_b / E))
        # route (router math in f32 whatever the stream dtype)
        logits = xs.to(torch.float32) @ wrv.to(torch.float32)
        probs = torch.softmax(logits, -1)                      # [S, E]
        experts = torch.arange(E, device=xv.device)
        onehot = (probs.argmax(-1)[:, None] == experts).to(torch.float32)
        gate = (probs * onehot).sum(-1)                        # [S]
        # each token's place in its expert's queue; past capacity its
        # one-hot row over C is all zeros: the drop
        pos = torch.cumsum(onehot, 0)
        if batch:
            pos = pos + _earlier_counts(onehot, batch)
        pos = ((pos * onehot).sum(-1) - 1.0).to(torch.int64)
        pos_oh = (pos[:, None] == torch.arange(C, device=xv.device)).to(
            torch.float32)                                     # [S, C]
        # this rank's experts on the tokens that chose them; over ep
        # their gradients are summed and the ranks' outputs too
        if group is not None:
            xs = comm.CopyToGroup.apply(xs, group)
            gate = comm.CopyToGroup.apply(gate, group)
        dispatch = onehot[:, lo:hi, None] * pos_oh[:, None, :]  # [S, e, C]
        combine = dispatch * gate[:, None, None]
        xin = torch.einsum("sec,sd->ecd", dispatch.to(xv.dtype), xs)
        h = torch.relu(torch.einsum("ecd,edf->ecf", xin, w1v)
                       + b1v[:, None, :])
        xout = torch.einsum("ecf,efd->ecd", h, w2v) + b2v[:, None, :]
        ys = torch.einsum("sec,ecd->sd", combine.to(xv.dtype), xout)
        if group is not None:
            ys = comm.ReduceFromGroup.apply(ys, group)
        # the Switch aux loss E * sum_e f_e p_e over the whole batch
        f_sum, p_sum = onehot.sum(0), probs.sum(0)
        for _a, g, _n in batch:
            f_sum = comm.SumOverBatch.apply(f_sum, g)
            p_sum = comm.SumOverBatch.apply(p_sum, g)
        aux_l = E * ((f_sum / (S * n_b)) * (p_sum / (S * n_b))).sum()
        return ys.reshape(B, T, D), aux_l

    # a sharded run hands the op this rank's block of the experts
    fn.block_inputs = ("W1", "B1", "W2", "B2")
    helper.append_op(
        type="switch_moe",
        inputs={"X": [x.name], "RouterW": [wr.name],
                "W1": [w1.name], "B1": [b1.name],
                "W2": [w2.name], "B2": [b2.name]},
        outputs={"Out": [out.name], "AuxLoss": [aux.name]},
        attrs={"num_experts": E, "capacity_factor": cf}, fn=fn)
    out.shape = x.shape
    return out, aux


def _expert_part(mesh, held: int, E: int):
    """``(first, end, ep group, batch)`` of the experts this rank runs:
    its block of them (``held < E``) in a sharded run over ``ep``, else
    all E with no group. ``batch``: ``((axis, group, size), ...)`` of
    the axes a sharded run splits the batch over (() outside one)."""
    if mesh is None or not mesh.live:
        return 0, E, None, ()
    from ..sharding.spmd import batch_axes

    batch = tuple((a, mesh.group(a), mesh.size(a)) for a in batch_axes())
    if held == E:
        return 0, E, None, batch
    i, n = mesh.index(("ep",))
    enforce(held * n == E, "switch_moe: a block of %d of %d experts over "
            "ep=%d" % (held, E, n))
    return i * held, (i + 1) * held, mesh.group("ep"), batch


def _earlier_counts(onehot, batch):
    """[E] tokens the batch blocks before this rank's routed to each
    expert: the whole batch's queue positions of this block's tokens
    start after them (the JAX package's cumsum over the whole batch).
    The blocks' counts are gathered innermost axis first, so they come
    out in the batch's block order (first axis major)."""
    import torch.distributed as dist

    from ..sharding import comm

    E = onehot.shape[1]
    t = onehot.sum(0)
    mine, stride = 0, 1
    for _a, g, n in reversed(batch):
        t = comm.all_gather(t[None], g, 0)
        mine += dist.get_rank(g) * stride
        stride *= n
    return t.reshape(-1, E)[:mine].sum(0)


__all__ = ["switch_moe"]
