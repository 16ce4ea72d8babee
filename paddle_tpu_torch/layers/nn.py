"""Neural-network layer functions (counterpart of
paddle_tpu/layers/nn.py): the ones the causal LM, Transformer-base and
ResNet training reach.

Each function appends ops carrying torch fns to the default main program
and returns the output Variable(s). Under ``use_bfloat16`` the matrix
products take bf16 operands (:func:`_mm`); under the bf16 activation
stream (``flags.bf16_stream()``) their results stay bf16 too, while the
reductions (softmax, cross-entropy, layer-norm statistics) run in f32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..core import flags
from ..core import initializer as init
from ..core.enforce import not_ported
from ..core.program import Deferred
from ..layer_helper import LayerHelper


def _mm_f32(a, b):
    """f32 product of two bf16 matrices. On the card cuBLAS takes the
    bf16 operands and writes f32 (``torch.mm(..., out_dtype=)``); that
    op has no CPU kernel, so there the operands are widened first — a
    product of two bf16 values is exact in f32, and the sums run in
    f32 either way."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.to(torch.float32), b.to(torch.float32))


class _Bf16MatmulF32(torch.autograd.Function):
    """``a @ b`` of bf16 matrices with an f32 result. The gradients are
    f32 products of the f32 cotangent, cast to the operands' dtype, as
    the JAX package's transpose of its mixed-precision dot casts them."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.mm(g, b.to(g.dtype).t()).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.mm(a.to(g.dtype).t(), g).to(b.dtype)
        return ga, gb


def _mm_rule():
    """The bf16 rule of the JAX package's ``_mm``, read when a layer is
    built (a built program does not change with later flag flips):
    None (a plain product), ``"f32"`` (``use_bfloat16``: bf16 operands,
    f32 result) or ``"bf16"`` (the bf16 activation stream: bf16
    result)."""
    if not flags.get_flag("use_bfloat16"):
        return None
    return "bf16" if flags.bf16_stream() else "f32"


def _mm(a, b, rule):
    """2-D matrix product under ``rule`` (:func:`_mm_rule`)."""
    if rule is None:
        return torch.matmul(a, b)
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if rule == "bf16":
        return torch.matmul(a, b)
    return _Bf16MatmulF32.apply(a, b)


def fc(input, size: int, num_flatten_dims: int = 1, param_attr=None,
       bias_attr=None, act: Optional[str] = None, is_test: bool = False,
       name=None):
    """Fully-connected layer: flatten to 2-D at ``num_flatten_dims``,
    project, add bias, activate. Multiple inputs are summed after
    projection."""
    inputs = input if isinstance(input, (list, tuple)) else [input]
    helper = LayerHelper("fc")
    dtype = inputs[0].dtype

    proj_names = []
    rule = _mm_rule()
    for x in inputs:
        in_features = int(np.prod(x.shape[num_flatten_dims:]))
        w = helper.create_parameter(param_attr, [in_features, size], dtype)
        out = helper.create_tmp_variable(dtype)

        def mul_fn(xv, wv, _nfd=num_flatten_dims):
            lead = xv.shape[:_nfd]
            xv2 = torch.reshape(xv, (int(np.prod(lead)) if lead else 1, -1))
            y = _mm(xv2, wv, rule)
            return torch.reshape(y, (*lead, y.shape[-1]))

        helper.append_op(type="mul",
                         inputs={"X": [x.name], "Y": [w.name]},
                         outputs={"Out": [out.name]}, fn=mul_fn)
        proj_names.append(out)

    if len(proj_names) == 1:
        pre_bias = proj_names[0]
    else:
        pre_bias = helper.create_tmp_variable(dtype)
        helper.append_op(type="sum",
                         inputs={"X": [v.name for v in proj_names]},
                         outputs={"Out": [pre_bias.name]},
                         fn=lambda *vs: sum(vs))

    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [size], dtype, is_bias=True)
        pre_act = helper.create_tmp_variable(dtype)
        helper.append_op(type="elementwise_add",
                         inputs={"X": [pre_bias.name], "Y": [b.name]},
                         outputs={"Out": [pre_act.name]},
                         fn=lambda xv, bv: xv + bv.to(xv.dtype))
    else:
        pre_act = pre_bias
    return helper.append_activation(pre_act, act)


def embedding(input, size: Sequence[int], is_sparse: bool = False,
              is_distributed: bool = False, padding_idx: Optional[int] = None,
              param_attr=None, dtype="float32"):
    """Lookup table. Ids whose trailing dim is 1 are squeezed first (the
    reference's ``[B, 1]`` ids convention), and the output shape follows
    the same rule — the decode rewrite swaps this op for a no-squeeze
    lookup because of it. ``is_sparse`` marks the table for a row-sparse
    gradient: ``append_backward`` gives it the ``(rows, values)`` pair
    ``<table>@GRAD@ROWS`` / ``<table>@GRAD@VALUES`` instead of a dense
    ``[V, D]`` gradient, and the optimizers update only those rows.
    Distributed tables are not ported yet."""
    if is_distributed:
        raise not_ported("embedding(is_distributed=True)",
                         "Queue A 9, multi-GPU")
    helper = LayerHelper("embedding")
    w = helper.create_parameter(param_attr, list(size), dtype,
                                default_initializer=init.Uniform(-0.05, 0.05))
    if is_sparse:
        w.sparse_grad = True
    out = helper.create_tmp_variable(dtype)

    def fn(ids, table):
        idx = ids.to(torch.int64)
        if idx.dim() and idx.shape[-1] == 1:
            idx = torch.squeeze(idx, -1)
        emb = F.embedding(idx, table)
        if padding_idx is not None:
            pad = padding_idx if padding_idx >= 0 else table.shape[0] + padding_idx
            emb = torch.where((idx == pad)[..., None],
                              torch.zeros((), dtype=emb.dtype,
                                          device=emb.device), emb)
        return emb

    helper.append_op(type="lookup_table",
                     inputs={"Ids": [input.name], "W": [w.name]},
                     outputs={"Out": [out.name]},
                     attrs={"is_sparse": is_sparse,
                            "is_distributed": is_distributed,
                            "padding_idx": padding_idx}, fn=fn)
    if input.shape is not None:
        ishape = tuple(input.shape)
        if ishape and ishape[-1] == 1:
            ishape = ishape[:-1]
        out.shape = ishape + (int(size[1]),)
    return out


def dropout(x, dropout_prob: float, is_test: bool = False, seed=None,
            name=None):
    """Inference dropout: ``x * (1 - dropout_prob)`` (the reference's
    downgrade_in_infer). Training dropout is not ported yet."""
    if not is_test:
        raise not_ported("training dropout (dropout(is_test=False))",
                         "Queue A 3, step 5: training dropout with a "
                         "seeded generator")
    helper = LayerHelper("dropout")
    out = helper.create_tmp_variable(x.dtype)
    counter = _dropout_counter(helper)

    def fn(v, c, is_test=True):
        return v * (1.0 - dropout_prob), c

    helper.append_op(type="dropout",
                     inputs={"X": [x.name], "Seed": [counter.name]},
                     outputs={"Out": [out.name], "SeedOut": [counter.name]},
                     attrs={"dropout_prob": dropout_prob, "is_test": True,
                            "_fn_attrs": ["is_test"]},
                     fn=fn)
    return out


def _dropout_counter(helper):
    """The shared persistable int32 step counter the JAX package keys
    dropout masks on; kept so both packages build the same symbol
    table."""
    gb = helper.main_program.global_block()
    name = "_dropout_rng_counter"
    if name in gb.vars:
        return gb.vars[name]
    v = gb.create_var(name=name, shape=(), dtype="int32", persistable=True)
    sb = helper.startup_program.global_block()
    sb.create_var(name=name, shape=(), dtype="int32", persistable=True)
    sb.append_op(type="init_counter", inputs={}, outputs={"Out": [name]},
                 fn=lambda: torch.zeros((), dtype=torch.int32))
    return v


# ---------------------------------------------------------------------------
# losses & reductions
# ---------------------------------------------------------------------------


def _hard_label_ce_forward(lg, idx, eps):
    """(loss ``[.., 1]`` f32, lse ``[.., 1]`` f32) from the f32
    log-sum-exp; the ``[.., V]`` log-probabilities are never formed."""
    mx = lg.amax(-1, keepdim=True).to(torch.float32)
    lse = torch.log(torch.exp(lg.to(torch.float32) - mx)
                    .sum(-1, keepdim=True)) + mx
    picked = torch.gather(lg, -1, idx[..., None]).to(torch.float32)
    if eps:
        mean_lg = lg.to(torch.float32).mean(-1, keepdim=True)
        loss = -((1.0 - eps) * picked + eps * mean_lg - lse)
    else:
        loss = lse - picked
    return loss, lse


class _HardLabelCE(torch.autograd.Function):
    """Hard-label (optionally smoothed) cross-entropy with the JAX
    package's hand-written gradient (``_hard_label_ce``): the analytic
    ``softmax - (1-eps)*onehot - eps/V`` in one pass over the saved
    logits, in the logits dtype — not autograd of the log-sum-exp.
    Residuals: the logits and the f32 lse."""

    @staticmethod
    def forward(ctx, lg, idx, eps):
        loss, lse = _hard_label_ce_forward(lg, idx, eps)
        ctx.save_for_backward(lg, idx, lse)
        ctx.eps = eps
        return loss

    @staticmethod
    def backward(ctx, dloss):
        lg, idx, lse = ctx.saved_tensors
        eps = ctx.eps
        v = lg.shape[-1]
        g = torch.exp(lg.to(torch.float32) - lse)          # softmax
        at = idx[..., None]
        p_at = torch.gather(g, -1, at)
        # p - tgt with tgt = (1-eps)*onehot + eps/V, element by element
        # as the JAX package rounds it, without forming the one-hot
        # (made on the device: a host scalar copied over would sync the
        # host, which a captured CUDA graph cannot hold)
        tgt_at = torch.full((), 1.0 - eps, dtype=torch.float32,
                            device=g.device)
        if eps:
            tgt_at = tgt_at + eps / v
            g.sub_(eps / v)
        g.scatter_(-1, at, p_at - tgt_at)
        g.mul_(dloss)
        return g.to(lg.dtype), None, None


def softmax_with_cross_entropy(logits, label, soft_label: bool = False,
                               return_softmax: bool = False,
                               smooth_eps: float = 0.0):
    """Numerically stable softmax + cross-entropy in one op, with label
    smoothing folded in by ``smooth_eps``. Returns the loss ``[.., 1]``
    (f32), and the softmax too with ``return_softmax``. The ``Softmax``
    output is always declared (the symbol table matches the JAX
    package's) but computed only when something reads it: XLA drops it
    when it is dead, and eagerly it would cost a full ``[.., V]`` pass."""
    helper = LayerHelper("softmax_with_cross_entropy")
    loss = helper.create_tmp_variable(logits.dtype)
    sm = helper.create_tmp_variable(logits.dtype)
    eps = float(smooth_eps or 0.0)

    def fn(lg, y):
        if soft_label:
            mx = lg.amax(-1, keepdim=True).detach()
            shifted = (lg - mx).to(torch.float32)
            lse = torch.log(torch.exp(shifted).sum(-1, keepdim=True)) \
                + mx.to(torch.float32)
            l = lse * y.sum(-1, keepdim=True) - (
                y * lg.to(torch.float32)).sum(-1, keepdim=True)
            return l, Deferred(
                lambda: torch.exp(lg.to(torch.float32) - lse).to(lg.dtype))
        idx = y.to(torch.int64)
        if idx.dim() == lg.dim():
            idx = idx.squeeze(-1)
        l = _HardLabelCE.apply(lg, idx, eps)
        return l, Deferred(
            lambda: torch.softmax(lg.to(torch.float32), -1).to(lg.dtype))

    helper.append_op(type="softmax_with_cross_entropy",
                     inputs={"Logits": [logits.name], "Label": [label.name]},
                     outputs={"Loss": [loss.name], "Softmax": [sm.name]},
                     fn=fn)
    return (loss, sm) if return_softmax else loss


def softmax(input, use_cudnn=False, name=None):
    """Softmax over the last axis, reduced in f32 even on a bf16
    activation stream; the output keeps the input dtype."""
    helper = LayerHelper("softmax")
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="softmax", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     fn=lambda x: torch.softmax(x.to(torch.float32),
                                                -1).to(x.dtype))
    return out


def mean(x, name=None):
    """The mean of every element of ``x``, a 0-d tensor."""
    helper = LayerHelper("mean")
    out = helper.create_tmp_variable(x.dtype, shape=())
    helper.append_op(type="mean", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, fn=torch.mean)
    return out


def square_error_cost(input, label):
    """(input - label)^2, elementwise."""
    helper = LayerHelper("square_error_cost")
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="square_error_cost",
                     inputs={"X": [input.name], "Label": [label.name]},
                     outputs={"Out": [out.name]},
                     fn=lambda x, y: torch.square(x - y))
    return out


def cross_entropy(input, label, soft_label: bool = False,
                  ignore_index: int = -100):
    """Cross-entropy of probabilities ``input`` (post-softmax) against
    hard or soft labels. The log is taken in f32: a bf16 stream loses
    too much resolution near p = 1."""
    helper = LayerHelper("cross_entropy")
    out = helper.create_tmp_variable(input.dtype)

    def fn(p, y):
        logp = torch.log(torch.clamp(p.to(torch.float32), 1e-8, 1.0))
        if soft_label:
            return -(y * logp).sum(-1, keepdim=True)
        idx = y.to(torch.int64)
        if idx.dim() == logp.dim():
            idx = idx.squeeze(-1)
        loss = -torch.gather(logp, -1, idx[..., None])
        if ignore_index >= 0:
            loss = torch.where(idx[..., None] == ignore_index,
                               torch.zeros((), dtype=loss.dtype,
                                           device=loss.device), loss)
        return loss

    helper.append_op(type="cross_entropy",
                     inputs={"X": [input.name], "Label": [label.name]},
                     outputs={"Out": [out.name]},
                     attrs={"soft_label": soft_label}, fn=fn)
    return out


def _reduce(name, tfn, x, dim=None, keep_dim=False):
    helper = LayerHelper(name)
    out = helper.create_tmp_variable(x.dtype)
    axis = tuple(dim) if isinstance(dim, (list, tuple)) else dim

    def fn(v):
        if axis is None:
            r = tfn(v)
            return r.reshape((1,) * v.dim()) if keep_dim else r
        return tfn(v, dim=axis, keepdim=keep_dim)

    helper.append_op(type=name, inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"dim": dim, "keep_dim": keep_dim}, fn=fn)
    return out


def reduce_sum(x, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", torch.sum, x, dim, keep_dim)


# ---------------------------------------------------------------------------
# shape ops
# ---------------------------------------------------------------------------


def squeeze(input, axes: Sequence[int], name=None):
    helper = LayerHelper("squeeze")
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="squeeze", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     fn=lambda v: torch.squeeze(v, tuple(axes)))
    return out
