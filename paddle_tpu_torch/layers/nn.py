"""Neural-network layer functions (counterpart of
paddle_tpu/layers/nn.py): every function of the JAX module.

Each function appends ops carrying torch fns to the default main program
and returns the output Variable(s). Under ``use_bfloat16`` the matrix
products take bf16 operands (:func:`_mm`); under the bf16 activation
stream (``flags.bf16_stream()``) their results stay bf16 too, while the
reductions (softmax, cross-entropy, layer-norm statistics) run in f32.
Index outputs (``topk``'s indices, ``argmax``, ``sampling_id``) are
int64, the dtype their variables declare; the JAX package's are int32
unless jax runs in 64-bit mode.
"""

from __future__ import annotations

import builtins
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..core import flags, prng
from ..core import initializer as init
from ..core.enforce import enforce
from ..core.program import Deferred, Variable
from ..layer_helper import LayerHelper


@torch.library.custom_op("paddle_tpu_torch::mm_f32", mutates_args=(),
                         device_types="cpu")
def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 product of two bf16 matrices, as a torch.library custom op so
    that an exported graph picks the kernel by device when it runs. On
    the card cuBLAS takes the bf16 operands and writes f32
    (``torch.mm(..., out_dtype=)``); that op has no CPU kernel, so there
    the operands are widened first — a product of two bf16 values is
    exact in f32, and the sums run in f32 either way."""
    return torch.mm(a.to(torch.float32), b.to(torch.float32))


@_mm_f32.register_fake
def _(a, b):
    return a.new_empty((a.shape[0], b.shape[1]), dtype=torch.float32)


@_mm_f32.register_kernel("cuda")
def _(a, b):
    return torch.mm(a, b, out_dtype=torch.float32)


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
    """Matrix product under ``rule`` (:func:`_mm_rule`). A batched
    product under the ``"f32"`` rule widens its bf16 operands to f32
    (exact products, f32 sums: the same numbers). Under no rule,
    operands of two float types meet in the wider one, as the JAX
    package's promotion has them (an f32 input against weights cast to
    bf16 by ``transpile_to_bfloat16``)."""
    if rule is None:
        if a.dtype != b.dtype:
            dt = torch.promote_types(a.dtype, b.dtype)
            a, b = a.to(dt), b.to(dt)
        return torch.matmul(a, b)
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if rule == "bf16":
        return torch.matmul(a, b)
    if a.dim() == b.dim() == 2:
        return _Bf16MatmulF32.apply(a, b)
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def _tp_kind(param_attr) -> Optional[str]:
    """``"column"`` / ``"row"`` for an fc weight whose ParamAttr shards
    its out / in features over a tensor-parallel axis (``mp``, as
    ``models.transformer(tp=True)`` writes it, or ``tp``), else None."""
    from ..param_attr import ParamAttr

    if param_attr is None or isinstance(param_attr, (list, tuple)):
        return None
    spec = ParamAttr._to_attr(param_attr).sharding
    if not spec or len(spec) != 2:
        return None
    if spec[1] in ("mp", "tp"):
        return "column"
    if spec[0] in ("mp", "tp"):
        return "row"
    return None


def _tp_block():
    """(axis, index, count, group) of the live tensor-parallel axis of
    the active sharded run, or None (then a tensor-parallel fc computes
    on whole tensors)."""
    from ..core.trace_ctx import current_mesh
    from ..sharding.comm import tensor_axis

    mesh = current_mesh()
    tp = tensor_axis(mesh)
    if tp is None:
        return None
    axis, i, n = tp
    return axis, i, n, mesh.group(axis)


def fc(input, size: int, num_flatten_dims: int = 1, param_attr=None,
       bias_attr=None, act: Optional[str] = None, is_test: bool = False,
       name=None):
    """Fully-connected layer: flatten to 2-D at ``num_flatten_dims``,
    project, add bias, activate. Multiple inputs are summed after
    projection.

    A weight whose ``ParamAttr(sharding=...)`` names a tensor-parallel
    axis (``(None, "mp")``: column-parallel, ``("mp", None)``:
    row-parallel — ``models.transformer(tp=True)``) computes, in a
    sharded run over a mesh with a tensor-parallel axis, the Megatron
    way: a column-parallel fc its rank's block of output columns (bias
    block included), a row-parallel one its rank's block of input rows
    summed over the axis. The sharded run hands it the rank's block of
    the weight; a whole tensor it cuts itself (a replicated activation,
    or a weight some other op also reads), and the gradient of what it
    cut is summed over the axis. Elsewhere it is an ordinary fc."""
    inputs = input if isinstance(input, (list, tuple)) else [input]
    helper = LayerHelper("fc")
    dtype = inputs[0].dtype
    kind = _tp_kind(param_attr) if len(inputs) == 1 else None

    proj_names = []
    rule = _mm_rule()
    for x in inputs:
        in_features = int(np.prod(x.shape[num_flatten_dims:]))
        w = helper.create_parameter(param_attr, [in_features, size], dtype)
        out = helper.create_tmp_variable(dtype)

        def mul_fn(xv, wv, _nfd=num_flatten_dims, tp_gather=False,
                   _in=in_features):
            tp = _tp_block() if kind is not None else None
            if tp is not None:
                from ..sharding.comm import CopyToGroup

                _axis, i, n, group = tp
                if kind == "column":
                    xv = CopyToGroup.apply(xv, group)
                    if wv.shape[1] == size:
                        per = size // n
                        wv = CopyToGroup.apply(wv, group)[
                            :, i * per:(i + 1) * per]
                else:
                    if wv.shape[0] == _in:
                        per = _in // n
                        wv = CopyToGroup.apply(wv, group)[
                            i * per:(i + 1) * per]
                    per = wv.shape[0]
                    if xv.shape[-1] == per * n:
                        xv = CopyToGroup.apply(xv, group)[
                            ..., i * per:(i + 1) * per]
            lead = xv.shape[:_nfd]
            xv2 = torch.reshape(xv, (int(np.prod(lead)) if lead else 1, -1))
            y = torch.reshape(_mm(xv2, wv, rule), (*lead, wv.shape[-1]))
            if tp is not None and kind == "row":
                from ..sharding.comm import ReduceFromGroup

                y = ReduceFromGroup.apply(y, tp[3])
            elif tp is not None and tp_gather:
                from ..sharding.comm import GatherFromGroup

                y = GatherFromGroup.apply(y, tp[3], -1)
            return y

        # the sharded run hands a tensor-parallel fc its block of ``w``
        attrs = {"_tp": kind} if kind is not None else {}
        helper.append_op(type="mul",
                         inputs={"X": [x.name], "Y": [w.name]},
                         outputs={"Out": [out.name]}, attrs=attrs,
                         fn=mul_fn)
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

        def add_fn(xv, bv):
            if kind == "column" and xv.shape[-1] != bv.shape[-1]:
                from ..sharding.comm import CopyToGroup

                _axis, i, _n, group = _tp_block()
                w = xv.shape[-1]
                bv = CopyToGroup.apply(bv, group)[i * w:(i + 1) * w]
            return xv + bv.to(xv.dtype)

        helper.append_op(type="elementwise_add",
                         inputs={"X": [pre_bias.name], "Y": [b.name]},
                         outputs={"Out": [pre_act.name]}, fn=add_fn)
    else:
        pre_act = pre_bias
    return helper.append_activation(pre_act, act)


def mul(x, y, x_num_col_dims: int = 1, y_num_col_dims: int = 1, name=None):
    """The flattening matrix product: ``x`` flattened to 2-D at
    ``x_num_col_dims``, ``y`` at ``y_num_col_dims``."""
    helper = LayerHelper("mul")
    out = helper.create_tmp_variable(x.dtype)
    rule = _mm_rule()

    def fn(xv, yv):
        xl = xv.shape[:x_num_col_dims]
        yl = yv.shape[:y_num_col_dims]
        x2 = torch.reshape(xv, (int(np.prod(xl)), -1))
        y2 = torch.reshape(yv, (int(np.prod(yl)), -1))
        return torch.reshape(_mm(x2, y2, rule), (*xl, y2.shape[-1]))

    helper.append_op(type="mul", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]}, fn=fn)
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    """(Batched) matrix product, optionally of transposed operands,
    scaled by ``alpha``."""
    helper = LayerHelper("matmul")
    out = helper.create_tmp_variable(x.dtype)
    rule = _mm_rule()

    def fn(xv, yv):
        if transpose_x and xv.dim() > 1:
            xv = torch.transpose(xv, -1, -2)
        if transpose_y and yv.dim() > 1:
            yv = torch.transpose(yv, -1, -2)
        r = _mm(xv, yv, rule)
        return r * alpha if alpha != 1.0 else r

    helper.append_op(type="matmul", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]}, fn=fn)
    return out


class _Lookup(torch.autograd.Function):
    """``table[idx]``, rows of a 2-D table at integer ids of any shape.
    The backward sums the cotangent rows of repeated ids with
    ``index_put_(accumulate=True)``, whose CUDA path adds them in a
    fixed (sorted) order: ``F.embedding``'s CUDA backward does not
    (two runs of BERT's sentence table, 8192 lookups of 2 rows, part
    in their last bits), and a captured step must equal the eager
    one bit for bit."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return F.embedding(idx, table)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        gt = torch.zeros(ctx.table_shape, dtype=g.dtype, device=g.device)
        gt.index_put_((idx.reshape(-1),), g.reshape(-1, g.shape[-1]),
                      accumulate=True)
        return gt, None


def lookup(table, idx):
    """Rows of ``table`` at ``idx`` (int64), with the deterministic
    backward of :class:`_Lookup`."""
    return _Lookup.apply(table, idx)


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

    ``is_distributed`` annotates the table ``sharding_spec = ("ep",
    None)`` (rows over the embedding-parallel axis) and gives it a dense
    gradient (``is_sparse`` is ignored). In a sharded run over a mesh
    with an ``ep`` axis each rank holds its block of the rows and the
    lookup is ``sharding.sharded_lookup`` (each rank's rows for the ids
    it holds, summed over ``ep``; the table's gradient is its block's);
    elsewhere the lookup is the plain one, as the JAX package's on one
    device."""
    helper = LayerHelper("embedding")
    w = helper.create_parameter(param_attr, list(size), dtype,
                                default_initializer=init.Uniform(-0.05, 0.05))
    if is_sparse and not is_distributed:
        w.sparse_grad = True
    if is_distributed and getattr(w, "sharding_spec", None) is None:
        w.sharding_spec = ("ep", None)
    out = helper.create_tmp_variable(dtype)

    def fn(ids, table):
        idx = ids.to(torch.int64)
        if idx.dim() and idx.shape[-1] == 1:
            idx = torch.squeeze(idx, -1)
        if is_distributed and table.shape[0] != int(size[0]):
            from ..core.trace_ctx import current_mesh
            from ..sharding.embedding import sharded_lookup

            # this rank's block of the rows (the sharded run's)
            emb = sharded_lookup(table, idx, current_mesh())
        else:
            emb = lookup(table, idx)
        if padding_idx is not None:
            pad = padding_idx if padding_idx >= 0 else table.shape[0] + padding_idx
            emb = torch.where((idx == pad)[..., None],
                              torch.zeros((), dtype=emb.dtype,
                                          device=emb.device), emb)
        return emb

    if is_distributed:
        fn.block_inputs = ("W",)
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
    """Dropout in the reference's downgrade_in_infer form: training
    multiplies by a Bernoulli(1 - p) mask, inference (``is_test``, or
    ``Program.clone(for_test=True)``) by ``1 - p``.

    The mask is the JAX package's, bit for bit: keyed on
    ``fold_in(PRNGKey(base_seed), counter)``, where ``base_seed`` is
    ``seed`` or the program's next parameter seed (taken here, so
    parameters and dropout sites draw from one sequence in build order,
    as in the JAX package) and ``counter`` the shared persistable int32
    ``_dropout_rng_counter``, which every site advances by one. On a
    card the mask is drawn by the dropout kernel (``ops/dropout.py``),
    forward and backward."""
    helper = LayerHelper("dropout")
    out = helper.create_tmp_variable(x.dtype)
    counter = _dropout_counter(helper)
    base_seed = seed if seed is not None else \
        helper.main_program.next_param_seed()

    def fn(v, c, is_test=False, tp_width=None):
        if is_test:
            return v * (1.0 - dropout_prob), c
        from ..ops.dropout import dropout as dropout_op
        from ..sharding.spmd import batch_block

        # in a sharded run ``v`` is this rank's block of the batch (and,
        # after a column-parallel fc, of the ``tp_width`` columns): it
        # takes that block of the whole tensor's mask
        idx, _ = batch_block()
        if tp_width and v.dim() and v.shape[-1] != tp_width:
            from ..core.trace_ctx import current_mesh
            from ..sharding.comm import tensor_axis

            _axis, i, _n = tensor_axis(current_mesh())
            rows = v.numel() // v.shape[-1]
            return dropout_op(v, base_seed, c, dropout_prob,
                              idx * rows * tp_width,
                              (i * v.shape[-1], tp_width))
        return dropout_op(v, base_seed, c, dropout_prob, idx * v.numel())

    helper.append_op(type="dropout",
                     inputs={"X": [x.name], "Seed": [counter.name]},
                     outputs={"Out": [out.name], "SeedOut": [counter.name]},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "_fn_attrs": ["is_test"]},
                     fn=fn)
    return out


def _dropout_counter(helper):
    """The shared persistable int32 counter dropout masks are keyed on
    (initialized to 0 by the startup program)."""
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
    log-sum-exp (f64 for f64 logits); the ``[.., V]`` log-probabilities
    are never formed."""
    cdt = torch.promote_types(lg.dtype, torch.float32)
    mx = lg.amax(-1, keepdim=True).to(cdt)
    lse = torch.log(torch.exp(lg.to(cdt) - mx)
                    .sum(-1, keepdim=True)) + mx
    picked = torch.gather(lg, -1, idx[..., None]).to(cdt)
    if eps:
        mean_lg = lg.to(cdt).mean(-1, keepdim=True)
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
        g = torch.exp(lg.to(lse.dtype) - lse)              # softmax
        at = idx[..., None]
        p_at = torch.gather(g, -1, at)
        # p - tgt with tgt = (1-eps)*onehot + eps/V, element by element
        # as the JAX package rounds it, without forming the one-hot
        # (made on the device: a host scalar copied over would sync the
        # host, which a captured CUDA graph cannot hold)
        tgt_at = torch.full((), 1.0 - eps, dtype=g.dtype,
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


def fused_linear_softmax_ce(input, label, size: int,
                            smooth_eps: float = 0.0, param_attr=None,
                            bias_attr=None):
    """The vocab projection and softmax cross-entropy as one op that
    never forms the ``[.., size]`` logits (``ops/fused_ce.py``): a
    drop-in for ``fc(num_flatten_dims=ndim-1)`` +
    ``softmax_with_cross_entropy``.

    Returns ``(loss [..., 1] f32, predict [..., size])``: ``predict`` is
    the raw logits of the same affine map, as the plain ``mul`` +
    ``elementwise_add`` pair ``fc`` emits, on the same parameters. The
    executor skips that pair when nothing reads or fetches it (the JAX
    package leaves it to XLA's dead-code elimination), so training that
    fetches only the loss never computes it. The parameters come from
    the ``"fc"`` name family, so a fused build and an unfused one have
    the same parameter names and checkpoints interchange."""
    from ..ops.fused_ce import fused_linear_softmax_ce_fn

    helper = LayerHelper("fused_linear_softmax_ce")
    param_helper = LayerHelper("fc")
    dtype = input.dtype
    d = int(input.shape[-1])
    w = param_helper.create_parameter(param_attr, [d, size], dtype)
    b = (None if bias_attr is False else
         param_helper.create_parameter(bias_attr, [size], dtype,
                                       is_bias=True))
    loss = helper.create_tmp_variable("float32")
    eps = float(smooth_eps or 0.0)
    bf16 = bool(flags.get_flag("use_bfloat16"))

    ce_inputs = {"X": [input.name], "W": [w.name], "Label": [label.name]}
    if b is not None:
        ce_inputs["Bias"] = [b.name]

    def fn(xv, wv, yv, bv=None):
        return fused_linear_softmax_ce_fn(xv, wv, bv, yv, smooth_eps=eps,
                                          bf16=bf16)

    helper.append_op(type="fused_linear_softmax_ce", inputs=ce_inputs,
                     outputs={"Loss": [loss.name]},
                     attrs={"smooth_eps": eps, "size": size}, fn=fn)

    mul_out = helper.create_tmp_variable(dtype)
    rule = _mm_rule()

    def mul_fn(xv, wv):
        lead = xv.shape[:-1]
        y = _mm(xv.reshape(-1, xv.shape[-1]), wv, rule)
        return y.reshape(*lead, y.shape[-1])

    helper.append_op(type="mul", inputs={"X": [input.name], "Y": [w.name]},
                     outputs={"Out": [mul_out.name]}, fn=mul_fn)
    if b is None:
        return loss, mul_out
    predict = helper.create_tmp_variable(dtype)
    helper.append_op(type="elementwise_add",
                     inputs={"X": [mul_out.name], "Y": [b.name]},
                     outputs={"Out": [predict.name]},
                     fn=lambda xv, bv: xv + bv.to(xv.dtype))
    return loss, predict


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


def sigmoid_cross_entropy_with_logits(x, label, name=None):
    """The numerically stable ``max(x, 0) - x * z + log1p(exp(-|x|))``,
    elementwise, in that order."""
    helper = LayerHelper("sigmoid_cross_entropy_with_logits")
    out = helper.create_tmp_variable(x.dtype)

    def fn(lg, z):
        return (torch.clamp(lg, min=0) - lg * z
                + torch.log1p(torch.exp(-torch.abs(lg))))

    helper.append_op(type="sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x.name], "Label": [label.name]},
                     outputs={"Out": [out.name]}, fn=fn)
    return out


def log_softmax(input, name=None):
    """Log-softmax over the last axis, in the input dtype."""
    helper = LayerHelper("log_softmax")
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="log_softmax", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     fn=lambda x: torch.log_softmax(x, -1))
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


def _prod(v, dim=None, keepdim=False):
    """``torch.prod`` over one dim, several, or all."""
    if dim is None:
        return torch.prod(v)
    dims = dim if isinstance(dim, tuple) else (dim,)
    for d in sorted((d % v.dim() for d in dims), reverse=True):
        v = torch.prod(v, dim=d, keepdim=keepdim)
    return v


def reduce_sum(x, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", torch.sum, x, dim, keep_dim)


def reduce_mean(x, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", torch.mean, x, dim, keep_dim)


def reduce_max(x, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", torch.amax, x, dim, keep_dim)


def reduce_min(x, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", torch.amin, x, dim, keep_dim)


def reduce_prod(x, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_prod", _prod, x, dim, keep_dim)


# ---------------------------------------------------------------------------
# shape ops
# ---------------------------------------------------------------------------


def reshape(x, shape: Sequence[int], actual_shape=None, act=None,
            inplace=False, name=None):
    """``x`` in ``shape``: a 0 copies the input's dim at that place, a
    -1 is inferred."""
    helper = LayerHelper("reshape")
    out = helper.create_tmp_variable(x.dtype)

    def fn(v):
        return torch.reshape(v, [v.shape[i] if s == 0 else s
                                 for i, s in enumerate(shape)])

    helper.append_op(type="reshape", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"shape": shape},
                     fn=fn)
    return helper.append_activation(out, act)


def transpose(x, perm: Sequence[int], name=None):
    helper = LayerHelper("transpose")
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="transpose", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"perm": perm},
                     fn=lambda v: torch.permute(v, tuple(perm)))
    return out


def concat(input: List[Variable], axis=0, name=None):
    helper = LayerHelper("concat")
    out = helper.create_tmp_variable(input[0].dtype)
    helper.append_op(type="concat",
                     inputs={"X": [v.name for v in input]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis},
                     fn=lambda *vs: torch.cat(vs, dim=axis))
    return out


def slice(input, axes, starts, ends, name=None):
    """A static slice along ``axes``; an ``end`` past its dim is clamped
    to it."""
    enforce(len(axes) == len(starts) == len(ends),
            "slice: axes/starts/ends must have equal lengths")
    helper = LayerHelper("slice")
    out = helper.create_tmp_variable(input.dtype)

    def fn(x):
        idx = [builtins.slice(None)] * x.dim()
        for ax, st, en in zip(axes, starts, ends):
            en_c = min(en, x.shape[ax]) if en >= 0 else en
            idx[ax] = builtins.slice(st, en_c)
        return x[tuple(idx)]

    helper.append_op(type="slice", inputs={"Input": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)}, fn=fn)
    return out


def split(input, num_or_sections, dim=-1, name=None):
    """``num_or_sections`` equal parts along ``dim``, or parts of the
    listed sizes."""
    helper = LayerHelper("split")
    if isinstance(num_or_sections, int):
        n, cuts = num_or_sections, num_or_sections
    else:
        n = len(num_or_sections)
        cuts = np.cumsum(num_or_sections)[:-1].tolist()
    outs = [helper.create_tmp_variable(input.dtype) for _ in range(n)]
    helper.append_op(type="split", inputs={"X": [input.name]},
                     outputs={"Out": [o.name for o in outs]},
                     attrs={"dim": dim},
                     fn=lambda v: tuple(torch.tensor_split(v, cuts, dim)))
    return outs


def stack(x: List[Variable], axis=0):
    helper = LayerHelper("stack")
    out = helper.create_tmp_variable(x[0].dtype)
    helper.append_op(type="stack", inputs={"X": [v.name for v in x]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis},
                     fn=lambda *vs: torch.stack(vs, dim=axis))
    return out


def squeeze(input, axes: Sequence[int], name=None):
    helper = LayerHelper("squeeze")
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="squeeze", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     fn=lambda v: torch.squeeze(v, tuple(axes)))
    return out


def unsqueeze(input, axes: Sequence[int], name=None):
    helper = LayerHelper("unsqueeze")
    out = helper.create_tmp_variable(input.dtype)

    def fn(v):
        for a in sorted(axes):
            v = torch.unsqueeze(v, a)
        return v

    helper.append_op(type="unsqueeze", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]}, fn=fn)
    return out


# ---------------------------------------------------------------------------
# counter-keyed draws: sampling_id, random_crop
# ---------------------------------------------------------------------------


def _counter_key(base_seed, c):
    """``fold_in(PRNGKey(base_seed), counter)``, made on the counter's
    device."""
    return prng.fold_in(prng.prng_key(torch.full(
        (), base_seed, dtype=torch.int64, device=c.device)), c.reshape(()))


def sampling_id(x, seed=None, name=None):
    """One class id per row of a ``[B, V]`` probability matrix, drawn
    as ``jax.random.categorical`` draws it (the argmax of the log
    probabilities plus Gumbel noise) under the dropout counter's key;
    the counter advances by one."""
    helper = LayerHelper("sampling_id")
    out = helper.create_tmp_variable("int64")
    counter = _dropout_counter(helper)
    base_seed = seed if seed is not None else \
        helper.main_program.next_param_seed()

    def fn(v, c):
        logp = torch.log(torch.clamp(v.to(torch.float32), min=1e-30))
        g = prng.gumbel(_counter_key(base_seed, c), logp.numel())
        return torch.argmax(g.reshape(logp.shape) + logp, dim=-1), c + 1

    helper.append_op(type="sampling_id",
                     inputs={"X": [x.name], "Seed": [counter.name]},
                     outputs={"Out": [out.name], "SeedOut": [counter.name]},
                     fn=fn)
    if x.shape is not None:
        out.shape = tuple(x.shape[:-1])
    return out


def random_crop(x, shape: Sequence[int], seed=None):
    """Each example cropped to ``shape`` at offsets drawn as the JAX
    package draws them: ``jax.random.randint(key, (B, dims), 0, 2**30)``
    (the low 30 bits of the second split key's bits) modulo the room
    left in each dim; the counter advances by one."""
    helper = LayerHelper("random_crop")
    out = helper.create_tmp_variable(x.dtype)
    counter = _dropout_counter(helper)
    base_seed = seed if seed is not None else \
        helper.main_program.next_param_seed()
    tgt = tuple(int(s) for s in shape)

    def fn(v, c):
        b, dims = v.shape[0], v.dim() - 1
        # randint's second key of split(key, 2) is the fold-in of 1
        k2 = prng.fold_in(_counter_key(base_seed, c),
                          torch.ones((), dtype=torch.int64, device=c.device))
        bits = prng.random_bits(k2, b * dims).reshape(b, dims)
        room = torch.tensor([max(v.shape[1 + d] - tgt[d] + 1, 1)
                             for d in range(dims)], dtype=torch.int64,
                            device=v.device)
        offs = (bits & ((1 << 30) - 1)) % room
        out = v
        for d in range(dims):
            at = offs[:, d, None] + torch.arange(tgt[d], device=v.device)
            view = [b] + [1] * dims
            view[1 + d] = tgt[d]
            size = list(out.shape)
            size[1 + d] = tgt[d]
            out = torch.gather(out, 1 + d, at.reshape(view).expand(size))
        return out, c + 1

    helper.append_op(type="random_crop",
                     inputs={"X": [x.name], "Seed": [counter.name]},
                     outputs={"Out": [out.name], "SeedOut": [counter.name]},
                     attrs={"shape": list(tgt)}, fn=fn)
    if x.shape is not None:
        out.shape = (x.shape[0],) + tgt
    return out


# ---------------------------------------------------------------------------
# comparison / selection
# ---------------------------------------------------------------------------


def topk(input, k: int, name=None):
    """The ``k`` largest values of the last axis and their indices, the
    lower index first among equal values (``lax.top_k``'s order): a
    stable descending sort."""
    helper = LayerHelper("top_k")
    values = helper.create_tmp_variable(input.dtype)
    indices = helper.create_tmp_variable("int64")

    def fn(v):
        vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
        return vals[..., :k], idx[..., :k]

    helper.append_op(type="top_k", inputs={"X": [input.name]},
                     outputs={"Out": [values.name], "Indices": [indices.name]},
                     attrs={"k": k}, fn=fn)
    return values, indices


def argmax(x, axis=-1, name=None):
    helper = LayerHelper("arg_max")
    out = helper.create_tmp_variable("int64")
    helper.append_op(type="arg_max", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     fn=lambda v: torch.argmax(v, dim=axis))
    return out


def one_hot(input, depth: int, name=None):
    """f32 one-hot rows of ``depth``; an id outside ``[0, depth)`` gives
    a row of zeros."""
    helper = LayerHelper("one_hot")
    out = helper.create_tmp_variable("float32")

    def fn(ids):
        idx = ids.to(torch.int64)
        if idx.dim() and idx.shape[-1] == 1:
            idx = torch.squeeze(idx, -1)
        cls = torch.arange(depth, device=idx.device)
        return (idx[..., None] == cls).to(torch.float32)

    helper.append_op(type="one_hot", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]}, attrs={"depth": depth},
                     fn=fn)
    return out


def cos_sim(X, Y):
    """Row-wise cosine similarity."""
    helper = LayerHelper("cos_sim")
    out = helper.create_tmp_variable(X.dtype)

    def fn(x, y):
        xn = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-12)
        yn = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True) + 1e-12)
        return torch.sum(x * y, dim=-1, keepdim=True) / (xn * yn)

    helper.append_op(type="cos_sim", inputs={"X": [X.name], "Y": [Y.name]},
                     outputs={"Out": [out.name]}, fn=fn)
    return out


# ---------------------------------------------------------------------------
# elementwise losses / normalization / selection
# ---------------------------------------------------------------------------


def l2_normalize(x, axis: int, epsilon: float = 1e-12, name=None):
    """``x / sqrt(max(sum(x^2, axis), epsilon))``."""
    helper = LayerHelper("l2_normalize")
    out = helper.create_tmp_variable(x.dtype)

    def fn(v):
        sq = torch.sum(v * v, dim=axis, keepdim=True)
        return v / torch.sqrt(torch.clamp(sq, min=epsilon))

    helper.append_op(type="l2_normalize", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"axis": axis, "epsilon": epsilon}, fn=fn)
    out.shape = x.shape
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    """Smooth-L1 (Huber) loss summed over the non-batch dims, ``[B, 1]``:
    with ``diff = (x - y) * inside_w``, ``0.5 * (sigma * diff)^2`` where
    ``|diff| < 1 / sigma^2``, else ``|diff| - 0.5 / sigma^2``, times
    ``outside_w``."""
    helper = LayerHelper("smooth_l1")
    out = helper.create_tmp_variable(x.dtype)
    sigma = 1.0 if sigma is None else float(sigma)
    s2 = sigma * sigma

    inputs = {"X": [x.name], "Y": [y.name]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight.name]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight.name]

    def fn(xv, yv, iw=None, ow=None):
        # with only outside_weight given it arrives in the iw slot
        if inside_weight is None and outside_weight is not None:
            iw, ow = None, iw
        diff = xv - yv
        if iw is not None:
            diff = diff * iw
        a = torch.abs(diff)
        err = torch.where(a < 1.0 / s2, 0.5 * s2 * diff * diff,
                          a - 0.5 / s2)
        if ow is not None:
            err = err * ow
        return torch.sum(err.reshape(err.shape[0], -1), dim=1, keepdim=True)

    helper.append_op(type="smooth_l1", inputs=inputs,
                     outputs={"Out": [out.name]}, attrs={"sigma": sigma},
                     fn=fn)
    out.shape = (x.shape[0], 1) if x.shape else None
    return out


def label_smooth(label, prior_dist=None, epsilon: float = 0.1,
                 dtype="float32", name=None):
    """``(1 - epsilon) * label + epsilon * prior`` (uniform ``1/C``
    without ``prior_dist``)."""
    from ..core import dtype_utils

    helper = LayerHelper("label_smooth")
    out = helper.create_tmp_variable(dtype)
    inputs = {"X": [label.name]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist.name]
    tgt = dtype_utils.to_torch(dtype)

    def fn(lbl, prior=None):
        lbl = lbl.to(tgt)
        smooth = prior if prior is not None else 1.0 / lbl.shape[-1]
        return (1.0 - epsilon) * lbl + epsilon * smooth

    helper.append_op(type="label_smooth", inputs=inputs,
                     outputs={"Out": [out.name]},
                     attrs={"epsilon": epsilon}, fn=fn)
    out.shape = label.shape
    return out


def multiplex(inputs: List[Variable], index):
    """Row ``i`` of ``inputs[index[i]]``, for each row ``i``."""
    enforce(len(inputs) >= 2, "multiplex needs >= 2 candidate inputs")
    helper = LayerHelper("multiplex")
    out = helper.create_tmp_variable(inputs[0].dtype)

    def fn(idx, *cands):
        stacked = torch.stack(cands, dim=0)          # [N, B, ...]
        rows = idx.to(torch.int64).reshape(-1)      # [B]
        return stacked[rows, torch.arange(rows.shape[0],
                                          device=rows.device)]

    helper.append_op(type="multiplex",
                     inputs={"Ids": [index.name],
                             "X": [v.name for v in inputs]},
                     outputs={"Out": [out.name]}, fn=fn)
    out.shape = inputs[0].shape
    return out


def dice_loss(input, label, epsilon: float = 1e-5):
    """The batch mean of ``1 - (2 |X n Y| + eps) / (|X| + |Y| + eps)``."""
    helper = LayerHelper("dice_loss")
    out = helper.create_tmp_variable(input.dtype)

    def fn(x, lbl):
        lbl = lbl.to(x.dtype)
        red = tuple(range(1, x.dim()))
        inter = torch.sum(x * lbl, dim=red)
        union = torch.sum(x, dim=red) + torch.sum(lbl, dim=red)
        return torch.mean(1.0 - (2.0 * inter + epsilon) / (union + epsilon))

    helper.append_op(type="dice_loss",
                     inputs={"X": [input.name], "Label": [label.name]},
                     outputs={"Out": [out.name]},
                     attrs={"epsilon": epsilon}, fn=fn)
    out.shape = ()
    return out


def pad(x, paddings: Sequence[int], pad_value: float = 0.0, name=None):
    """Constant padding; ``paddings`` is the flat [before0, after0,
    before1, after1, ...] list."""
    enforce(x.shape is None or len(paddings) == 2 * len(x.shape),
            "pad: paddings must hold 2 ints per input dim")
    helper = LayerHelper("pad")
    out = helper.create_tmp_variable(x.dtype)
    widths = [(int(paddings[2 * i]), int(paddings[2 * i + 1]))
              for i in range(len(paddings) // 2)]
    # F.pad takes the last dim's pair first
    flat = [w for pair in reversed(widths) for w in pair]
    helper.append_op(type="pad", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"paddings": list(paddings),
                            "pad_value": pad_value},
                     fn=lambda v: F.pad(v, flat, value=pad_value))
    if x.shape is not None:
        out.shape = tuple(
            (-1 if s == -1 else s + w[0] + w[1])
            for s, w in zip(x.shape, widths))
    return out


def crop(x, shape=None, offsets=None, name=None):
    """A static crop to ``shape`` at ``offsets`` (default 0)."""
    enforce(shape is not None, "crop requires a static target shape")
    helper = LayerHelper("crop")
    out = helper.create_tmp_variable(x.dtype)
    offs = list(offsets) if offsets is not None else [0] * len(shape)
    idx = tuple(builtins.slice(o, o + s) for o, s in zip(offs, shape))
    helper.append_op(type="crop", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"shape": list(shape), "offsets": offs},
                     fn=lambda v: v[idx])
    out.shape = tuple(shape)
    return out


def gather(input, index):
    """The rows of ``input`` at the 1-D ``index``."""
    helper = LayerHelper("gather")
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="gather",
                     inputs={"X": [input.name], "Index": [index.name]},
                     outputs={"Out": [out.name]},
                     fn=lambda x, idx: torch.index_select(
                         x, 0, idx.to(torch.int64).reshape(-1)))
    if input.shape is not None and index.shape is not None:
        out.shape = (index.shape[0],) + tuple(input.shape[1:])
    return out


def row_conv(input, future_context_size: int, param_attr=None, act=None):
    """Lookahead (row) convolution over ``[B, T, D]`` sequences:
    ``out[t] = sum_{w=0..ctx} x[t+w] * W[w]``, per feature."""
    helper = LayerHelper("row_conv")
    d = input.shape[-1]
    ctx = future_context_size + 1
    w = helper.create_parameter(param_attr, [ctx, d], input.dtype,
                                default_initializer=init.Uniform(-0.1, 0.1))
    out = helper.create_tmp_variable(input.dtype)

    def fn(x, wv):
        t = x.shape[1]
        padded = F.pad(x, (0, 0, 0, ctx - 1))
        return sum(padded[:, i:i + t, :] * wv[i][None, None, :]
                   for i in range(ctx))

    helper.append_op(type="row_conv",
                     inputs={"X": [input.name], "Filter": [w.name]},
                     outputs={"Out": [out.name]},
                     attrs={"future_context_size": future_context_size},
                     fn=fn)
    out.shape = input.shape
    return helper.append_activation(out, act)


def autoincreased_step_counter(counter_name=None, begin: int = 1,
                               step: int = 1):
    """A persistable int64 global step counter, ``begin`` at the first
    run and ``step`` more at each after."""
    helper = LayerHelper("step_counter")
    gb = helper.main_program.global_block()
    name = counter_name or "@STEP_COUNTER@"
    if name in gb.vars:
        return gb.vars[name]
    v = gb.create_var(name=name, shape=(), dtype="int64", persistable=True)
    sb = helper.startup_program.global_block()
    sb.create_var(name=name, shape=(), dtype="int64", persistable=True)
    sb.append_op(type="fill_constant", inputs={}, outputs={"Out": [name]},
                 fn=lambda: torch.full((), begin - step, dtype=torch.int64))
    helper.append_op(type="increment", inputs={"X": [name]},
                     outputs={"Out": [name]}, attrs={"step": step},
                     fn=lambda c: c + step)
    return v
