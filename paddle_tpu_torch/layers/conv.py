"""Convolution, pooling and normalization layers (counterpart of
paddle_tpu/layers/conv.py): ``conv2d``, ``conv3d``, the transposed
``conv2d_transpose``/``conv3d_transpose``, ``pool2d``, ``pool3d``,
``batch_norm`` (NCHW and NHWC), ``layer_norm``, ``lrn`` and
``im2sequence``.

The layout is NCHW (NCDHW) at the API, as in the JAX package; batch
norm also takes channels-last input. The JAX package lowers these
through XLA (``lax.conv_general_dilated``, ``lax.reduce_window``); no
Pallas kernel stands behind them, so here they are PyTorch's own ops
(cuDNN on the card): ``F.conv2d``/``F.conv3d``, ``F.conv_transpose2d``/
``F.conv_transpose3d`` (which take the reference's ``(in, out / groups,
k...)`` filter as it is, where the JAX package flips it into an
input-dilated forward conv), ``F.max_pool*``/``F.avg_pool*``,
``F.batch_norm`` and ``F.unfold``.

Mixed precision follows the JAX package's rule, read when the layer is
built (a built program does not change with later flag flips):
``use_bfloat16`` casts the conv's operands to bf16 (bf16 in, bf16 out,
f32 accumulation inside), and the bf16 activation stream
(``flags.bf16_stream()``) keeps the result bf16; otherwise it returns to
the input's dtype. Normalization statistics run in f32 whatever the
stream, and batch norm's running statistics are f32 state.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core import dtype_utils, flags
from ..core import initializer as init
from ..core.enforce import enforce
from ..layer_helper import LayerHelper


def _pair(v, n=2):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


def _triple(v):
    return _pair(v, 3)


def _conv_dtype():
    """The conv operands' dtype: bf16 under ``use_bfloat16``, else None
    (the input's own)."""
    return torch.bfloat16 if flags.get_flag("use_bfloat16") else None


def _maybe_bf16(x, dtype):
    """``x`` in the conv dtype ``dtype`` (:func:`_conv_dtype`)."""
    return x.to(dtype) if dtype is not None else x


def _stream_dtype(x, stream: bool):
    """The conv result's dtype: the input's, or bf16 on the bf16
    activation stream (``stream``, read at build time; parameters stay
    f32 master weights)."""
    return torch.bfloat16 if stream else x.dtype


def _conv(kind, nd, input, num_filters, filter_size, stride, padding,
          dilation, groups, param_attr, bias_attr, act):
    """The ``nd``-D convolution ``kind`` over NC...: filters
    ``[num_filters, C / groups, k...]`` initialized N(0, 2 / fan_in);
    bias and activation after. The conv2d op carries its geometry as
    attributes, as the JAX package's does."""
    helper = LayerHelper(kind)
    dtype = input.dtype
    fsize = _pair(filter_size, nd)
    stride = _pair(stride, nd)
    padding = _pair(padding, nd)
    dilation = _pair(dilation, nd)
    in_channels = input.shape[1]
    enforce(in_channels is not None and in_channels > 0,
            "%s input needs a static channel dim" % kind)
    filter_shape = (num_filters, in_channels // groups, *fsize)
    fan_in = (in_channels // groups) * math.prod(fsize)
    w = helper.create_parameter(
        param_attr, filter_shape, dtype,
        default_initializer=init.Normal(0.0, (2.0 / fan_in) ** 0.5))
    out = helper.create_tmp_variable(dtype)
    cdt, stream = _conv_dtype(), flags.bf16_stream()
    conv = F.conv2d if nd == 2 else F.conv3d

    def fn(x, wv):
        y = conv(_maybe_bf16(x, cdt), _maybe_bf16(wv, cdt), None, stride,
                 padding, dilation, groups)
        return y.to(_stream_dtype(x, stream))

    helper.append_op(type=kind,
                     inputs={"Input": [input.name], "Filter": [w.name]},
                     outputs={"Output": [out.name]},
                     attrs={"strides": stride, "paddings": padding,
                            "groups": groups, "dilations": dilation}
                     if kind == "conv2d" else None, fn=fn)
    out = _add_bias(helper, out, bias_attr, num_filters, dtype, nd)
    return helper.append_activation(out, act)


def conv2d(input, num_filters: int, filter_size, stride=1, padding=0,
           dilation=1, groups: int = 1, param_attr=None, bias_attr=None,
           use_cudnn: bool = True, act: Optional[str] = None, name=None):
    """2-D convolution, NCHW, filters ``[num_filters, C / groups, kh,
    kw]`` initialized N(0, 2 / fan_in); bias and activation after."""
    return _conv("conv2d", 2, input, num_filters, filter_size, stride,
                 padding, dilation, groups, param_attr, bias_attr, act)


def _add_bias(helper, out, bias_attr, num_filters, dtype, nd):
    """``out`` plus a ``[num_filters]`` bias over the channel axis of an
    ``nd``-spatial-dim NC... tensor (no bias when ``bias_attr`` is
    False)."""
    if bias_attr is False:
        return out
    b = helper.create_parameter(bias_attr, [num_filters], dtype,
                                is_bias=True)
    pre = helper.create_tmp_variable(dtype)
    view = (1, -1) + (1,) * nd
    helper.append_op(type="elementwise_add",
                     inputs={"X": [out.name], "Y": [b.name]},
                     outputs={"Out": [pre.name]},
                     fn=lambda x, bv: x + bv.reshape(view))
    return pre


def conv3d(input, num_filters: int, filter_size, stride=1, padding=0,
           dilation=1, groups: int = 1, param_attr=None, bias_attr=None,
           use_cudnn: bool = True, act=None, name=None):
    """3-D convolution, NCDHW, filters ``[num_filters, C / groups, kd,
    kh, kw]`` initialized N(0, 2 / fan_in); bias and activation
    after."""
    return _conv("conv3d", 3, input, num_filters, filter_size, stride,
                 padding, dilation, groups, param_attr, bias_attr, act)


def _conv_transpose(kind, input, num_filters, output_size, filter_size,
                    padding, stride, dilation, groups, param_attr,
                    bias_attr, act):
    """The transposed conv of ``nd`` spatial dims (``kind`` is
    ``conv2d_transpose`` or ``conv3d_transpose``): filters ``(C,
    num_filters / groups, k...)`` initialized Xavier; without
    ``filter_size`` the filter is the size that maps the input to
    ``output_size``; bias and activation after."""
    nd = 2 if kind == "conv2d_transpose" else 3
    helper = LayerHelper(kind)
    dtype = input.dtype
    stride = _pair(stride, nd)
    padding = _pair(padding, nd)
    dilation = _pair(dilation, nd)
    in_channels = input.shape[1]
    if filter_size is None:
        enforce(output_size is not None,
                "either filter_size or output_size required")
        osize = _pair(output_size, nd)
        dims = input.shape[2:2 + nd]
        filter_size = tuple(osize[i] - (dims[i] - 1) * stride[i]
                            + 2 * padding[i] for i in range(nd))
    fsize = _pair(filter_size, nd)
    filter_shape = (in_channels, num_filters // groups, *fsize)
    w = helper.create_parameter(param_attr, filter_shape, dtype,
                                default_initializer=init.Xavier())
    out = helper.create_tmp_variable(dtype)
    cdt, stream = _conv_dtype(), flags.bf16_stream()
    conv = F.conv_transpose2d if nd == 2 else F.conv_transpose3d

    def fn(x, wv):
        y = conv(_maybe_bf16(x, cdt), _maybe_bf16(wv, cdt), None, stride,
                 padding, 0, groups, dilation)
        return y.to(_stream_dtype(x, stream))

    helper.append_op(type=kind,
                     inputs={"Input": [input.name], "Filter": [w.name]},
                     outputs={"Output": [out.name]}, fn=fn)
    out = _add_bias(helper, out, bias_attr, num_filters, dtype, nd)
    return helper.append_activation(out, act)


def conv2d_transpose(input, num_filters: int, output_size=None,
                     filter_size=None, padding=0, stride=1, dilation=1,
                     groups: int = 1, param_attr=None, bias_attr=None,
                     use_cudnn: bool = True, act=None, name=None):
    """Transposed 2-D conv, NCHW, filters ``(C, num_filters / groups,
    kh, kw)``."""
    return _conv_transpose("conv2d_transpose", input, num_filters,
                           output_size, filter_size, padding, stride,
                           dilation, groups, param_attr, bias_attr, act)


def conv3d_transpose(input, num_filters: int, output_size=None,
                     filter_size=None, padding=0, stride=1, dilation=1,
                     groups: int = 1, param_attr=None, bias_attr=None,
                     use_cudnn: bool = True, act=None, name=None):
    """Transposed 3-D conv, NCDHW, filters ``(C, num_filters / groups,
    kd, kh, kw)``."""
    return _conv_transpose("conv3d_transpose", input, num_filters,
                           output_size, filter_size, padding, stride,
                           dilation, groups, param_attr, bias_attr, act)


def _ceil_extra(size, k, s, p):
    """The trailing pad ``ceil_mode`` adds so the window count rounds
    up (the JAX package's rule: every window it counts, even one that
    starts in the padding)."""
    n = math.ceil((size + 2 * p - k) / s) + 1
    return max(0, (n - 1) * s + k - size - 2 * p)


def _pool(nd, pool_type, psize, stride, padding, global_pooling,
          ceil_mode, exclusive):
    """The op fn of ``nd``-D max or average pooling over NC... (the
    rules of :func:`pool2d`)."""
    max_pool = F.max_pool2d if nd == 2 else F.max_pool3d
    avg_pool = F.avg_pool2d if nd == 2 else F.avg_pool3d

    def fn(x):
        if global_pooling:
            if pool_type == "max":
                # max pooling routes a tie's gradient to one element, as
                # the JAX package's select-and-scatter does
                return max_pool(x, tuple(x.shape[2:]))
            return x.sum(dim=tuple(range(2, 2 + nd)), keepdim=True) / (
                math.prod(x.shape[2:]))
        ex = tuple(_ceil_extra(x.shape[2 + i], psize[i], stride[i],
                               padding[i]) if ceil_mode else 0
                   for i in range(nd))
        padded = any(padding) or any(ex)
        # torch pads symmetrically, at most half a window
        if not any(ex) and all(p <= k // 2 for p, k in zip(padding, psize)):
            if pool_type == "max":
                return max_pool(x, psize, stride, padding)
            return avg_pool(x, psize, stride, padding,
                            count_include_pad=not (exclusive and padded))
        # F.pad takes the last dim first
        pads = sum(((p, p + e) for p, e in zip(reversed(padding),
                                               reversed(ex))), ())
        if pool_type == "max":
            return max_pool(F.pad(x, pads, value=-math.inf), psize, stride)
        total = avg_pool(F.pad(x, pads), psize, stride, divisor_override=1)
        if exclusive and padded:
            return total / avg_pool(F.pad(torch.ones_like(x), pads), psize,
                                    stride, divisor_override=1)
        return total / math.prod(psize)

    return fn


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling: bool = False,
           use_cudnn: bool = True, ceil_mode: bool = False,
           exclusive: bool = True, name=None):
    """2-D max or average pooling, NCHW.

    Max pooling pads with -inf (a window of padding alone gives -inf).
    Average pooling sums over zero padding and divides by the window's
    size, or, ``exclusive``, by the count of real elements under it
    whenever there is padding. ``ceil_mode`` pads the trailing edge up
    to the rounded-up window count, as the JAX package does: torch's own
    ``ceil_mode`` drops a window that starts in the right padding, so it
    is not used; such shapes pad explicitly. ``global_pooling`` pools
    the whole plane."""
    helper = LayerHelper("pool2d")
    out = helper.create_tmp_variable(input.dtype)
    enforce(pool_type in ("max", "avg"), "pool_type must be max|avg")
    fn = _pool(2, pool_type, _pair(pool_size), _pair(pool_stride),
               _pair(pool_padding), global_pooling, ceil_mode, exclusive)
    helper.append_op(type="pool2d", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"pooling_type": pool_type,
                            "global_pooling": global_pooling}, fn=fn)
    return out


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None):
    """3-D max or average pooling, NCDHW. Max pooling pads with -inf;
    average pooling sums over zero padding and divides by the window's
    size (padding included). ``ceil_mode`` is accepted and, as in the
    JAX package, has no effect."""
    helper = LayerHelper("pool3d")
    out = helper.create_tmp_variable(input.dtype)
    fn = _pool(3, pool_type, _triple(pool_size), _triple(pool_stride),
               _triple(pool_padding), global_pooling, False, False)
    helper.append_op(type="pool3d", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]}, fn=fn)
    return out


def batch_norm(input, act=None, is_test: bool = False, momentum: float = 0.9,
               epsilon: float = 1e-5, param_attr=None, bias_attr=None,
               data_layout="NCHW", in_place: bool = False, name=None,
               moving_mean_name=None, moving_variance_name=None,
               do_model_average_for_mean_and_var=False, fuse_with_relu=False):
    """Batch normalization with persistable f32 running statistics:
    over N, H, W of NCHW input, or, ``data_layout="NHWC"``, over every
    axis but the last of channels-last input (the JAX package's rule;
    such input runs as a channels-last view of NCHW, so the same
    ``F.batch_norm`` normalizes it).

    Training: normalized by the batch's mean and population variance
    (``F.batch_norm`` with no running statistics: in f32, emitted in the
    input's dtype), and the running statistics updated the JAX package's
    way — ``momentum * running + (1 - momentum) * batch`` with the
    population variance, where ``F.batch_norm``'s own update would take
    the unbiased variance and the opposite momentum. The batch
    statistics for that update are computed apart, in f32, under
    ``no_grad``: the ``MeanOut``/``VarianceOut`` outputs are state
    written back to the scope, and one left attached to the step's
    autograd graph would keep that graph alive. ``is_test`` (an op
    attribute, set by ``Program.clone(for_test=True)``) normalizes by the
    running statistics and returns them unchanged."""
    helper = LayerHelper("batch_norm")
    dtype = input.dtype
    enforce(data_layout in ("NCHW", "NHWC"),
            "batch_norm: data_layout must be NCHW or NHWC")
    last = data_layout == "NHWC"
    c = input.shape[-1] if last else input.shape[1]
    enforce(c is not None and c > 0, "batch_norm needs static channel dim")

    scale = helper.create_parameter(param_attr, [c], dtype,
                                    default_initializer=init.Constant(1.0))
    bias = helper.create_parameter(bias_attr, [c], dtype, is_bias=True)

    gb = helper.main_program.global_block()
    mean_name = moving_mean_name or helper.unique_out("moving_mean")
    var_name = moving_variance_name or helper.unique_out("moving_var")
    # running statistics are master state: always f32, even when the
    # activation stream is bf16
    stats_dtype = ("float32" if dtype_utils.name(dtype) in ("bfloat16",
                                                             "float16")
                   else dtype)
    for nm, fill in ((mean_name, 0.0), (var_name, 1.0)):
        gb.create_var(name=nm, shape=(c,), dtype=stats_dtype,
                      persistable=True)
        sb = helper.startup_program.global_block()
        sb.create_var(name=nm, shape=(c,), dtype=stats_dtype,
                      persistable=True)
        sb.append_op(type="fill_constant", inputs={},
                     outputs={"Out": [nm]},
                     attrs={"shape": (c,), "value": fill},
                     fn=(lambda _f=fill, _c=c: torch.full(
                         (_c,), _f, dtype=torch.float32)))

    out = helper.create_tmp_variable(dtype)

    def fn(x, sc, b, mm, mv, is_test=False):
        if last:
            x = x.movedim(-1, 1)
        if is_test:
            y = F.batch_norm(x, mm, mv, sc, b, training=False, eps=epsilon)
            return (y.movedim(1, -1) if last else y), mm, mv
        with torch.no_grad():
            ax = (0,) + tuple(range(2, x.dim()))
            var, mean = torch.var_mean(x.detach().to(torch.float32), dim=ax,
                                       correction=0)
            mm_new = momentum * mm + (1 - momentum) * mean.to(mm.dtype)
            mv_new = momentum * mv + (1 - momentum) * var.to(mv.dtype)
        y = F.batch_norm(x, None, None, sc, b, training=True, eps=epsilon)
        return (y.movedim(1, -1) if last else y), mm_new, mv_new

    helper.append_op(
        type="batch_norm",
        inputs={"X": [input.name], "Scale": [scale.name],
                "Bias": [bias.name], "Mean": [mean_name],
                "Variance": [var_name]},
        outputs={"Y": [out.name], "MeanOut": [mean_name],
                 "VarianceOut": [var_name]},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "is_test": is_test, "_fn_attrs": ["is_test"]},
        fn=fn)
    return helper.append_activation(out, act)


def layer_norm(input, scale: bool = True, shift: bool = True,
               begin_norm_axis: int = 1, epsilon: float = 1e-5,
               param_attr=None, bias_attr=None, act=None, name=None):
    """Layer normalization over the axes from ``begin_norm_axis`` on."""
    helper = LayerHelper("layer_norm")
    dtype = input.dtype
    norm_shape = input.shape[begin_norm_axis:]
    nelem = int(np.prod(norm_shape))
    inputs = {"X": [input.name]}
    if scale:
        g = helper.create_parameter(param_attr, [nelem], dtype,
                                    default_initializer=init.Constant(1.0))
        inputs["Scale"] = [g.name]
    if shift:
        b = helper.create_parameter(bias_attr, [nelem], dtype, is_bias=True)
        inputs["Bias"] = [b.name]
    out = helper.create_tmp_variable(dtype)

    def fn(x, *sb):
        # stats in f32 even for a bf16 activation stream (in f64 for an
        # f64 one); output returns to the input dtype
        cdt = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(cdt)
        ax = tuple(range(begin_norm_axis, x.dim()))
        mean = torch.mean(xf, dim=ax, keepdim=True)
        var = torch.var(xf, dim=ax, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + epsilon)
        tail = x.shape[begin_norm_axis:]
        i = 0
        if scale:
            y = y * sb[i].reshape(tail).to(cdt)
            i += 1
        if shift:
            y = y + sb[i].reshape(tail).to(cdt)
        return y.to(x.dtype)

    helper.append_op(type="layer_norm", inputs=inputs,
                     outputs={"Y": [out.name]},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis}, fn=fn)
    return helper.append_activation(out, act)


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    """Local response normalization across channels: ``x / (k + alpha *
    sum of x**2 over a window of n channels) ** beta``, the window's
    zero padding ``n // 2`` channels before and the rest after."""
    helper = LayerHelper("lrn")
    out = helper.create_tmp_variable(input.dtype)

    def fn(x):
        sq = torch.square(x)
        pad = n // 2
        sq_p = F.pad(sq, (0, 0, 0, 0, pad, n - 1 - pad))
        # summed slice by slice in window order, as the JAX package does
        acc = sum(sq_p[:, i:i + x.shape[1]] for i in range(n))
        return x / torch.pow(k + alpha * acc, beta)

    helper.append_op(type="lrn", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]}, fn=fn)
    return out


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    """Image patches as a sequence: ``[N, C, H, W]`` to ``[N * oh * ow, C
    * kh * kw]``, one row per output position (row-major over the
    image), each row a patch in (channel, kh, kw) order."""
    helper = LayerHelper("im2sequence")
    out = helper.create_tmp_variable(input.dtype)
    fsize = _pair(filter_size)
    stride_ = _pair(stride)
    pad = _pair(padding)

    def fn(x):
        n = x.shape[0]
        xp = F.pad(x, (pad[1], pad[1], pad[0], pad[0]))
        patches = F.unfold(xp, fsize, stride=stride_)  # [N, C*kh*kw, L]
        return patches.transpose(1, 2).reshape(n * patches.shape[2], -1)

    helper.append_op(type="im2sequence", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]}, fn=fn)
    return out
