"""Variable-length sequence ops (counterpart of
paddle_tpu/layers/sequence.py; reference: the LoD offset tables of
framework/lod_tensor.h:58,110 and the operators/sequence_* family).

A sequence is a dense padded array ``[batch, max_len, ...]`` with a
per-example length vector, as in the JAX package:
``layers.data(..., lod_level=1)`` declares the int32 companion
``<name>@LEN``, the DataFeeder pads ragged rows and fills it, and the
ops here take (padded, lengths) and mask. Every op keeps its shapes
static — it masks, and never gathers ragged rows — so a step holding
them captures as a CUDA graph.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.enforce import enforce
from ..core.program import Variable
from ..layer_helper import LayerHelper

LEN_SUFFIX = "@LEN"


def length_var_of(x: Variable) -> Optional[Variable]:
    """The companion length var of a sequence var: the propagated
    ``seq_length_name``, else ``<name>@LEN``."""
    b = x.block
    if x.seq_length_name:
        v = b._find_var_recursive(x.seq_length_name)
        if v is not None:
            return v
    return b._find_var_recursive(x.name + LEN_SUFFIX)


def outer_length_var_of(x: Variable) -> Optional[Variable]:
    """The outer (``@LEN0``) companion of a 2-level sequence var."""
    b = x.block
    if x.seq_outer_length_name:
        v = b._find_var_recursive(x.seq_outer_length_name)
        if v is not None:
            return v
    return b._find_var_recursive(x.name + "@LEN0")


def _seq_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """[B, maxlen] validity mask of the lengths [B]."""
    return (torch.arange(maxlen, device=lengths.device)[None, :]
            < lengths.to(torch.int64).reshape(-1)[:, None])


def _trail(m: torch.Tensor, ndim: int) -> torch.Tensor:
    """``m`` with trailing size-1 axes up to ``ndim`` dims."""
    return m.reshape(tuple(m.shape) + (1,) * (ndim - m.dim()))


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _require_len(x: Variable, length) -> Variable:
    if length is not None:
        return length
    lv = length_var_of(x)
    enforce(lv is not None,
            "sequence op on %r needs lengths: declare the input with "
            "lod_level=1 (creates '%s@LEN') or pass length=" %
            (x.name, x.name))
    return lv


def sequence_mask(x, maxlen=None, dtype="int64", like=None):
    """Lengths ``x`` [B] to a [B, maxlen] mask. The width is static:
    pass ``maxlen`` or ``like``, a [B, T, ...] variable whose time axis
    gives it."""
    from ..core import dtype_utils

    enforce(maxlen is not None or like is not None,
            "sequence_mask requires maxlen under compilation: pass the "
            "padded time extent (or like=<a [B, T, ...] variable>)")
    helper = LayerHelper("sequence_mask")
    out = helper.create_tmp_variable(dtype)
    tgt = dtype_utils.to_torch(dtype)
    if like is None:
        def fn(lens):
            return _seq_mask(lens, maxlen).to(tgt)

        inputs = {"X": [x.name]}
    else:
        def fn(lens, ref):
            return _seq_mask(lens, ref.shape[1]).to(tgt)

        inputs = {"X": [x.name], "MaxLenLike": [like.name]}
    helper.append_op(type="sequence_mask", inputs=inputs,
                     outputs={"Y": [out.name]}, attrs={"maxlen": maxlen},
                     fn=fn)
    return out


def sequence_pool(input, pool_type: str, length=None, is_test=False):
    """Masked pooling over the time axis: average, sum, sqrt, max,
    last, first (reference: operators/sequence_pool_op.cc)."""
    helper = LayerHelper("sequence_pool")
    lv = _require_len(input, length)
    out = helper.create_tmp_variable(input.dtype)
    pt = pool_type.lower()
    enforce(pt in ("average", "sum", "sqrt", "max", "last", "first"),
            "bad pool_type %r" % pool_type)

    def fn(x, lens):
        m = _trail(_seq_mask(lens, x.shape[1]), x.dim())
        if pt == "max":
            # amax splits the gradient among tied maxima, as jnp.max
            neg = torch.full((), torch.finfo(x.dtype).min, dtype=x.dtype,
                             device=x.device)
            return torch.amax(torch.where(m, x, neg), dim=1)
        if pt == "last":
            idx = torch.clamp(lens.to(torch.int64).reshape(-1) - 1, min=0)
            idx = idx.reshape((-1,) + (1,) * (x.dim() - 1))
            return torch.take_along_dim(x, idx, dim=1).squeeze(1)
        if pt == "first":
            return x[:, 0]
        s = torch.sum(torch.where(m, x, _zero(x)), dim=1)
        if pt == "sum":
            return s
        cnt = torch.clamp(lens.to(x.dtype).reshape(-1), min=1.0)
        cnt = cnt.reshape((-1,) + (1,) * (x.dim() - 2))
        if pt == "average":
            return s / cnt
        return s / torch.sqrt(cnt)

    helper.append_op(type="sequence_pool",
                     inputs={"X": [input.name], "Length": [lv.name]},
                     outputs={"Out": [out.name]},
                     attrs={"pooltype": pool_type}, fn=fn)
    if input.shape is not None and len(input.shape) >= 2:
        out.shape = (input.shape[0],) + tuple(input.shape[2:])
    out.seq_length_name = None  # the time axis is consumed
    return out


def sequence_first_step(input, length=None):
    return sequence_pool(input, "first", length)


def sequence_last_step(input, length=None):
    return sequence_pool(input, "last", length)


def sequence_softmax(input, length=None, use_cudnn=False):
    """Softmax over the valid time steps, 0 past each length
    (reference: operators/sequence_softmax_op.cc)."""
    helper = LayerHelper("sequence_softmax")
    lv = _require_len(input, length)
    out = helper.create_tmp_variable(input.dtype)

    def fn(x, lens):
        m = _trail(_seq_mask(lens, x.shape[1]), x.dim())
        neg = torch.full((), torch.finfo(x.dtype).min, dtype=x.dtype,
                         device=x.device)
        sm = torch.softmax(torch.where(m, x, neg), dim=1)
        return torch.where(m, sm, _zero(sm))

    helper.append_op(type="sequence_softmax",
                     inputs={"X": [input.name], "Length": [lv.name]},
                     outputs={"Out": [out.name]}, fn=fn)
    return out


def _shift(x: torch.Tensor, off: int) -> torch.Tensor:
    """``x[:, t + off]`` at each t of the time axis, zero where that
    falls outside [0, T)."""
    T = x.shape[1]
    if off == 0:
        return x
    z = torch.zeros((x.shape[0], min(abs(off), T)) + tuple(x.shape[2:]),
                    dtype=x.dtype, device=x.device)
    if off > 0:
        return torch.cat([x[:, off:], z], dim=1)
    return torch.cat([z, x[:, :max(T + off, 0)]], dim=1)


def sequence_conv(input, num_filters: int, filter_size: int = 3,
                  filter_stride: int = 1, padding=None, bias_attr=None,
                  param_attr=None, act=None, length=None):
    """Context-window convolution over time (reference:
    operators/sequence_conv_op.cc, math/context_project.h): the windows
    centred as the reference centres them, zero outside each sequence,
    one matrix product."""
    helper = LayerHelper("sequence_conv")
    lv = _require_len(input, length)
    dtype = input.dtype
    hidden = input.shape[-1]
    enforce(hidden is not None and hidden > 0,
            "sequence_conv needs static feature dim")
    w = helper.create_parameter(param_attr,
                                [filter_size * hidden, num_filters], dtype)
    out = helper.create_tmp_variable(dtype)
    up = (filter_size - 1) // 2

    def fn(x, lens, wv):
        mask = _seq_mask(lens, x.shape[1])[..., None]
        x = torch.where(mask, x, _zero(x))
        cat = torch.cat([_shift(x, off)
                         for off in range(-up, filter_size - up)], dim=-1)
        y = torch.matmul(cat, wv)
        return torch.where(mask, y, _zero(y))

    helper.append_op(type="sequence_conv",
                     inputs={"X": [input.name], "Length": [lv.name],
                             "Filter": [w.name]},
                     outputs={"Out": [out.name]}, fn=fn)
    if input.shape is not None:
        out.shape = tuple(input.shape[:-1]) + (num_filters,)
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], dtype,
                                    is_bias=True)
        pre = helper.create_tmp_variable(dtype)
        pre.shape = out.shape
        helper.append_op(type="elementwise_add",
                         inputs={"X": [out.name], "Y": [b.name]},
                         outputs={"Out": [pre.name]},
                         fn=lambda xv, bv: xv + bv)
        out = pre
    return helper.append_activation(out, act)


def sequence_expand(x, y, ref_level=-1, y_length=None):
    """Broadcast the per-sequence rows of ``x`` along ``y``'s time axis:
    [B, ...] to [B, T_y, ...] (reference: operators/sequence_expand_op.cc)."""
    helper = LayerHelper("sequence_expand")
    out = helper.create_tmp_variable(x.dtype)

    def fn(xv, yv):
        T = yv.shape[1]
        if xv.dim() == yv.dim():
            return xv[:, :1].expand((xv.shape[0], T) + tuple(xv.shape[2:]))
        return xv[:, None].expand((xv.shape[0], T) + tuple(xv.shape[1:]))

    helper.append_op(type="sequence_expand",
                     inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]}, fn=fn)
    return out


def sequence_reverse(x, length=None):
    """Reverse each sequence's valid prefix; padding stays in place
    (reference: operators/sequence_reverse_op.cc)."""
    helper = LayerHelper("sequence_reverse")
    lv = _require_len(x, length)
    out = helper.create_tmp_variable(x.dtype)

    def fn(xv, lens):
        idx = torch.arange(xv.shape[1], device=xv.device)[None, :]
        L = lens.to(torch.int64).reshape(-1)[:, None]
        src = torch.where(idx < L, L - 1 - idx, idx)
        return torch.take_along_dim(xv, _trail(src, xv.dim()), dim=1)

    helper.append_op(type="sequence_reverse",
                     inputs={"X": [x.name], "Length": [lv.name]},
                     outputs={"Y": [out.name]}, fn=fn)
    return out


def sequence_pad(x, pad_value=0.0, maxlen=None, length=None):
    """Re-pad with ``pad_value`` past each length; returns (out,
    lengths) (reference: operators/sequence_pad_op.cc)."""
    helper = LayerHelper("sequence_pad")
    lv = _require_len(x, length)
    out = helper.create_tmp_variable(x.dtype)

    def fn(xv, lens):
        m = _trail(_seq_mask(lens, xv.shape[1]), xv.dim())
        return torch.where(m, xv, torch.full((), pad_value, dtype=xv.dtype,
                                             device=xv.device))

    helper.append_op(type="sequence_pad",
                     inputs={"X": [x.name], "Length": [lv.name]},
                     outputs={"Out": [out.name]}, fn=fn)
    return out, lv


def sequence_erase(x, tokens, length=None):
    """Remove ``tokens``, compacting each sequence to the left with new
    lengths; the freed tail is padding, id 0 (reference:
    operators/sequence_erase_op.cc)."""
    helper = LayerHelper("sequence_erase")
    lv = _require_len(x, length)
    out = helper.create_tmp_variable(x.dtype)
    newlen = helper.create_tmp_variable("int32")
    toks = [int(t) for t in tokens]

    def fn(xv, lens):
        T = xv.shape[1]
        keep = _seq_mask(lens, T)
        for tok in toks:
            keep = keep & (xv != tok)
        # stable compaction: kept positions first, in order
        order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
        gathered = torch.take_along_dim(xv, order, dim=1)
        nl = keep.sum(dim=1).to(torch.int32)
        return torch.where(_seq_mask(nl, T), gathered, _zero(xv)), nl

    helper.append_op(type="sequence_erase",
                     inputs={"X": [x.name], "Length": [lv.name]},
                     outputs={"Out": [out.name], "NewLen": [newlen.name]},
                     fn=fn)
    out.seq_length_name = newlen.name
    newlen.seq_length_name = None
    return out, newlen


def sequence_reshape(input, new_dim: int):
    """Each step's width to ``new_dim``, lengths scaled by D/new_dim:
    [B, T, D] to [B, T*D/new_dim, new_dim] (reference:
    operators/sequence_reshape_op.cc)."""
    helper = LayerHelper("sequence_reshape")
    lv = _require_len(input, None)
    D = input.shape[-1]
    T = input.shape[1] if len(input.shape) > 2 else -1
    enforce(D != -1 and (D % new_dim == 0 or new_dim % D == 0),
            "sequence_reshape: D and new_dim must divide evenly")
    enforce(T == -1 or (T * D) % new_dim == 0,
            "sequence_reshape: T*D (%s*%s) must be divisible by new_dim=%s"
            % (T, D, new_dim))
    out = helper.create_tmp_variable(input.dtype)
    newlen = helper.create_tmp_variable(np.int32)

    def fn(xv, lens):
        B, t, d = xv.shape
        nl = (lens.to(torch.int64) * d // new_dim).to(torch.int32)
        return torch.reshape(xv, (B, t * d // new_dim, new_dim)), nl

    helper.append_op(type="sequence_reshape",
                     inputs={"X": [input.name], "Length": [lv.name]},
                     outputs={"Out": [out.name], "NewLen": [newlen.name]},
                     attrs={"new_dim": new_dim}, fn=fn)
    if input.shape is not None:
        B, T = input.shape[0], input.shape[1]
        out.shape = (B, -1 if T == -1 else T * D // new_dim, new_dim)
    out.seq_length_name = newlen.name
    newlen.seq_length_name = None
    return out


def sequence_slice(input, offset, length, name=None):
    """``out[i] = x[i][offset[i] : offset[i] + length[i]]``, padded to
    the input's width; the new lengths are ``length`` (reference:
    operators/sequence_slice_op.cc)."""
    helper = LayerHelper("sequence_slice")
    lv = _require_len(input, None)
    out = helper.create_tmp_variable(input.dtype)
    newlen = helper.create_tmp_variable(np.int32)

    def fn(xv, offs, lens_want, lens_have):
        T = xv.shape[1]
        offs = offs.to(torch.int64).reshape(-1)
        want = lens_want.to(torch.int32).reshape(-1)
        idx = torch.clamp(offs[:, None] + torch.arange(
            T, device=xv.device)[None, :], 0, T - 1)
        g = torch.take_along_dim(xv, _trail(idx, xv.dim()), dim=1)
        m = _trail(_seq_mask(want, T), xv.dim())
        return torch.where(m, g, _zero(g)), want

    helper.append_op(type="sequence_slice",
                     inputs={"X": [input.name], "Offset": [offset.name],
                             "Length": [length.name], "InLen": [lv.name]},
                     outputs={"Out": [out.name], "NewLen": [newlen.name]},
                     fn=fn)
    out.shape = input.shape
    out.seq_length_name = newlen.name
    newlen.seq_length_name = None
    return out


def sequence_concat(input, name=None):
    """Concatenate sequences along time, per example:
    ``out[i] = concat(a[i, :len_a[i]], b[i, :len_b[i]], ...)``, width
    the sum of the widths, lengths the sum of the lengths (reference:
    operators/sequence_concat_op.cc). Each input is written at its
    running offset in turn, a later write over an earlier one's padding,
    as the JAX package's row-wise ``dynamic_update_slice``."""
    helper = LayerHelper("sequence_concat")
    xs = list(input)
    enforce(len(xs) >= 2, "sequence_concat needs >= 2 inputs")
    lvs = [_require_len(x, None) for x in xs]
    out = helper.create_tmp_variable(xs[0].dtype)
    newlen = helper.create_tmp_variable(np.int32)

    def fn(*args):
        n = len(args) // 2
        vals, lens = args[:n], args[n:]
        B = vals[0].shape[0]
        ttot = sum(v.shape[1] for v in vals)
        buf = torch.zeros((B, ttot) + tuple(vals[0].shape[2:]),
                          dtype=vals[0].dtype, device=vals[0].device)
        off = torch.zeros((B,), dtype=torch.int32, device=vals[0].device)
        for v, ln in zip(vals, lens):
            ln = ln.to(torch.int32).reshape(-1)
            m = _trail(_seq_mask(ln, v.shape[1]), v.dim())
            v = torch.where(m, v, _zero(v))
            idx = off.to(torch.int64)[:, None] + torch.arange(
                v.shape[1], device=v.device)[None, :]
            buf = buf.scatter(1, _trail(idx, v.dim()).expand(v.shape), v)
            off = off + ln
        return buf, off

    helper.append_op(
        type="sequence_concat",
        inputs={"X": [x.name for x in xs],
                "Len": [lv.name for lv in lvs]},
        outputs={"Out": [out.name], "NewLen": [newlen.name]}, fn=fn)
    if xs[0].shape is not None:
        widths = [x.shape[1] if x.shape is not None else -1 for x in xs]
        w = -1 if any(t == -1 for t in widths) else sum(widths)
        out.shape = (xs[0].shape[0], w) + tuple(xs[0].shape[2:])
    out.seq_length_name = newlen.name
    newlen.seq_length_name = None
    return out


def lod_reset(x, y=None, target_lod=None):
    """Reattach sequence lengths: the data is untouched, the length
    companion becomes ``y``'s (a sequence var's lengths, or a length
    vector) or the static ``target_lod`` (reference:
    operators/lod_reset_op.cc)."""
    helper = LayerHelper("lod_reset")
    enforce(y is not None or target_lod is not None,
            "lod_reset: pass y (length var) or target_lod (lengths list)")
    out = helper.create_tmp_variable(x.dtype)
    if y is None:
        lens = [int(v) for v in np.asarray(target_lod, np.int32)]
        newlen = helper.create_tmp_variable(np.int32)
        helper.append_op(type="lod_reset_lengths", inputs={},
                         outputs={"Out": [newlen.name]},
                         attrs={"lengths": lens},
                         fn=lambda: torch.tensor(lens, dtype=torch.int32))
        lenvar = newlen
    else:
        ylen = length_var_of(y)
        lenvar = ylen if ylen is not None else y
    helper.append_op(type="lod_reset", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, fn=lambda v: v)
    out.shape = x.shape
    out.seq_length_name = lenvar.name
    return out


def sub_nested_seq(x, selected_indices, selected_counts=None,
                   length=None, outer_length=None, name=None):
    """Select inner sequences of a 2-level sequence by index (reference:
    gserver sub_nested_seq_layer). ``x`` [B, S, T, ...];
    ``selected_indices`` [B, K] into the S axis, entries past
    ``selected_counts[b]`` (default K) ignored. Returns a 2-level
    [B, K, T, ...] whose outer counts are ``selected_counts`` (at most
    each example's own) and whose inner lengths are gathered from x's;
    a selection past an example's count, or negative, is zero."""
    helper = LayerHelper(name or "sub_nested_seq")
    lens1 = _require_len(x, length)
    lens0 = outer_length if outer_length is not None \
        else outer_length_var_of(x)
    enforce(lens0 is not None,
            "sub_nested_seq on %r needs the outer length companion: "
            "declare the input with lod_level=2 (creates '%s@LEN0') or "
            "pass outer_length=" % (x.name, x.name))
    out = helper.create_tmp_variable(x.dtype)
    out_len = helper.create_tmp_variable("int32")
    out_len0 = helper.create_tmp_variable("int32")
    inputs = {"X": [x.name], "Lens": [lens1.name], "Lens0": [lens0.name],
              "Idx": [selected_indices.name]}
    if selected_counts is not None:
        inputs["Counts"] = [selected_counts.name]

    def fn(xv, l1, l0, idx, counts=None):
        K = idx.shape[1]
        idx = idx.to(torch.int64)
        l0 = l0.to(torch.int32).reshape(-1)
        if counts is None:
            counts = torch.full(tuple(xv.shape[:1]), K, dtype=torch.int32,
                                device=xv.device)
        counts = torch.minimum(counts.to(torch.int32).reshape(-1), l0)
        valid = ((torch.arange(K, device=xv.device)[None, :]
                  < counts[:, None]) & (idx < l0[:, None]) & (idx >= 0))
        safe = torch.clamp(idx, 0, xv.shape[1] - 1)
        g = torch.take_along_dim(xv, _trail(safe, xv.dim()), dim=1)
        g = torch.where(_trail(valid, xv.dim()), g, _zero(g))
        new_l1 = torch.where(valid, torch.take_along_dim(
            l1.to(torch.int32), safe, dim=1), torch.zeros(
                (), dtype=torch.int32, device=xv.device))
        return g, new_l1, counts

    helper.append_op(type="sub_nested_seq", inputs=inputs,
                     outputs={"Out": [out.name], "OutLen": [out_len.name],
                              "OutLen0": [out_len0.name]}, fn=fn)
    out.seq_length_name = out_len.name
    out.seq_outer_length_name = out_len0.name
    out.lod_level = 2
    return out


__all__ = ["length_var_of", "outer_length_var_of", "sequence_mask",
           "sequence_pool", "sequence_first_step", "sequence_last_step",
           "sequence_softmax", "sequence_conv", "sequence_expand",
           "sequence_reverse", "sequence_pad", "sequence_erase",
           "sequence_reshape", "sequence_slice", "sequence_concat",
           "lod_reset", "sub_nested_seq"]
