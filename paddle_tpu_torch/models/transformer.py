"""Transformer building blocks (counterpart of
paddle_tpu/models/transformer.py): the ones the causal LM reaches.

Attention is one fused op (scale -> logits -> mask -> softmax ->
context), the JAX package's ``"fused"`` einsum path. Its ``"pallas"``
(flash attention) and ``"ring"`` (sequence parallel) implementations
are not ported yet.
"""

from __future__ import annotations

import math

import torch

from .. import layers
from ..layer_helper import LayerHelper


def sinusoid_table(positions, d_model: int):
    """The fixed sinusoid encoding at float32 ``positions`` (any shape):
    ``[..., d_model]`` with the sines in the first half and the cosines
    in the second, as the reference's position_encoding_init lays them
    out."""
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                 device=positions.device)
                    * -(math.log(10000.0) / d_model))
    ang = positions[..., None] * div
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def positional_encoding(x, max_length=2048):
    """Add the fixed sinusoid position encoding (positions 0..T-1)."""
    helper = LayerHelper("pos_encoding")
    out = helper.create_tmp_variable(x.dtype)

    def fn(v):
        pos = torch.arange(v.shape[1], dtype=torch.float32, device=v.device)
        pe = sinusoid_table(pos, v.shape[-1])
        return v + pe[None, :, :].to(v.dtype)

    helper.append_op(type="pos_encoding", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, fn=fn)
    return out


def attention(qh, kh, vh, mask=None, causal=False):
    """Multi-head attention on head-split ``[B, T, H, D]`` tensors: the
    JAX package's fused math in the same order — logits scaled by
    ``1/sqrt(D)``, ``-1e9`` masking, softmax in f32, cast back."""
    Tq, Tk = qh.shape[1], kh.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(qh.shape[-1])
    neg = torch.full((), -1e9, dtype=logits.dtype, device=logits.device)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :] > 0, logits, neg)
    if causal:
        cm = torch.ones((Tq, Tk), dtype=torch.bool,
                        device=logits.device).tril()
        logits = torch.where(cm[None, None, :, :], logits, neg)
    w = torch.softmax(logits.to(torch.float32), dim=-1).to(vh.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, vh)


def multi_head_attention(queries, keys, values, d_key, d_value, d_model,
                         n_head=1, dropout_rate=0.0, is_test=False,
                         causal=False, kv_mask=None, tp=False, cache=None,
                         attn_impl=None):
    """Fused multi-head attention. ``kv_mask`` is a ``[B, T_k]`` 0/1
    float var masking padded keys; ``causal`` adds the autoregressive
    mask. ``attn_impl`` ``None`` or ``"fused"`` selects the einsum path;
    ``"pallas"`` and ``"ring"`` are not ported yet."""
    if attn_impl not in (None, "fused"):
        raise NotImplementedError(
            "multi_head_attention(attn_impl=%r) is not ported yet; use "
            "attn_impl=None or 'fused'" % (attn_impl,))
    if tp:
        raise NotImplementedError(
            "multi_head_attention(tp=True) is not ported yet")
    helper = LayerHelper("multi_head_attention")

    q = layers.fc(input=queries, size=d_key * n_head, num_flatten_dims=2,
                  bias_attr=False)
    k = layers.fc(input=keys, size=d_key * n_head, num_flatten_dims=2,
                  bias_attr=False)
    v = layers.fc(input=values, size=d_value * n_head, num_flatten_dims=2,
                  bias_attr=False)

    out = helper.create_tmp_variable(queries.dtype)
    in_names = {"Q": [q.name], "K": [k.name], "V": [v.name]}
    if kv_mask is not None:
        in_names["Mask"] = [kv_mask.name]

    def fn(qv, kv, vv, mask=None):
        B, Tq, _ = qv.shape
        Tk = kv.shape[1]
        qh = torch.reshape(qv, (B, Tq, n_head, d_key))
        kh = torch.reshape(kv, (B, Tk, n_head, d_key))
        vh = torch.reshape(vv, (B, Tk, n_head, d_value))
        ctx = attention(qh, kh, vh, mask=mask, causal=causal)
        return torch.reshape(ctx, (B, Tq, n_head * d_value))

    helper.append_op(type="fused_attention", inputs=in_names,
                     outputs={"Out": [out.name]},
                     attrs={"n_head": n_head, "causal": causal}, fn=fn)
    proj = layers.fc(input=out, size=d_model, num_flatten_dims=2,
                     bias_attr=False)
    if dropout_rate and not is_test:
        proj = layers.dropout(proj, dropout_prob=dropout_rate,
                              is_test=is_test)
    return proj


def positionwise_feed_forward(x, d_inner_hid, d_hid, dropout_rate=0.0,
                              is_test=False, tp=False):
    hidden = layers.fc(input=x, size=d_inner_hid, num_flatten_dims=2,
                       act="relu")
    if dropout_rate and not is_test:
        hidden = layers.dropout(hidden, dropout_prob=dropout_rate,
                                is_test=is_test)
    return layers.fc(input=hidden, size=d_hid, num_flatten_dims=2)


def pre_post_process_layer(prev_out, out, process_cmd, dropout_rate=0.0,
                           is_test=False):
    """'n' = layer_norm, 'a' = residual add, 'd' = dropout."""
    for cmd in process_cmd:
        if cmd == "a":
            out = layers.elementwise_add(x=out, y=prev_out) \
                if prev_out is not None else out
        elif cmd == "n":
            out = layers.layer_norm(out, begin_norm_axis=len(out.shape) - 1)
        elif cmd == "d":
            if dropout_rate and not is_test:
                out = layers.dropout(out, dropout_prob=dropout_rate,
                                     is_test=is_test)
    return out
