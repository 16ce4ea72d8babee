"""Transformer-base for NMT and its building blocks (counterpart of
paddle_tpu/models/transformer.py): the encoder-decoder that
``transformer_base`` trains, and the blocks the causal LM reuses.

Attention is one op (scale -> logits -> mask -> softmax -> context).
``attn_impl="fused"`` runs it as plain torch ops (the JAX package's
einsum path); ``"pallas"`` runs the hand-written flash-attention
kernels (``ops/flash_attention.py``), forward and backward. ``None``
resolves to ``"fused"``: the JAX package's crossover to its kernel at
2048 keys was measured on a TPU, and the card's own rule waits for its
measurements (PERF.md). Training dropout draws its masks with the
dropout kernel (``ops/dropout.py``); ``transformer_base(fused_ce=True)``
ends in the chunked projection + CE op (``ops/fused_ce.py``).

``tp=True`` annotates the weights as the JAX package does (``_tp``):
QKV and FFN-in column-parallel, the attention output and FFN-out
row-parallel over the ``mp`` axis. In a sharded run over a mesh with a
tensor-parallel axis (``mp``, else ``tp``) each rank computes its block
of the heads and of the FFN's hidden columns (``layers.fc``'s
tensor-parallel path); the attention op takes its heads from its
inputs' width, so the flash kernels run at the local heads. The
sequence-parallel ``"ring"`` path, the pipelined encoder and
distributed embeddings are not ported yet (ROADMAP Queue A 9).
"""

from __future__ import annotations

import math

import torch

from .. import layers
from ..core import flags
from ..core.dtype_utils import rounded_sqrt
from ..core.enforce import not_ported
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

_MULTI_GPU = "Queue A 9, multi-GPU"


def _tp(axes, enable):
    """ParamAttr with a tensor-parallel sharding spec when enabled."""
    return ParamAttr(sharding=axes) if enable else None


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
    JAX package's fused math in the same order — logits divided by
    ``sqrt(D)`` rounded to q's dtype, ``-1e9`` masking, softmax in f32
    (f64 for f64 operands), cast back."""
    Tq, Tk = qh.shape[1], kh.shape[1]
    logits = (torch.einsum("bqhd,bkhd->bhqk", qh, kh)
              / rounded_sqrt(qh.shape[-1], qh.dtype))
    neg = torch.full((), -1e9, dtype=logits.dtype, device=logits.device)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :] > 0, logits, neg)
    if causal:
        cm = torch.ones((Tq, Tk), dtype=torch.bool,
                        device=logits.device).tril()
        logits = torch.where(cm[None, None, :, :], logits, neg)
    w = torch.softmax(logits.to(torch.promote_types(logits.dtype,
                                                    torch.float32)),
                      dim=-1).to(vh.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, vh)


def multi_head_attention(queries, keys, values, d_key, d_value, d_model,
                         n_head=1, dropout_rate=0.0, is_test=False,
                         causal=False, kv_mask=None, tp=False, cache=None,
                         attn_impl=None):
    """Multi-head attention as one op. ``kv_mask`` is a ``[B, T_k]`` 0/1
    float var masking padded keys; ``causal`` adds the autoregressive
    mask. ``attn_impl``: ``"fused"`` (plain torch ops), ``"pallas"``
    (the flash-attention kernels) or ``None`` (``"fused"``). ``tp``:
    column-parallel QKV, row-parallel output projection (the op then
    runs on this rank's heads)."""
    if attn_impl == "ring":
        raise not_ported("multi_head_attention(attn_impl='ring')",
                         _MULTI_GPU)
    if attn_impl not in (None, "fused", "pallas"):
        raise ValueError("multi_head_attention: unknown attn_impl %r"
                         % (attn_impl,))
    helper = LayerHelper("multi_head_attention")

    q = layers.fc(input=queries, size=d_key * n_head, num_flatten_dims=2,
                  bias_attr=False, param_attr=_tp((None, "mp"), tp))
    k = layers.fc(input=keys, size=d_key * n_head, num_flatten_dims=2,
                  bias_attr=False, param_attr=_tp((None, "mp"), tp))
    v = layers.fc(input=values, size=d_value * n_head, num_flatten_dims=2,
                  bias_attr=False, param_attr=_tp((None, "mp"), tp))

    out = helper.create_tmp_variable(queries.dtype)
    in_names = {"Q": [q.name], "K": [k.name], "V": [v.name]}
    if kv_mask is not None:
        in_names["Mask"] = [kv_mask.name]

    def fn(qv, kv, vv, mask=None):
        B, Tq, _ = qv.shape
        Tk = kv.shape[1]
        # n_head, or this rank's block of the heads under tensor
        # parallelism
        heads = qv.shape[-1] // d_key
        qh = torch.reshape(qv, (B, Tq, heads, d_key))
        kh = torch.reshape(kv, (B, Tk, heads, d_key))
        vh = torch.reshape(vv, (B, Tk, heads, d_value))
        if attn_impl == "pallas":
            from ..ops.flash_attention import flash_attention

            ctx = flash_attention(qh, kh, vh, causal=causal, kv_mask=mask)
        else:
            ctx = attention(qh, kh, vh, mask=mask, causal=causal)
        return torch.reshape(ctx, (B, Tq, heads * d_value))

    helper.append_op(type="fused_attention", inputs=in_names,
                     outputs={"Out": [out.name]},
                     attrs={"n_head": n_head, "causal": causal}, fn=fn)
    proj = layers.fc(input=out, size=d_model, num_flatten_dims=2,
                     bias_attr=False, param_attr=_tp(("mp", None), tp))
    if dropout_rate and not is_test:
        proj = layers.dropout(proj, dropout_prob=dropout_rate,
                              is_test=is_test)
    return proj


def positionwise_feed_forward(x, d_inner_hid, d_hid, dropout_rate=0.0,
                              is_test=False, tp=False):
    hidden = layers.fc(input=x, size=d_inner_hid, num_flatten_dims=2,
                       act="relu", param_attr=_tp((None, "mp"), tp))
    if dropout_rate and not is_test:
        hidden = layers.dropout(hidden, dropout_prob=dropout_rate,
                                is_test=is_test)
        if tp:
            # a rank holds a block of the hidden columns: it draws that
            # block of the whole width's mask
            op = hidden.block.ops[-1]
            op.attrs["tp_width"] = d_inner_hid
            op.attrs["_fn_attrs"] = list(op.attrs["_fn_attrs"]) + \
                ["tp_width"]
    return layers.fc(input=hidden, size=d_hid, num_flatten_dims=2,
                     param_attr=_tp(("mp", None), tp))


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


def encoder_layer(enc_input, src_mask, n_head, d_key, d_value, d_model,
                  d_inner_hid, dropout_rate=0.0, is_test=False, tp=False,
                  attn_impl=None):
    attn = multi_head_attention(enc_input, enc_input, enc_input, d_key,
                                d_value, d_model, n_head, dropout_rate,
                                is_test=is_test, kv_mask=src_mask, tp=tp,
                                attn_impl=attn_impl)
    attn_out = pre_post_process_layer(enc_input, attn, "dan", dropout_rate,
                                      is_test)
    ffd = positionwise_feed_forward(attn_out, d_inner_hid, d_model,
                                    dropout_rate, is_test=is_test, tp=tp)
    return pre_post_process_layer(attn_out, ffd, "dan", dropout_rate,
                                  is_test)


def decoder_layer(dec_input, enc_output, src_mask, n_head, d_key, d_value,
                  d_model, d_inner_hid, dropout_rate=0.0, is_test=False,
                  tp=False, attn_impl=None):
    slf = multi_head_attention(dec_input, dec_input, dec_input, d_key,
                               d_value, d_model, n_head, dropout_rate,
                               is_test=is_test, causal=True, tp=tp,
                               attn_impl=attn_impl)
    slf_out = pre_post_process_layer(dec_input, slf, "dan", dropout_rate,
                                     is_test)
    ctx = multi_head_attention(slf_out, enc_output, enc_output, d_key,
                               d_value, d_model, n_head, dropout_rate,
                               is_test=is_test, kv_mask=src_mask, tp=tp,
                               attn_impl=attn_impl)
    ctx_out = pre_post_process_layer(slf_out, ctx, "dan", dropout_rate,
                                     is_test)
    ffd = positionwise_feed_forward(ctx_out, d_inner_hid, d_model,
                                    dropout_rate, is_test=is_test, tp=tp)
    return pre_post_process_layer(ctx_out, ffd, "dan", dropout_rate,
                                  is_test)


def _embed(ids, vocab_size, d_model, name, is_sparse=False):
    emb = layers.embedding(input=ids, size=[vocab_size, d_model],
                           is_sparse=is_sparse,
                           param_attr=ParamAttr(name=name))
    emb = layers.scale(x=emb, scale=d_model ** 0.5)
    if flags.bf16_stream():
        # enter the bf16 activation stream at the embedding output; the
        # table and every parameter stay f32
        emb = layers.cast(emb, "bfloat16")
    return emb


def transformer_model(src_word, trg_word, src_mask, src_vocab_size,
                      trg_vocab_size, max_length=256, n_layer=6, n_head=8,
                      d_key=64, d_value=64, d_model=512, d_inner_hid=2048,
                      dropout_rate=0.1, is_test=False, tp=False,
                      weight_sharing=False, attn_impl=None,
                      pp_encoder=False, pp_microbatches=2,
                      sparse_embedding=False, distributed_embedding=False,
                      return_hidden=False):
    """Encoder-decoder -> next-token logits ``[B, T_trg, V_trg]``, or
    the decoder's last hidden states with ``return_hidden`` (for a head
    of the caller's, such as the fused projection + CE op).
    ``sparse_embedding`` gives both word tables row-sparse gradients;
    ``dropout_rate`` drops at the JAX package's sites in training;
    ``tp`` makes the attention and FFN blocks tensor-parallel. The
    pipelined encoder and distributed embeddings are not ported yet and
    raise."""
    if pp_encoder:
        raise not_ported("transformer_model(pp_encoder=True)", _MULTI_GPU)
    if distributed_embedding:
        raise not_ported("transformer_model(distributed_embedding=True)",
                         _MULTI_GPU)
    src_emb = _embed(src_word, src_vocab_size, d_model,
                     "src_word_emb_table", is_sparse=sparse_embedding)
    src_emb = positional_encoding(src_emb, max_length)
    enc_input = pre_post_process_layer(None, src_emb, "nd", dropout_rate,
                                       is_test)
    for _ in range(n_layer):
        enc_input = encoder_layer(enc_input, src_mask, n_head, d_key,
                                  d_value, d_model, d_inner_hid,
                                  dropout_rate, is_test, tp=tp,
                                  attn_impl=attn_impl)
    enc_output = enc_input

    trg_table = ("src_word_emb_table" if weight_sharing
                 else "trg_word_emb_table")
    trg_emb = _embed(trg_word, trg_vocab_size, d_model, trg_table,
                     is_sparse=sparse_embedding)
    trg_emb = positional_encoding(trg_emb, max_length)
    dec_input = pre_post_process_layer(None, trg_emb, "nd", dropout_rate,
                                       is_test)
    for _ in range(n_layer):
        dec_input = decoder_layer(dec_input, enc_output, src_mask, n_head,
                                  d_key, d_value, d_model, d_inner_hid,
                                  dropout_rate, is_test, tp=tp,
                                  attn_impl=attn_impl)
    if return_hidden:
        return dec_input
    predict = layers.fc(input=dec_input, size=trg_vocab_size,
                        num_flatten_dims=2, act=None,
                        param_attr=_tp((None, "mp"), tp))
    if tp:
        _gather_tp_output(predict)
    return predict


def _gather_tp_output(out):
    """Make the column-parallel fc producing ``out`` gather its columns
    (the loss reads whole logits): its product all-gathers over the
    tensor axis, and its bias is added to the whole output."""
    mul = next(op for op in reversed(out.block.ops) if op.attrs.get("_tp"))
    mul.attrs["tp_gather"] = True
    mul.attrs["_fn_attrs"] = list(mul.attrs.get("_fn_attrs", ())) + \
        ["tp_gather"]


def transformer_base(src_vocab_size=10000, trg_vocab_size=10000,
                     max_length=256, n_layer=6, n_head=8, d_model=512,
                     d_inner_hid=2048, dropout_rate=0.1,
                     label_smooth_eps=0.1, is_test=False, tp=False,
                     attn_impl=None, pp_encoder=False, pp_microbatches=2,
                     sparse_embedding=False, distributed_embedding=False,
                     fused_ce=False):
    """Build the full training graph: data vars, model, smoothed CE loss
    averaged over the real target tokens (``trg_mask``).

    ``fused_ce=True`` replaces the vocab fc + softmax_with_cross_entropy
    pair with the chunked op (``layers.fused_linear_softmax_ce``) that
    never forms the ``[B, T, V]`` logits; ``predict`` is then its raw
    logits head, computed only when fetched.

    Returns (feed_vars, avg_cost, predict)."""
    src_word = layers.data(name="src_word", shape=[-1, -1], dtype="int64",
                           append_batch_size=False)
    trg_word = layers.data(name="trg_word", shape=[-1, -1], dtype="int64",
                           append_batch_size=False)
    lbl_word = layers.data(name="lbl_word", shape=[-1, -1], dtype="int64",
                           append_batch_size=False)
    src_mask = layers.data(name="src_mask", shape=[-1, -1],
                           dtype="float32", append_batch_size=False)
    trg_mask = layers.data(name="trg_mask", shape=[-1, -1],
                           dtype="float32", append_batch_size=False)

    out = transformer_model(
        src_word, trg_word, src_mask, src_vocab_size, trg_vocab_size,
        max_length, n_layer, n_head, d_model // n_head, d_model // n_head,
        d_model, d_inner_hid, dropout_rate, is_test=is_test, tp=tp,
        attn_impl=attn_impl, pp_encoder=pp_encoder,
        pp_microbatches=pp_microbatches, sparse_embedding=sparse_embedding,
        distributed_embedding=distributed_embedding, return_hidden=fused_ce)
    if fused_ce:
        cost, predict = layers.fused_linear_softmax_ce(
            out, lbl_word, size=trg_vocab_size,
            smooth_eps=label_smooth_eps)
    else:
        predict = out
        cost = layers.softmax_with_cross_entropy(
            logits=predict, label=lbl_word, soft_label=False,
            smooth_eps=label_smooth_eps)
    cost = layers.squeeze(cost, axes=[-1])
    # mask padded target positions, average over real tokens
    masked = layers.elementwise_mul(x=cost, y=trg_mask)
    sum_cost = layers.reduce_sum(masked)
    token_count = layers.reduce_sum(trg_mask)
    avg_cost = layers.elementwise_div(x=sum_cost, y=token_count)

    feeds = [src_word, trg_word, lbl_word, src_mask, trg_mask]
    return feeds, avg_cost, predict
