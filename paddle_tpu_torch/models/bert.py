"""BERT-base pretraining (counterpart of paddle_tpu/models/bert.py):
the encoder stack of ``models/transformer.py`` under word, position and
sentence embeddings, and the masked-LM and next-sentence heads.

The masked-LM head gathers only the masked positions (a static
``max_predictions`` count, padded slots pointing at position 0 with
weight 0), so the tied vocab projection runs on ``[B, P, H]``, not
``[B, T, H]``. Two ops are the model's own:

* ``gather_masked`` — ``[B, T, H]`` rows at ``[B, P]`` positions. Its
  backward sums the cotangent of repeated positions (every padded slot
  repeats position 0) with ``index_put_(accumulate=True)``
  (``layers.nn.lookup``), whose CUDA path adds them in a fixed (sorted)
  order, so a step is bit-equal run to run; ``scatter_add_``'s float
  atomics are not.
* ``mlm_tied_projection`` — ``h @ word_embedding^T + b``, the table the
  lookup reads too, so its gradient sums both users. Both operands are
  cast to their promoted type first (``jnp.einsum`` promotes a bf16
  ``h`` against the f32 table to f32; ``torch.einsum`` refuses mixed
  dtypes).
"""

from __future__ import annotations

import torch

from .. import layers
from ..layer_helper import LayerHelper
from ..layers.nn import lookup
from ..param_attr import ParamAttr
from .transformer import encoder_layer


def gather_masked(e, pos):
    """``e[b, pos[b, p], :]``: ``[B, T, H]`` by ``[B, P]`` -> ``[B, P,
    H]``, a lookup in ``e``'s rows (``layers.nn.lookup``, whose backward
    sums repeated positions in a fixed order)."""
    b, t, h = e.shape
    rows = pos.to(torch.int64) + t * torch.arange(b, device=pos.device)[
        :, None]
    return lookup(e.reshape(b * t, h), rows)


def tied_projection(h, table, b):
    """``einsum("bph,vh->bpv", h, table) + b`` in the operands' promoted
    dtype."""
    dt = torch.promote_types(h.dtype, table.dtype)
    return torch.einsum("bph,vh->bpv", h.to(dt), table.to(dt)) + b


def _embeddings(src_ids, sent_ids, pos_ids, vocab_size, d_model,
                max_pos, type_vocab=2):
    word = layers.embedding(src_ids, size=[vocab_size, d_model],
                            param_attr=ParamAttr(name="word_embedding"))
    pos = layers.embedding(pos_ids, size=[max_pos, d_model],
                           param_attr=ParamAttr(name="pos_embedding"))
    sent = layers.embedding(sent_ids, size=[type_vocab, d_model],
                            param_attr=ParamAttr(name="sent_embedding"))
    emb = layers.elementwise_add(layers.elementwise_add(word, pos), sent)
    return layers.layer_norm(emb, begin_norm_axis=len(emb.shape) - 1)


def bert_encoder(src_ids, sent_ids, pos_ids, input_mask,
                 vocab_size=30522, n_layer=12, n_head=12, d_model=768,
                 d_inner=3072, max_pos=512, dropout=0.1, is_test=False,
                 tp=False, attn_impl="fused"):
    """Token-level encoder output [B, T, H]."""
    enc = _embeddings(src_ids, sent_ids, pos_ids, vocab_size, d_model,
                      max_pos)
    if dropout and not is_test:
        enc = layers.dropout(enc, dropout_prob=dropout, is_test=is_test)
    for _ in range(n_layer):
        enc = encoder_layer(enc, input_mask, n_head,
                            d_model // n_head, d_model // n_head, d_model,
                            d_inner, dropout, is_test, tp=tp,
                            attn_impl=attn_impl)
    return enc


def bert_pretrain(vocab_size=30522, n_layer=12, n_head=12, d_model=768,
                  d_inner=3072, max_pos=512, max_predictions=20,
                  dropout=0.1, is_test=False, tp=False,
                  attn_impl="fused"):
    """Masked-LM + next-sentence pretraining graph.

    Feeds: src_ids/sent_ids/pos_ids [B, T] int64, input_mask [B, T] f32,
    mask_pos [B, P] int64 (padded with 0), mask_label [B, P] int64,
    mask_weight [B, P] f32, ns_label [B, 1] int64.
    Returns (feeds, total_loss, (mlm_loss, ns_loss))."""
    mk = lambda n, sh, dt: layers.data(name=n, shape=sh, dtype=dt,  # noqa
                                       append_batch_size=False)
    src_ids = mk("src_ids", [-1, -1], "int64")
    sent_ids = mk("sent_ids", [-1, -1], "int64")
    pos_ids = mk("pos_ids", [-1, -1], "int64")
    input_mask = mk("input_mask", [-1, -1], "float32")
    mask_pos = mk("mask_pos", [-1, max_predictions], "int64")
    mask_label = mk("mask_label", [-1, max_predictions], "int64")
    mask_weight = mk("mask_weight", [-1, max_predictions], "float32")
    ns_label = mk("ns_label", [-1, 1], "int64")

    enc = bert_encoder(src_ids, sent_ids, pos_ids, input_mask, vocab_size,
                       n_layer, n_head, d_model, d_inner, max_pos, dropout,
                       is_test, tp, attn_impl)

    helper = LayerHelper("bert_heads")
    gathered = helper.create_tmp_variable("float32")
    helper.append_op(type="gather_masked",
                     inputs={"X": [enc.name], "Pos": [mask_pos.name]},
                     outputs={"Out": [gathered.name]}, fn=gather_masked)
    gathered.shape = (enc.shape[0], max_predictions, d_model)

    trans = layers.fc(input=gathered, size=d_model, num_flatten_dims=2,
                      act="gelu")
    trans = layers.layer_norm(trans, begin_norm_axis=2)

    # the output projection is tied to the word embedding table
    mlm_logits = helper.create_tmp_variable("float32")
    mlm_bias = helper.create_parameter(
        ParamAttr(name="mlm_out_bias"), [vocab_size], "float32",
        is_bias=True)
    helper.append_op(type="mlm_tied_projection",
                     inputs={"X": [trans.name], "W": ["word_embedding"],
                             "B": [mlm_bias.name]},
                     outputs={"Out": [mlm_logits.name]}, fn=tied_projection)
    mlm_logits.shape = (enc.shape[0], max_predictions, vocab_size)

    mlm_loss_all = layers.softmax_with_cross_entropy(
        logits=mlm_logits, label=mask_label)
    mlm_loss_all = layers.squeeze(mlm_loss_all, axes=[-1])
    weighted = layers.elementwise_mul(mlm_loss_all, mask_weight)
    mlm_loss = layers.elementwise_div(
        layers.reduce_sum(weighted),
        layers.elementwise_add(layers.reduce_sum(mask_weight),
                               layers.fill_constant([], "float32", 1e-6)))

    # next-sentence head over [CLS] (position 0)
    cls = layers.slice(enc, axes=[1], starts=[0], ends=[1])
    cls = layers.squeeze(cls, axes=[1])
    pooled = layers.fc(input=cls, size=d_model, act="tanh")
    ns_logits = layers.fc(input=pooled, size=2)
    ns_loss = layers.mean(layers.softmax_with_cross_entropy(
        logits=ns_logits, label=ns_label))

    total = layers.elementwise_add(mlm_loss, ns_loss)
    feeds = [src_ids, sent_ids, pos_ids, input_mask, mask_pos, mask_label,
             mask_weight, ns_label]
    return feeds, total, (mlm_loss, ns_loss)
