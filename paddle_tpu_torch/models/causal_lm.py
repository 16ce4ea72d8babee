"""Decoder-only causal language model — the serving-side autoregressive
workload (counterpart of paddle_tpu/models/causal_lm.py, whole).

Reuses the Transformer-base building blocks (models/transformer.py):
embedding + sinusoid positions, post-LN "dan" processing, fused causal
self-attention, position-wise FFN, untied LM head. The forward program
this builds is exactly what ``decoding.derive_decode_programs`` rewrites
into the prefill/decode program pair: every ``fused_attention`` op is
causal self-attention (no cross-attention, no kv_mask), so the paged-KV
rewrite applies cleanly.
"""

from __future__ import annotations

from .. import layers
from ..param_attr import ParamAttr
from .transformer import (multi_head_attention, pre_post_process_layer,
                          positional_encoding, positionwise_feed_forward)


def causal_lm_block(x, n_head, d_key, d_value, d_model, d_inner_hid,
                    dropout_rate=0.0, is_test=True, attn_impl=None):
    """One decoder block: causal self-attention + FFN, post-LN "dan"
    processing (same layer math as models/transformer.py decoder_layer
    minus the encoder-side cross attention)."""
    slf = multi_head_attention(x, x, x, d_key, d_value, d_model, n_head,
                               dropout_rate, is_test=is_test, causal=True,
                               attn_impl=attn_impl)
    slf_out = pre_post_process_layer(x, slf, "dan", dropout_rate, is_test)
    ffd = positionwise_feed_forward(slf_out, d_inner_hid, d_model,
                                    dropout_rate, is_test=is_test)
    return pre_post_process_layer(slf_out, ffd, "dan", dropout_rate,
                                  is_test)


def causal_lm(vocab_size: int, n_layer: int = 2, n_head: int = 2,
              d_model: int = 64, d_inner_hid: int = 128,
              max_length: int = 2048, dropout_rate: float = 0.0,
              is_test: bool = True, attn_impl=None,
              token_name: str = "tokens"):
    """Build the forward graph: token ids ``[B, T]`` -> next-token
    logits ``[B, T, V]``. Returns ``(tokens_var, logits_var)``.

    ``is_test=True`` (the serving default) builds the inference forward
    the decoding rewrite consumes; build with ``is_test=False`` plus a
    loss head for training the same weights."""
    tokens = layers.data(name=token_name, shape=[-1, -1], dtype="int64",
                         append_batch_size=False)
    emb = layers.embedding(
        input=tokens, size=[vocab_size, d_model],
        param_attr=ParamAttr(name="lm_word_emb_table"))
    emb = layers.scale(x=emb, scale=d_model ** 0.5)
    x = positional_encoding(emb, max_length)
    x = pre_post_process_layer(None, x, "nd", dropout_rate, is_test)
    d_head = d_model // n_head
    for _ in range(n_layer):
        x = causal_lm_block(x, n_head, d_head, d_head, d_model,
                            d_inner_hid, dropout_rate, is_test=is_test,
                            attn_impl=attn_impl)
    logits = layers.fc(input=x, size=vocab_size, num_flatten_dims=2,
                       act=None)
    return tokens, logits
