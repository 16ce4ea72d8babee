"""Seq2seq attention NMT — book chapter 08 (counterpart of
paddle_tpu/models/machine_translation.py; reference:
python/paddle/fluid/tests/book/test_machine_translation.py and
test_rnn_encoder_decoder.py): an LSTM encoder and a GRU decoder with
additive (Bahdanau) attention, teacher-forced for training.

The decoder's time loop is one composite op (``attention_decoder``)
walking the target axis (``core.scan``), and the loss one more
(``masked_seq_ce``): the mean over real target tokens of
``-log(clip(p, 1e-8, 1))`` of the decoder's softmax, as the JAX
package computes it (not a log-softmax), with the attention scores of
padded source steps set to -1e9.
"""

from __future__ import annotations

import torch

from .. import layers
from ..core.scan import scan
from ..layer_helper import LayerHelper


def encoder(src_word, dict_size, word_dim=256, hidden_dim=512):
    emb = layers.embedding(input=src_word, size=[dict_size, word_dim])
    proj = layers.fc(input=emb, size=hidden_dim * 4, num_flatten_dims=2)
    enc_out, _ = layers.dynamic_lstm(input=proj, size=hidden_dim * 4)
    return enc_out


def attend_and_step(enc, enc_proj, mask, h, x_t, w_ad, va, wgx, wgh, bg, wo,
                    bo):
    """One decoder step: attention over the encoder states, the GRU
    update of ``h`` from ``[x_t, context]``, the softmax over the target
    vocabulary. Returns (h_new, probs)."""
    H = h.shape[-1]
    score = torch.tanh(enc_proj + (h @ w_ad)[:, None, :]) @ va
    score = torch.where(mask > 0, score, torch.full(
        (), -1e9, dtype=score.dtype, device=score.device))
    alpha = torch.softmax(score, dim=-1)
    ctx = torch.einsum("bt,bth->bh", alpha, enc)
    g = torch.cat([x_t, ctx], dim=-1) @ wgx + bg
    gh = h @ wgh
    u = torch.sigmoid(g[:, :H] + gh[:, :H])
    r = torch.sigmoid(g[:, H:2 * H] + gh[:, H:2 * H])
    c = torch.tanh(g[:, 2 * H:] + r * gh[:, 2 * H:])
    h_new = u * h + (1.0 - u) * c
    return h_new, torch.softmax(h_new @ wo + bo, dim=-1)


def attention_decoder_train(enc_out, trg_word, dict_size, word_dim=256,
                            hidden_dim=512):
    """The teacher-forced attention decoder as one op; returns the
    per-step vocabulary probabilities [B, T_trg, V]."""
    helper = LayerHelper("attn_decoder")
    trg_emb = layers.embedding(input=trg_word, size=[dict_size, word_dim])
    dtype = "float32"
    W_att_enc = helper.create_parameter(None, [hidden_dim, hidden_dim], dtype)
    W_att_dec = helper.create_parameter(None, [hidden_dim, hidden_dim], dtype)
    v_att = helper.create_parameter(None, [hidden_dim], dtype)
    W_gru_x = helper.create_parameter(
        None, [word_dim + hidden_dim, 3 * hidden_dim], dtype)
    W_gru_h = helper.create_parameter(None, [hidden_dim, 3 * hidden_dim],
                                      dtype)
    b_gru = helper.create_parameter(None, [3 * hidden_dim], dtype,
                                    is_bias=True)
    W_out = helper.create_parameter(None, [hidden_dim, dict_size], dtype)
    b_out = helper.create_parameter(None, [dict_size], dtype, is_bias=True)
    enc_len = layers.length_var_of(enc_out)
    out = helper.create_tmp_variable(dtype)

    def fn(enc, emb, elen, w_ae, w_ad, va, wgx, wgh, bg, wo, bo):
        B, Ts, H = enc.shape
        mask = (torch.arange(Ts, device=enc.device)[None, :]
                < elen.to(torch.int64).reshape(-1)[:, None]).to(enc.dtype)
        enc_proj = torch.einsum("bth,hk->btk", enc, w_ae)

        def step(h, x_t):
            h_new, prob = attend_and_step(enc, enc_proj, mask, h, x_t, w_ad,
                                          va, wgx, wgh, bg, wo, bo)
            return h_new, (prob,)

        h0 = torch.zeros((B, H), dtype=enc.dtype, device=enc.device)
        _, (probs,) = scan(step, h0, (emb.transpose(0, 1),))
        return probs.transpose(0, 1)

    helper.append_op(
        type="attention_decoder",
        inputs={"Enc": [enc_out.name], "Emb": [trg_emb.name],
                "Len": [enc_len.name], "Wae": [W_att_enc.name],
                "Wad": [W_att_dec.name], "Va": [v_att.name],
                "Wgx": [W_gru_x.name], "Wgh": [W_gru_h.name],
                "Bg": [b_gru.name], "Wo": [W_out.name], "Bo": [b_out.name]},
        outputs={"Out": [out.name]}, fn=fn)
    return out


def masked_seq_ce(p, y, lens):
    """The mean over valid target steps of ``-log(clip(p, 1e-8, 1))`` at
    the label: probabilities [B, T, V], labels [B, T(, 1)], lengths [B]."""
    idx = y.to(torch.int64)
    if idx.shape[-1] == 1:
        idx = idx.squeeze(-1)
    logp = torch.log(torch.clamp(p, 1e-8, 1.0))
    nll = -torch.take_along_dim(logp, idx[..., None], dim=-1)[..., 0]
    mask = (torch.arange(p.shape[1], device=p.device)[None, :]
            < lens.to(torch.int64).reshape(-1)[:, None]).to(p.dtype)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def build_train(src_dict_size=30000, trg_dict_size=30000, word_dim=256,
                hidden_dim=512):
    """([src, trg, lbl], avg_cost, probs): three sequence slots
    (``src_word_id``, ``target_language_word``,
    ``target_language_next_word``, each with its ``@LEN``)."""
    src = layers.data(name="src_word_id", shape=[-1, -1, 1], dtype="int64",
                      lod_level=1, append_batch_size=False)
    trg = layers.data(name="target_language_word", shape=[-1, -1, 1],
                      dtype="int64", lod_level=1, append_batch_size=False)
    lbl = layers.data(name="target_language_next_word", shape=[-1, -1, 1],
                      dtype="int64", lod_level=1, append_batch_size=False)
    enc_out = encoder(src, src_dict_size, word_dim, hidden_dim)
    probs = attention_decoder_train(enc_out, trg, trg_dict_size, word_dim,
                                    hidden_dim)
    helper = LayerHelper("masked_seq_ce")
    trg_len = layers.length_var_of(trg)
    avg_cost = helper.create_tmp_variable("float32")
    helper.append_op(
        type="masked_seq_ce",
        inputs={"P": [probs.name], "Y": [lbl.name], "Len": [trg_len.name]},
        outputs={"Out": [avg_cost.name]}, fn=masked_seq_ce)
    return [src, trg, lbl], avg_cost, probs
