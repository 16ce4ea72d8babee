"""Semantic role labelling — book chapter 07 (counterpart of
paddle_tpu/models/label_semantic_roles.py; reference:
python/paddle/fluid/tests/book/test_label_semantic_roles.py): the db-lstm
model — eight feature embeddings, stacked LSTMs of alternating
direction, and a linear-chain CRF over the padded sequences, whose
lengths ride ``word_data@LEN``."""

from __future__ import annotations

from .. import layers
from ..param_attr import ParamAttr

WORD_DICT_LEN = 44068
LABEL_DICT_LEN = 59
PRED_DICT_LEN = 3162
MARK_DICT_LEN = 2


def db_lstm(word_dim=32, mark_dim=5, hidden_dim=512, depth=4,
            max_len=128, word_dict_len=WORD_DICT_LEN,
            label_dict_len=LABEL_DICT_LEN, pred_dict_len=PRED_DICT_LEN):
    """Build the SRL training graph; returns (feeds, avg_cost, crf_nll)."""
    # one length companion (word_data@LEN) for all eight slots: the
    # reference feeds them with identical LoD
    names = ["word_data", "ctx_n2_data", "ctx_n1_data", "ctx_0_data",
             "ctx_p1_data", "ctx_p2_data"]
    feeds, embs = [], []
    for i, n in enumerate(names):
        v = layers.data(name=n, shape=[-1, max_len], dtype="int64",
                        append_batch_size=False,
                        lod_level=1 if i == 0 else 0)
        feeds.append(v)
        # one table for the six word/context slots (the reference's
        # embedding_name='emb')
        embs.append(layers.embedding(v, size=[word_dict_len, word_dim],
                                     param_attr=ParamAttr(name="emb")))
    length = layers.length_var_of(feeds[0])
    predicate = layers.data(name="verb_data", shape=[-1, max_len],
                            dtype="int64", append_batch_size=False)
    mark = layers.data(name="mark_data", shape=[-1, max_len],
                       dtype="int64", append_batch_size=False)
    feeds += [predicate, mark]
    embs.append(layers.embedding(predicate, size=[pred_dict_len, word_dim]))
    embs.append(layers.embedding(mark, size=[MARK_DICT_LEN, mark_dim]))

    emb = layers.concat(embs, axis=-1)
    hidden = layers.fc(input=emb, size=hidden_dim, num_flatten_dims=2,
                       act="tanh")
    lstm, _ = layers.dynamic_lstm(hidden, size=hidden_dim, length=length)
    for i in range(1, depth):
        mixed = layers.fc(input=layers.concat([hidden, lstm], axis=-1),
                          size=hidden_dim, num_flatten_dims=2, act="tanh")
        lstm, _ = layers.dynamic_lstm(mixed, size=hidden_dim,
                                      is_reverse=(i % 2 == 1),
                                      length=length)
        hidden = mixed
    feature_out = layers.fc(input=layers.concat([hidden, lstm], axis=-1),
                            size=label_dict_len, num_flatten_dims=2)
    target = layers.data(name="target", shape=[-1, max_len], dtype="int64",
                         append_batch_size=False)
    feeds.append(target)
    crf_cost = layers.linear_chain_crf(feature_out, target, length=length)
    avg_cost = layers.mean(crf_cost)
    return feeds, avg_cost, crf_cost
