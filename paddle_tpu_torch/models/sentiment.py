"""Sentiment classification on IMDB — book chapter 06 (counterpart of
paddle_tpu/models/sentiment.py; reference:
python/paddle/fluid/tests/book/test_understand_sentiment.py and
benchmark/fluid/models/stacked_dynamic_lstm.py): the text CNN and the
stacked LSTM, alternate layers reversed."""

from __future__ import annotations

from .. import layers, nets


def convolution_net(data, dict_dim, class_dim=2, emb_dim=32, hid_dim=32):
    emb = layers.embedding(input=data, size=[dict_dim, emb_dim])
    conv_3 = nets.sequence_conv_pool(input=emb, num_filters=hid_dim,
                                     filter_size=3, act="tanh",
                                     pool_type="sqrt")
    conv_4 = nets.sequence_conv_pool(input=emb, num_filters=hid_dim,
                                     filter_size=4, act="tanh",
                                     pool_type="sqrt")
    return layers.fc(input=[conv_3, conv_4], size=class_dim, act="softmax")


def stacked_lstm_net(data, dict_dim, class_dim=2, emb_dim=128, hid_dim=512,
                     stacked_num=3):
    assert stacked_num % 2 == 1
    emb = layers.embedding(input=data, size=[dict_dim, emb_dim])
    fc1 = layers.fc(input=emb, size=hid_dim, num_flatten_dims=2)
    lstm1, _ = layers.dynamic_lstm(input=fc1, size=hid_dim)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = layers.fc(input=inputs, size=hid_dim, num_flatten_dims=2)
        lstm, _ = layers.dynamic_lstm(input=fc, size=hid_dim,
                                      is_reverse=(i % 2) == 0)
        inputs = [fc, lstm]
    fc_last = layers.sequence_pool(input=inputs[0], pool_type="max")
    lstm_last = layers.sequence_pool(input=inputs[1], pool_type="max")
    return layers.fc(input=[fc_last, lstm_last], size=class_dim,
                     act="softmax")


def build_train(dict_dim, model="stacked_lstm", class_dim=2, **kw):
    """(data, label, avg_cost, acc, predict); ``words`` is a sequence
    slot (``words@LEN``), ``label`` [B, 1] int64."""
    data = layers.data(name="words", shape=[-1, -1, 1], dtype="int64",
                       lod_level=1, append_batch_size=False)
    label = layers.data(name="label", shape=[1], dtype="int64")
    if model == "conv":
        predict = convolution_net(data, dict_dim, class_dim, **kw)
    else:
        predict = stacked_lstm_net(data, dict_dim, class_dim, **kw)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=predict, label=label)
    return data, label, avg_cost, acc, predict
