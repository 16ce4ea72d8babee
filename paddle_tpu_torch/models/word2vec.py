"""Word2vec, the N-gram language model of the book's chapter 04
(counterpart of paddle_tpu/models/word2vec.py): four context words
through one shared embedding, concatenated, a hidden fc and a softmax
over the vocabulary."""

from __future__ import annotations

from .. import layers
from ..param_attr import ParamAttr


def build_train(dict_size, embed_size=32, hidden_size=256, is_sparse=False):
    """(words, avg_cost, predict): the five word feeds, the mean
    cross-entropy of the fifth word, the softmax."""
    words = []
    names = ["firstw", "secondw", "thirdw", "forthw", "nextw"]
    for n in names:
        words.append(layers.data(name=n, shape=[1], dtype="int64"))

    embeds = []
    for w in words[:4]:
        embeds.append(layers.embedding(
            input=w, size=[dict_size, embed_size], is_sparse=is_sparse,
            param_attr=ParamAttr(name="shared_w")))

    concat = layers.concat(input=embeds, axis=1)
    hidden1 = layers.fc(input=concat, size=hidden_size, act="sigmoid")
    predict = layers.fc(input=hidden1, size=dict_size, act="softmax")
    cost = layers.cross_entropy(input=predict, label=words[4])
    avg_cost = layers.mean(cost)
    return words, avg_cost, predict
