"""Linear regression — book chapter 01 (counterpart of
paddle_tpu/models/fit_a_line.py).

Reference: python/paddle/fluid/tests/book/test_fit_a_line.py.
"""

from __future__ import annotations

from .. import layers


def build_train():
    x = layers.data(name="x", shape=[13], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    y_predict = layers.fc(input=x, size=1, act=None)
    cost = layers.square_error_cost(input=y_predict, label=y)
    avg_cost = layers.mean(cost)
    return x, y, avg_cost, y_predict
