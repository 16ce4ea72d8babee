"""MNIST models (counterpart of paddle_tpu/models/mnist.py): the
LeNet-style CNN of the benchmark suite and the MLP of the book's
recognize_digits chapter."""

from __future__ import annotations

from .. import layers


def mnist_cnn(images, class_dim=10):
    conv1 = layers.conv2d(input=images, num_filters=20, filter_size=5,
                          act="relu")
    pool1 = layers.pool2d(input=conv1, pool_size=2, pool_stride=2,
                          pool_type="max")
    conv2 = layers.conv2d(input=pool1, num_filters=50, filter_size=5,
                          act="relu")
    pool2 = layers.pool2d(input=conv2, pool_size=2, pool_stride=2,
                          pool_type="max")
    return layers.fc(input=pool2, size=class_dim, act="softmax")


def mnist_mlp(images, class_dim=10):
    h1 = layers.fc(input=images, size=200, act="tanh")
    h2 = layers.fc(input=h1, size=200, act="tanh")
    return layers.fc(input=h2, size=class_dim, act="softmax")


def build_train(model="cnn"):
    """(images, label, avg_cost, accuracy, predict) of ``"cnn"`` or
    ``"mlp"``."""
    image_shape = [1, 28, 28] if model == "cnn" else [784]
    images = layers.data(name="pixel", shape=image_shape, dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    predict = (mnist_cnn if model == "cnn" else mnist_mlp)(images)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=predict, label=label)
    return images, label, avg_cost, acc, predict
