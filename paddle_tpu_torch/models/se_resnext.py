"""SE-ResNeXt-50 (counterpart of paddle_tpu/models/se_resnext.py):
grouped bottlenecks (32 groups) with squeeze-and-excitation, built with
the JAX package's calls in its order."""

from __future__ import annotations

from .. import layers


def _conv_bn(input, num_filters, filter_size, stride=1, groups=1, act=None,
             is_test=False):
    conv = layers.conv2d(input=input, num_filters=num_filters,
                         filter_size=filter_size, stride=stride,
                         padding=(filter_size - 1) // 2, groups=groups,
                         act=None, bias_attr=False)
    return layers.batch_norm(input=conv, act=act, is_test=is_test)


def _squeeze_excitation(input, num_channels, reduction_ratio=16):
    pool = layers.pool2d(input=input, pool_type="avg", global_pooling=True)
    squeeze = layers.fc(input=pool, size=num_channels // reduction_ratio,
                        act="relu")
    excitation = layers.fc(input=squeeze, size=num_channels, act="sigmoid")
    # one scale per channel, broadcast over H and W
    exc4 = layers.reshape(excitation, shape=[-1, num_channels, 1, 1])
    return layers.elementwise_mul(x=input, y=exc4)


def _shortcut(input, ch_out, stride, is_test=False):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return _conv_bn(input, ch_out, 1, stride, is_test=is_test)
    return input


def _bottleneck_block(input, num_filters, stride, cardinality=32,
                      reduction_ratio=16, is_test=False):
    conv0 = _conv_bn(input, num_filters, 1, act="relu", is_test=is_test)
    conv1 = _conv_bn(conv0, num_filters, 3, stride=stride,
                     groups=cardinality, act="relu", is_test=is_test)
    conv2 = _conv_bn(conv1, num_filters * 2, 1, act=None, is_test=is_test)
    scale = _squeeze_excitation(conv2, num_filters * 2, reduction_ratio)
    short = _shortcut(input, num_filters * 2, stride, is_test=is_test)
    return layers.elementwise_add(x=short, y=scale, act="relu")


def se_resnext50(input, class_dim=1000, is_test=False, s2d_stem=False):
    cardinality, reduction_ratio = 32, 16
    depth = [3, 4, 6, 3]
    num_filters = [128, 256, 512, 1024]
    if s2d_stem:
        # ResNet's stem shape (64 filters, 7x7/s2/pad3): the same helper
        from .resnet import s2d_stem

        conv = s2d_stem(input, is_test=is_test)
    else:
        conv = _conv_bn(input, 64, 7, stride=2, act="relu",
                        is_test=is_test)
    conv = layers.pool2d(input=conv, pool_size=3, pool_stride=2,
                         pool_padding=1, pool_type="max")
    for block in range(len(depth)):
        for i in range(depth[block]):
            conv = _bottleneck_block(
                conv, num_filters[block], 2 if i == 0 and block != 0 else 1,
                cardinality, reduction_ratio, is_test=is_test)
    pool = layers.pool2d(input=conv, pool_type="avg", global_pooling=True)
    drop = layers.dropout(x=pool, dropout_prob=0.2, is_test=is_test)
    return layers.fc(input=drop, size=class_dim, act="softmax")
