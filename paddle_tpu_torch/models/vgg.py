"""VGG-16/19 with batch norm (counterpart of paddle_tpu/models/vgg.py):
blocks of 3x3 convs, each followed by batch norm and ReLU, and a 2x2 max
pool; then dropout 0.5, fc 4096, batch norm + ReLU, dropout 0.5, fc 4096
+ ReLU and the softmax classifier. Built with the JAX package's calls in
its order, so both packages give the same parameter names and the same
dropout seeds."""

from __future__ import annotations

from .. import layers


def _conv_block(input, num_filter, groups, use_bn=True, dropouts=None,
                is_test=False):
    tmp = input
    for i in range(groups):
        tmp = layers.conv2d(input=tmp, num_filters=num_filter,
                            filter_size=3, stride=1, padding=1,
                            act=None if use_bn else "relu")
        if use_bn:
            tmp = layers.batch_norm(input=tmp, act="relu", is_test=is_test)
        if dropouts and dropouts[i] > 0 and not is_test:
            tmp = layers.dropout(x=tmp, dropout_prob=dropouts[i],
                                 is_test=is_test)
    return layers.pool2d(input=tmp, pool_size=2, pool_type="max",
                         pool_stride=2)


_VGG_CFG = {16: [2, 2, 3, 3, 3], 19: [2, 2, 4, 4, 4]}


def _vgg(input, class_dim, depth, use_bn, is_test):
    groups = _VGG_CFG[depth]
    filters = [64, 128, 256, 512, 512]
    tmp = input
    for g, f in zip(groups, filters):
        tmp = _conv_block(tmp, f, g, use_bn=use_bn, is_test=is_test)
    drop = layers.dropout(x=tmp, dropout_prob=0.5, is_test=is_test)
    fc1 = layers.fc(input=drop, size=4096, act=None)
    if use_bn:
        fc1 = layers.batch_norm(input=fc1, act="relu", is_test=is_test)
    fc1 = layers.dropout(x=fc1, dropout_prob=0.5, is_test=is_test)
    fc2 = layers.fc(input=fc1, size=4096, act="relu")
    return layers.fc(input=fc2, size=class_dim, act="softmax")


def vgg16(input, class_dim=1000, use_bn=True, is_test=False):
    return _vgg(input, class_dim, 16, use_bn, is_test)


def vgg19(input, class_dim=1000, use_bn=True, is_test=False):
    return _vgg(input, class_dim, 19, use_bn, is_test)
