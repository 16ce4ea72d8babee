"""ResNet for ImageNet (50/101/152, bottleneck blocks) and CIFAR-10
(basic blocks) — counterpart of paddle_tpu/models/resnet.py, with the
same builder calls, so the two packages build the same symbol table.

NCHW at the API; convolutions, pooling and batch norm are the port's
``layers.conv`` ops (cuDNN on the card), in bf16 under the
``use_bfloat16``/``bf16_activations`` flags while parameters and batch
norm's running statistics stay f32.
"""

from __future__ import annotations

import torch.nn.functional as F

from .. import layers
from ..core import flags
from ..core import initializer as init
from ..core.enforce import enforce
from ..layer_helper import LayerHelper
from ..layers.conv import _conv_dtype, _maybe_bf16, _stream_dtype


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu",
                  is_test=False):
    conv = layers.conv2d(input=input, num_filters=ch_out,
                         filter_size=filter_size, stride=stride,
                         padding=padding, act=None, bias_attr=False)
    return layers.batch_norm(input=conv, act=act, is_test=is_test)


def _s2d_weight(w):
    """The canonical ``[O, C, 7, 7]`` stem kernel as the ``[O, 4C, 4,
    4]`` kernel of the space-to-depth conv: padded to 8x8 on the top and
    left, its taps split by spatial parity,
    ``wr[o, c*4 + u*2 + v, a, b] = w8[o, c, 2a + u, 2b + v]``."""
    O, C = w.shape[:2]
    wp = F.pad(w, (1, 0, 1, 0))
    wr = wp.reshape(O, C, 4, 2, 4, 2).permute(0, 1, 3, 5, 2, 4)
    return wr.reshape(O, C * 4, 4, 4)


def _s2d_input(x):
    """``z[b, c*4 + u*2 + v, i, j] = x[b, c, 2i + u, 2j + v]``."""
    B, C, H, W = x.shape
    z = x.reshape(B, C, H // 2, 2, W // 2, 2).permute(0, 1, 3, 5, 2, 4)
    return z.reshape(B, C * 4, H // 2, W // 2)


def _s2d_stem_conv(input):
    """The ImageNet stem conv (64 filters, 7x7, stride 2, pad 3)
    computed exactly as a 4x4, stride-1 conv over a 2x2 space-to-depth
    input (the JAX package's TPU transform, kept so both packages offer
    the same model). Padding the kernel to 8x8 on the top and left
    shifts the input padding from 3 to 4 (a whole 2x2 block); splitting
    input and kernel taps by spatial parity turns the stride-2 conv into
    a stride-1 conv with padding (2, 1) on each spatial axis. The
    parameter keeps the canonical ``[64, C, 7, 7]`` shape, so checkpoints
    interchange with the plain stem and gradients reach the canonical
    weight through the pad/reshape/permute."""
    helper = LayerHelper("conv2d")  # same family as the plain stem
    dtype = input.dtype
    C = input.shape[1]
    w = helper.create_parameter(
        None, (64, C, 7, 7), dtype,
        default_initializer=init.Normal(0.0, (2.0 / (C * 7 * 7)) ** 0.5))
    out = helper.create_tmp_variable(dtype)
    cdt, stream = _conv_dtype(), flags.bf16_stream()

    def fn(x, wv):
        # z-pad (2, 1) = x-pad (4, 2..3): the kernel's zero top/left row
        # absorbs the extra leading x-pad; the trailing side needs
        # ceil(3 / 2) = 2 x-rows, one z-row
        z = F.pad(_s2d_input(x), (2, 1, 2, 1))
        y = F.conv2d(_maybe_bf16(z, cdt), _maybe_bf16(_s2d_weight(wv), cdt))
        return y.to(_stream_dtype(x, stream))

    helper.append_op(type="s2d_stem_conv",
                     inputs={"Input": [input.name], "Filter": [w.name]},
                     outputs={"Output": [out.name]},
                     attrs={"strides": (2, 2), "paddings": (3, 3)},
                     fn=fn)
    return out


def s2d_stem(input, is_test=False):
    """The full ImageNet stem: the space-to-depth conv, batch norm and
    relu."""
    return layers.batch_norm(input=_s2d_stem_conv(input), act="relu",
                             is_test=is_test)


# alias for call sites where a same-named keyword argument shadows the
# helper (resnet_imagenet's s2d_stem flag)
_apply_s2d_stem = s2d_stem


def _shortcut(input, ch_out, stride, is_test=False):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, 0, act=None,
                             is_test=is_test)
    return input


def basicblock(input, ch_out, stride, is_test=False):
    short = _shortcut(input, ch_out, stride, is_test=is_test)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_test=is_test)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None, is_test=is_test)
    return layers.elementwise_add(x=short, y=conv2, act="relu")


def bottleneck(input, ch_out, stride, is_test=False):
    short = _shortcut(input, ch_out * 4, stride, is_test=is_test)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, is_test=is_test)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, is_test=is_test)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None,
                          is_test=is_test)
    return layers.elementwise_add(x=short, y=conv3, act="relu")


def _layer_warp(block_func, input, ch_out, count, stride, is_test=False):
    res_out = block_func(input, ch_out, stride, is_test=is_test)
    for _ in range(1, count):
        res_out = block_func(res_out, ch_out, 1, is_test=is_test)
    return res_out


_DEPTH_CFG = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


def resnet_imagenet(input, class_dim=1000, depth=50, is_test=False,
                    s2d_stem=False):
    """ResNet-{50,101,152} trunk -> class probabilities (a softmax fc),
    NCHW 3x224x224. ``s2d_stem=True`` computes the stem conv through the
    exact space-to-depth transform (same math, same parameter shape);
    it needs even static spatial dims."""
    cfg = _DEPTH_CFG[depth]
    if s2d_stem:
        h, w = input.shape[2], input.shape[3]
        enforce(h and w and h % 2 == 0 and w % 2 == 0,
                "s2d_stem needs even static spatial dims")
        conv1 = _apply_s2d_stem(input, is_test=is_test)
    else:
        conv1 = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2,
                              padding=3, is_test=is_test)
    pool1 = layers.pool2d(input=conv1, pool_type="max", pool_size=3,
                          pool_stride=2, pool_padding=1)
    res1 = _layer_warp(bottleneck, pool1, 64, cfg[0], 1, is_test=is_test)
    res2 = _layer_warp(bottleneck, res1, 128, cfg[1], 2, is_test=is_test)
    res3 = _layer_warp(bottleneck, res2, 256, cfg[2], 2, is_test=is_test)
    res4 = _layer_warp(bottleneck, res3, 512, cfg[3], 2, is_test=is_test)
    pool2 = layers.pool2d(input=res4, pool_size=7, pool_type="avg",
                          global_pooling=True)
    return layers.fc(input=pool2, size=class_dim, act="softmax")


def resnet_cifar10(input, class_dim=10, depth=32, is_test=False):
    """ResNet-(6n+2) for CIFAR-10, basic blocks."""
    enforce((depth - 2) % 6 == 0, "resnet_cifar10: depth must be 6n + 2")
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input, ch_out=16, filter_size=3, stride=1,
                          padding=1, is_test=is_test)
    res1 = _layer_warp(basicblock, conv1, 16, n, 1, is_test=is_test)
    res2 = _layer_warp(basicblock, res1, 32, n, 2, is_test=is_test)
    res3 = _layer_warp(basicblock, res2, 64, n, 2, is_test=is_test)
    pool = layers.pool2d(input=res3, pool_size=8, pool_type="avg",
                         global_pooling=True)
    return layers.fc(input=pool, size=class_dim, act="softmax")


def build_train(class_dim=1000, depth=50, image_shape=(3, 224, 224),
                cifar=False):
    """Data and label variables, the model and its mean cross-entropy in
    the current program: (image, label, avg_cost, predict)."""
    image = layers.data(name="image", shape=list(image_shape),
                        dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    if cifar:
        predict = resnet_cifar10(image, class_dim=class_dim, depth=depth)
    else:
        predict = resnet_imagenet(image, class_dim=class_dim, depth=depth)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    return image, label, avg_cost, predict
