"""Composite network blocks (counterpart of paddle_tpu/nets.py;
reference: python/paddle/fluid/nets.py): simple_img_conv_pool,
img_conv_group, sequence_conv_pool, glu, scaled_dot_product_attention.
"""

from __future__ import annotations

import torch

from . import layers
from .layer_helper import LayerHelper


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act=None, pool_type="max",
                         param_attr=None, use_cudnn=True):
    conv_out = layers.conv2d(input=input, num_filters=num_filters,
                             filter_size=filter_size, param_attr=param_attr,
                             act=act)
    return layers.pool2d(input=conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True,
                   is_test=False):
    tmp = input
    assert isinstance(conv_num_filter, (list, tuple))

    def _expand(v):
        return (v if isinstance(v, (list, tuple))
                else [v] * len(conv_num_filter))

    conv_padding = _expand(conv_padding)
    conv_filter_size = _expand(conv_filter_size)
    param_attr = _expand(param_attr)
    conv_with_batchnorm = _expand(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _expand(conv_batchnorm_drop_rate)

    for i in range(len(conv_num_filter)):
        local_conv_act = None if conv_with_batchnorm[i] else conv_act
        tmp = layers.conv2d(input=tmp, num_filters=conv_num_filter[i],
                            filter_size=conv_filter_size[i],
                            padding=conv_padding[i],
                            param_attr=param_attr[i], act=local_conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act, is_test=is_test)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate,
                                     is_test=is_test)
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, act="sigmoid",
                       pool_type="max", param_attr=None):
    conv_out = layers.sequence_conv(input=input, num_filters=num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr, act=act)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)


def glu(input, dim=-1):
    """Gated linear unit: split in two along ``dim``, a * sigmoid(b)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(x=a, y=layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0, is_test=False):
    """Multi-head scaled dot-product attention over projected [B, T, D]
    tensors: two batched products a head group, in the [B, T, H, D]
    head layout."""
    helper = LayerHelper("scaled_dot_product_attention")
    out = helper.create_tmp_variable(queries.dtype)
    d = values.shape[-1]
    assert d is not None and d % num_heads == 0

    def fn(q, k, v):
        B, Tq, D = q.shape
        H = num_heads

        def split_heads(x):
            return torch.reshape(x, (B, x.shape[1], H, x.shape[2] // H))

        qh, kh, vh = split_heads(q), split_heads(k), split_heads(v)
        scale = (k.shape[-1] // H) ** -0.5
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
        ctx = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1),
                           vh)
        return torch.reshape(ctx, (B, Tq, D))

    helper.append_op(
        type="scaled_dot_product_attention",
        inputs={"Q": [queries.name], "K": [keys.name], "V": [values.name]},
        outputs={"Out": [out.name]}, fn=fn)
    return out
