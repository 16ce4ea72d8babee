"""DeepFM sparse-CTR model (counterpart of paddle_tpu/models/deepfm.py):
first-order weights per feature, second-order factorized interactions
and an MLP over the concatenated embeddings, both reading one table.

The tables are ``embedding(is_distributed=True)`` by default: annotated
for row sharding over an embedding-parallel axis, a plain lookup on one
card."""

from __future__ import annotations

import torch

from .. import layers
from ..layer_helper import LayerHelper


def fm_interaction(e, v):
    """``0.5 * sum_d((sum_f e v)^2 - sum_f (e v)^2)``: ``[B, F, D]``
    embeddings and ``[B, F]`` values -> ``[B, 1]``."""
    ev = e * v[..., None]                       # [B, F, D]
    s = torch.sum(ev, dim=1)                    # [B, D]
    s2 = torch.sum(ev * ev, dim=1)              # [B, D]
    return 0.5 * torch.sum(s * s - s2, dim=1, keepdim=True)


def deepfm(num_features: int = 100000, num_fields: int = 39,
           embed_dim: int = 16, mlp_dims=(400, 400, 400),
           is_distributed: bool = True):
    """Build the training graph. Feeds: feat_ids [B, F] int64,
    feat_vals [B, F] float32, label [B, 1] float32.
    Returns (feeds, avg_cost, auc_prob)."""
    feat_ids = layers.data(name="feat_ids", shape=[-1, num_fields],
                           dtype="int64", append_batch_size=False)
    feat_vals = layers.data(name="feat_vals", shape=[-1, num_fields],
                            dtype="float32", append_batch_size=False)
    label = layers.data(name="label", shape=[-1, 1], dtype="float32",
                        append_batch_size=False)

    # first order: w_i * x_i (a 1-wide embedding per feature)
    first_emb = layers.embedding(feat_ids, size=[num_features, 1],
                                 is_distributed=is_distributed)  # [B, F, 1]
    first = layers.reduce_sum(
        layers.elementwise_mul(layers.squeeze(first_emb, axes=[-1]),
                               feat_vals), dim=1, keep_dim=True)  # [B, 1]

    # second order: 0.5 * ((sum v x)^2 - sum (v x)^2)
    emb = layers.embedding(feat_ids, size=[num_features, embed_dim],
                           is_distributed=is_distributed)  # [B, F, D]
    helper = LayerHelper("fm_interaction")
    fm_out = helper.create_tmp_variable("float32")
    helper.append_op(type="fm_interaction",
                     inputs={"Emb": [emb.name], "Vals": [feat_vals.name]},
                     outputs={"Out": [fm_out.name]}, fn=fm_interaction)

    # deep tower over the flattened embeddings
    deep = layers.reshape(emb, shape=[-1, num_fields * embed_dim])
    for dim in mlp_dims:
        deep = layers.fc(input=deep, size=dim, act="relu")
    deep = layers.fc(input=deep, size=1, act=None)

    logit = layers.elementwise_add(layers.elementwise_add(first, fm_out),
                                   deep)
    prob = layers.sigmoid(logit)
    cost = layers.sigmoid_cross_entropy_with_logits(x=logit, label=label)
    avg_cost = layers.mean(cost)
    return [feat_ids, feat_vals, label], avg_cost, prob
