"""Large-vocabulary output layers (counterpart of
paddle_tpu/layers/sampled.py): the hierarchical sigmoid, noise-contrastive
estimation and sampled softmax.

``hsigmoid`` walks every class's path in the heap-indexed complete
binary tree (the reference's SimpleCode), padded to the longest code:
two gathers and a masked sum. ``nce`` and
``sampled_softmax_with_cross_entropy`` draw fresh negatives each run
from ``fold_in(PRNGKey(seed), counter)`` with the dropout counter, as
the JAX package does, and the draws are bit-equal to its:
``core.prng.randint`` is ``jax.random.randint`` and ``core.prng.uniform``
``jax.random.uniform``. The counter advances by one per op and run.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core import initializer as init
from ..core import prng
from ..layer_helper import LayerHelper
from .detection import _constants
from .nn import _counter_key
from .nn import _dropout_counter as _rng_counter


def _code_table(num_classes: int):
    """Heap bit-codes of each class: class c is heap node ``c +
    num_classes``, internal nodes 1..C-1 (root 1), node n's parameter
    row n - 1. Returns (node_idx ``[C, L]``, bits ``[C, L]``, mask ``[C,
    L]``) padded to the longest code L."""
    C = num_classes
    max_len = int(math.floor(math.log2(2 * C - 1)))
    node_idx = np.zeros((C, max_len), np.int64)
    bits = np.zeros((C, max_len), np.float32)
    mask = np.zeros((C, max_len), np.float32)
    for c in range(C):
        code = c + C
        length = code.bit_length() - 1
        # walk from the root: prefixes of the binary representation
        for j in range(length):
            node_idx[c, j] = (code >> (length - j)) - 1
            bits[c, j] = float((code >> (length - j - 1)) & 1)
            mask[c, j] = 1.0
    return node_idx, bits, mask


def _labels(lbl):
    return (lbl[:, 0] if lbl.dim() == 2 else lbl).to(torch.int64)


def hsigmoid(input, label, num_classes: int, param_attr=None,
             bias_attr=None):
    """Hierarchical sigmoid cost: ``input [B, D]``, ``label [B]`` or
    ``[B, 1]``. Returns the ``[B, 1]`` cost; the classes' probabilities
    over the tree sum to 1."""
    helper = LayerHelper("hsigmoid")
    D = input.shape[-1]
    # one weight row and bias per internal node (num_classes - 1)
    w = helper.create_parameter(param_attr, [num_classes - 1, D],
                                input.dtype,
                                default_initializer=init.Uniform(-0.1, 0.1))
    b = helper.create_parameter(bias_attr, [num_classes - 1], input.dtype,
                                is_bias=True)
    out = helper.create_tmp_variable(input.dtype)
    table = _code_table(num_classes)
    cache = {}

    def fn(x, lbl, wv, bv):
        node_idx, bits, mask = _constants(
            cache, None, x.device,
            lambda: tuple(torch.from_numpy(a) for a in table))
        lbl = _labels(lbl)
        nodes = node_idx[lbl]                               # [B, L]
        logit = torch.einsum("bld,bd->bl", wv[nodes], x) + bv[nodes]
        # p(bit) = sigmoid(logit) for a 1 bit, sigmoid(-logit) for a 0
        sign = 2.0 * bits[lbl] - 1.0
        logp = F.logsigmoid(sign * logit) * mask[lbl]
        return -logp.sum(1, keepdim=True)

    helper.append_op(type="hierarchical_sigmoid",
                     inputs={"X": [input.name], "Label": [label.name],
                             "W": [w.name], "Bias": [b.name]},
                     outputs={"Cost": [out.name]},
                     attrs={"num_classes": num_classes}, fn=fn)
    out.shape = (input.shape[0], 1) if input.shape else None
    return out


def nce(input, label, num_total_classes: int, num_neg_samples: int = 10,
        param_attr=None, bias_attr=None, seed: int = 0,
        sampler: str = "uniform"):
    """Noise-contrastive estimation cost: ``input [B, D]``, ``label
    [B]`` or ``[B, 1]``; ``num_neg_samples`` negatives a row drawn
    uniformly or log-uniformly (Zipfian), the logits corrected by the
    proposal. Returns the ``[B, 1]`` loss."""
    helper = LayerHelper("nce")
    D = input.shape[-1]
    C = num_total_classes
    w = helper.create_parameter(param_attr, [C, D], input.dtype,
                                default_initializer=init.Uniform(-0.1, 0.1))
    b = helper.create_parameter(bias_attr, [C], input.dtype, is_bias=True)
    out = helper.create_tmp_variable(input.dtype)
    k = num_neg_samples
    counter = _rng_counter(helper)
    log_span = float(np.log(np.float32(C + 1.0)))

    def fn(x, lbl, wv, bv, c):
        lbl = _labels(lbl)
        B = x.shape[0]
        key = _counter_key(seed, c)
        if sampler == "log_uniform":
            u = prng.uniform(key, B * k).reshape(B, k)
            neg = (torch.exp(u * log_span) - 1.0).to(torch.int32)
            neg = torch.clamp(neg, 0, C - 1).to(torch.int64)

            def q(cls):  # the log-uniform (Zipfian) proposal
                return (torch.log1p(1.0 / (cls.to(torch.float32) + 1.0))
                        / log_span)
        else:
            neg = prng.randint(key, B * k, 0, C).reshape(B, k)

            def q(cls):
                return torch.full(cls.shape, 1.0 / C, dtype=torch.float32,
                                  device=cls.device)

        s_pos = torch.einsum("bd,bd->b", x, wv[lbl]) + bv[lbl]
        s_neg = torch.einsum("bd,bkd->bk", x, wv[neg]) + bv[neg]
        pos_logit = s_pos - torch.log(k * q(lbl) + 1e-20)
        neg_logit = s_neg - torch.log(k * q(neg) + 1e-20)
        loss = -(F.logsigmoid(pos_logit)
                 + F.logsigmoid(-neg_logit).sum(1))
        return loss[:, None], c + 1

    helper.append_op(type="nce",
                     inputs={"Input": [input.name], "Label": [label.name],
                             "Weight": [w.name], "Bias": [b.name],
                             "Seed": [counter.name]},
                     outputs={"Cost": [out.name],
                              "SeedOut": [counter.name]},
                     attrs={"num_neg_samples": k, "seed": seed}, fn=fn)
    out.shape = (input.shape[0], 1) if input.shape else None
    return out


def sampled_softmax_with_cross_entropy(logits_input, label,
                                       num_total_classes: int,
                                       num_samples: int = 64,
                                       param_attr=None, bias_attr=None,
                                       seed: int = 0):
    """Sampled-softmax cross entropy over a ``[C, D]`` weight: each row
    scored against the batch's true classes and ``num_samples``
    uniformly drawn ones, its own class at its own column. Returns the
    ``[B, 1]`` loss."""
    helper = LayerHelper("sampled_softmax")
    D = logits_input.shape[-1]
    C = num_total_classes
    w = helper.create_parameter(param_attr, [C, D], logits_input.dtype,
                                default_initializer=init.Uniform(-0.1, 0.1))
    b = helper.create_parameter(bias_attr, [C], logits_input.dtype,
                                is_bias=True)
    out = helper.create_tmp_variable(logits_input.dtype)
    counter = _rng_counter(helper)

    def fn(x, lbl, wv, bv, c):
        lbl = _labels(lbl)
        neg = prng.randint(_counter_key(seed, c), num_samples, 0, C)
        cand = torch.cat([lbl, neg])                        # [B + S]
        s = x @ wv[cand].T + bv[cand]                       # [B, B + S]
        true_s = torch.diagonal(s)                          # row i, col i
        return (torch.logsumexp(s, 1) - true_s)[:, None], c + 1

    helper.append_op(type="sampled_softmax",
                     inputs={"X": [logits_input.name], "Label": [label.name],
                             "W": [w.name], "B": [b.name],
                             "Seed": [counter.name]},
                     outputs={"Out": [out.name],
                              "SeedOut": [counter.name]},
                     attrs={"num_samples": num_samples, "seed": seed},
                     fn=fn)
    out.shape = (logits_input.shape[0], 1) if logits_input.shape else None
    return out


__all__ = ["hsigmoid", "nce", "sampled_softmax_with_cross_entropy"]
