"""Neural-network layer functions (counterpart of
paddle_tpu/layers/nn.py): the ones the causal LM reaches.

Each function appends ops carrying torch fns to the default main program
and returns the output Variable(s).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..core import initializer as init
from ..layer_helper import LayerHelper


def fc(input, size: int, num_flatten_dims: int = 1, param_attr=None,
       bias_attr=None, act: Optional[str] = None, is_test: bool = False,
       name=None):
    """Fully-connected layer: flatten to 2-D at ``num_flatten_dims``,
    project, add bias, activate. Multiple inputs are summed after
    projection."""
    inputs = input if isinstance(input, (list, tuple)) else [input]
    helper = LayerHelper("fc")
    dtype = inputs[0].dtype

    proj_names = []
    for x in inputs:
        in_features = int(np.prod(x.shape[num_flatten_dims:]))
        w = helper.create_parameter(param_attr, [in_features, size], dtype)
        out = helper.create_tmp_variable(dtype)

        def mul_fn(xv, wv, _nfd=num_flatten_dims):
            lead = xv.shape[:_nfd]
            xv2 = torch.reshape(xv, (int(np.prod(lead)) if lead else 1, -1))
            y = torch.matmul(xv2, wv)
            return torch.reshape(y, (*lead, y.shape[-1]))

        helper.append_op(type="mul",
                         inputs={"X": [x.name], "Y": [w.name]},
                         outputs={"Out": [out.name]}, fn=mul_fn)
        proj_names.append(out)

    if len(proj_names) == 1:
        pre_bias = proj_names[0]
    else:
        pre_bias = helper.create_tmp_variable(dtype)
        helper.append_op(type="sum",
                         inputs={"X": [v.name for v in proj_names]},
                         outputs={"Out": [pre_bias.name]},
                         fn=lambda *vs: sum(vs))

    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [size], dtype, is_bias=True)
        pre_act = helper.create_tmp_variable(dtype)
        helper.append_op(type="elementwise_add",
                         inputs={"X": [pre_bias.name], "Y": [b.name]},
                         outputs={"Out": [pre_act.name]},
                         fn=lambda xv, bv: xv + bv.to(xv.dtype))
    else:
        pre_act = pre_bias
    return helper.append_activation(pre_act, act)


def embedding(input, size: Sequence[int], is_sparse: bool = False,
              is_distributed: bool = False, padding_idx: Optional[int] = None,
              param_attr=None, dtype="float32"):
    """Lookup table. Ids whose trailing dim is 1 are squeezed first (the
    reference's ``[B, 1]`` ids convention), and the output shape follows
    the same rule — the decode rewrite swaps this op for a no-squeeze
    lookup because of it. Sparse gradients and distributed tables belong
    to training and are not ported yet."""
    if is_distributed:
        raise NotImplementedError(
            "embedding(is_distributed=True) is not ported yet")
    helper = LayerHelper("embedding")
    w = helper.create_parameter(param_attr, list(size), dtype,
                                default_initializer=init.Uniform(-0.05, 0.05))
    out = helper.create_tmp_variable(dtype)

    def fn(ids, table):
        idx = ids.to(torch.int64)
        if idx.dim() and idx.shape[-1] == 1:
            idx = torch.squeeze(idx, -1)
        emb = F.embedding(idx, table)
        if padding_idx is not None:
            pad = padding_idx if padding_idx >= 0 else table.shape[0] + padding_idx
            emb = torch.where((idx == pad)[..., None],
                              torch.zeros((), dtype=emb.dtype,
                                          device=emb.device), emb)
        return emb

    helper.append_op(type="lookup_table",
                     inputs={"Ids": [input.name], "W": [w.name]},
                     outputs={"Out": [out.name]},
                     attrs={"is_sparse": is_sparse,
                            "is_distributed": is_distributed,
                            "padding_idx": padding_idx}, fn=fn)
    if input.shape is not None:
        ishape = tuple(input.shape)
        if ishape and ishape[-1] == 1:
            ishape = ishape[:-1]
        out.shape = ishape + (int(size[1]),)
    return out


def dropout(x, dropout_prob: float, is_test: bool = False, seed=None,
            name=None):
    """Inference dropout: ``x * (1 - dropout_prob)`` (the reference's
    downgrade_in_infer). Training dropout is not ported yet."""
    if not is_test:
        raise NotImplementedError(
            "dropout(is_test=False) is not ported yet: this slice serves "
            "inference programs only")
    helper = LayerHelper("dropout")
    out = helper.create_tmp_variable(x.dtype)
    counter = _dropout_counter(helper)

    def fn(v, c, is_test=True):
        return v * (1.0 - dropout_prob), c

    helper.append_op(type="dropout",
                     inputs={"X": [x.name], "Seed": [counter.name]},
                     outputs={"Out": [out.name], "SeedOut": [counter.name]},
                     attrs={"dropout_prob": dropout_prob, "is_test": True,
                            "_fn_attrs": ["is_test"]},
                     fn=fn)
    return out


def _dropout_counter(helper):
    """The shared persistable int32 step counter the JAX package keys
    dropout masks on; kept so both packages build the same symbol
    table."""
    gb = helper.main_program.global_block()
    name = "_dropout_rng_counter"
    if name in gb.vars:
        return gb.vars[name]
    v = gb.create_var(name=name, shape=(), dtype="int32", persistable=True)
    sb = helper.startup_program.global_block()
    sb.create_var(name=name, shape=(), dtype="int32", persistable=True)
    sb.append_op(type="init_counter", inputs={}, outputs={"Out": [name]},
                 fn=lambda: torch.zeros((), dtype=torch.int32))
    return v
