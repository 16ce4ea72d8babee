"""Elementwise / activation / unary ops (counterpart of
paddle_tpu/layers/ops.py): the activations, the elementwise binary
family with its ``axis`` broadcast, ``clip``/``clip_by_norm``,
``logical_xor``, ``maxout``, ``scatter``, ``sum``,
``polygon_box_transform`` and the random generators.

The random generators draw from the shared persistable counter the
dropout sites advance (``nn._dropout_counter``) with ``core/prng.py``'s
threefry, the JAX package's ``jax.random`` bit for bit: ``uniform``
values are equal, ``gaussian`` ones are ``sqrt(2) * erfinv(u)`` of equal
``u`` (torch's ``erfinv``, a few ulps from XLA's).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core import dtype_utils, prng
from ..core.enforce import enforce
from ..core.program import Variable
from ..layer_helper import LayerHelper


def _unary(name, fn, x, attrs=None):
    helper = LayerHelper(name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type=name, inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs=attrs, fn=fn)
    return out


def _make_unary(name, fn, doc):
    def layer(x, name=None):
        return _unary(name_, fn, x)

    name_ = name
    layer.__name__ = name
    layer.__doc__ = doc
    return layer


def _zero(v):
    """A 0-d zero of ``v``'s dtype on its device (made there: no host
    value is copied, so it is safe under CUDA graph capture)."""
    return torch.zeros((), dtype=v.dtype, device=v.device)


# Activations (reference: operators/activation_op.cc registrations).
# relu is the JAX package's jnp.maximum(x, 0): half the gradient passes
# at an exact 0 (torch.relu passes none), which the structural zeros of
# a conv over relu outputs meet often
relu = _make_unary("relu", lambda x: torch.maximum(x, _zero(x)),
                   "max(0, x)")
sigmoid = _make_unary("sigmoid", torch.sigmoid, "1/(1+exp(-x))")
tanh = _make_unary("tanh", torch.tanh, "tanh(x)")
exp = _make_unary("exp", torch.exp, "exp(x)")
log = _make_unary("log", torch.log, "ln(x)")
sqrt = _make_unary("sqrt", torch.sqrt, "sqrt(x)")
rsqrt = _make_unary("rsqrt", torch.rsqrt, "1/sqrt(x)")
abs = _make_unary("abs", torch.abs, "|x|")
ceil = _make_unary("ceil", torch.ceil, "ceil(x)")
floor = _make_unary("floor", torch.floor, "floor(x)")
round = _make_unary("round", torch.round, "round(x)")
reciprocal = _make_unary("reciprocal", lambda x: 1.0 / x, "1/x")
square = _make_unary("square", torch.square, "x^2")
softsign = _make_unary("softsign", F.softsign, "x/(1+|x|)")
softplus = _make_unary("softplus", F.softplus, "log(1+exp(x))")
sin = _make_unary("sin", torch.sin, "sin(x)")
cos = _make_unary("cos", torch.cos, "cos(x)")
logsigmoid = _make_unary("logsigmoid", F.logsigmoid, "log(sigmoid(x))")
tanh_shrink = _make_unary("tanh_shrink", lambda x: x - torch.tanh(x),
                          "x - tanh(x)")
relu6 = _make_unary("relu6", lambda x: torch.clamp(x, 0, 6),
                    "min(max(0,x),6)")
# jax.nn.gelu defaults to its tanh approximation
gelu = _make_unary("gelu", lambda x: F.gelu(x, approximate="tanh"),
                   "gaussian error linear unit (tanh approximation)")


def leaky_relu(x, alpha=0.02, name=None):
    return _unary("leaky_relu",
                  lambda v: torch.where(v >= 0, v, alpha * v), x)


def elu(x, alpha=1.0, name=None):
    return _unary("elu", lambda v: F.elu(v, alpha), x)


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    return _unary("hard_sigmoid",
                  lambda v: torch.clamp(slope * v + offset, 0.0, 1.0), x)


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return _unary("brelu", lambda v: torch.clamp(v, t_min, t_max), x)


def soft_relu(x, threshold=40.0, name=None):
    return _unary("soft_relu",
                  lambda v: torch.log1p(torch.exp(
                      torch.clamp(v, -threshold, threshold))), x)


def pow(x, factor=1.0, name=None):
    return _unary("pow", lambda v: torch.pow(v, factor), x)


def hard_shrink(x, threshold=0.5, name=None):
    """out = x if |x| > threshold else 0."""
    return _unary("hard_shrink",
                  lambda v: torch.where(torch.abs(v) > threshold, v,
                                        _zero(v)), x)


def softshrink(x, alpha=0.5, name=None):
    """out = x -+ alpha outside [-alpha, alpha], 0 inside."""
    return _unary("softshrink",
                  lambda v: torch.where(v > alpha, v - alpha,
                                        torch.where(v < -alpha, v + alpha,
                                                    _zero(v))), x)


def stanh(x, scale_a=2.0 / 3.0, scale_b=1.7159, name=None):
    """out = b * tanh(a * x)."""
    return _unary("stanh", lambda v: scale_b * torch.tanh(scale_a * v), x)


def swish(x, beta=1.0, name=None):
    """out = x * sigmoid(beta * x)."""
    return _unary("swish", lambda v: v * torch.sigmoid(beta * v), x)


def thresholded_relu(x, threshold=1.0, name=None):
    """out = x if x > threshold else 0."""
    return _unary("thresholded_relu",
                  lambda v: torch.where(v > threshold, v, _zero(v)), x)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, name=None):
    if bias_after_scale:
        fn = lambda v: v * scale + bias
    else:
        fn = lambda v: (v + bias) * scale
    return _unary("scale", fn, x)


def clip(x, min, max, name=None):
    return _unary("clip", lambda v: torch.clamp(v, min, max), x)


def clip_by_norm(x, max_norm, name=None):
    """``x * max_norm / ||x||`` where the L2 norm of all of ``x``
    exceeds ``max_norm``, else ``x``."""

    def fn(v):
        norm = torch.sqrt(torch.sum(torch.square(v)))
        return torch.where(norm > max_norm, v * (max_norm / norm), v)

    return _unary("clip_by_norm", fn, x)


# -- the elementwise binary family ---------------------------------------


def _elementwise(name, tfn, x, y, axis=-1, act=None):
    helper = LayerHelper(name)
    if not isinstance(y, Variable):
        const = y

        def fn(xv):
            return tfn(xv, const)

        out = helper.create_tmp_variable(x.dtype)
        helper.append_op(type=name, inputs={"X": [x.name]},
                         outputs={"Out": [out.name]}, fn=fn)
        return helper.append_activation(out, act)

    def fn(xv, yv):
        if axis != -1 and yv.dim() < xv.dim():
            # reference broadcast rule: align y's dims starting at `axis`
            shape = [1] * xv.dim()
            for i in range(yv.dim()):
                shape[axis + i] = yv.shape[i]
            yv = torch.reshape(yv, shape)
        return tfn(xv, yv)

    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type=name, inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]}, fn=fn)
    return helper.append_activation(out, act)


def _tensor_op(op):
    """``op`` of two tensors taking a Python number for its second
    operand too (made on the first's device, in its dtype: the JAX
    package's weak-typed constant)."""

    def fn(a, b):
        if not isinstance(b, torch.Tensor):
            b = torch.full((), b, dtype=a.dtype, device=a.device)
        return op(a, b)

    return fn


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", torch.add, x, y, axis, act)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_sub", torch.sub, x, y, axis, act)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", torch.mul, x, y, axis, act)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", torch.div, x, y, axis, act)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_max", _tensor_op(torch.maximum), x, y,
                        axis, act)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_min", _tensor_op(torch.minimum), x, y,
                        axis, act)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_pow", torch.pow, x, y, axis, act)


# -- logical_xor, maxout, scatter, sum, polygon_box_transform ------------


def logical_xor(x, y, out=None, name=None):
    helper = LayerHelper("logical_xor")
    out = out or helper.create_tmp_variable("bool")
    helper.append_op(type="logical_xor",
                     inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]},
                     fn=lambda a, b: torch.logical_xor(a.to(torch.bool),
                                                       b.to(torch.bool)))
    return out


def maxout(x, groups: int, name=None):
    """Channel-group max: [N, C, H, W] -> [N, C/groups, H, W] (the
    input read as [N, C/g, g, H, W]), or [N, C] -> [N, C/groups]."""
    helper = LayerHelper("maxout")
    out = helper.create_tmp_variable(x.dtype)

    def fn(v):
        if v.dim() == 2:
            n, c = v.shape
            return torch.amax(v.reshape(n, c // groups, groups), dim=2)
        n, c, h, w = v.shape
        return torch.amax(v.reshape(n, c // groups, groups, h, w), dim=2)

    helper.append_op(type="maxout", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"groups": groups}, fn=fn)
    return out


def polygon_box_transform(input, name=None):
    """EAST-style geometry decode: even (n*C+c) planes become
    w - offset, odd planes h - offset."""
    helper = LayerHelper("polygon_box_transform")
    out = helper.create_tmp_variable(input.dtype)

    def fn(v):
        n, c, h, w = v.shape
        plane = (torch.arange(n, device=v.device)[:, None] * c
                 + torch.arange(c, device=v.device)[None, :])
        even = (plane % 2 == 0)[:, :, None, None]
        wcoord = torch.arange(w, dtype=v.dtype,
                              device=v.device)[None, None, None, :]
        hcoord = torch.arange(h, dtype=v.dtype,
                              device=v.device)[None, None, :, None]
        return torch.where(even, wcoord - v, hcoord - v)

    helper.append_op(type="polygon_box_transform",
                     inputs={"Input": [input.name]},
                     outputs={"Output": [out.name]}, fn=fn)
    return out


def scatter(input, index, updates, overwrite: bool = True, name=None):
    """Row scatter: out = input; out[index[i]] = (or +=) updates[i].
    The sum is ``index_put(accumulate=True)``, whose CUDA path adds
    repeated rows in a fixed (sorted) order."""
    helper = LayerHelper("scatter")
    out = helper.create_tmp_variable(input.dtype)

    def fn(x, idx, upd):
        idx = idx.reshape(-1).to(torch.int64)
        return torch.index_put(x, (idx,), upd.to(x.dtype),
                               accumulate=not overwrite)

    helper.append_op(type="scatter",
                     inputs={"X": [input.name], "Ids": [index.name],
                             "Updates": [updates.name]},
                     outputs={"Out": [out.name]},
                     attrs={"overwrite": overwrite}, fn=fn)
    return out


def sum(x, name=None):
    """Sum a list of tensors elementwise."""
    from .tensor import sums

    if isinstance(x, (list, tuple)):
        return sums(list(x))
    return sums([x])


# -- random generators ----------------------------------------------------


def _random_op(op_type, sampler, shape_of, seed, dtype, helper_args):
    """Shared body of the random generators: ``seed == 0`` draws anew
    each run, keyed on ``fold_in(PRNGKey(base_seed), counter)`` with the
    shared counter advanced by one (``base_seed`` the program's next
    parameter seed, as dropout takes it); a nonzero ``seed`` folds in 0
    and leaves the counter alone, the same values every step."""
    from .nn import _dropout_counter

    enforce(dtype_utils.name(dtype) == "float32",
            "%s: only float32 draws are ported (got %s)"
            % (op_type, dtype_utils.name(dtype)))
    helper = LayerHelper(op_type)
    out = helper.create_tmp_variable(dtype)
    counter = _dropout_counter(helper)
    base_seed = seed if seed else helper.main_program.next_param_seed()

    def fn(*args):
        c = args[-1]
        fold = torch.zeros((), dtype=torch.int64, device=c.device) \
            if seed else c.reshape(())
        key = prng.fold_in(prng.prng_key(
            torch.full((), base_seed, dtype=torch.int64, device=c.device)),
            fold)
        shape = shape_of(args[:-1])
        val = sampler(key, shape)
        return val, (c if seed else c + 1)

    inputs = dict(helper_args)
    inputs["Seed"] = [counter.name]
    helper.append_op(type=op_type, inputs=inputs,
                     outputs={"Out": [out.name], "SeedOut": [counter.name]},
                     attrs={"seed": seed}, fn=fn)
    return out


def _uniform(lo, hi):
    def sample(key, shape):
        n = int(np.prod(shape, dtype=np.int64))
        return prng.uniform(key, n, lo, hi).reshape(shape)

    return sample


def _normal(mean, std):
    """``jax.random.normal(key, shape) * std + mean``: ``sqrt(2) *
    erfinv(u)`` of ``u`` uniform in ``[nextafter(-1, inf), 1)``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(np.inf)))
    root2 = float(np.float32(math.sqrt(2.0)))

    def sample(key, shape):
        n = int(np.prod(shape, dtype=np.int64))
        u = prng.uniform(key, n, lo, 1.0).reshape(shape)
        return root2 * torch.erfinv(u) * std + mean

    return sample


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0,
                   name=None):
    return _random_op("uniform_random", _uniform(float(min), float(max)),
                      lambda _: tuple(int(s) for s in shape), seed, dtype,
                      {})


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32",
                    name=None):
    return _random_op("gaussian_random", _normal(float(mean), float(std)),
                      lambda _: tuple(int(s) for s in shape), seed, dtype,
                      {})


def _batch_size_like_shape(shape, input_dim_idx=0, output_dim_idx=0):
    def shape_of(args):
        target = [int(s) for s in shape]
        target[output_dim_idx] = args[0].shape[input_dim_idx]
        return tuple(target)

    return shape_of


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0, name=None):
    return _random_op(
        "uniform_random_batch_size_like", _uniform(float(min), float(max)),
        _batch_size_like_shape(shape, input_dim_idx, output_dim_idx),
        seed, dtype, {"Input": [input.name]})


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32", name=None):
    return _random_op(
        "gaussian_random_batch_size_like", _normal(float(mean), float(std)),
        _batch_size_like_shape(shape, input_dim_idx, output_dim_idx),
        seed, dtype, {"Input": [input.name]})
