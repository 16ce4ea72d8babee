"""Parameter initializers (counterpart of paddle_tpu/core/initializer.py).

Each initializer appends an op to the startup program whose fn draws the
initial value from an explicit ``torch.Generator`` seeded at build time.
Values are made on the CPU, constants too: a seed gives the same
weights on every device, and the pack of a flat parameter buffer
(``fuse_optimizer_state``) joins tensors of one device, though the
executor makes other input-less ops' tensors on its own. The executor
moves them to its device when it writes them back.
The numbers differ from the JAX package's (another generator): tests
that compare the packages carry weights across with
``paddle_tpu_torch.convert.params_from_numpy``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import dtype_utils
from . import program as P


class Initializer:
    def _append_init_op(self, param: "P.Parameter") -> None:
        startup = P.default_startup_program()
        gb = startup.global_block()
        if param.name not in gb.vars:
            gb.create_var(name=param.name, shape=param.shape,
                          dtype=param.dtype, persistable=True)
        seed = getattr(self, "seed", 0) or P.default_main_program().next_param_seed()
        shape = tuple(param.shape)
        fn = self.make_fn(shape, dtype_utils.to_torch(param.dtype), seed)
        gb.append_op(type="init_" + type(self).__name__.lower(),
                     inputs={}, outputs={"Out": [param.name]},
                     attrs={"seed": seed, "shape": shape}, fn=fn)

    def make_fn(self, shape, dtype, seed):
        raise NotImplementedError


def _generator(seed: int) -> torch.Generator:
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed))
    return g


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def make_fn(self, shape, dtype, seed):
        value = self.value
        return lambda: torch.full(shape, value, dtype=dtype, device="cpu")


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def make_fn(self, shape, dtype, seed):
        low, high = self.low, self.high

        def fn():
            u = torch.rand(shape, generator=_generator(seed),
                           dtype=torch.float32, device="cpu")
            return (u * (high - low) + low).to(dtype)

        return fn


class Normal(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def make_fn(self, shape, dtype, seed):
        loc, scale = self.loc, self.scale
        return lambda: (torch.randn(shape, generator=_generator(seed),
                                    dtype=torch.float32, device="cpu")
                        * scale + loc).to(dtype)


def _fan_in_out(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Xavier(Initializer):
    """Glorot init."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = (
            uniform, fan_in, fan_out, seed)

    def make_fn(self, shape, dtype, seed):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            return Uniform(-limit, limit).make_fn(shape, dtype, seed)
        std = math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std).make_fn(shape, dtype, seed)

