"""Hand-written kernels of paddle_tpu_torch, each beside its plain torch
version.

``flash_attention`` here is the function, as in the JAX package's
``ops``; its module (counters, builders, plain versions) is
``importlib.import_module("paddle_tpu_torch.ops.flash_attention")``.
``xla_window_attention`` is the JAX package's name for the paged
window attention that runs without the kernel: here it is the plain
torch version, ``plain_window_attention``."""

from .flash_attention import flash_attention
from .paged_attention import (paged_window_attention,
                              plain_split_window_attention,
                              plain_window_attention, plan_route)

xla_window_attention = plain_window_attention

__all__ = ["flash_attention", "paged_window_attention",
           "plain_split_window_attention", "plain_window_attention",
           "plan_route", "xla_window_attention"]
