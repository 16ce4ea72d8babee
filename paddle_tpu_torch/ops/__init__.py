"""Hand-written kernels of paddle_tpu_torch, each beside its plain torch
version."""

from .paged_attention import (paged_window_attention,
                              plain_split_window_attention,
                              plain_window_attention, plan_route)

__all__ = ["paged_window_attention", "plain_split_window_attention",
           "plain_window_attention", "plan_route"]
