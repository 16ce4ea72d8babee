"""``scan``: the port's counterpart of ``lax.scan`` for the sequence tier.

The JAX package compiles every recurrence (the RNN layers, CRF, CTC,
StaticRNN/DynamicRNN, beam search, the attention decoder) into one
``lax.scan`` over the padded time axis. Here the same recurrence is an
eager loop of torch ops: its trip count is the padded length, fixed by
the tensor shapes, so a step that holds one replays as a captured CUDA
graph. Autograd records through the loop, so the backward pass is the
reverse of the same steps.

On ``meta`` tensors (build-time shape inference and the static tier)
the step runs once and its outputs are repeated along the time axis:
the shapes of a T-step scan without T steps of work.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch


def scan(step: Callable, carry, xs: Sequence[torch.Tensor],
         reverse: bool = False) -> Tuple[object, Tuple[torch.Tensor, ...]]:
    """``step(carry, *x_t) -> (carry, ys)`` over the leading axis of each
    tensor of ``xs`` (``ys`` a tuple of tensors). Returns the final
    carry and each of ``ys`` stacked on a new leading axis, in the
    order of ``xs`` also when ``reverse`` walks it from the end."""
    T = xs[0].shape[0]
    if xs[0].device.type == "meta":
        carry, ys = step(carry, *(x[0] for x in xs))
        return carry, tuple(y.unsqueeze(0).expand((T,) + tuple(y.shape))
                            for y in ys)
    outs = []
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        carry, ys = step(carry, *(x[t] for x in xs))
        outs.append(ys)
    if reverse:
        outs.reverse()
    return carry, tuple(torch.stack(col) for col in zip(*outs))
