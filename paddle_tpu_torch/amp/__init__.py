"""paddle_tpu_torch.amp — graph-level automatic mixed precision
(counterpart of paddle_tpu/amp).

Mixed precision as a pass over the Program IR:

  * :mod:`policy`    — :class:`AmpPolicy`: per-op allow/deny/infer lists
    (matmul/conv/attention -> bf16 with f32 accumulation;
    softmax/norm/reductions/losses -> f32; elementwise follows inputs);
  * :mod:`rewrite`   — :func:`rewrite_program`: minimal ``cast`` ops
    (one per consumer group, no chains, one fused master-weight cast per
    block), for freshly built programs and loaded artifacts alike — the
    route to bf16 serving (the decode pools take the bf16 stream);
  * :mod:`scaler`    — :class:`DynamicLossScaler` (grow/backoff, the
    overflow flag on the card) and :func:`device_all_finite`;
  * :mod:`decorator` — :func:`decorate(optimizer)`: scaling wired into
    ``minimize``, moments and updates f32 against f32 master weights,
    an overflowed step skipped on the card (the gated update).

Default-off: a program never passed through this package is exactly
what it was.
"""

from .decorator import OptimizerWithMixedPrecision, decorate
from .policy import (DEFAULT_ALLOW, DEFAULT_DENY, DEFAULT_INFER,
                     AmpPolicy)
from .rewrite import rewrite_program
from .scaler import DynamicLossScaler, device_all_finite

__all__ = [
    "AmpPolicy", "DEFAULT_ALLOW", "DEFAULT_DENY", "DEFAULT_INFER",
    "DynamicLossScaler", "OptimizerWithMixedPrecision", "decorate",
    "device_all_finite", "rewrite_program",
]
