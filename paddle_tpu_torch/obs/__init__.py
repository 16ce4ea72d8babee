"""paddle_tpu_torch.obs — counterpart of paddle_tpu/obs.

Ported: :mod:`~paddle_tpu_torch.obs.cost`, the static per-op FLOP/byte
attribution over the Program IR (the MFU numerator). The rest of the
JAX package's telemetry plane — ``metrics``, ``trace``, ``steplog``,
``record`` and ``watch`` — is not (ROADMAP Queue A 8).
"""

from . import cost
from .cost import CostReport

__all__ = ["CostReport", "cost"]
