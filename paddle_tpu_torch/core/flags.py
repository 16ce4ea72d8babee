"""Global flag registry (counterpart of paddle_tpu/core/flags.py).

Only the flags the ported slices read are defined. The bf16 training
flags and ``fuse_optimizer_state`` exist so that a program setting them
is refused where they are read (``NotImplementedError``), never
silently ignored. ``pallas_paged_attention``
has no counterpart: the port's decode op always runs the hand-written
paged-attention kernel (ops/paged_attention.py), which is what the JAX
package does with that flag on.
"""

from __future__ import annotations

from typing import Any, Dict

_REGISTRY: Dict[str, Any] = {}


def define_flag(name: str, default: Any, help_str: str = "") -> None:
    if name not in _REGISTRY:
        _REGISTRY[name] = default


def get_flag(name: str) -> Any:
    return _REGISTRY.get(name)


def set_flags(flags: Dict[str, Any]) -> None:
    _REGISTRY.update(flags)


define_flag("debug_fallback", False,
            "raise instead of warn when build-time shape inference "
            "fails for a reason other than data-dependent control flow")
define_flag("use_bfloat16", False,
            "bf16 matmuls (not ported yet: the embedding refuses it)")
define_flag("bf16_activations", False,
            "bf16 activation stream (not ported yet)")
define_flag("bf16_moments", False,
            "bf16 optimizer moments (not ported yet: accumulators refuse "
            "it)")
define_flag("fuse_optimizer_state", False,
            "flat per-group optimizer state (not ported yet: minimize "
            "refuses it)")
