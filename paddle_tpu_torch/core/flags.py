"""Global flag registry (counterpart of paddle_tpu/core/flags.py).

Only the flags the ported slices read are defined. The mixed-precision
training recipe reads three of them: ``use_bfloat16`` (bf16 matmul
operands), ``bf16_activations`` (with it, the activation stream stays
bf16: :func:`bf16_stream`) and ``bf16_moments`` (bf16 optimizer
moments); ``fuse_optimizer_state`` stores each parameter group and its
moments as one flat buffer. Set them before the program is built (the
bf16 flags) or before ``optimizer.minimize`` (the other two).

Two flags of the JAX package have no counterpart, because the port has
no plain route to choose against. ``pallas_paged_attention``: the
decode op always runs the hand-written paged-attention kernel
(ops/paged_attention.py). ``pallas_fused_update``: on a CUDA tensor the
flat group update op always runs the hand-written fused-update kernel
(ops/fused_optimizer.py). That is what the JAX package does with those
flags on.

``resilience.faults`` reads ``fault_plan`` (a plan as inline JSON or a
file path) at the first ``fire`` when no plan was installed and
``PDTPU_FAULT_PLAN`` is unset.

The executor reads ``donate_state_buffers``, ``scan_unroll`` and
``check_program`` at each run, ``reader.DataLoader`` reads ``dataloader_buffer_size`` when it is
made.
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


def bf16_stream() -> bool:
    """The one predicate for the bf16 activation stream: both
    ``use_bfloat16`` and ``bf16_activations`` on."""
    return bool(_REGISTRY.get("use_bfloat16")
                and _REGISTRY.get("bf16_activations"))


define_flag("debug_fallback", False,
            "raise instead of warn when build-time shape inference "
            "fails for a reason other than data-dependent control flow")
define_flag("use_bfloat16", False,
            "matmuls take bf16 operands; their results are f32 unless "
            "bf16_activations is on too")
define_flag("bf16_activations", False,
            "with use_bfloat16: matmul results and the activation stream "
            "stay bf16 (parameters, optimizer state and reductions f32)")
define_flag("bf16_moments", False,
            "store the optimizers' moment accumulators in bf16; the "
            "update arithmetic stays f32 (set before optimizer.minimize)")
define_flag("fuse_optimizer_state", False,
            "store parameters and optimizer moments as one flat buffer "
            "per (dtype, grad dtype, lr scale) group, updated by one op "
            "per group; per-name access goes through scope views (set "
            "before optimizer.minimize)")
define_flag("donate_state_buffers", True,
            "ops update persistable state (parameters, moments, beta "
            "powers) in place, and Executor.run_steps' captured graph "
            "reads and writes the scope's own tensors. "
            "fluid.memory_optimize(program) forces it on per program; "
            "set False to keep a state tensor obtained before a run "
            "unchanged after it (the run works on copies)")
define_flag("scan_unroll", False,
            "Executor.run_steps(unroll=None) captures its N steps as one "
            "straight-line CUDA graph, replayed once, instead of one "
            "step replayed N times")
define_flag("check_program", False,
            "run the static program verifier (paddle_tpu_torch.analysis."
            "check_program) over each new program version before "
            "Executor.run or run_steps runs it; structural errors "
            "(undefined vars, use-before-def, shape/dtype mismatches...) "
            "raise EnforceError with op-level context before any op runs "
            "(reference analog: the C++ InferShape/InferVarType sweep over "
            "the ProgramDesc)")
define_flag("dataloader_buffer_size", 2,
            "default number of batches a reader.DataLoader keeps in "
            "flight (reader thread, DataFeeder conversion and the copy to "
            "the card run this far ahead of the consuming step); raise it "
            "when the loader's stall fraction shows the card waiting on "
            "input")
define_flag("fault_plan", "",
            "a resilience.FaultPlan (inline JSON or a path to a JSON "
            "file) activated at the first fault-point fire when no plan "
            "was installed and PDTPU_FAULT_PLAN is unset")
