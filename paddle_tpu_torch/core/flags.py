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

The executor reads ``donate_state_buffers``, ``scan_unroll``,
``check_program`` and ``check_nan_inf`` at each run, ``reader.DataLoader`` reads ``dataloader_buffer_size`` when it is
made. ``tuning`` reads ``tuning_cache_dir`` (falling back to
``<compile_cache_dir>/tuning``) at each store resolution; ``io`` and the
executor read ``compile_cache_dir`` at each export and capture. The
caches' roots, ``profiler_max_spans`` and the flight recorder's
``obs_record``/``obs_record_interval_s`` are also read from
``PDTPU_<NAME>`` at import (:func:`try_from_env`).
"""

from __future__ import annotations

import os
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
define_flag("check_nan_inf", False,
            "after each Executor.run (and each run_steps call, over its "
            "stacked fetches) check the fetched values and the state the "
            "run wrote for NaN/Inf: one reduction on the device and one "
            "bool read; a failure names the variable (debug mode; "
            "reference: FLAGS_check_nan_inf)")
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
define_flag("compile_cache_dir", "",
            "root of the persistent compile cache "
            "(paddle_tpu_torch.compile_cache): each torch.export of "
            "save_inference_model's buckets and of "
            "save_trainable_program is fingerprinted and its .pt2 stored "
            "under this directory, so a second export of the same "
            "program (a re-export after retraining, another process) "
            "writes the stored file instead of tracing again; the "
            "executor's captured CUDA graphs are fingerprinted into "
            "recent_fingerprints() and persist nothing. Empty (default) "
            "= off, zero behavior change. Maintain with "
            "`python -m paddle_tpu_torch.tools.cache`")
define_flag("tuning_cache_dir", "",
            "root of the persistent kernel-autotuning store "
            "(paddle_tpu_torch.tuning): measured per-(device, kernel, "
            "shape-bucket, dtype) launch configs of the Hopper kernels "
            "persist here and warm a second process with zero re-sweeps. "
            "Empty (default) = live beside the compile cache at "
            "<compile_cache_dir>/tuning when that flag is set, else no "
            "persistence: lookups serve the in-process memo and the "
            "kernels' defaults. Maintain with "
            "`python -m paddle_tpu_torch.tools.tuning`")
define_flag("profiler_max_spans", 1_000_000,
            "capacity of the profiler's span ring "
            "(paddle_tpu_torch.profiler): a long-enabled profiler keeps "
            "the newest this-many spans and reports evictions through "
            "spans_dropped() instead of growing without bound. The "
            "aggregated event counts and totals never drop. Applied at "
            "the next reset_profiler()")
define_flag("obs_record", "",
            "enable the flight recorder (paddle_tpu_torch.obs.record) at "
            "import with this bundle directory: bounded in-memory rings "
            "(span, steplog, error and alert tails, metric snapshots) "
            "flushed as atomic post-mortem bundles on unhandled "
            "exceptions, SIGTERM/SIGQUIT, watchdog alerts, degradation "
            "escalation and a rolling cadence that survives SIGKILL. "
            "Subprocess workers inherit it through the PDTPU_RECORD_DIR "
            "env var. Empty (default) = off. Inspect bundles with "
            "`python -m paddle_tpu_torch.tools.postmortem`")
define_flag("obs_record_interval_s", 1.0,
            "flight-recorder snapshot cadence in seconds: metric-registry "
            "snapshots, tick-rule watchdog evaluation and the rolling "
            "flush all run on this period")


def try_from_env(names) -> None:
    """Read ``PDTPU_<NAME>`` for each flag of ``names`` where it is set
    (the JAX package's ``--tryfromenv``), parsed as the default's type.
    A value that does not parse warns and is ignored."""
    for name in names:
        env = os.environ.get("PDTPU_" + name.upper())
        if env is None:
            continue
        cur = _REGISTRY.get(name)
        try:
            if isinstance(cur, bool):
                val = env.lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                val = int(env)
            elif isinstance(cur, float):
                val = float(env)
            else:
                val = env
        except ValueError:
            import warnings

            warnings.warn(f"ignoring invalid PDTPU_{name.upper()}={env!r}")
            continue
        set_flags({name: val})


# the flags a deployment sets from its environment: the caches' roots,
# the recorder's, and the span ring's size
try_from_env(["compile_cache_dir", "tuning_cache_dir",
              "profiler_max_spans", "obs_record", "obs_record_interval_s"])
