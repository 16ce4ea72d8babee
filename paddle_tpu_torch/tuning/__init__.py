"""paddle_tpu_torch.tuning — persistent autotuning of the Hopper
kernels' launch knobs (counterpart of paddle_tpu/tuning).

Each tunable kernel publishes a declarative parameter space of the
launch knobs its CUDA kernel reads, with machine-checked validity
constraints (:mod:`registry`, declarations in :mod:`kernels`); a sweep
engine measures candidates on the card with CUDA events around
dependency-chained calls (:mod:`sweep`); winners persist in a
content-addressed store keyed by (device kind — the card's
``torch.cuda.get_device_name()`` —, kernel, shape bucket, dtype,
kernel-version fingerprint) (:mod:`store`), so tuned configs survive
restarts, warm a second process with ZERO re-sweeps, and ship inside
exported artifacts. The wrappers consult :func:`lookup` at each launch;
with nothing tuned they run the launch shapes they had before, and every
captured-graph key and manifest stays what it was.

Maintain with ``python -m paddle_tpu_torch.tools.tuning {ls,verify,
sweep,gc,clear}``.
"""

from .api import (active_store, clear_memo, current_device_kind,
                  export_configs, lookup, prefetch, program_stamp,
                  reset_tuning_metrics, seed_configs, tuning_metrics)
from .registry import (Constraint, TunableKernel, get_tunable,
                       list_tunables, pow2_bucket, register_tunable,
                       tunables_for_ops)
from .store import TunedRecord, TuningStore, tuning_key
from .sweep import chained_grad_scan, measure_min_ms, sweep, sweep_program

__all__ = [
    "Constraint",
    "TunableKernel",
    "TunedRecord",
    "TuningStore",
    "active_store",
    "chained_grad_scan",
    "clear_memo",
    "current_device_kind",
    "export_configs",
    "get_tunable",
    "list_tunables",
    "lookup",
    "measure_min_ms",
    "pow2_bucket",
    "prefetch",
    "program_stamp",
    "register_tunable",
    "reset_tuning_metrics",
    "seed_configs",
    "sweep",
    "sweep_program",
    "tunables_for_ops",
    "tuning_key",
    "tuning_metrics",
]
