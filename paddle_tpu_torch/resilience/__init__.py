"""paddle_tpu_torch.resilience — deterministic fault injection,
supervised elastic training, and the shared retry, circuit-breaker and
degradation machinery (counterpart of paddle_tpu/resilience):

* :mod:`faults`  — seeded :class:`FaultPlan` of registered
  :data:`FAULT_POINTS` injecting crashes, delays and payload corruption
  on a reproducible schedule (default off is byte-identical);
* :mod:`retry`   — the ONE capped-exponential-backoff-with-jitter
  :class:`RetryPolicy` (supervisor restarts, decode re-steps,
  Retry-After hints, client resubmits);
* :mod:`supervisor` — heartbeat-watched subprocess supervision with
  crash AND hang detection (a worker of several ranks killed as one
  process group), composing ``ckpt.restore``'s N→M restores with a
  relaunch at another world size;
* :mod:`breaker` — the closed→open→half-open :class:`CircuitBreaker`
  the serving layer sheds load through;
* :mod:`degrade` — the ordered, reversible degradation ladder of the
  serving and decoding tier.
"""

from .breaker import CLOSED, HALF_OPEN, OPEN, CircuitBreaker
from .degrade import (PRIORITY_HIGH, PRIORITY_LOW, PRIORITY_NORMAL,
                      STAGE_ADMISSION, STAGE_FEATURE_SHED,
                      STAGE_LOAD_SHED, STAGE_NAMES, STAGE_NORMAL,
                      STAGE_PREEMPTION, DegradationConfig,
                      DegradationManager, clamp_priority)
from .faults import (FAULT_POINTS, FaultPlan, FaultRule, InjectedFault,
                     active_plan, clear_plan, fire, hit_counts,
                     injection_log, injections, install_plan, load_plan,
                     plan_env, register_fault_point)
from .retry import RetryError, RetryPolicy
from .retry import call as retry_call
from .supervisor import (HEARTBEAT_ENV, Supervisor, SupervisorGaveUp,
                         WorkerReport, note_progress, read_heartbeat,
                         supervise, worker_argv)


__all__ = [
    "CLOSED",
    "CircuitBreaker",
    "DegradationConfig",
    "DegradationManager",
    "FAULT_POINTS",
    "FaultPlan",
    "FaultRule",
    "HALF_OPEN",
    "HEARTBEAT_ENV",
    "InjectedFault",
    "OPEN",
    "PRIORITY_HIGH",
    "PRIORITY_LOW",
    "PRIORITY_NORMAL",
    "RetryError",
    "RetryPolicy",
    "STAGE_ADMISSION",
    "STAGE_FEATURE_SHED",
    "STAGE_LOAD_SHED",
    "STAGE_NAMES",
    "STAGE_NORMAL",
    "STAGE_PREEMPTION",
    "Supervisor",
    "SupervisorGaveUp",
    "WorkerReport",
    "active_plan",
    "clamp_priority",
    "clear_plan",
    "fire",
    "hit_counts",
    "injection_log",
    "injections",
    "install_plan",
    "load_plan",
    "note_progress",
    "plan_env",
    "read_heartbeat",
    "register_fault_point",
    "retry_call",
    "supervise",
    "worker_argv",
]
