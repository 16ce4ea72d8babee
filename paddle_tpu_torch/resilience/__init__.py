"""paddle_tpu_torch.resilience — deterministic fault injection and the
shared retry, circuit-breaker and degradation machinery (counterpart of
paddle_tpu/resilience):

* :mod:`faults`  — seeded :class:`FaultPlan` of registered
  :data:`FAULT_POINTS` injecting crashes, delays and payload corruption
  on a reproducible schedule (default off is byte-identical);
* :mod:`retry`   — the ONE capped-exponential-backoff-with-jitter
  :class:`RetryPolicy` (decode re-steps, Retry-After hints, client
  resubmits);
* :mod:`breaker` — the closed→open→half-open :class:`CircuitBreaker`
  the serving layer sheds load through;
* :mod:`degrade` — the ordered, reversible degradation ladder of the
  serving and decoding tier.

Not ported: the supervisor (``Supervisor``, ``supervise``,
``note_progress`` and the rest of its names raise, naming ROADMAP
Queue A 10; its elastic restart at another world size needs Queue A 9).
"""

from ..core.enforce import not_ported
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

_SUPERVISOR_NAMES = ("HEARTBEAT_ENV", "Supervisor", "SupervisorGaveUp",
                     "WorkerReport", "note_progress", "read_heartbeat",
                     "supervise", "supervisor", "worker_argv")


def __getattr__(name):
    if name in _SUPERVISOR_NAMES:
        raise not_ported("resilience.%s (the supervisor)" % name,
                         "Queue A 10")
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))


__all__ = [
    "CLOSED",
    "CircuitBreaker",
    "DegradationConfig",
    "DegradationManager",
    "FAULT_POINTS",
    "FaultPlan",
    "FaultRule",
    "HALF_OPEN",
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
    "active_plan",
    "clamp_priority",
    "clear_plan",
    "fire",
    "hit_counts",
    "injection_log",
    "injections",
    "install_plan",
    "load_plan",
    "plan_env",
    "register_fault_point",
    "retry_call",
]
