"""paddle_tpu_torch.obs — counterpart of paddle_tpu/obs.

Ported:

* :mod:`~paddle_tpu_torch.obs.cost` — static per-op FLOP/byte
  attribution over the Program IR (the MFU numerator);
* :mod:`~paddle_tpu_torch.obs.metrics` — the process-wide labeled
  Counter/Gauge/Histogram registry, Prometheus exposition and the
  opt-in ``/metrics`` + ``/healthz`` HTTP thread;
* :mod:`~paddle_tpu_torch.obs.trace` — trace/span/parent ids on every
  profiler span, propagated across threads and processes.

Not ported: ``steplog``, ``record`` (the flight recorder) and ``watch``
(ROADMAP Queue A 8).
"""

from . import cost, metrics, trace
from .cost import CostReport
from .metrics import (Counter, Gauge, Histogram, Registry, REGISTRY,
                      register_health, render_prometheus, snapshot,
                      start_http_server, unregister_health)
from .trace import SpanContext

__all__ = [
    "trace", "metrics", "cost",
    "SpanContext", "Counter", "Gauge", "Histogram", "Registry",
    "REGISTRY", "register_health", "unregister_health",
    "render_prometheus", "snapshot", "start_http_server", "CostReport",
]
