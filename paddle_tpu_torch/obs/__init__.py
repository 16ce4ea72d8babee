"""paddle_tpu_torch.obs — the telemetry plane (counterpart of
paddle_tpu/obs), six pillars over the profiler/timeline substrate:

* :mod:`~paddle_tpu_torch.obs.trace` — trace/span/parent ids on every
  profiler span, propagated across threads and processes;
* :mod:`~paddle_tpu_torch.obs.metrics` — the process-wide labeled
  Counter/Gauge/Histogram registry, Prometheus exposition and the
  opt-in ``/metrics`` + ``/healthz`` HTTP thread;
* :mod:`~paddle_tpu_torch.obs.steplog` — per-step training telemetry
  to an append-only JSONL run log (live-tail with ``python -m
  paddle_tpu_torch.tools.top``);
* :mod:`~paddle_tpu_torch.obs.cost` — static per-op FLOP/byte
  attribution over the Program IR (the MFU numerator);
* :mod:`~paddle_tpu_torch.obs.record` — the flight recorder: bounded
  rings dumped as atomic post-mortem bundles (inspect with ``python -m
  paddle_tpu_torch.tools.postmortem``);
* :mod:`~paddle_tpu_torch.obs.watch` — anomaly watchdogs: declarative
  rules emitting typed firing/cleared Alert records onto the registry,
  the recorder rings, and an optional callback.

Everything is default-off and changes nothing when off (fingerprints,
capture counts and counters are the same both ways).
"""

from . import cost, metrics, record, steplog, trace, watch
from .cost import CostReport
from .metrics import (Counter, Gauge, Histogram, Registry, REGISTRY,
                      register_health, render_prometheus, snapshot,
                      start_http_server, unregister_health)
from .record import (FlightRecorder, RecorderConfig, dump,
                     latest_bundle, read_bundle, validate_bundle)
from .steplog import StepLogger, read_steplog
from .trace import SpanContext
from .watch import Alert, Watchdogs, WatchRule, default_rules

__all__ = [
    "trace", "metrics", "steplog", "cost", "record", "watch",
    "SpanContext", "Counter", "Gauge", "Histogram", "Registry",
    "REGISTRY", "register_health", "unregister_health",
    "render_prometheus", "snapshot", "start_http_server",
    "StepLogger", "read_steplog", "CostReport",
    "FlightRecorder", "RecorderConfig", "dump", "latest_bundle",
    "read_bundle", "validate_bundle",
    "Alert", "Watchdogs", "WatchRule", "default_rules",
]
