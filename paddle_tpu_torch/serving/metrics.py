"""Serving metrics on the process-wide registry (counterpart of
paddle_tpu/serving/metrics.py).

Counters, gauges and latency histograms of one serving stack live in
labeled ``obs.metrics`` families (``pdtpu_serving_*`` with a
per-instance ``sink`` label — the JAX package's names), so one
``/metrics`` read covers every stack in the process; ``report()`` and
``render()`` read them back.

Every timed section (``span``) also emits a ``profiler.RecordEvent`` of
the same name, so the serving spans show in the same tables (and, with
``obs.trace`` on, the same traces) as the executor's.

Times are host wall-clock milliseconds around work that ends in a
device synchronize (the executor synchronizes before it returns
fetches), so on the card they include the device time.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

from ..obs import metrics as obs_metrics
from ..obs.metrics import Histogram  # noqa: F401  (re-export)
from ..profiler import RecordEvent

_SINK_IDS = itertools.count()


def _hist_family(name: str, unit: str = "ms"):
    return obs_metrics.histogram(
        "pdtpu_serving_%s_%s" % (name, unit),
        "serving %s distribution (%s)" % (name, unit),
        labels=("sink",), unit=unit)


def _gauge_prop(name):
    def get(self):
        return self._gauges.labels(sink=self.sink, gauge=name).value

    def set_(self, v):
        self._gauges.labels(sink=self.sink, gauge=name).set(v)

    return property(get, set_)


class ServingMetrics:
    """Thread-safe counters/gauges/histograms for one serving stack."""

    COUNTERS = ("requests_total", "responses_total", "batches_total",
                "queue_full_rejections", "deadline_expired",
                "request_errors", "padded_rows_total", "batched_rows_total",
                # breaker admission rejections / state transitions, and
                # retries spent inside recovery paths (decode re-steps)
                "breaker_rejections", "breaker_transitions",
                "retries_total",
                # submits shed by the degradation ladder at stage 4
                # (also per class in pdtpu_serving_admissions_rejected_total)
                "admissions_rejected_total")

    def __init__(self):
        self._lock = threading.Lock()
        self.sink = "%s-%d" % (type(self).__name__.lower(),
                               next(_SINK_IDS))
        events = obs_metrics.counter(
            "pdtpu_serving_events_total",
            "serving/decoding event counters, one stack per sink",
            labels=("sink", "event"))
        self._counters = {name: events.labels(sink=self.sink, event=name)
                          for name in self.COUNTERS}
        self._gauges = obs_metrics.gauge(
            "pdtpu_serving_gauge", "serving/decoding gauges",
            labels=("sink", "gauge"))
        self._rejected_by_class = obs_metrics.counter(
            "pdtpu_serving_admissions_rejected_total",
            "submits rejected by degradation load shedding, per "
            "priority class", labels=("sink", "class"))
        self.queue_depth = 0  # gauge, set by the server
        self.degradation_stage = 0  # gauge, set by DegradationManager
        self.queue_wait = _hist_family("queue_wait").labels(
            sink=self.sink)                # enqueue -> dequeue
        self.batch_execute = _hist_family("batch_execute").labels(
            sink=self.sink)                # engine run, per batch
        self.batch_size = _hist_family("batch_size", "rows").labels(
            sink=self.sink)                # rows per executed batch

    queue_depth = _gauge_prop("queue_depth")
    degradation_stage = _gauge_prop("degradation_stage")

    def note_admission_rejected(self, priority) -> None:
        """One stage-4 shed rejection: counts on the event counter AND
        the per-class family."""
        self.inc("admissions_rejected_total")
        self._rejected_by_class.labels(
            sink=self.sink, **{"class": str(int(priority))}).inc()

    def retire(self) -> None:
        """Drop this instance's children (its ``sink`` label) from the
        process-wide exposition; its own accessors keep working."""
        obs_metrics.REGISTRY.remove_sink(self.sink)

    def inc(self, name: str, n: int = 1) -> None:
        self._counters[name].inc(n)

    def get(self, name: str) -> int:
        return self._counters[name].value

    def observe(self, hist: Histogram, value_ms: float) -> None:
        with self._lock:
            hist.observe(value_ms)

    def span(self, name: str, hist: Optional[Histogram] = None):
        """Timed section: records into ``hist`` (ms) and emits a
        profiler.RecordEvent span of the same name."""
        return _Span(self, name, hist)

    def report(self) -> Dict[str, object]:
        with self._lock:
            out: Dict[str, object] = {n: c.value
                                      for n, c in self._counters.items()}
            out["queue_wait"] = self.queue_wait.snapshot()
            out["batch_execute"] = self.batch_execute.snapshot()
            out["batch_size"] = self.batch_size.snapshot()
        out["queue_depth"] = self.queue_depth
        n = out["batched_rows_total"]
        out["padding_overhead"] = (
            round(out["padded_rows_total"] / n, 4) if n else 0.0)
        return out

    def render(self) -> str:
        rep = self.report()
        lines: List[str] = ["--- serving metrics ---"]
        for k in self.COUNTERS + ("queue_depth", "padding_overhead"):
            lines.append(f"{k:<24}{rep[k]}")
        for k, u in (("queue_wait", "ms"), ("batch_execute", "ms"),
                     ("batch_size", "rows")):
            h = rep[k]
            lines.append(
                f"{k:<24}count={h['count']} mean={h[f'mean_{u}']}{u} "
                f"p50={h[f'p50_{u}']}{u} p99={h[f'p99_{u}']}{u} "
                f"max={h[f'max_{u}']}{u}")
        return "\n".join(lines)


class DecodeMetrics(ServingMetrics):
    """ServingMetrics extended for the decode path: per-step and
    per-sequence latencies and the decode gauges (``tokens_per_sec``, an
    EMA over decode iterations; ``ttft`` histogram; ``step_ms_ema``, a
    pressure signal of the degradation ladder).

    Histograms (``report()`` gives each one's ``count``, ``mean_ms``,
    ``p50_ms``, ...): ``prefill_latency`` (full prefills), ``extend``
    (suffix prefills of a prefix-cache hit), ``decode_step``, ``verify``
    (speculative verify steps) and ``ttft``. The JAX package folds
    suffix prefills into ``prefill_latency`` and verify steps into
    ``decode_step``; the port keeps them apart. ``tokens_generated``
    counts every token put into a stream (first tokens included);
    ``tokens_generated_total`` the JAX package's decode-step tokens."""

    COUNTERS = ServingMetrics.COUNTERS + (
        "prefills_total", "prefill_rows_total", "decode_steps_total",
        "decode_rows_total", "tokens_generated_total", "tokens_generated",
        "sequences_completed", "sequences_interrupted",
        "admission_blocked_total",
        # prefix caching: admissions that reused >= 1 cached prefix
        # block / that found none; prompt tokens whose prefill was
        # skipped (vs computed); cached blocks reclaimed under pressure
        "prefix_cache_hits_total", "prefix_cache_misses_total",
        "prefill_tokens_computed_total", "prefill_tokens_avoided_total",
        "prefix_blocks_evicted_total",
        # speculative decoding: draft tokens proposed / accepted, and
        # the verify steps executed on the target and their rows
        "spec_proposed_total", "spec_accepted_total",
        "verify_steps_total", "verify_rows_total",
        # degradation: mid-flight sequences evicted for a higher class;
        # speculation disable events (pressure shed or the permanent
        # DraftEngineError fallback); prefix publishes dropped by the
        # decoding.prefix_commit fault guard
        "preemptions_total", "spec_disabled_total",
        "prefix_commits_dropped_total")

    HISTOGRAMS = ("prefill_latency", "extend", "decode_step", "verify",
                  "ttft")

    def __init__(self):
        super().__init__()
        for name in self.HISTOGRAMS:
            setattr(self, name, _hist_family(name).labels(sink=self.sink))
        self.tokens_per_sec = 0.0            # gauge, EMA
        self.ttft_ms = 0.0                   # gauge, latest
        self.active_sequences = 0            # gauge, set by the batcher
        self.step_ms_ema = 0.0               # gauge, decode-step EMA

    tokens_per_sec = _gauge_prop("tokens_per_sec")
    ttft_ms = _gauge_prop("ttft_ms")
    active_sequences = _gauge_prop("active_sequences")
    step_ms_ema = _gauge_prop("step_ms_ema")
    prefix_cached_blocks = _gauge_prop("prefix_cached_blocks")
    prefix_reclaimable_frac = _gauge_prop("prefix_reclaimable_frac")
    prefix_hit_rate_window = _gauge_prop("prefix_hit_rate_window")

    def note_ttft(self, ms: float) -> None:
        self.observe(self.ttft, ms)
        self.ttft_ms = ms

    def note_decode_step(self, tokens: int, dt_s: float) -> None:
        """Fold one decode iteration into the throughput gauge (EMA,
        weight 0.2 a step) and the step-latency EMA. ``tokens`` is the
        count ACCEPTED into streams: under speculation a verify
        iteration passes its accepted tokens, not its rows."""
        self.inc("tokens_generated_total", tokens)
        self.inc("tokens_generated", tokens)
        if dt_s <= 0:
            return
        inst = tokens / dt_s
        with self._lock:
            self.tokens_per_sec = (inst if self.tokens_per_sec == 0.0
                                   else 0.8 * self.tokens_per_sec
                                   + 0.2 * inst)
            ms = dt_s * 1e3
            self.step_ms_ema = (ms if self.step_ms_ema == 0.0
                                else 0.8 * self.step_ms_ema + 0.2 * ms)

    def report(self):
        out = super().report()
        with self._lock:
            for name in self.HISTOGRAMS:
                out[name] = getattr(self, name).snapshot()
            out["tokens_per_sec"] = round(self.tokens_per_sec, 2)
            out["ttft_ms"] = round(self.ttft_ms, 3)
        out["active_sequences"] = self.active_sequences
        lookups = (out["prefix_cache_hits_total"]
                   + out["prefix_cache_misses_total"])
        out["prefix_hit_rate"] = (
            round(out["prefix_cache_hits_total"] / lookups, 4)
            if lookups else 0.0)
        out["spec_acceptance_rate"] = (
            round(out["spec_accepted_total"]
                  / out["spec_proposed_total"], 4)
            if out["spec_proposed_total"] else 0.0)
        return out

    def render(self) -> str:
        lines = [super().render()]
        rep = self.report()
        for k in ("tokens_per_sec", "ttft_ms", "active_sequences",
                  "prefix_hit_rate", "spec_acceptance_rate"):
            lines.append(f"{k:<24}{rep[k]}")
        for k in self.HISTOGRAMS:
            h = rep[k]
            lines.append(
                f"{k:<24}count={h['count']} mean={h['mean_ms']}ms "
                f"p50={h['p50_ms']}ms p99={h['p99_ms']}ms "
                f"max={h['max_ms']}ms")
        return "\n".join(lines)


class _Span:
    def __init__(self, metrics: ServingMetrics, name: str,
                 hist: Optional[Histogram]):
        self._metrics = metrics
        self._hist = hist
        self._event = RecordEvent(name)
        self._t0 = 0.0

    def __enter__(self):
        self._event.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt_ms = (time.perf_counter() - self._t0) * 1e3
        self._event.__exit__(*exc)
        if self._hist is not None and exc[0] is None:
            self._metrics.observe(self._hist, dt_ms)
        return False
