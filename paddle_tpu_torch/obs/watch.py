"""Anomaly watchdogs: declarative rules over the telemetry plane that
emit structured, typed :class:`Alert` records (counterpart of
paddle_tpu/obs/watch.py: the same rules, thresholds and alert records).

The rest of ``obs`` makes the process observable (traces, one metrics
registry, step logs); this module makes it self-observing: a small set of
:class:`WatchRule` objects is evaluated live — step rules on every
StepStats record the flight recorder sees, tick rules on the recorder's
snapshot cadence — and each rule transition produces an :class:`Alert`
with explicit ``firing``/``cleared`` states. Alerts land in three
places at once:

* the **metrics registry** — ``pdtpu_alerts_total{rule,state}`` counter
  and the ``pdtpu_alert_active{rule}`` 0/1 gauge, so `/metrics`
  scrapers see anomalies without any bundle;
* the **recorder ring** — the bounded ``alerts`` deque the flight
  recorder dumps into every post-mortem bundle (``alerts.jsonl``);
* an optional **callback** — e.g. a Supervisor annotating restarts, or
  a test asserting the watchdog fired before recovery did.

Built-in rules cover the failure shapes this repo's chaos suite
injects: step-time spike vs the rule's own ``step_ms_ema``, input-stall
fraction, loss NaN/divergence (from the steplog), serving queue
saturation (from registered ``health()`` sources), prefix-cache
hit-rate collapse, and compile-cache miss storms (both from registry
counter deltas per tick). Rules are plain objects — subclass
:class:`WatchRule` to add one; an evaluation that raises is swallowed
(a watchdog must never take down the thing it watches).

Default off changes nothing: nothing here runs unless a
:class:`Watchdogs` is constructed (the flight recorder builds one when
enabled).
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from ..profiler import RecordEvent
from . import metrics as obs_metrics

SEVERITIES = ("info", "warning", "critical")


class Alert:
    """One structured alert record: which rule, which transition
    (``firing`` | ``cleared``), why, when, with labels."""

    __slots__ = ("rule", "severity", "state", "reason", "t", "labels")

    def __init__(self, rule: str, severity: str, state: str,
                 reason: str, t: Optional[float] = None,
                 labels: Optional[Dict[str, str]] = None):
        self.rule = str(rule)
        self.severity = str(severity)
        self.state = str(state)
        self.reason = str(reason)
        self.t = time.time() if t is None else float(t)
        self.labels = dict(labels or {})

    def to_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "state": self.state, "reason": self.reason,
                "t": round(self.t, 6), "labels": dict(self.labels)}

    def __repr__(self):
        return "Alert(%s %s: %s)" % (self.rule, self.state, self.reason)


class WatchRule:
    """Base class of one declarative watchdog rule.

    ``observe_step(record)`` is called per StepStats record,
    ``observe_tick(ctx)`` once per recorder snapshot tick; each returns
    a human-readable *reason* string while the condition holds and None
    while it does not. The :class:`Watchdogs` engine owns the
    firing/cleared hysteresis: a rule fires ONCE per excursion and
    clears only after ``clear_after`` consecutive None evaluations.
    Rules may keep internal state (EMAs, baselines) — one rule instance
    belongs to one Watchdogs."""

    name = "watch_rule"
    severity = "warning"

    def __init__(self, clear_after: int = 3):
        self.clear_after = max(1, int(clear_after))

    def observe_step(self, record: dict) -> Optional[str]:
        return None

    def observe_tick(self, ctx: dict) -> Optional[str]:
        return None


def delta_sum(ctx: dict, family: str, **labels) -> float:
    """Sum the per-tick counter deltas of ``family`` children whose
    labels include every given key=value (the tick-rule helper)."""
    total = 0.0
    want = {k: str(v) for k, v in labels.items()}
    for (fam, lbls), d in (ctx.get("deltas") or {}).items():
        if fam != family:
            continue
        as_dict = dict(lbls)
        if all(as_dict.get(k) == v for k, v in want.items()):
            total += d
    return total


# ---------------------------------------------------------------------------
# built-in rules
# ---------------------------------------------------------------------------


class StepTimeSpike(WatchRule):
    """Step time spiked vs this rule's own running EMA
    (``step_ms_ema``): fires when one step takes ``factor``x the EMA of
    the preceding steps. The spiking sample is NOT folded into the EMA
    — a storm must not normalize itself away."""

    name = "step_time_spike"

    def __init__(self, factor: float = 3.0, warmup_steps: int = 3,
                 alpha: float = 0.2, clear_after: int = 3):
        super().__init__(clear_after)
        self.factor = float(factor)
        self.warmup_steps = max(1, int(warmup_steps))
        self.alpha = float(alpha)
        self.step_ms_ema: Optional[float] = None
        self._seen = 0

    def observe_step(self, record):
        dt = record.get("dt_s")
        if not isinstance(dt, (int, float)) or dt <= 0 \
                or not math.isfinite(dt):
            return None
        if record.get("fresh_compiles"):
            # a step that compiled is EXPECTED slow: folding it into
            # the EMA would poison the baseline (first-step compiles
            # are seconds) and firing on it would cry wolf per bucket
            return None
        ms = dt * 1e3
        if self._seen >= self.warmup_steps and self.step_ms_ema \
                and ms > self.factor * self.step_ms_ema:
            return "step_ms=%.1f > %.1fx step_ms_ema=%.1f" % (
                ms, self.factor, self.step_ms_ema)
        self.step_ms_ema = (ms if self.step_ms_ema is None else
                            self.alpha * ms
                            + (1.0 - self.alpha) * self.step_ms_ema)
        self._seen += 1
        return None


class StallFraction(WatchRule):
    """The input pipeline is starving the device: the steplog's
    ``stall_frac`` (feed_wait / step time) at or above ``max_frac``."""

    name = "stall_fraction"

    def __init__(self, max_frac: float = 0.5, clear_after: int = 3):
        super().__init__(clear_after)
        self.max_frac = float(max_frac)

    def observe_step(self, record):
        sf = record.get("stall_frac")
        if isinstance(sf, (int, float)) and sf >= self.max_frac:
            return "stall_frac=%.2f >= %.2f" % (sf, self.max_frac)
        return None


class LossAnomaly(WatchRule):
    """Loss went NaN/Inf (always fires), or diverged above an explicit
    ``max_loss`` threshold (opt-in — loss scales are model-specific)."""

    name = "loss_anomaly"
    severity = "critical"

    def __init__(self, max_loss: Optional[float] = None,
                 clear_after: int = 3):
        super().__init__(clear_after)
        self.max_loss = None if max_loss is None else float(max_loss)

    def observe_step(self, record):
        loss = record.get("loss")
        if not isinstance(loss, (int, float)):
            return None
        if not math.isfinite(loss):
            return "loss=%r is not finite" % (loss,)
        if self.max_loss is not None and loss > self.max_loss:
            return "loss=%.4g > max_loss=%.4g" % (loss, self.max_loss)
        return None


class QueueSaturation(WatchRule):
    """A serving/decoding queue is (nearly) full: any registered
    ``health()`` source reporting ``queue_depth / queue_capacity`` at
    or above ``frac`` (health sources are how the recorder already
    sees the serving tier — no new plumbing)."""

    name = "queue_saturation"

    def __init__(self, frac: float = 0.95, clear_after: int = 3):
        super().__init__(clear_after)
        self.frac = float(frac)

    def observe_tick(self, ctx):
        sources = (ctx.get("health") or {}).get("sources") or {}
        for name, snap in sources.items():
            if not isinstance(snap, dict):
                continue
            depth = snap.get("queue_depth")
            cap = snap.get("queue_capacity")
            if isinstance(depth, (int, float)) and \
                    isinstance(cap, (int, float)) and cap > 0 \
                    and depth / cap >= self.frac:
                return "%s queue %d/%d >= %.0f%%" % (
                    name, depth, cap, self.frac * 100.0)
        return None


class PrefixHitCollapse(WatchRule):
    """The prefix-cache hit rate collapsed: over one tick, admissions
    volume was at least ``min_events`` but the hit rate fell below
    ``min_rate`` (reads the ``pdtpu_serving_events_total`` counter
    deltas — an idle tick never fires)."""

    name = "prefix_hit_collapse"

    def __init__(self, min_rate: float = 0.2, min_events: int = 32,
                 clear_after: int = 3):
        super().__init__(clear_after)
        self.min_rate = float(min_rate)
        self.min_events = max(1, int(min_events))

    def observe_tick(self, ctx):
        hits = delta_sum(ctx, "pdtpu_serving_events_total",
                         event="prefix_cache_hits_total")
        misses = delta_sum(ctx, "pdtpu_serving_events_total",
                           event="prefix_cache_misses_total")
        total = hits + misses
        if total >= self.min_events and hits / total < self.min_rate:
            return "prefix hit rate %.2f < %.2f over %d admissions" % (
                hits / total, self.min_rate, int(total))
        return None


class CompileMissStorm(WatchRule):
    """The persistent compile cache is missing in a storm: more than
    ``max_misses`` ``pdtpu_compile_cache_total{event="miss"}`` deltas
    in one tick — a redeploy that lost its warm cache, or a fingerprint
    churn bug."""

    name = "compile_miss_storm"

    def __init__(self, max_misses: int = 8, clear_after: int = 2):
        super().__init__(clear_after)
        self.max_misses = max(1, int(max_misses))

    def observe_tick(self, ctx):
        misses = delta_sum(ctx, "pdtpu_compile_cache_total",
                           event="miss")
        if misses > self.max_misses:
            return "%d compile-cache misses in one tick (> %d)" % (
                int(misses), self.max_misses)
        return None


def default_rules() -> List[WatchRule]:
    """The stock rule set the flight recorder installs: one instance
    of every built-in with production-shaped defaults."""
    return [StepTimeSpike(), StallFraction(), LossAnomaly(),
            QueueSaturation(), PrefixHitCollapse(), CompileMissStorm()]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class Watchdogs:
    """Evaluate a rule set and own the alert lifecycle.

    ``observe_step(record)`` runs the step rules (the flight recorder
    feeds it from the steplog), ``observe_tick(health=...)`` the tick
    rules (the recorder's snapshot cadence; counter deltas are computed
    here against the previous tick). Both return the alerts EMITTED by
    that evaluation (state transitions only — a still-firing rule emits
    nothing new). All state is lock-guarded; a rule or callback that
    raises is contained."""

    def __init__(self, rules: Optional[Sequence[WatchRule]] = None,
                 on_alert: Optional[Callable[[Alert], None]] = None,
                 registry: Optional[obs_metrics.Registry] = None,
                 alerts_tail: int = 256):
        self.rules = list(default_rules() if rules is None else rules)
        self.on_alert = on_alert
        self._registry = registry or obs_metrics.REGISTRY
        self._fired = self._registry.counter(
            "pdtpu_alerts_total",
            "watchdog alert transitions (paddle_tpu_torch.obs.watch)",
            labels=("rule", "state"))
        self._active = self._registry.gauge(
            "pdtpu_alert_active",
            "1 while the watchdog rule is firing, else 0",
            labels=("rule",))
        # RLock: the flight recorder's signal-handler dump reads
        # active()/alerts on whatever frame the signal interrupted —
        # possibly one already inside _run on the same thread
        self._lock = threading.RLock()
        self._state = {r.name: {"active": False, "clear_streak": 0}
                       for r in self.rules}
        self._last_counters: Optional[Dict] = None
        self.alerts: "deque[Alert]" = deque(maxlen=max(1, alerts_tail))

    # ------------------------------------------------------------------
    def active(self) -> List[str]:
        """Names of the rules currently firing."""
        with self._lock:
            return [n for n, s in self._state.items() if s["active"]]

    def _emit(self, rule: WatchRule, state: str, reason: str,
              labels: Optional[Dict[str, str]] = None) -> Alert:
        alert = Alert(rule.name, rule.severity, state, reason,
                      labels=labels)
        self.alerts.append(alert)
        try:
            self._fired.labels(rule=rule.name, state=state).inc()
            self._active.labels(rule=rule.name).set(
                1 if state == "firing" else 0)
        except Exception:
            pass
        # zero-length marker span (the breaker/degrade idiom): alerts
        # show up in the same span tables and structured traces as the
        # workload they describe
        with RecordEvent("obs/alert." + rule.name):
            pass
        cb = self.on_alert
        if cb is not None:
            try:
                cb(alert)
            except Exception:
                pass  # an alert sink must never break the workload
        return alert

    def _evaluate(self, rule: WatchRule, reason: Optional[str]
                  ) -> Optional[Alert]:
        # caller holds the lock for the state transition bookkeeping;
        # _emit runs outside it (callbacks may be slow)
        st = self._state.setdefault(
            rule.name, {"active": False, "clear_streak": 0})
        if reason is not None:
            st["clear_streak"] = 0
            if not st["active"]:
                st["active"] = True
                return self._pending(rule, "firing", reason)
            return None
        if st["active"]:
            st["clear_streak"] += 1
            if st["clear_streak"] >= rule.clear_after:
                st["active"] = False
                st["clear_streak"] = 0
                return self._pending(rule, "cleared",
                                     "condition cleared for %d "
                                     "evaluations" % rule.clear_after)
        return None

    @staticmethod
    def _pending(rule, state, reason):
        return (rule, state, reason)

    def _run(self, kind: str, payload) -> List[Alert]:
        pending = []
        with self._lock:
            for rule in self.rules:
                try:
                    reason = getattr(rule, kind)(payload)
                except Exception:
                    reason = None  # a broken rule never kills the host
                p = self._evaluate(rule, reason)
                if p is not None:
                    pending.append(p)
        return [self._emit(rule, state, reason)
                for rule, state, reason in pending]

    # ------------------------------------------------------------------
    def observe_step(self, record: dict) -> List[Alert]:
        """Run the step rules against one StepStats record."""
        return self._run("observe_step", record)

    def _counter_values(self) -> Dict:
        vals: Dict = {}
        for fam in self._registry.families():
            if fam.kind != "counter":
                continue
            for labels, child in fam.children():
                vals[(fam.name, tuple(sorted(labels.items())))] = \
                    child.value
        return vals

    def observe_tick(self, health: Optional[dict] = None,
                     dt_s: Optional[float] = None,
                     counter_values: Optional[Dict] = None
                     ) -> List[Alert]:
        """Run the tick rules: computes this tick's counter deltas vs
        the previous call (first call establishes the baseline and
        never fires a delta rule), composes the health snapshot, and
        evaluates. The flight recorder calls this once per snapshot
        interval — passing ``counter_values`` from its own registry
        walk so one traversal serves both it and the history ring;
        standalone users may call it on any cadence and omit it."""
        now_vals = (dict(counter_values) if counter_values is not None
                    else self._counter_values())
        with self._lock:
            prev, self._last_counters = self._last_counters, now_vals
        deltas = ({} if prev is None else
                  {k: v - prev.get(k, 0) for k, v in now_vals.items()
                   if v != prev.get(k, 0)})
        if health is None:
            try:
                health = obs_metrics.health_snapshot()
            except Exception:
                health = {}
        ctx = {"deltas": deltas, "health": health, "dt_s": dt_s,
               "t": time.time()}
        return self._run("observe_tick", ctx)
