"""Ordered degradation ladder for the serving and decoding tier
(counterpart of paddle_tpu/resilience/degrade.py).

A circuit breaker is right when the engine is broken; a flooded server
is not broken, it is overloaded. A :class:`DegradationManager` watches
the pressure signals the stack exposes (queue depth, KV block-pool
pressure, breaker state, decode-step latency EMA, progress age) and
walks an ORDERED, REVERSIBLE ladder::

    stage 0  normal             everything on
    stage 1  admission_control  token-budget admission per priority
                                class (the worst-case block estimate
                                KVCacheManager already computes)
    stage 2  preemption         evict lowest-priority mid-flight
                                sequences back to the queue when a
                                higher class cannot be admitted (their
                                full blocks publish to the prefix cache
                                first, so resumption is a cheap suffix
                                prefill)
    stage 3  feature_shed       speculative decoding auto-disables;
                                prefix-cache eviction tightens before
                                admissions are refused
    stage 4  load_shed          lowest-class submits are rejected with
                                the typed retriable OverloadedError
                                carrying a Retry-After hint from the
                                shared RetryPolicy

Transitions are hysteresis-guarded both directions: ONE stage at a
time, up only after ``up_after`` consecutive evaluations above the
stage thresholds, down only after ``down_after`` consecutive
evaluations below ``clear_ratio`` x those thresholds. Every transition
is recorded (``transitions``, the ``resilience/degrade.<stage-name>``
marker span, the ``degradation_stage`` registry gauge of the bound
metrics).

A RUNTIME plane: it never rewrites programs. Default off —
``DecodingConfig(degrade=None)`` — is byte-identical admission.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..profiler import RecordEvent
from .retry import RetryPolicy

# Priority classes carried by requests (lower value = more important).
# Three classes cover the production taxonomy: interactive traffic,
# default traffic, and batch/offline backfill.
PRIORITY_HIGH = 0
PRIORITY_NORMAL = 1
PRIORITY_LOW = 2

STAGE_NORMAL = 0
STAGE_ADMISSION = 1
STAGE_PREEMPTION = 2
STAGE_FEATURE_SHED = 3
STAGE_LOAD_SHED = 4

STAGE_NAMES = ("normal", "admission_control", "preemption",
               "feature_shed", "load_shed")


def clamp_priority(priority) -> int:
    """Coerce any caller-supplied priority into the known class range
    (None = normal)."""
    if priority is None:
        return PRIORITY_NORMAL
    return max(PRIORITY_HIGH, min(PRIORITY_LOW, int(priority)))


class DegradationConfig:
    """Thresholds and hysteresis knobs for the ladder.

    queue_fracs: 4 backlog fractions of queue capacity ((queued +
        waiting) / capacity); crossing entry ``i`` targets stage
        ``i + 1``. The default tops out at 1.0 — stage 4 load shedding
        engages when the backlog reaches a full queue's worth.
    pool_fracs: 4 fractions of KV pool blocks in live use (1 -
        reclaimable/num_blocks); None entries never trigger. Pool
        pressure alone defaults to targeting at most stage 2
        (preemption frees blocks; shedding load on pool pressure alone
        would under-use the queue).
    step_ms_high: decode-step latency EMA (ms) that targets
        ``latency_stage`` (feature shedding: speculation off). None
        (default) = latency never escalates — CI boxes have wildly
        different step times, so this knob is opt-in.
    breaker_stage: stage targeted while the wired breaker is not
        closed (default: feature shedding — the engine is struggling,
        stop spending steps on speculation).
    stall_age_s / stall_stage: last-progress age that escalates (None
        = off), same rationale as step_ms_high.
    class_headroom: per-priority-class pool headroom enforced from
        stage 1 — class ``p`` may only reserve while
        ``used + needed <= num_blocks * (1 - class_headroom[p])``.
        The defaults leave the highest class the whole pool.
    shed_priority: classes >= this are rejected at stage 4.
    up_after / down_after: consecutive evaluations required to move
        one stage up / down (hysteresis).
    clear_ratio: de-escalation evaluates the thresholds scaled by this
        factor — pressure must drop clearly below the entry point
        before the ladder walks back.
    retry_policy: the shared RetryPolicy whose backoff sequence
        provides the Retry-After hints on shed rejections (seeded —
        hints are reproducible like every resilience delay).
    """

    def __init__(self,
                 queue_fracs=(0.50, 0.75, 0.90, 1.00),
                 pool_fracs=(0.85, 0.95, None, None),
                 step_ms_high: Optional[float] = None,
                 latency_stage: int = STAGE_FEATURE_SHED,
                 breaker_stage: int = STAGE_FEATURE_SHED,
                 stall_age_s: Optional[float] = None,
                 stall_stage: int = STAGE_FEATURE_SHED,
                 class_headroom=(0.0, 0.10, 0.25),
                 shed_priority: int = PRIORITY_LOW,
                 up_after: int = 2, down_after: int = 6,
                 clear_ratio: float = 0.75,
                 retry_policy: Optional[RetryPolicy] = None):
        def _fracs(v):
            out = tuple(None if f is None else float(f) for f in v)
            if len(out) != 4:
                raise ValueError("threshold tuples need one entry per "
                                 "stage 1..4, got %r" % (v,))
            return out

        def _stage(v):
            # an out-of-range stage knob must never walk the ladder
            # past STAGE_NAMES (a worker-killing IndexError otherwise)
            return max(STAGE_NORMAL, min(STAGE_LOAD_SHED, int(v)))

        self.queue_fracs = _fracs(queue_fracs)
        self.pool_fracs = _fracs(pool_fracs)
        self.step_ms_high = (None if step_ms_high is None
                             else float(step_ms_high))
        self.latency_stage = _stage(latency_stage)
        self.breaker_stage = _stage(breaker_stage)
        self.stall_age_s = (None if stall_age_s is None
                            else float(stall_age_s))
        self.stall_stage = _stage(stall_stage)
        self.class_headroom = tuple(float(h) for h in class_headroom)
        self.shed_priority = clamp_priority(shed_priority)
        self.up_after = max(1, int(up_after))
        self.down_after = max(1, int(down_after))
        self.clear_ratio = float(clear_ratio)
        if not (0.0 < self.clear_ratio <= 1.0):
            raise ValueError("clear_ratio must be in (0, 1]")
        self.retry_policy = retry_policy or RetryPolicy(
            base_delay_s=0.1, max_delay_s=2.0, jitter=0.0)


class DegradationManager:
    """Walks the ladder from observed pressure signals.

    One manager serves one server/session. The owning worker thread
    calls :meth:`evaluate` once per loop iteration (client threads may
    also evaluate — all state is lock-guarded); admission paths read
    the predicates. ``on_transition(frm, to, reason)`` is an optional
    hook (metrics counters, logs) that must never raise into admission.
    """

    def __init__(self, config: Optional[DegradationConfig] = None,
                 on_transition: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config or DegradationConfig()
        self.on_transition = on_transition
        self._clock = clock
        self._lock = threading.Lock()
        self._stage = STAGE_NORMAL
        self._up_count = 0
        self._down_count = 0
        self._shed_streak = 0
        self._evaluations = 0
        self._stage_since = self._clock()
        self._metrics = None
        self.transitions: List[dict] = []  # [{t, from, to, reason}]
        self.last_signals: Dict[str, object] = {}

    # ------------------------------------------------------------------
    def bind_metrics(self, metrics) -> None:
        """Attach a ServingMetrics/DecodeMetrics: the manager keeps its
        ``degradation_stage`` registry gauge current."""
        self._metrics = metrics
        try:
            metrics.degradation_stage = self._stage
        except Exception:
            pass

    @property
    def stage(self) -> int:
        with self._lock:
            return self._stage

    @property
    def stage_name(self) -> str:
        return STAGE_NAMES[self.stage]

    @property
    def evaluations(self) -> int:
        with self._lock:
            return self._evaluations

    # ------------------------------------------------------------------
    def _target_stage(self, signals: Dict, scale: float) -> tuple:
        """(target stage, reason) for thresholds scaled by ``scale``
        (1.0 on the way up, ``clear_ratio`` on the way down)."""
        cfg = self.config
        target, reason = STAGE_NORMAL, "clear"

        def bump(stage, why):
            nonlocal target, reason
            if stage > target:
                target, reason = stage, why

        qf = float(signals.get("queue_frac", 0.0) or 0.0)
        for i, thr in enumerate(cfg.queue_fracs):
            if thr is not None and qf >= thr * scale:
                bump(i + 1, "queue_frac=%.2f" % qf)
        pf = float(signals.get("pool_frac", 0.0) or 0.0)
        for i, thr in enumerate(cfg.pool_fracs):
            if thr is not None and pf >= thr * scale:
                bump(i + 1, "pool_frac=%.2f" % pf)
        if signals.get("breaker_open"):
            bump(cfg.breaker_stage, "breaker_open")
        ema = signals.get("step_ms_ema")
        if cfg.step_ms_high is not None and ema is not None \
                and float(ema) >= cfg.step_ms_high * scale:
            bump(cfg.latency_stage, "step_ms_ema=%.1f" % float(ema))
        age = signals.get("progress_age_s")
        if cfg.stall_age_s is not None and age is not None \
                and float(age) >= cfg.stall_age_s * scale:
            bump(cfg.stall_stage, "progress_age_s=%.1f" % float(age))
        return target, reason

    def evaluate(self, signals: Dict) -> int:
        """Fold one signal snapshot into the ladder; returns the (new)
        stage. Moves at most ONE stage per call, each direction behind
        its own consecutive-evaluation guard."""
        with self._lock:
            self._evaluations += 1
            self.last_signals = dict(signals)
            up_target, up_reason = self._target_stage(signals, 1.0)
            down_target, _ = self._target_stage(
                signals, self.config.clear_ratio)
            moved = None
            if up_target > self._stage:
                self._down_count = 0
                self._up_count += 1
                if self._up_count >= self.config.up_after:
                    moved = (self._stage + 1, up_reason)
            elif down_target < self._stage:
                self._up_count = 0
                self._down_count += 1
                if self._down_count >= self.config.down_after:
                    moved = (self._stage - 1, "pressure_cleared")
            else:
                self._up_count = 0
                self._down_count = 0
            if moved is not None:
                self._transition(*moved)
            stage = self._stage
            self._shed_streak = (self._shed_streak + 1
                                 if stage >= STAGE_LOAD_SHED else 0)
        return stage

    def force_stage(self, stage: int, reason: str = "forced") -> None:
        """Jump directly to a stage (ops override / tests). Resets the
        hysteresis counters, so organic evaluation resumes cleanly."""
        stage = max(STAGE_NORMAL, min(STAGE_LOAD_SHED, int(stage)))
        with self._lock:
            if stage != self._stage:
                self._transition(stage, reason)

    def _transition(self, to: int, reason: str) -> None:
        # caller holds the lock
        to = max(STAGE_NORMAL, min(STAGE_LOAD_SHED, int(to)))
        frm, self._stage = self._stage, to
        self._up_count = 0
        self._down_count = 0
        self._stage_since = self._clock()
        self.transitions.append({"t": self._clock(), "from": frm,
                                 "to": to, "reason": reason})
        if self._metrics is not None:
            try:
                self._metrics.degradation_stage = to
            except Exception:
                pass
        hook = self.on_transition
        if hook is not None:
            try:
                hook(frm, to, reason)
            except Exception:
                pass  # a telemetry hook must never break admission
        # flight-recorder hook (obs.record): transitions land in the
        # recorder's degrade ring, and reaching the configured stage
        # dumps a bundle. One None check while the recorder is off;
        # guarded because telemetry must never break admission.
        try:
            from ..obs import record as obs_record

            obs_record.note_degradation(frm, to, reason)
        except Exception:
            pass
        # zero-length marker span, the breaker-transition idiom:
        # degradations show up in the same profiler table as
        # fault/breaker events
        with RecordEvent("resilience/degrade." + STAGE_NAMES[to]):
            pass

    # ----------------------------------------------------- predicates
    @property
    def admission_controlled(self) -> bool:
        return self.stage >= STAGE_ADMISSION

    @property
    def preemption_enabled(self) -> bool:
        return self.stage >= STAGE_PREEMPTION

    def spec_enabled(self) -> bool:
        """Speculative decoding allowed right now? (Reversible — the
        batcher re-enables when the ladder walks back below stage 3.)"""
        return self.stage < STAGE_FEATURE_SHED

    def tighten_cache(self) -> bool:
        """Drop unreferenced prefix-cache blocks before refusing an
        admission? (stage >= 3)."""
        return self.stage >= STAGE_FEATURE_SHED

    def should_shed(self, priority) -> bool:
        """Reject this submit outright? (stage 4, lowest class(es))."""
        return (self.stage >= STAGE_LOAD_SHED
                and clamp_priority(priority)
                >= self.config.shed_priority)

    def may_admit(self, priority, needed_blocks: int,
                  used_blocks: int, num_blocks: int) -> bool:
        """Token-budget admission check (stage >= 1): may a request of
        this class reserve ``needed_blocks`` (the worst-case estimate
        KVCacheManager computes) given current pool use? Pure
        arithmetic — callers pass the numbers, the manager stays
        decoupled from the cache."""
        if self.stage < STAGE_ADMISSION:
            return True
        headroom = self.config.class_headroom
        p = clamp_priority(priority)
        h = headroom[p] if p < len(headroom) else headroom[-1]
        return (used_blocks + needed_blocks) <= num_blocks * (1.0 - h)

    def retry_after_s(self) -> float:
        """The Retry-After hint attached to shed rejections: the shared
        RetryPolicy's backoff for the current shed streak (longer
        overload -> longer hint), capped at the policy's max delay."""
        with self._lock:
            attempt = min(self._shed_streak, 16)
        return self.config.retry_policy.delay_s(attempt)

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """One health()-ready view of the ladder."""
        with self._lock:
            return {
                "stage": self._stage,
                "stage_name": STAGE_NAMES[self._stage],
                "stage_age_s": round(self._clock() - self._stage_since,
                                     3),
                "evaluations": self._evaluations,
                "transitions": len(self.transitions),
                "signals": dict(self.last_signals),
            }
