"""Circuit breaker for the serving layer (counterpart of
paddle_tpu/resilience/breaker.py).

Three states, sized for the worker model of InferenceServer and
DecodeSession: the WORKER thread records outcomes (it is the single
consumer that sees engine errors), client threads consult ``allow()``
inside ``submit`` — so everything is guarded by one lock::

    CLOSED ──(error rate over the outcome window, or sustained
              queue saturation)──▶ OPEN
    OPEN ──(reset_timeout_s elapsed)──▶ HALF_OPEN
    HALF_OPEN ──(half_open_probes successes)──▶ CLOSED
    HALF_OPEN ──(any failure)──▶ OPEN

While OPEN, ``allow()`` is False and the server sheds load with the
typed retriable ``serving.CircuitOpenError``. Every transition is
recorded (``transitions`` and the ``on_transition`` hook, which the
server wires to its metrics counter) and marked by a
``resilience/breaker.<to-state>`` profiler span.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, Optional

from ..profiler import RecordEvent

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Error-rate + queue-pressure circuit breaker.

    window: sliding window of recent outcomes the error rate is
        computed over.
    min_samples: outcomes required in the window before the rate can
        trip (a single early failure must not open a cold breaker).
    failure_rate: trip threshold on failures/window.
    queue_trip_after: consecutive queue-full rejections that trip the
        breaker regardless of error rate (sustained saturation is
        degradation even when every executed batch succeeds).
    reset_timeout_s: OPEN hold time before probing.
    half_open_probes: successful probes required to close again.
    """

    def __init__(self, window: int = 32, min_samples: int = 8,
                 failure_rate: float = 0.5,
                 queue_trip_after: int = 8,
                 reset_timeout_s: float = 1.0,
                 half_open_probes: int = 1,
                 on_transition: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.failure_rate = float(failure_rate)
        self.queue_trip_after = int(queue_trip_after)
        self.reset_timeout_s = float(reset_timeout_s)
        self.half_open_probes = int(half_open_probes)
        self.on_transition = on_transition
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._outcomes: deque = deque(maxlen=self.window)
        self._consecutive_full = 0
        self._opened_at = 0.0
        self._probes_in_flight = 0
        self._probe_successes = 0
        self._probe_granted_at = 0.0
        self.transitions: List[dict] = []  # [{t, from, to, reason}]

    # ------------------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, to: str, reason: str) -> None:
        # caller holds the lock
        frm, self._state = self._state, to
        self.transitions.append({"t": self._clock(), "from": frm,
                                 "to": to, "reason": reason})
        if to == OPEN:
            self._opened_at = self._clock()
        if to == HALF_OPEN:
            self._probes_in_flight = 0
            self._probe_successes = 0
        if to == CLOSED:
            self._outcomes.clear()
            self._consecutive_full = 0
        hook = self.on_transition
        if hook is not None:
            try:
                hook(frm, to, reason)
            except Exception:
                pass  # a metrics hook must never break admission
        # zero-length marker span: transitions show up in the same
        # profiler table as the fault spans
        with RecordEvent("resilience/breaker." + to):
            pass

    # ------------------------------------------------------------------
    def allow(self) -> bool:
        """May one more request be admitted right now? (HALF_OPEN hands
        out at most ``half_open_probes`` concurrent trial slots.)"""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at < self.reset_timeout_s:
                    return False
                self._transition(HALF_OPEN, "reset_timeout")
            # HALF_OPEN
            if self._probes_in_flight >= self.half_open_probes and \
                    self._clock() - self._probe_granted_at \
                    >= self.reset_timeout_s:
                # a granted probe whose outcome was never recorded (the
                # request expired in the queue, the client abandoned it)
                # must not wedge the breaker in HALF_OPEN forever —
                # after another reset window, assume it lost and re-arm
                self._probes_in_flight = 0
            if self._probes_in_flight < self.half_open_probes:
                self._probes_in_flight += 1
                self._probe_granted_at = self._clock()
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._probe_successes += 1
                if self._probe_successes >= self.half_open_probes:
                    self._transition(CLOSED, "probe_success")
                return
            self._outcomes.append(0)
            self._consecutive_full = 0

    def record_failure(self, reason: str = "error") -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._transition(OPEN, "probe_failure")
                return
            self._outcomes.append(1)
            if self._state != CLOSED:
                return
            n = len(self._outcomes)
            if n >= self.min_samples and \
                    sum(self._outcomes) / n >= self.failure_rate:
                self._transition(OPEN, reason)

    def record_pressure(self, full: bool) -> None:
        """Queue saturation signal from ``submit``: ``full=True`` on a
        queue-full rejection, ``False`` on a successful enqueue.
        ``queue_trip_after`` consecutive rejections open the breaker."""
        with self._lock:
            if not full:
                self._consecutive_full = 0
                return
            self._consecutive_full += 1
            if (self._state == CLOSED
                    and self._consecutive_full >= self.queue_trip_after):
                self._transition(OPEN, "queue_depth")

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            n = len(self._outcomes)
            return {
                "state": self._state,
                "window_samples": n,
                "window_failures": sum(self._outcomes),
                "consecutive_queue_full": self._consecutive_full,
                "transitions": len(self.transitions),
                "open_age_s": (round(self._clock() - self._opened_at, 3)
                               if self._state == OPEN else None),
            }
