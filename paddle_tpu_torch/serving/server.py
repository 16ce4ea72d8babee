"""Thread-based inference server (counterpart of
paddle_tpu/serving/server.py): bounded request queue (backpressure via
queue-full rejection), per-request deadlines, one worker loop driving
the dynamic batcher, the circuit breaker and the degradation ladder,
``health()``, and graceful drain-and-shutdown.

Layering: clients -> submit()/infer() -> bounded queue ->
DynamicBatcher (coalesce) -> BucketedEngine (pad to a bucket, its
captured graph on a card) -> futures resolve per request. The decode
session (decoding/session.py) is a subclass whose worker runs the
continuous batching loop instead.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.enforce import enforce
from .batcher import DynamicBatcher, Request, deliver
from .engine import BucketedEngine, ServingConfig
from .errors import (CircuitOpenError, OverloadedError, QueueFullError,
                     ServerClosedError)
from .metrics import ServingMetrics

_STOP = object()  # queue sentinel: wakes the worker for shutdown


class InferenceServer:
    """Serve a bucketed engine to many concurrent callers.

    One worker thread owns the engine (device work stays
    single-threaded); client threads block on per-request futures.
    Use as a context manager for deterministic drain on exit.
    """

    def __init__(self, engine: BucketedEngine,
                 config: Optional[ServingConfig] = None,
                 auto_start: bool = True):
        self.engine = engine
        self.config = config or engine.config
        self.metrics: ServingMetrics = engine.metrics
        # a server-level config overrides the engine's batching knobs
        # too, not just the queue ones
        self.batcher = DynamicBatcher(
            engine, metrics=self.metrics,
            max_batch_size=self.config.max_batch_size,
            batch_timeout_ms=self.config.batch_timeout_ms)
        self._queue: _queue.Queue = _queue.Queue(
            maxsize=self.config.queue_capacity)
        self._closed = False
        self._abort = False  # shutdown(drain=False): fail pending fast
        self._lock = threading.Lock()
        self._worker: Optional[threading.Thread] = None
        self._wire_breaker()
        if auto_start:
            self.start()

    def _wire_breaker(self) -> None:
        """Attach the config's circuit breaker (None = disabled): the
        batcher records executed-batch outcomes, submit() consults
        ``allow()`` and feeds queue pressure, transitions count into
        the metrics."""
        self.breaker = getattr(self.config, "breaker", None)
        self._last_progress_t: Optional[float] = None
        if self.breaker is not None:
            self.batcher.breaker = self.breaker
            if self.breaker.on_transition is None:
                self.breaker.on_transition = (
                    lambda frm, to, reason:
                    self.metrics.inc("breaker_transitions"))
        self._wire_degrade()

    def _wire_degrade(self) -> None:
        """Attach the config's degradation ladder (None = disabled,
        byte-identical admission). Accepts a DegradationConfig or a
        pre-built DegradationManager; binds the metrics so the
        ``degradation_stage`` gauge tracks the ladder."""
        from ..resilience.degrade import (DegradationManager,
                                          clamp_priority)

        self._clamp_priority = clamp_priority
        d = getattr(self.config, "degrade", None)
        if d is None:
            self.degrade = None
            return
        self.degrade = (d if isinstance(d, DegradationManager)
                        else DegradationManager(d))
        self.degrade.bind_metrics(self.metrics)

    def _degrade_signals(self) -> dict:
        """The pressure snapshot the ladder evaluates — the signals the
        stack already exposes (queue backlog, breaker, progress age).
        The decode session extends this with pool pressure and the
        decode-step latency EMA."""
        now = time.monotonic()
        return {
            "queue_frac": (self._queue.qsize()
                           / max(1, self.config.queue_capacity)),
            "pool_frac": 0.0,
            "breaker_open": (self.breaker is not None
                             and self.breaker.state != "closed"),
            "step_ms_ema": None,
            "progress_age_s": (
                None if self._last_progress_t is None
                else now - self._last_progress_t),
        }

    def _admit(self, priority=None) -> None:
        """Shared submit-side gate: breaker open ⇒ shed load with the
        typed retriable error instead of queueing doomed work; ladder
        at stage 4 ⇒ shed the lowest class(es) with the typed
        retriable OverloadedError + Retry-After hint. The closed check
        comes FIRST — a shut-down server must fail fast with the FATAL
        error, not feed a client's retry loop an open-breaker signal it
        can never outwait."""
        if self._closed:
            raise ServerClosedError("server is shut down")
        if self.breaker is not None and not self.breaker.allow():
            self.metrics.inc("breaker_rejections")
            raise CircuitOpenError(
                "circuit breaker is %s — load is being shed while the "
                "engine recovers; retry after >= %.1fs"
                % (self.breaker.state, self.breaker.reset_timeout_s))
        if self.degrade is not None:
            pr = self._clamp_priority(priority)
            if self.degrade.should_shed(pr):
                self.metrics.note_admission_rejected(pr)
                hint = self.degrade.retry_after_s()
                raise OverloadedError(
                    "overloaded (degradation stage %d, %s) — priority "
                    "class %d is being shed; retry after >= %.2fs"
                    % (self.degrade.stage, self.degrade.stage_name,
                       pr, hint), retry_after_s=hint)

    # ------------------------------------------------------------------
    @property
    def fetch_names(self) -> List[str]:
        return list(self.engine.fetch_names)

    @property
    def running(self) -> bool:
        return self._worker is not None and self._worker.is_alive()

    def start(self) -> "InferenceServer":
        with self._lock:
            enforce(not self._closed, "server is shut down")
            if self.running:
                return self
            if self.config.warm_up:
                self.engine.warm_up()
            self._worker = threading.Thread(
                target=self._worker_main, name="paddle-tpu-torch-serving",
                daemon=True)
            self._worker.start()
        # register this stack's health() as an obs source (unregistered
        # at shutdown): /healthz sees the serving tier without wiring
        from ..obs import metrics as obs_metrics

        obs_metrics.register_health(self.metrics.sink, self.health)
        return self

    def _worker_main(self) -> None:
        """Worker-thread entry (the decode session's continuous loop
        too): pin the thread to the engine's card (its default stream),
        then loop. Anything escaping the loop is the catastrophic case
        every later request hangs on: dump a post-mortem bundle on the
        way down (no-op when the recorder is off), then re-raise so the
        death stays loud."""
        try:
            device = self.engine.device
            if device.type == "cuda":
                torch.cuda.set_device(device)
            self._worker_loop()
        except BaseException as e:
            from ..obs import record as obs_record

            obs_record.record_exception(
                e, context="%s.worker" % type(self).__name__)
            raise

    # ------------------------------------------------------------------
    def submit(self, feed: Dict[str, np.ndarray],
               deadline_ms: Optional[float] = None,
               priority: Optional[int] = None):
        """Enqueue one request; returns a concurrent.futures.Future that
        resolves to the fetch list (np arrays, in fetch_names order).

        Raises QueueFullError when the bounded queue is at capacity and
        ServerClosedError after shutdown began. ``priority`` (a
        ``resilience.PRIORITY_*`` class, default normal) only matters
        with the degradation ladder enabled: the lowest class(es) are
        shed first under overload (typed retriable OverloadedError)."""
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        if self.degrade is not None:
            # the plain server has no per-iteration worker hook, so the
            # ladder evaluates on the submit path (thread-safe)
            self.degrade.evaluate(self._degrade_signals())
        self._admit(priority)
        req = Request(feed, deadline_ms=deadline_ms)
        self.metrics.inc("requests_total")
        from ..obs import trace as obs_trace

        # one request = one trace: the enqueue span is the trace ROOT;
        # the worker's batcher/engine spans attach to it via req.trace
        # (no-op context, no recording, while tracing is off)
        with obs_trace.root_span("serving/enqueue") as tctx:
            req.trace = tctx
            req.future.trace_ctx = tctx
            # closed-check and enqueue under the lock: a submit racing
            # shutdown() must never land AFTER the stop sentinel (its
            # future would otherwise hang unresolved once the worker
            # exits)
            with self._lock:
                if self._closed:
                    raise ServerClosedError("server is shut down")
                try:
                    self._queue.put_nowait(req)
                except _queue.Full:
                    self.metrics.inc("queue_full_rejections")
                    if self.breaker is not None:
                        self.breaker.record_pressure(True)
                    raise QueueFullError(
                        "request queue full (capacity %d) — shed load "
                        "or raise queue_capacity"
                        % self.config.queue_capacity) from None
        if self.breaker is not None:
            self.breaker.record_pressure(False)
        self.metrics.queue_depth = self._queue.qsize()
        return req.future

    def infer(self, feed: Dict[str, np.ndarray],
              deadline_ms: Optional[float] = None,
              priority: Optional[int] = None,
              timeout: Optional[float] = None) -> List[np.ndarray]:
        """Synchronous convenience wrapper over :meth:`submit`."""
        return self.submit(feed, deadline_ms=deadline_ms,
                           priority=priority).result(timeout=timeout)

    # ------------------------------------------------------------------
    def _worker_loop(self) -> None:
        while True:
            if self._abort:
                self._fail_pending()
                return
            batch = self.batcher.next_batch(self._queue, _STOP)
            self.metrics.queue_depth = self._queue.qsize()
            if batch is None:  # sentinel, queue drained
                return
            if self._abort:
                for r in batch:
                    deliver(r.future, exc=ServerClosedError(
                        "server shut down before this request executed"))
                self._fail_pending()
                return
            try:
                self.batcher.run_batch(batch)
                self._last_progress_t = time.monotonic()
                if self.degrade is not None:
                    # walk the ladder back as the backlog drains even
                    # when no new submits arrive to evaluate it
                    self.degrade.evaluate(self._degrade_signals())
            except Exception as e:
                # engine errors are handled inside run_batch; anything
                # escaping is a delivery-path bug — fail this batch's
                # futures but NEVER kill the worker (a dead worker hangs
                # every later request forever)
                for r in batch:
                    deliver(r.future, exc=e)

    def _fail_pending(self) -> None:
        carry = self.batcher._carry
        self.batcher._carry = None
        pending = [carry] if carry is not None else []
        while True:
            try:
                item = self._queue.get_nowait()
            except _queue.Empty:
                break
            if item is not _STOP:
                pending.append(item)
        for r in pending:
            deliver(r.future, exc=ServerClosedError(
                "server shut down before this request executed"))
        self.metrics.queue_depth = 0

    # ------------------------------------------------------------------
    def health(self) -> Dict[str, object]:
        """One status snapshot for probes/ops:
        serving state, queue depth vs capacity, breaker state, age of
        the last completed batch/step, and the error counters a load
        balancer would key on. Cheap (no locks beyond the metrics') —
        safe to poll."""
        now = time.monotonic()
        status = "serving"
        if self._closed:
            status = "draining" if self.running else "shutdown"
        elif not self.running:
            status = "stopped"
        out: Dict[str, object] = {
            "status": status,
            "queue_depth": self._queue.qsize(),
            "queue_capacity": self.config.queue_capacity,
            "breaker": (self.breaker.snapshot() if self.breaker
                        is not None else {"state": "disabled"}),
            "last_progress_age_s": (
                None if self._last_progress_t is None
                else round(now - self._last_progress_t, 3)),
            "requests_total": self.metrics.get("requests_total"),
            "request_errors": self.metrics.get("request_errors"),
            "queue_full_rejections":
                self.metrics.get("queue_full_rejections"),
            "breaker_rejections": self.metrics.get("breaker_rejections"),
            "degradation_stage": (self.degrade.stage
                                  if self.degrade is not None else 0),
        }
        if self.degrade is not None:
            out["degradation"] = self.degrade.snapshot()
        return out

    # ------------------------------------------------------------------
    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop the server. ``drain=True`` (graceful): stop accepting,
        finish every in-flight and queued request, then exit.
        ``drain=False``: fail queued requests with ServerClosedError."""
        from ..obs import metrics as obs_metrics

        obs_metrics.unregister_health(self.metrics.sink)
        with self._lock:
            already = self._closed
            self._closed = True
            if not drain:
                self._abort = True
            worker = self._worker
        if worker is None or not worker.is_alive():
            self._fail_pending()
            return
        if not already:
            self._queue.put(_STOP)
        worker.join(timeout=timeout)

    def __enter__(self) -> "InferenceServer":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.shutdown(drain=exc == (None, None, None))
        return False


def serve_program(program_or_model_dir, feed_names: Optional[
        Sequence[str]] = None, fetch_list: Optional[Sequence] = None,
        scope=None, config: Optional[ServingConfig] = None,
        place=None, auto_start: bool = True) -> InferenceServer:
    """One-call entry point: build the bucketed engine on ``place``
    (default ``CUDAPlace(0)``) and start a server over it.

    Pass a ``save_inference_model`` directory (str) for the artifact
    backend (``BucketedEngine.from_artifact``: no program, no scope), or
    an in-memory Program plus ``feed_names``/``fetch_list`` (and the
    scope holding its parameters on that place) for the executor
    backend.
    """
    if isinstance(program_or_model_dir, str):
        engine = BucketedEngine.from_artifact(program_or_model_dir,
                                              config=config, place=place)
    else:
        engine = BucketedEngine.from_program(
            program_or_model_dir, feed_names=feed_names,
            fetch_list=fetch_list, scope=scope, config=config,
            place=place)
    return InferenceServer(engine, auto_start=auto_start)
