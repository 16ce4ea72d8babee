"""Dynamic micro-batching (counterpart of paddle_tpu/serving/batcher.py):
coalesce queued requests until the batch is full or the timeout window
closes, run it once through the bucketed engine, and split the fetches
back to per-request futures in order.

The Clipper/ORCA trade: a few ms of queueing buy a run at a bucket
shape the engine already prepared (on a card: a captured graph), so
throughput scales with batch size while the set of graphs stays at
``len(buckets)``.
"""

from __future__ import annotations

import queue as _queue
import time
from concurrent.futures import Future, InvalidStateError
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.enforce import enforce
from .engine import BucketedEngine
from .errors import DeadlineExceededError
from .metrics import ServingMetrics

BATCHER_SPAN = "serving/batcher"


def deliver(future: Future, result=None, exc: Optional[BaseException]
            = None) -> None:
    """Resolve a request future, tolerating the client's own
    cancellation: set_result/set_exception raise InvalidStateError on a
    Future the caller already cancelled, and that must never kill the
    worker. Any other error propagates."""
    try:
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(result)
    except InvalidStateError:
        pass  # cancelled by the client: it gave up on the result


class Request:
    """One queued inference request: a feed dict (leading batch axis on
    every array), the future its caller waits on, and bookkeeping."""

    __slots__ = ("feed", "rows", "future", "enqueue_t", "deadline_t",
                 "trace")

    def __init__(self, feed: Dict[str, np.ndarray],
                 deadline_ms: Optional[float] = None):
        # per-request trace context (obs.trace; None when tracing is
        # off) — stamped by the server's submit path so the worker's
        # batch/engine spans join the request's trace
        self.trace = None
        self.feed = {k: np.asarray(v) for k, v in feed.items()}
        enforce(self.feed, "empty feed")
        rows = None
        for n, a in self.feed.items():
            enforce(a.ndim >= 1,
                    "request feed %r must have a leading batch axis" % n)
            rows = a.shape[0] if rows is None else rows
            enforce(a.shape[0] == rows,
                    "request feed %r batch %s disagrees with %s"
                    % (n, a.shape[0], rows))
        self.rows = int(rows)
        enforce(self.rows >= 1, "request feed has zero rows")
        self.future: Future = Future()
        self.enqueue_t = time.monotonic()
        self.deadline_t = (self.enqueue_t + deadline_ms / 1e3
                           if deadline_ms is not None else None)

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline_t is not None
                and (now or time.monotonic()) > self.deadline_t)

    def signature(self):
        """Coalescing key: feed names + per-row shapes + dtypes."""
        return tuple(sorted(
            (n, a.shape[1:], str(a.dtype)) for n, a in self.feed.items()))


def concat_feeds(requests: Sequence[Request]) -> Dict[str, np.ndarray]:
    if len(requests) == 1:
        return requests[0].feed
    names = requests[0].feed.keys()
    return {n: np.concatenate([r.feed[n] for r in requests], axis=0)
            for n in names}


def split_fetches(outs: List[np.ndarray], requests: Sequence[Request],
                  total_rows: int,
                  batched_mask: Optional[Sequence[bool]] = None
                  ) -> List[List[np.ndarray]]:
    """Slice batch-major fetches back to per-request chunks, in request
    order. Fetches whose leading dim is not the batch (e.g. scalar
    metrics) are replicated to every request. ``batched_mask`` (from
    the engine's bucket calibration) overrides the leading-dim
    heuristic when available."""
    per_request: List[List[np.ndarray]] = [[] for _ in requests]
    for j, o in enumerate(outs):
        batched = (hasattr(o, "ndim") and o.ndim >= 1
                   and o.shape[0] == total_rows)
        if batched and batched_mask is not None and j < len(batched_mask):
            batched = batched_mask[j]
        start = 0
        for i, r in enumerate(requests):
            per_request[i].append(o[start:start + r.rows] if batched
                                  else o)
            start += r.rows
    return per_request


class DynamicBatcher:
    """Coalesces requests from a queue and drives the engine.

    Single consumer: exactly one worker thread calls :meth:`next_batch`
    and :meth:`run_batch` (the server's worker loop). The producer side
    is the server's ``submit``.
    """

    def __init__(self, engine: BucketedEngine,
                 metrics: Optional[ServingMetrics] = None,
                 max_batch_size: Optional[int] = None,
                 batch_timeout_ms: Optional[float] = None):
        self.engine = engine
        self.metrics = metrics or engine.metrics
        cfg = engine.config
        self.max_batch_size = max_batch_size or cfg.max_batch_size
        self.batch_timeout_ms = (cfg.batch_timeout_ms
                                 if batch_timeout_ms is None
                                 else batch_timeout_ms)
        # set by the server when a circuit breaker is configured: the
        # batcher is the one place that sees engine outcomes
        self.breaker = None
        # an incompatible/overflow request popped while closing a batch
        # seeds the next one — never dropped, order preserved
        self._carry: Optional[Request] = None
        # set once the shutdown sentinel is consumed: from then on the
        # batcher drains without blocking and next_batch returns None
        # when nothing is pending
        self.stop_seen = False

    # ------------------------------------------------------------------
    def _get(self, q: "_queue.Queue", timeout: Optional[float]):
        """Queue pop honoring drain mode: after the sentinel, never
        block (the producer side is closed; only leftovers remain)."""
        if self.stop_seen:
            return q.get_nowait()
        if timeout is None:
            return q.get()
        if timeout <= 0:
            raise _queue.Empty
        return q.get(timeout=timeout)

    def next_batch(self, q: "_queue.Queue", stop_sentinel) -> Optional[
            List[Request]]:
        """Block for the first live request, then coalesce until the
        batch is full, the timeout window closes, or an incompatible
        request arrives (carried to the next batch). Returns None once
        the sentinel has been seen and nothing is pending."""
        first = self._carry
        self._carry = None
        if first is not None and self._expire(first):
            first = None  # carried across a slow batch, now expired
        while first is None:
            try:
                item = self._get(q, None)
            except _queue.Empty:
                return None
            if item is stop_sentinel:
                self.stop_seen = True
                continue
            if self._expire(item):
                continue
            first = item

        batch = [first]
        rows = first.rows
        sig = first.signature()
        window_end = time.monotonic() + self.batch_timeout_ms / 1e3
        while rows < self.max_batch_size:
            try:
                item = self._get(q, window_end - time.monotonic())
            except _queue.Empty:
                break
            if item is stop_sentinel:
                self.stop_seen = True
                continue  # drain mode: keep coalescing leftovers
            if self._expire(item):
                continue
            if (item.signature() != sig
                    or rows + item.rows > self.max_batch_size):
                self._carry = item
                break
            batch.append(item)
            rows += item.rows
        return batch

    def _expire(self, req: Request) -> bool:
        if req.expired():
            self.metrics.inc("deadline_expired")
            deliver(req.future, exc=DeadlineExceededError(
                "request exceeded its deadline while queued "
                "(waited %.1f ms)"
                % ((time.monotonic() - req.enqueue_t) * 1e3)))
            return True
        return False

    # ------------------------------------------------------------------
    def run_batch(self, requests: Sequence[Request]) -> None:
        """Execute one coalesced batch and deliver per-request results.

        A failing batch never poisons its neighbors: on error the batch
        re-executes one request at a time, so only the offending
        request's future carries the exception."""
        now = time.monotonic()
        for r in requests:
            self.metrics.observe(self.metrics.queue_wait,
                                 (now - r.enqueue_t) * 1e3)
        total = sum(r.rows for r in requests)
        from ..obs import trace as obs_trace

        # the coalesced batch serves many traces at once; its spans
        # attach to the FIRST traced request's context (the others keep
        # their own enqueue/deliver spans)
        ctx = next((r.trace for r in requests if r.trace is not None),
                   None)
        with obs_trace.attach(ctx), self.metrics.span(BATCHER_SPAN):
            self.metrics.inc("batches_total")
            self.metrics.observe(self.metrics.batch_size, total)
            try:
                outs = self.engine.run(concat_feeds(requests))
            except Exception as e:
                if len(requests) == 1:
                    self.metrics.inc("request_errors")
                    if self.breaker is not None:
                        self.breaker.record_failure()
                    deliver(requests[0].future, exc=e)
                    return
                for r in requests:  # isolate the poison request
                    self._run_one(r)
                return
            if self.breaker is not None:
                self.breaker.record_success()
            mask = getattr(self.engine, "batched_fetch_mask", None)
            for r, chunk in zip(requests,
                                split_fetches(outs, requests, total,
                                              batched_mask=mask)):
                deliver(r.future, chunk)
                self.metrics.inc("responses_total")

    def _run_one(self, req: Request) -> None:
        """Individual re-execution after a batch failure: only the
        request that actually fails carries the exception."""
        try:
            outs = self.engine.run(req.feed)
        except Exception as e:
            self.metrics.inc("request_errors")
            if self.breaker is not None:
                self.breaker.record_failure()
            deliver(req.future, exc=e)
        else:
            if self.breaker is not None:
                self.breaker.record_success()
            deliver(req.future, outs)
            self.metrics.inc("responses_total")
