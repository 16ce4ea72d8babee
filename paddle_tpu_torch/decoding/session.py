"""DecodeSession: the server layer of the decode subsystem (counterpart
of paddle_tpu/decoding/session.py).

An InferenceServer whose worker runs the CONTINUOUS batching loop:
bounded submit queue with backpressure, per-sequence deadlines (queued
and mid-generation), streaming token callbacks, graceful drain —
``shutdown(drain=True)`` finishes every in-flight generation,
``shutdown(drain=False)`` flushes partial streams with the typed
GenerationInterruptedError (futures are always resolved, never
dropped). Requests carry a :class:`SamplingParams` (mixed greedy and
sampled requests share one batch) and a priority class, and a draft
engine enables speculative decoding (``serve_decoding(draft_program=
...)`` builds it; the draft owns its own scope and KV pools).

``DecodingConfig(breaker=, degrade=)`` wire the serving layer's circuit
breaker and degradation ladder: the ladder evaluates once per worker
iteration over the queue backlog, the KV pool's pressure, the breaker
state and the decode-step EMA; each request is one trace rooted at its
``decoding/enqueue`` span when ``obs.trace`` is on.
"""

from __future__ import annotations

import queue as _queue
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..core.enforce import enforce
from ..serving.batcher import deliver
from ..serving.errors import (DeadlineExceededError,
                              GenerationInterruptedError,
                              PromptTooLongError, QueueFullError,
                              ServerClosedError)
from ..serving.server import _STOP, InferenceServer
from .batcher import ContinuousBatcher
from .cache import CacheConfig, KVCacheManager
from .engine import DecodeEngine, DecodingConfig
from .sampling import GREEDY, SamplingParams


class GenerationRequest:
    """One queued generation: prompt ids, budget, stop condition,
    sampling config, priority class, optional streaming callback, and
    the future its caller waits on (resolves to the list of GENERATED
    token ids; eos, when configured and produced, is included as the
    last token).

    ``priority`` (a ``resilience.PRIORITY_*`` class, default normal)
    matters only under the degradation ladder: lower classes are
    budget-limited, preempted, and shed first. ``resume_tokens`` is
    batcher-owned preemption state — the tokens already emitted before
    the sequence was evicted back to the queue; they preload the
    resumed stream (and are what a shutdown/deadline surfaces as the
    partial stream in ``GenerationInterruptedError.tokens``)."""

    __slots__ = ("prompt", "max_new_tokens", "eos_id", "on_token",
                 "future", "enqueue_t", "deadline_t", "trace",
                 "sampling", "prefix_keys", "priority", "resume_tokens")

    def __init__(self, prompt, max_new_tokens: int,
                 eos_id: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 on_token: Optional[Callable[[int], None]] = None,
                 sampling: Optional[SamplingParams] = None,
                 priority: Optional[int] = None):
        # per-request trace context (obs.trace; None when tracing is
        # off): the session's submit path stamps it so prefill/decode/
        # stream spans across the worker thread join ONE trace
        self.trace = None
        self.prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        enforce(len(self.prompt) >= 1, "empty prompt")
        enforce(int(max_new_tokens) >= 1, "max_new_tokens must be >= 1")
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.on_token = on_token
        self.sampling = sampling or GREEDY
        from ..resilience.degrade import clamp_priority

        self.priority = clamp_priority(priority)
        self.resume_tokens: List[int] = []
        # chain-hash memo (batcher-owned): the prompt is immutable, so
        # its prefix keys are computed once per request, not once per
        # blocked-admission poll (preemption resets it — the effective
        # prompt grows by the resumed span)
        self.prefix_keys = None
        self.future: Future = Future()
        self.enqueue_t = time.monotonic()
        self.deadline_t = (self.enqueue_t + deadline_ms / 1e3
                           if deadline_ms is not None else None)

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline_t is not None
                and (now or time.monotonic()) > self.deadline_t)


class DecodeSession(InferenceServer):
    """Serve continuous-batched autoregressive generation.

    One worker thread owns the engine(s) (device work stays
    single-threaded); client threads block on per-request futures or
    stream tokens via ``on_token`` callbacks (invoked from the worker —
    keep them cheap). Use as a context manager for deterministic drain.

    ``draft_engine`` (optional) enables speculative decoding: a small
    DecodeEngine over a cheap model, with its OWN scope/pools, whose
    proposals the target verifies in one multi-token step. Requires
    ``DecodingConfig(speculate_k >= 1)`` on the target engine.
    """

    def __init__(self, engine: DecodeEngine,
                 config: Optional[DecodingConfig] = None,
                 auto_start: bool = True,
                 draft_engine: Optional[DecodeEngine] = None):
        import threading

        self.engine = engine
        self.config = config or engine.config
        self.metrics = engine.metrics
        self.draft_engine = draft_engine
        self.batcher = ContinuousBatcher(engine, metrics=self.metrics,
                                         draft=draft_engine)
        self._waiting: List[GenerationRequest] = []
        self._queue: _queue.Queue = _queue.Queue(
            maxsize=self.config.queue_capacity)
        self._closed = False
        self._abort = False
        self._stop_seen = False
        # prefix-cache hit/miss totals at the LAST health() snapshot —
        # health() reports the hit rate over the window between
        # snapshots, not the lifetime average
        self._prefix_snap = (0, 0)
        self._lock = threading.Lock()
        self._worker = None
        self._wire_breaker()  # config.breaker/.degrade; None = disabled
        self.batcher.degrade = self.degrade
        if auto_start:
            self.start()

    def start(self) -> "DecodeSession":
        # the draft engine warms (on a card: captures) its own bucket
        # set alongside the target's
        if self.draft_engine is not None and self.config.warm_up \
                and not self.running:
            self.draft_engine.warm_up()
        return super().start()

    # ------------------------------------------------------------------
    @property
    def kv(self) -> KVCacheManager:
        return self.batcher.kv

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_id: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               on_token: Optional[Callable[[int], None]] = None,
               sampling: Optional[SamplingParams] = None,
               priority: Optional[int] = None,
               resume_tokens: Optional[Sequence[int]] = None
               ) -> Future:
        """Enqueue one generation; returns a Future resolving to the
        generated token ids. Raises QueueFullError at capacity
        (backpressure), ServerClosedError after shutdown began, and
        PromptTooLongError for requests this cache geometry can never
        hold. ``sampling`` (a SamplingParams) needs an engine built
        with ``DecodingConfig(sampling=True)`` — greedy defaults work
        everywhere. ``priority`` (a ``resilience.PRIORITY_*`` class)
        only matters with ``DecodingConfig(degrade=...)``: lower
        classes are budget-limited, preempted, and — at stage 4 — shed
        with the typed retriable OverloadedError.

        ``resume_tokens`` preloads the stream with tokens already
        emitted by a PREVIOUS attempt of this generation: the sequence
        continues in the original prompt's coordinate frame — position
        math, the max_new_tokens budget and seeded sampling's
        stream-positional keys all pick up exactly where the prior
        attempt stopped, and the preloaded tokens are never
        re-streamed."""
        if max_new_tokens is None:
            max_new_tokens = self.config.max_new_tokens
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        if sampling is not None and not sampling.greedy:
            enforce(self.engine.sampling,
                    "this session was built without the sampling head "
                    "(DecodingConfig(sampling=True)) — non-greedy "
                    "SamplingParams cannot be served")
        req = GenerationRequest(prompt, max_new_tokens, eos_id=eos_id,
                                deadline_ms=deadline_ms,
                                on_token=on_token, sampling=sampling,
                                priority=priority)
        if resume_tokens:
            resumed = [int(t) for t in resume_tokens]
            enforce(len(resumed) < req.max_new_tokens,
                    "resume_tokens already carries %d tokens but "
                    "max_new_tokens is %d — nothing left to generate"
                    % (len(resumed), req.max_new_tokens))
            req.resume_tokens = resumed
            req.prefix_keys = None  # the effective prompt grew
        cache = self.engine.cache_config
        if len(req.prompt) + req.max_new_tokens > cache.max_context or \
                self.engine.prompt_bucket_for(len(req.prompt)) is None:
            raise PromptTooLongError(
                "prompt %d + max_new_tokens %d exceeds max_context %d "
                "(block_size %d x max_blocks_per_seq %d)"
                % (len(req.prompt), req.max_new_tokens,
                   cache.max_context, cache.block_size,
                   cache.max_blocks_per_seq))
        self._admit(req.priority)  # breaker/ladder ⇒ typed retriable shed
        self.metrics.inc("requests_total")
        from ..obs import trace as obs_trace

        # one request = one trace, rooted at the enqueue span; the
        # worker's prefill/decode/stream spans and any consumer thread
        # attaching future.trace_ctx all join it (no-op when tracing
        # is off)
        with obs_trace.root_span("decoding/enqueue") as tctx:
            req.trace = tctx
            req.future.trace_ctx = tctx
            with self._lock:
                if self._closed:
                    raise ServerClosedError("session is shut down")
                try:
                    self._queue.put_nowait(req)
                except _queue.Full:
                    self.metrics.inc("queue_full_rejections")
                    if self.breaker is not None:
                        self.breaker.record_pressure(True)
                    raise QueueFullError(
                        "generation queue full (capacity %d) — shed "
                        "load or raise queue_capacity"
                        % self.config.queue_capacity) from None
        if self.breaker is not None:
            self.breaker.record_pressure(False)
        self.metrics.queue_depth = self._queue.qsize()
        return req.future

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 on_token: Optional[Callable[[int], None]] = None,
                 sampling: Optional[SamplingParams] = None,
                 priority: Optional[int] = None,
                 timeout: Optional[float] = None) -> List[int]:
        """Synchronous convenience wrapper over :meth:`submit`."""
        return self.submit(prompt, max_new_tokens, eos_id=eos_id,
                           deadline_ms=deadline_ms,
                           on_token=on_token, sampling=sampling,
                           priority=priority).result(timeout=timeout)

    # ------------------------------------------------------------------
    def _pump_queue(self, block: bool) -> None:
        """Move everything available from the queue into the FIFO
        waiting list; optionally block for the first item (idle
        worker). The stop sentinel flips drain mode."""
        first = block
        while True:
            try:
                item = self._queue.get(timeout=0.1) if first \
                    else self._queue.get_nowait()
            except _queue.Empty:
                return
            first = False
            if item is _STOP:
                self._stop_seen = True
                continue
            self._waiting.append(item)

    def _expire_waiting(self) -> None:
        now = time.monotonic()
        for req in list(self._waiting):
            if req.expired(now):
                self._waiting.remove(req)
                self.metrics.inc("deadline_expired")
                err = DeadlineExceededError(
                    "generation request exceeded its deadline while "
                    "queued (waited %.1f ms)"
                    % ((now - req.enqueue_t) * 1e3))
                # a preempted-then-expired request still surfaces its
                # partial stream, like every interrupted generation
                err.tokens = list(req.resume_tokens)
                deliver(req.future, exc=err)

    def _degrade_signals(self) -> dict:
        """The decode-tier pressure snapshot: the serving signals plus
        KV block-pool pressure and the decode-step latency EMA. The
        queue backlog counts the internal waiting list too — the pump
        drains the submit queue each iteration, so qsize alone would
        read 0 under a flood."""
        out = super()._degrade_signals()
        kv = self.batcher.kv
        out["queue_frac"] = (
            (self._queue.qsize() + len(self._waiting))
            / max(1, self.config.queue_capacity))
        out["pool_frac"] = 1.0 - (kv.reclaimable_blocks
                                  / max(1, kv.config.num_blocks))
        out["step_ms_ema"] = self.metrics.step_ms_ema or None
        return out

    def _worker_loop(self) -> None:
        while True:
            if self._abort:
                self.batcher.interrupt_all(
                    "session shut down (drain=False) mid-generation")
                self._fail_pending()
                return
            idle = not self.batcher.active and not self._waiting
            self._pump_queue(block=idle and not self._stop_seen)
            self.metrics.queue_depth = self._queue.qsize()
            if self._abort:
                continue  # re-check before doing work after a block
            self._expire_waiting()
            if self.degrade is not None:
                # one ladder evaluation per worker iteration: the
                # hysteresis counts are loop steps, so walk-back after
                # a flood is bounded in ITERATIONS, not wall time
                self.degrade.evaluate(self._degrade_signals())
            # admissions (prefills) are progress too — a prefill-heavy
            # workload must not read as a stall in health(). Draining
            # bypasses every ladder gate: preempted-but-queued
            # sequences must drain, never orphan their futures.
            if self.batcher.admit_from(self._waiting,
                                       drain=self._stop_seen):
                self._last_progress_t = time.monotonic()
            if self.batcher.active:
                if self.batcher.step():
                    self._last_progress_t = time.monotonic()
            elif self._waiting:
                # nothing live but the head is blocked on admission
                # (pool or ladder budget): back off a tick instead of
                # busy-spinning the worker — admission is retried ~100x
                # a second, and ladder evaluations stay one-per-
                # iteration at a sane rate
                time.sleep(0.01)
            else:
                if self._stop_seen and self._queue.empty():
                    return
                if self._stop_seen:
                    continue

    def health(self) -> dict:
        """Serving-layer health snapshot plus the decode gauges a
        router scales on (active sequences, throughput EMA) and the
        degradation/speculation state.

        ``pressure`` is a 0.0–1.0 load score: the max of the
        queue-backlog fraction, the KV-pool occupancy (1 − reclaimable
        fraction) and the degradation-ladder stage normalized to
        [0, 1]."""
        out = super().health()
        sig = self._degrade_signals()
        stage = int(out.get("degradation_stage") or 0)
        out["pressure"] = round(
            min(1.0, max(float(sig.get("queue_frac") or 0.0),
                         float(sig.get("pool_frac") or 0.0),
                         stage / 4.0)), 4)
        out["active_sequences"] = self.metrics.active_sequences
        out["tokens_per_sec"] = round(self.metrics.tokens_per_sec, 2)
        if self.engine.cache_config.prefix_cache:
            # occupancy snapshot: cached blocks, the hit rate over the
            # window SINCE the last snapshot (None when the window saw
            # no admissions), and the fraction of the pool a new
            # reservation can draw on — mirrored onto the
            # pdtpu_serving_gauge family
            kv = self.batcher.kv
            hits = self.metrics.get("prefix_cache_hits_total")
            misses = self.metrics.get("prefix_cache_misses_total")
            with self._lock:
                ph, pm = self._prefix_snap
                self._prefix_snap = (hits, misses)
            window = (hits - ph) + (misses - pm)
            rate = (round((hits - ph) / window, 4) if window > 0
                    else None)
            frac = round(kv.reclaimable_blocks
                         / kv.config.num_blocks, 4)
            out["prefix_cache"] = {"cached_blocks": kv.cached_blocks,
                                   "hit_rate_window": rate,
                                   "reclaimable_frac": frac}
            self.metrics.prefix_cached_blocks = kv.cached_blocks
            self.metrics.prefix_reclaimable_frac = frac
            if rate is not None:
                self.metrics.prefix_hit_rate_window = rate
        if self.draft_engine is not None:
            err = self.batcher.draft_error
            out["speculation"] = (
                "disabled: %s" % (err,) if err is not None
                else ("shed" if self.batcher._spec_shed else "active"))
        return out

    def _fail_pending(self) -> None:
        pending = list(self._waiting)
        self._waiting.clear()
        while True:
            try:
                item = self._queue.get_nowait()
            except _queue.Empty:
                break
            if item is not _STOP:
                pending.append(item)
        for req in pending:
            if req.resume_tokens:
                # a preempted-but-queued sequence carries a partial
                # stream: flush it with the typed interrupted error
                # (tokens attached), never a bare closed error
                self.metrics.inc("request_errors")
                self.metrics.inc("sequences_interrupted")
                deliver(req.future, exc=GenerationInterruptedError(
                    "session shut down before this preempted "
                    "generation resumed", tokens=req.resume_tokens))
            else:
                deliver(req.future, exc=ServerClosedError(
                    "session shut down before this request started"))
        self.metrics.queue_depth = 0


def serve_decoding(program, token_name: str, logits_name: str,
                   scope=None, config: Optional[DecodingConfig] = None,
                   place=None, auto_start: bool = True,
                   draft_program=None,
                   draft_logits_name: Optional[str] = None,
                   draft_scope=None) -> DecodeSession:
    """One-call entry point: derive the prefill/decode pair from a
    forward program, build the engine on ``place`` (default
    ``CUDAPlace(0)``), start a DecodeSession over it. The scope must hold
    the program's parameters on that place.

    ``draft_program`` (with ``draft_logits_name`` and a SEPARATE
    ``draft_scope`` holding the draft's parameters) enables speculative
    decoding: the draft engine shares the target's cache geometry,
    prefix caching and bucket config (one prefill row at a time) but
    owns its own pools. It needs ``config.speculate_k >= 1``, set to 4
    (on a copy of the config) when a draft is given and the config
    left it 0."""
    config = config or DecodingConfig()
    if draft_program is not None and config.speculate_k == 0:
        # a draft with no window is a misconfiguration, not a mode: the
        # JAX package's default, on a copy (the caller's config is not
        # mutated, and the constructor re-validates speculate_k)
        config = DecodingConfig(
            cache=config.cache,
            prompt_buckets=config.prompt_buckets,
            decode_buckets=config.decode_buckets,
            prefill_batch_buckets=config.prefill_batch_buckets,
            suffix_buckets=config.suffix_buckets,
            sampling=config.sampling, speculate_k=4,
            max_new_tokens=config.max_new_tokens,
            queue_capacity=config.queue_capacity,
            default_deadline_ms=config.default_deadline_ms,
            warm_up=config.warm_up, breaker=config.breaker,
            degrade=config.degrade)
    engine = DecodeEngine(program, token_name, logits_name, scope=scope,
                          config=config, place=place)
    draft_engine = None
    if draft_program is not None:
        enforce(draft_logits_name is not None,
                "serve_decoding: draft_program needs draft_logits_name")
        enforce(draft_scope is not None and draft_scope is not scope,
                "serve_decoding: the draft needs its OWN scope (its KV "
                "pools share names with the target's)")
        c = config.cache
        draft_config = DecodingConfig(
            # the draft inherits prefix_cache too: shared-prompt and
            # preemption-resumed admissions suffix-prefill the DRAFT
            # pools instead of full-prefilling the cheap model
            cache=CacheConfig(num_blocks=c.num_blocks,
                              block_size=c.block_size,
                              max_blocks_per_seq=c.max_blocks_per_seq,
                              kv_dtype=c.kv_dtype,
                              prefix_cache=c.prefix_cache),
            prompt_buckets=config.prompt_buckets,
            decode_buckets=config.decode_buckets,
            prefill_batch_buckets=(1,),
            sampling=config.sampling,
            max_new_tokens=config.max_new_tokens,
            warm_up=config.warm_up)
        draft_engine = DecodeEngine(draft_program, token_name,
                                    draft_logits_name,
                                    scope=draft_scope,
                                    config=draft_config, place=place)
    return DecodeSession(engine, auto_start=auto_start,
                         draft_engine=draft_engine)
