"""DecodeSession: the server layer of the decode subsystem (counterpart
of paddle_tpu/decoding/session.py).

An InferenceServer whose worker runs the CONTINUOUS batching loop:
bounded submit queue with backpressure, per-sequence deadlines (queued
and mid-generation), streaming token callbacks, graceful drain —
``shutdown(drain=True)`` finishes every in-flight generation,
``shutdown(drain=False)`` flushes partial streams with the typed
GenerationInterruptedError (futures are always resolved, never
dropped). Requests carry a :class:`SamplingParams` (mixed greedy and
sampled requests share one batch), and a draft engine enables
speculative decoding (``serve_decoding(draft_program=...)`` builds it;
the draft owns its own scope and KV pools).
"""

from __future__ import annotations

import queue as _queue
import time
from concurrent.futures import Future
from typing import Callable, List, Optional

import numpy as np

from ..core.enforce import enforce
from ..serving.errors import (DeadlineExceededError, PromptTooLongError,
                              QueueFullError, ServerClosedError)
from ..serving.server import _STOP, InferenceServer, deliver
from .batcher import ContinuousBatcher
from .cache import CacheConfig, KVCacheManager
from .engine import DecodeEngine, DecodingConfig
from .sampling import GREEDY, SamplingParams


class GenerationRequest:
    """One queued generation: prompt ids, budget, stop condition,
    sampling config, optional streaming callback, and the future its
    caller waits on (resolves to the list of GENERATED token ids; eos,
    when configured and produced, is included as the last token)."""

    __slots__ = ("prompt", "max_new_tokens", "eos_id", "on_token",
                 "future", "enqueue_t", "deadline_t", "prefix_keys",
                 "sampling")

    def __init__(self, prompt, max_new_tokens: int,
                 eos_id: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 on_token: Optional[Callable[[int], None]] = None,
                 sampling: Optional[SamplingParams] = None):
        self.prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        enforce(len(self.prompt) >= 1, "empty prompt")
        enforce(int(max_new_tokens) >= 1, "max_new_tokens must be >= 1")
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.on_token = on_token
        self.sampling = sampling or GREEDY
        self.future: Future = Future()
        self.enqueue_t = time.monotonic()
        self.deadline_t = (self.enqueue_t + deadline_ms / 1e3
                           if deadline_ms is not None else None)
        # the prompt's prefix-cache chain keys, computed once by the
        # batcher at its first admission attempt
        self.prefix_keys = None

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline_t is not None
                and (now or time.monotonic()) > self.deadline_t)


class DecodeSession(InferenceServer):
    """Serve continuous-batched generation.

    One worker thread owns the engine(s); client threads block on
    per-request futures or stream tokens via ``on_token`` callbacks
    (invoked from the worker — keep them cheap). ``draft_engine``
    (optional) enables speculative decoding: a small model over its own
    scope and pools proposes ``speculate_k`` tokens per step, the target
    verifies them in one multi-token step."""

    def __init__(self, engine: DecodeEngine,
                 config: Optional[DecodingConfig] = None,
                 auto_start: bool = True,
                 draft_engine: Optional[DecodeEngine] = None):
        self.engine = engine
        self.metrics = engine.metrics
        self.draft_engine = draft_engine
        self.batcher = ContinuousBatcher(engine, metrics=self.metrics,
                                         draft=draft_engine)
        self._waiting: List[GenerationRequest] = []
        self._stop_seen = False
        super().__init__(config or engine.config, auto_start=auto_start)

    def start(self) -> "DecodeSession":
        # the draft engine warms (on a card: captures) its own bucket
        # set alongside the target's
        if self.draft_engine is not None and self.config.warm_up \
                and not self.running:
            self.draft_engine.warm_up()
        return super().start()

    @property
    def kv(self) -> KVCacheManager:
        return self.batcher.kv

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_id: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               on_token: Optional[Callable[[int], None]] = None,
               sampling: Optional[SamplingParams] = None) -> Future:
        """Enqueue one generation; returns a Future resolving to the
        generated token ids. Raises QueueFullError at capacity
        (backpressure), ServerClosedError after shutdown began, and
        PromptTooLongError for requests this cache geometry can never
        hold. ``sampling`` (a SamplingParams) needs an engine built with
        ``DecodingConfig(sampling=True)``; greedy works everywhere."""
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
                                deadline_ms=deadline_ms, on_token=on_token,
                                sampling=sampling)
        cache = self.engine.cache_config
        if len(req.prompt) + req.max_new_tokens > cache.max_context or \
                self.engine.prompt_bucket_for(len(req.prompt)) is None:
            raise PromptTooLongError(
                "prompt %d + max_new_tokens %d exceeds max_context %d "
                "(block_size %d x max_blocks_per_seq %d)"
                % (len(req.prompt), req.max_new_tokens,
                   cache.max_context, cache.block_size,
                   cache.max_blocks_per_seq))
        self._admit()
        with self._lock:
            if self._closed:
                raise ServerClosedError("session is shut down")
            try:
                self._queue.put_nowait(req)
            except _queue.Full:
                raise QueueFullError(
                    "generation queue full (capacity %d) — shed load or "
                    "raise queue_capacity"
                    % self.config.queue_capacity) from None
        return req.future

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 on_token: Optional[Callable[[int], None]] = None,
                 timeout: Optional[float] = None,
                 sampling: Optional[SamplingParams] = None) -> List[int]:
        """Synchronous convenience wrapper over :meth:`submit`."""
        return self.submit(prompt, max_new_tokens, eos_id=eos_id,
                           deadline_ms=deadline_ms, on_token=on_token,
                           sampling=sampling).result(timeout=timeout)

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
                err = DeadlineExceededError(
                    "generation request exceeded its deadline while "
                    "queued (waited %.1f ms)"
                    % ((now - req.enqueue_t) * 1e3))
                err.tokens = []
                deliver(req.future, exc=err)

    def _worker_loop(self) -> None:
        while True:
            if self._abort:
                self.batcher.interrupt_all(
                    "session shut down (drain=False) mid-generation")
                self._fail_pending()
                return
            idle = not self.batcher.active and not self._waiting
            self._pump_queue(block=idle and not self._stop_seen)
            if self._abort:
                continue  # re-check before doing work after a block
            self._expire_waiting()
            self.batcher.admit_from(self._waiting)
            if self.batcher.active:
                self.batcher.step()
            elif self._waiting:
                # nothing live but the head is blocked on admission:
                # back off a tick instead of busy-spinning
                time.sleep(0.01)
            elif self._stop_seen and self._queue.empty():
                return

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
            deliver(req.future, exc=ServerClosedError(
                "session shut down before this request started"))


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
            warm_up=config.warm_up)
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
            # the draft inherits prefix_cache too: shared-prompt
            # admissions suffix-prefill the draft's pools as well
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
                                    draft_logits_name, scope=draft_scope,
                                    config=draft_config, place=place)
    return DecodeSession(engine, auto_start=auto_start,
                         draft_engine=draft_engine)
