"""DecodeSession: the server layer of the decode subsystem (counterpart
of paddle_tpu/decoding/session.py, greedy and without a draft model).

An InferenceServer whose worker runs the CONTINUOUS batching loop:
bounded submit queue with backpressure, per-sequence deadlines (queued
and mid-generation), streaming token callbacks, graceful drain —
``shutdown(drain=True)`` finishes every in-flight generation,
``shutdown(drain=False)`` flushes partial streams with the typed
GenerationInterruptedError (futures are always resolved, never
dropped).
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
from .cache import KVCacheManager
from .engine import DecodeEngine, DecodingConfig


class GenerationRequest:
    """One queued generation: prompt ids, budget, stop condition,
    optional streaming callback, and the future its caller waits on
    (resolves to the list of GENERATED token ids; eos, when configured
    and produced, is included as the last token)."""

    __slots__ = ("prompt", "max_new_tokens", "eos_id", "on_token",
                 "future", "enqueue_t", "deadline_t")

    def __init__(self, prompt, max_new_tokens: int,
                 eos_id: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 on_token: Optional[Callable[[int], None]] = None):
        self.prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        enforce(len(self.prompt) >= 1, "empty prompt")
        enforce(int(max_new_tokens) >= 1, "max_new_tokens must be >= 1")
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.on_token = on_token
        self.future: Future = Future()
        self.enqueue_t = time.monotonic()
        self.deadline_t = (self.enqueue_t + deadline_ms / 1e3
                           if deadline_ms is not None else None)

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline_t is not None
                and (now or time.monotonic()) > self.deadline_t)


class DecodeSession(InferenceServer):
    """Serve continuous-batched greedy generation.

    One worker thread owns the engine; client threads block on
    per-request futures or stream tokens via ``on_token`` callbacks
    (invoked from the worker — keep them cheap)."""

    def __init__(self, engine: DecodeEngine,
                 config: Optional[DecodingConfig] = None,
                 auto_start: bool = True):
        self.engine = engine
        self.metrics = engine.metrics
        self.batcher = ContinuousBatcher(engine, metrics=self.metrics)
        self._waiting: List[GenerationRequest] = []
        self._stop_seen = False
        super().__init__(config or engine.config, auto_start=auto_start)

    @property
    def kv(self) -> KVCacheManager:
        return self.batcher.kv

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_id: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               on_token: Optional[Callable[[int], None]] = None) -> Future:
        """Enqueue one generation; returns a Future resolving to the
        generated token ids. Raises QueueFullError at capacity
        (backpressure), ServerClosedError after shutdown began, and
        PromptTooLongError for requests this cache geometry can never
        hold."""
        if max_new_tokens is None:
            max_new_tokens = self.config.max_new_tokens
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        req = GenerationRequest(prompt, max_new_tokens, eos_id=eos_id,
                                deadline_ms=deadline_ms, on_token=on_token)
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
                 timeout: Optional[float] = None) -> List[int]:
        """Synchronous convenience wrapper over :meth:`submit`."""
        return self.submit(prompt, max_new_tokens, eos_id=eos_id,
                           deadline_ms=deadline_ms,
                           on_token=on_token).result(timeout=timeout)

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
    the program's parameters on that place. Speculative decoding
    (``draft_program``) is not ported yet."""
    if draft_program is not None:
        raise NotImplementedError(
            "serve_decoding(draft_program=...): speculative decoding is "
            "not ported yet")
    engine = DecodeEngine(program, token_name, logits_name, scope=scope,
                          config=config, place=place)
    return DecodeSession(engine, auto_start=auto_start)
