"""Continuous (iteration-level) batching — Orca-style scheduling over
the decode engine (counterpart of paddle_tpu/decoding/batcher.py).

Sequences are admitted into free slots the moment cache blocks are
available, every step runs ONE bucketed decode over whatever is
currently active, and finished sequences retire (and free their blocks)
immediately — a long generation never holds short ones hostage.

**Prefix caching**: admission reserves only the un-cached suffix of a
prompt (cache.py's content-hash index); hits prefill through the EXTEND
program over the shared blocks, misses prefill fully, and both COMMIT
their fresh prefix blocks only after the prefill succeeded, so the next
same-prefix admission hits.

Single consumer: exactly one worker thread (the DecodeSession's) calls
``admit_from`` and ``step``.

Not ported yet: speculative decoding, preemption and the degradation
ladder, sampling, KV-block migration, and the per-sequence re-step
after a failed decode step (here a failed step fails every sequence in
it with its partial stream).
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from ..serving.errors import (DeadlineExceededError,
                              GenerationInterruptedError)
from ..serving.server import deliver
from .cache import KVCacheManager
from .engine import DecodeEngine


class _Sequence:
    """One live generation: its request, cache reservation and decode
    cursor (``next_token``/``position`` feed the next decode step)."""

    __slots__ = ("req", "sid", "table_row", "prompt_len", "generated",
                 "next_token", "position", "cached_tokens")

    def __init__(self, req, sid: int, table_row: np.ndarray,
                 cached_tokens: int = 0):
        self.req = req
        self.sid = sid
        self.table_row = table_row
        self.prompt_len = len(req.prompt)
        self.generated: List[int] = []
        self.next_token: Optional[int] = None
        self.position: Optional[int] = None
        # leading prompt positions whose K/V a shared prefix holds
        self.cached_tokens = int(cached_tokens)

    def note_token(self, tok: int) -> bool:
        """Record one generated token, arm the next decode step, stream
        it to the caller; True when the sequence is finished."""
        tok = int(tok)
        self.generated.append(tok)
        self.next_token = tok
        # the token just generated sits at prompt_len + len(generated)-1
        self.position = self.prompt_len + len(self.generated) - 1
        cb = self.req.on_token
        if cb is not None:
            try:
                cb(tok)
            except Exception:
                pass  # a streaming callback must never kill the worker
        if self.req.eos_id is not None and tok == self.req.eos_id:
            return True
        return len(self.generated) >= self.req.max_new_tokens


class ContinuousBatcher:
    """Admits, steps and retires sequences against one DecodeEngine."""

    def __init__(self, engine: DecodeEngine,
                 kv: Optional[KVCacheManager] = None, metrics=None):
        self.engine = engine
        self.metrics = metrics or engine.metrics
        self.kv = kv or KVCacheManager(engine.cache_config,
                                       metrics=self.metrics)
        self.max_active = engine.config.max_active
        self.active: List[_Sequence] = []

    @property
    def slots_free(self) -> int:
        return self.max_active - len(self.active)

    def _request_keys(self, req):
        """The request's prefix chain keys, computed once and replayed
        on every admission retry (a blocked head is retried per worker
        poll; re-hashing its prompt there would cost O(prompt_len) on
        the decode loop)."""
        if not self.engine.cache_config.prefix_cache:
            return None
        keys = getattr(req, "prefix_keys", None)
        if keys is None:
            keys = self.kv.prefix_keys(req.prompt)
            req.prefix_keys = keys
        return keys

    def _admit_one(self, req):
        """Reserve blocks for one request net of its committed shared
        prefix: ``(sid, cached_tokens)``, or None (blocked). Counts the
        prefix-cache hit or miss and the prompt tokens avoided."""
        adm = self.kv.admit_tokens(req.prompt, req.max_new_tokens,
                                   keys=self._request_keys(req))
        if adm is None:
            return None
        if self.engine.cache_config.prefix_cache:
            cached = adm[1]
            self.metrics.inc("prefix_cache_hits_total" if cached
                             else "prefix_cache_misses_total")
            if cached:
                self.metrics.inc("prefill_tokens_avoided_total", cached)
        return adm

    def _bucket(self, req, cached: int) -> Optional[int]:
        """The bucket a request's prefill runs at: its suffix bucket on
        the extend path (a prefix hit), its prompt bucket otherwise."""
        if cached > 0:
            return self.engine.suffix_bucket_for(len(req.prompt) - cached)
        return self.engine.prompt_bucket_for(len(req.prompt))

    def admit_from(self, waiting: List) -> int:
        """Admit request(s) from the FIFO ``waiting`` list (in place):
        reserve cache blocks, prefill, emit first tokens. A group widens
        up to the largest prefill batch bucket with followers on the
        same path (a prefix hit and a miss never share a prefill) and in
        the same suffix or prompt bucket. Head-of-line order is kept — a
        request that does not fit YET blocks the ones behind it rather
        than starving. Returns the number admitted."""
        admitted = 0
        while waiting and self.slots_free > 0:
            head = waiting[0]
            adm = self._admit_one(head)
            if adm is None:
                break
            sid, cached = adm
            group = [(waiting.pop(0), sid, cached)]
            is_extend = cached > 0
            tb = self._bucket(head, cached)
            while (waiting and self.slots_free > len(group)
                   and len(group) < self.engine.config.max_prefill_batch):
                nxt = waiting[0]
                ncached = self.kv.match_prefix(
                    nxt.prompt, keys=self._request_keys(nxt))
                if (ncached > 0) != is_extend \
                        or self._bucket(nxt, ncached) != tb:
                    break
                nadm = self._admit_one(nxt)
                if nadm is None:
                    break
                group.append((waiting.pop(0),) + nadm)
            admitted += len(group)
            self._prefill_group(group)
        return admitted

    def _prefill_group(self, group) -> None:
        seqs = [_Sequence(req, sid, self.kv.table_row(sid), cached)
                for req, sid, cached in group]
        try:
            if seqs[0].cached_tokens > 0:
                firsts = self.engine.extend_prefill(
                    [np.asarray(s.req.prompt[s.cached_tokens:])
                     for s in seqs],
                    np.stack([s.table_row for s in seqs]),
                    np.asarray([s.cached_tokens for s in seqs], np.int32))
            else:
                firsts = self.engine.prefill(
                    [np.asarray(s.req.prompt) for s in seqs],
                    np.stack([s.table_row for s in seqs]),
                    np.asarray([s.prompt_len for s in seqs], np.int32))
        except Exception as e:
            if len(seqs) == 1:
                # release drops the pending publish: nothing half-written
                # is ever shared
                self._retire(seqs[0], error=e)
                return
            for s in seqs:  # poison isolation: re-prefill one by one
                self._prefill_group([(s.req, s.sid, s.cached_tokens)])
            return
        for s in seqs:
            self.kv.commit_prefix(s.sid)  # prefix blocks now shareable
        now = time.monotonic()
        for s, tok in zip(seqs, firsts):
            self.metrics.observe("ttft_ms", (now - s.req.enqueue_t) * 1e3)
            self.metrics.inc("tokens_generated")
            if s.note_token(tok):
                self._retire(s)
            else:
                self.active.append(s)

    def step(self) -> int:
        """One decode iteration over the live set; retires finished
        sequences. Returns tokens emitted."""
        if not self.active:
            return 0
        self._expire_active()
        if not self.active:
            return 0
        return self._step_plain(list(self.active))

    def _step_plain(self, seqs) -> int:
        try:
            nxt = self.engine.decode(
                np.asarray([s.next_token for s in seqs]),
                np.asarray([s.position for s in seqs], np.int32),
                np.stack([s.table_row for s in seqs]))
        except Exception as e:
            for s in seqs:
                self.active.remove(s)
                err = GenerationInterruptedError(
                    "decode step failed mid-generation: %r" % (e,),
                    tokens=s.generated)
                err.__cause__ = e
                self._retire(s, error=err)
            return 0
        for s, tok in zip(seqs, nxt):
            if s.note_token(tok):
                self.active.remove(s)
                self._retire(s)
        self.metrics.inc("tokens_generated", len(seqs))
        return len(seqs)

    def _expire_active(self) -> None:
        now = time.monotonic()
        for s in list(self.active):
            if s.req.deadline_t is not None and now > s.req.deadline_t:
                self.active.remove(s)
                err = DeadlineExceededError(
                    "generation exceeded its deadline after %d tokens"
                    % len(s.generated))
                err.tokens = list(s.generated)
                self._retire(s, error=err)

    def _retire(self, s: _Sequence,
                error: Optional[BaseException] = None) -> None:
        self.kv.release(s.sid)
        if error is not None:
            self.metrics.inc("request_errors")
            deliver(s.req.future, exc=error)
            return
        self.metrics.inc("sequences_completed")
        deliver(s.req.future, list(s.generated))

    def interrupt_all(self, reason: str) -> None:
        """Fail every live sequence with its partial stream (non-drain
        shutdown): typed error, tokens so far attached."""
        for s in self.active:
            self.kv.release(s.sid)
            self.metrics.inc("request_errors")
            deliver(s.req.future, exc=GenerationInterruptedError(
                reason, tokens=s.generated))
        self.active.clear()
