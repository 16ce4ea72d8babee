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

**Speculative decoding**: with a draft engine attached, each iteration
drafts up to ``speculate_k`` tokens per live sequence on the draft model
(its own pools and tables mirror the target's positions), verifies them
in ONE multi-token target step (``engine.verify``), and emits the
longest verified prefix plus the target's own next token. Where a
window is accepted whole, one more draft step writes the last draft
token's K/V into the draft's pool: the JAX package's batcher leaves
that slot unwritten, so the next window's drafts attend a stale slot and
even a parameter-copied self-draft sees some of its proposals rejected.
Streams do not depend on it (the target decides every token). Greedy
acceptance keeps the stream token-identical to plain greedy decoding,
and seeded-sampling acceptance to plain sampling (the verify head
samples with the same stream-positional keys).

**Mixed sampling**: per-request SamplingParams ride as ``[B]`` feeds, so
greedy, temperature, top-k and top-p requests share one batch
(decoding/sampling.py).

Single consumer: exactly one worker thread (the DecodeSession's) calls
``admit_from`` and ``step``.

Not ported yet: preemption and the degradation ladder, KV-block
migration, the typed ``DraftEngineError`` fallback to plain decoding,
and the per-sequence re-step after a failed step (here a failed decode,
draft or verify step fails every sequence in it with its partial
stream).
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from ..core.enforce import enforce
from ..serving.errors import (DeadlineExceededError,
                              GenerationInterruptedError)
from ..serving.server import deliver
from .cache import KVCacheManager
from .engine import DecodeEngine


class _Sequence:
    """One live generation: its request, cache reservation and decode
    cursor (``next_token``/``position`` feed the next decode step)."""

    __slots__ = ("req", "sid", "table_row", "prompt_len", "generated",
                 "next_token", "position", "cached_tokens", "draft_sid",
                 "draft_row", "draft_cached")

    def __init__(self, req, sid: int, table_row: np.ndarray,
                 cached_tokens: int = 0, draft_sid: Optional[int] = None,
                 draft_row: Optional[np.ndarray] = None,
                 draft_cached: int = 0):
        self.req = req
        self.sid = sid
        self.table_row = table_row
        self.prompt_len = len(req.prompt)
        self.generated: List[int] = []
        self.next_token: Optional[int] = None
        self.position: Optional[int] = None
        # leading prompt positions whose K/V a shared prefix holds
        self.cached_tokens = int(cached_tokens)
        # the mirrored reservation on the draft engine's pools
        self.draft_sid = draft_sid
        self.draft_row = draft_row
        self.draft_cached = int(draft_cached)

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
    """Admits, steps and retires sequences against one DecodeEngine
    (plus an optional draft engine for speculative decoding)."""

    def __init__(self, engine: DecodeEngine,
                 kv: Optional[KVCacheManager] = None, metrics=None,
                 draft: Optional[DecodeEngine] = None):
        self.engine = engine
        self.metrics = metrics or engine.metrics
        self.kv = kv or KVCacheManager(engine.cache_config,
                                       metrics=self.metrics)
        self.max_active = engine.config.max_active
        self.active: List[_Sequence] = []
        self.draft = draft
        self.spec_k = engine.config.speculate_k if draft is not None \
            else 0
        self.draft_kv = None
        if draft is not None:
            enforce(engine.config.speculate_k >= 1,
                    "a draft engine needs DecodingConfig("
                    "speculate_k >= 1) on the target")
            enforce(draft.scope is not engine.scope,
                    "the draft engine must own a separate scope — its "
                    "KV pools share names with the target's")
            self.draft_kv = KVCacheManager(draft.cache_config)

    @property
    def slots_free(self) -> int:
        return self.max_active - len(self.active)

    def _sampling(self, seqs):
        """Per-row SamplingParams (None unless the engine was built with
        the sampling heads)."""
        if not self.engine.sampling:
            return None
        return [getattr(s.req, "sampling", None) for s in seqs]

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
        prefix, and the mirrored reservation on the draft's pools:
        ``(sid, cached_tokens, draft_sid, draft_cached)``, or None
        (blocked: both or neither). Counts the prefix-cache hit or miss
        and the prompt tokens avoided."""
        keys = self._request_keys(req)
        adm = self.kv.admit_tokens(req.prompt, req.max_new_tokens,
                                   keys=keys)
        if adm is None:
            return None
        sid, cached = adm
        draft_sid, draft_cached = None, 0
        if self.draft_kv is not None:
            # the draft shares the target's cache geometry, so the
            # request's chain keys serve both indexes
            dadm = self.draft_kv.admit_tokens(req.prompt,
                                              req.max_new_tokens, keys=keys)
            if dadm is None:
                self.kv.release(sid)  # lockstep or nothing
                return None
            draft_sid, draft_cached = dadm
        if self.engine.cache_config.prefix_cache:
            self.metrics.inc("prefix_cache_hits_total" if cached
                             else "prefix_cache_misses_total")
            if cached:
                self.metrics.inc("prefill_tokens_avoided_total", cached)
        return sid, cached, draft_sid, draft_cached

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
            cached = adm[1]
            group = [(waiting.pop(0),) + adm]
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
        seqs = [_Sequence(req, sid, self.kv.table_row(sid), cached,
                          draft_sid=dsid,
                          draft_row=(None if dsid is None
                                     else self.draft_kv.table_row(dsid)),
                          draft_cached=dcached)
                for req, sid, cached, dsid, dcached in group]
        params = self._sampling(seqs)
        try:
            if seqs[0].cached_tokens > 0:
                firsts = self.engine.extend_prefill(
                    [np.asarray(s.req.prompt[s.cached_tokens:])
                     for s in seqs],
                    np.stack([s.table_row for s in seqs]),
                    np.asarray([s.cached_tokens for s in seqs], np.int32),
                    params=params)
            else:
                firsts = self.engine.prefill(
                    [np.asarray(s.req.prompt) for s in seqs],
                    np.stack([s.table_row for s in seqs]),
                    np.asarray([s.prompt_len for s in seqs], np.int32),
                    params=params)
            if self.draft is not None:
                self._draft_prefill(seqs)
        except Exception as e:
            if len(seqs) == 1:
                # release drops the pending publish: nothing half-written
                # is ever shared
                self._retire(seqs[0], error=e)
                return
            for s in seqs:  # poison isolation: re-prefill one by one
                self._prefill_group([(s.req, s.sid, s.cached_tokens,
                                      s.draft_sid, s.draft_cached)])
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

    def _draft_prefill(self, seqs) -> None:
        """Mirror each prompt into the draft's pools after the target's
        prefill — a suffix prefill where the draft's own prefix index
        hits, a full prefill otherwise; the draft's first token is
        discarded (the target's is the stream's)."""
        for s in seqs:
            params = self._sampling([s])
            if s.draft_cached > 0:
                self.draft.extend_prefill(
                    [np.asarray(s.req.prompt[s.draft_cached:])],
                    s.draft_row[None, :],
                    np.asarray([s.draft_cached], np.int32), params=params)
            else:
                self.draft.prefill(
                    [np.asarray(s.req.prompt)], s.draft_row[None, :],
                    np.asarray([s.prompt_len], np.int32), params=params)
            self.draft_kv.commit_prefix(s.draft_sid)

    def step(self) -> int:
        """One decode iteration over the live set; retires finished
        sequences. Returns tokens emitted (under speculation one
        iteration can emit several verified tokens per sequence)."""
        if not self.active:
            return 0
        self._expire_active()
        if not self.active:
            return 0
        seqs = list(self.active)
        if self.draft is not None:
            return self._step_speculative(seqs)
        return self._step_plain(seqs)

    def _fail_step(self, seqs, e: BaseException) -> None:
        """A failed step fails every sequence in it with its partial
        stream."""
        for s in seqs:
            self.active.remove(s)
            err = GenerationInterruptedError(
                "decode step failed mid-generation: %r" % (e,),
                tokens=s.generated)
            err.__cause__ = e
            self._retire(s, error=err)

    def _step_plain(self, seqs) -> int:
        t0 = time.perf_counter()
        try:
            nxt = self.engine.decode(
                np.asarray([s.next_token for s in seqs]),
                np.asarray([s.position for s in seqs], np.int32),
                np.stack([s.table_row for s in seqs]),
                params=self._sampling(seqs),
                steps=[len(s.generated) for s in seqs])
        except Exception as e:
            self._fail_step(seqs, e)
            return 0
        dt = time.perf_counter() - t0
        for s, tok in zip(seqs, nxt):
            if s.note_token(tok):
                self.active.remove(s)
                self._retire(s)
        self.metrics.note_decode_step(len(seqs), dt)
        return len(seqs)

    def _step_speculative(self, seqs) -> int:
        """One speculative iteration: draft ``k`` tokens per row on the
        draft engine, verify them in ONE multi-token target step, emit
        the longest verified prefix plus the target's own token. The
        draft's pools track the target's positions: a rejected draft's
        K/V sits past the frontier and is overwritten before it is ever
        attended."""
        t0 = time.perf_counter()
        n = len(seqs)
        # per-row window, clamped so the last accepted token never
        # overshoots the budget (or the reservation)
        k_row = [max(0, min(self.spec_k,
                            s.req.max_new_tokens - len(s.generated) - 1))
                 for s in seqs]
        kmax = max(k_row)
        drafts = np.zeros((n, max(kmax, 1)), np.int64)
        params = self._sampling(seqs)
        pos0 = np.asarray([s.position for s in seqs], np.int32)
        dtab = np.stack([s.draft_row for s in seqs])
        try:
            if kmax > 0:
                toks = np.asarray([s.next_token for s in seqs])
                for j in range(kmax):
                    toks = self.draft.decode(
                        toks, pos0 + j, dtab, params=params,
                        steps=[len(s.generated) + j for s in seqs])
                    drafts[:, j] = toks
            windows = np.zeros((n, kmax + 1), np.int64)
            windows[:, 0] = [s.next_token for s in seqs]
            for i in range(n):
                windows[i, 1:1 + k_row[i]] = drafts[i, :k_row[i]]
            targets = self.engine.verify(
                windows, np.asarray([k + 1 for k in k_row], np.int32),
                pos0, np.stack([s.table_row for s in seqs]), params=params,
                steps=[len(s.generated) for s in seqs])
            accepted = []
            for i in range(n):
                m = 0
                while m < k_row[i] and int(drafts[i, m]) == \
                        int(targets[i, m]):
                    m += 1
                accepted.append(m)
            # a window accepted whole leaves its last draft token's K/V
            # out of the draft's pool (the draft proposed it but was
            # never fed it); one more draft step over those rows writes
            # it, so the next window's drafts attend over it
            full = [i for i in range(n) if kmax > 0 and accepted[i] == kmax]
            if full:
                self.draft.decode(
                    drafts[full, kmax - 1], pos0[full] + kmax, dtab[full],
                    params=None if params is None
                    else [params[i] for i in full],
                    steps=[len(seqs[i].generated) + kmax for i in full])
        except Exception as e:
            self._fail_step(seqs, e)
            return 0
        dt = time.perf_counter() - t0
        emitted = 0
        for i, s in enumerate(seqs):
            row = targets[i]
            m = accepted[i]
            self.metrics.inc("spec_proposed_total", k_row[i])
            self.metrics.inc("spec_accepted_total", m)
            done = False
            # the verified prefix, then the target's own token at the
            # first mismatch (or past the last draft)
            for tok in row[:m + 1]:
                emitted += 1
                done = s.note_token(tok)
                if done:
                    break
            if done:
                self.active.remove(s)
                self._retire(s)
        # tokens accepted into streams, not rows
        self.metrics.note_decode_step(emitted, dt)
        return emitted

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

    def _release(self, s: _Sequence) -> None:
        self.kv.release(s.sid)
        if self.draft_kv is not None and s.draft_sid is not None:
            self.draft_kv.release(s.draft_sid)

    def _retire(self, s: _Sequence,
                error: Optional[BaseException] = None) -> None:
        self._release(s)
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
            self._release(s)
            self.metrics.inc("request_errors")
            deliver(s.req.future, exc=GenerationInterruptedError(
                reason, tokens=s.generated))
        self.active.clear()
