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
and seeded-sampling acceptance to plain sampling.

**Mixed sampling**: per-request SamplingParams ride as ``[B]`` feeds, so
greedy, temperature, top-k and top-p requests share one batch.

**Resilience**: a failed decode step re-steps each of its sequences
alone under a ``RetryPolicy(max_attempts=2)`` — only a sequence that
fails alone too carries the error; a failed prefill of several
admissions re-prefills them one by one; a failed draft step (the
``decoding.draft_step`` fault, or any draft failure) drops the session
to plain decoding PERMANENTLY with a typed ``DraftEngineError`` (streams
stay identical); a failed verify degrades its round to plain decoding.
The breaker (when the session wires one) sees every step's outcome.
Under the degradation ladder admission turns priority-aware and
budgeted (stage 1), lower classes are preempted back to the queue with
their streams preloaded (stage 2), and speculation is shed (stage 3).

**Fleet KV-block migration**: with ``migrator`` set (a
``fleet.BlockMigrator``; None by default, and then nothing below runs)
the batcher restores migrated prefix blocks before an admission, and
exports a prefix after a preemption publish (so a peer replica can
resume the stream) and, on a prefill-role replica, after every commit.
A migration failure costs only a local re-prefill.

Single consumer: exactly one worker thread (the DecodeSession's) calls
``admit_from`` and ``step``.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from ..core.enforce import enforce
from ..obs import trace as obs_trace
from ..profiler import RecordEvent
from ..resilience import faults
from ..resilience.degrade import clamp_priority
from ..resilience.faults import InjectedFault
from ..resilience.retry import RetryError, RetryPolicy
from ..serving.batcher import deliver
from ..serving.errors import (DeadlineExceededError, DraftEngineError,
                              GenerationInterruptedError)
from .cache import KVCacheManager
from .engine import DecodeEngine

# re-step isolation budget: each sequence of a failed batch gets this
# many solo tries through the ONE shared backoff implementation before
# its future carries the error — a purely
# transient step failure (an injected one, a recovered allocator blip)
# costs a retry, not the generation
_RESTEP_POLICY_ARGS = dict(max_attempts=2, base_delay_s=0.0, jitter=0.0)


def _eff_prompt(req) -> List[int]:
    """The tokens a (possibly preemption-resumed) request must hold in
    its KV pools before decoding can continue: the original prompt plus
    everything generated before the preemption. Plain requests have no
    resume span, so this is just the prompt."""
    resume = getattr(req, "resume_tokens", None)
    return req.prompt + list(resume) if resume else req.prompt


class _Sequence:
    """One live generation: its request, cache reservation(s), and
    decode cursor (``next_token``/``position`` feed the next decode
    step; ``draft_sid``/``draft_row`` mirror the reservation on the
    draft engine's pools under speculation).

    A preemption-RESUMED request preloads ``generated`` with the tokens
    it emitted before eviction: the coordinate frame stays the original
    prompt's, so position math, the max_new_tokens budget, seeded
    sampling's stream-positional keys, and the final future delivery
    (prior + new tokens) all continue exactly where the evicted
    sequence left off — only the already-streamed tokens are never
    re-streamed (note_token only runs for NEW tokens)."""

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
        self.generated: List[int] = list(
            getattr(req, "resume_tokens", None) or ())
        self.next_token: Optional[int] = None
        self.position: Optional[int] = None
        self.cached_tokens = int(cached_tokens)
        self.draft_sid = draft_sid
        self.draft_row = draft_row
        self.draft_cached = int(draft_cached)

    @property
    def priority(self) -> int:
        return clamp_priority(getattr(self.req, "priority", None))

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
                if obs_trace.enabled() and self.req.trace is not None:
                    # streamed tokens are spans of THIS request's trace:
                    # the callback runs under the request context, so a
                    # consumer can read obs.trace.current() and carry
                    # the context into its own thread
                    with obs_trace.attach(self.req.trace), \
                            RecordEvent("decoding/stream"):
                        cb(tok)
                else:
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
        self._blocked_head = None  # last head counted as blocked
        self.breaker = None  # set by the session when configured
        self.degrade = None  # DegradationManager, set by the session
        self._spec_shed = False  # ladder currently shedding speculation
        self.draft_error = None  # typed DraftEngineError after fallback
        self.restep_policy = RetryPolicy(**_RESTEP_POLICY_ARGS)
        # fleet KV-block migration (fleet.migrate): None keeps every
        # stream, stamp and fingerprint as without a fleet
        self.migrator = None
        self.draft = draft
        self.spec_k = engine.config.speculate_k if draft is not None \
            else 0
        if draft is not None:
            enforce(engine.config.speculate_k >= 1,
                    "a draft engine needs DecodingConfig("
                    "speculate_k >= 1) on the target")
            enforce(draft.scope is not engine.scope,
                    "the draft engine must own a separate scope — its "
                    "KV pools share names with the target's")
            self.draft_kv = KVCacheManager(draft.cache_config)
        else:
            self.draft_kv = None

    # ------------------------------------------------------------------
    @property
    def slots_free(self) -> int:
        return self.max_active - len(self.active)

    def _sampling(self, seqs):
        """Per-row SamplingParams (None unless the engine was built
        with the sampling heads)."""
        if not self.engine.sampling:
            return None
        return [getattr(s.req, "sampling", None) for s in seqs]

    def _request_keys(self, req):
        """The request's chain-hash memo: computed once, replayed on
        every admission retry (a blocked head is re-tried per worker
        poll — re-hashing the prompt there would steal O(prompt_len)
        digest work from the decode hot path). Preemption invalidates
        the memo (the effective prompt grew by the resumed span)."""
        if not self.engine.cache_config.prefix_cache:
            return None
        keys = getattr(req, "prefix_keys", None)
        if keys is None:
            keys = self.kv.prefix_keys(_eff_prompt(req))
            try:
                req.prefix_keys = keys
            except AttributeError:
                pass  # foreign request type without the slot
        return keys

    def _admit_one(self, req, drain: bool = False):
        """Reserve target (prefix-aware) + draft blocks for one
        request; returns the admission tuple or None (blocked). The
        ``serving.admission`` fault point fires here: an injected raise
        leaves the request queued (the caller retries next poll), a
        delay models a slow admission path. Under the degradation
        ladder (stage >= 1, and never while draining) the class budget
        is enforced before any blocks are taken."""
        faults.fire("serving.admission")
        eff = _eff_prompt(req)
        # a resumed request's preloaded span counts against its budget:
        # the worst case is len(eff) + REMAINING tokens, which equals
        # the original prompt + max_new — identical to the reservation
        # it held before preemption, never larger
        remaining = req.max_new_tokens - (len(eff) - len(req.prompt))
        if not drain and self.degrade is not None \
                and self.degrade.admission_controlled:
            # token-budget admission: the worst-case block estimate the
            # cache already computes, gated per priority class. "Used"
            # = blocks a reservation cannot draw on (live blocks);
            # evictable cached blocks are reclaimable, not used.
            needed = self.kv.config.blocks_for(len(eff) + remaining)
            if not self.degrade.may_admit(
                    clamp_priority(getattr(req, "priority", None)),
                    needed,
                    self.kv.config.num_blocks
                    - self.kv.reclaimable_blocks,
                    self.kv.config.num_blocks):
                return None
        if self.migrator is not None \
                and self.engine.cache_config.prefix_cache:
            # opportunistic restore of migrated prefix blocks BEFORE the
            # admission match — a fetch/verify failure degrades to the
            # local re-prefill path, never to a failed admission
            try:
                self.migrator.preload(self.kv, eff,
                                      self._request_keys(req))
            except Exception:
                pass
        admission = self.kv.admit_tokens(eff, remaining,
                                         keys=self._request_keys(req))
        if admission is None:
            return None
        sid, cached = admission
        draft_sid, draft_cached = None, 0
        if self.draft_kv is not None:
            # the draft shares the target's cache geometry, so the
            # request's chain-key memo serves both pools — the draft's
            # index is its own, but a resumed/shared prefix hits there
            # too
            dadm = self.draft_kv.admit_tokens(
                eff, remaining, keys=self._request_keys(req))
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

    # ----------------------------------------------- degraded admission
    def _pick_index(self, waiting: List, drain: bool) -> int:
        """Which waiting request to try next. Plain FIFO (index 0)
        unless the ladder is active: from stage 1 the scan is priority-
        aware (stable within a class), so a blocked low-priority head
        cannot starve interactive traffic behind it."""
        if drain or self.degrade is None \
                or not self.degrade.admission_controlled:
            return 0
        return min(range(len(waiting)),
                   key=lambda i: (clamp_priority(
                       getattr(waiting[i], "priority", None)), i))

    def _pick_victim(self, priority: int) -> Optional[_Sequence]:
        """The preemption victim for an admission of ``priority``:
        the STRICTLY lower-priority live sequence, lowest class first,
        least generated first (the cheapest stream to re-establish —
        its published prefix makes the resume a suffix prefill)."""
        victims = [s for s in self.active if s.priority > priority
                   and self.engine.prompt_bucket_for(
                       len(s.req.prompt) + len(s.generated)) is not None]
        if not victims:
            return None
        return min(victims,
                   key=lambda s: (-s.priority, len(s.generated)))

    def _preempt(self, victim: _Sequence, waiting: List) -> None:
        """Evict one mid-flight sequence back to the queue: publish its
        written-prefix blocks to the prefix cache (target AND draft
        pools — resumption becomes a cheap suffix prefill), release its
        reservations, and park it at the FRONT of the waiting list with
        its emitted tokens preloaded so the stream continues exactly
        where it stopped."""
        with RecordEvent("resilience/degrade.preempt"):
            self.active.remove(victim)
            req = victim.req
            eff = req.prompt + victim.generated
            self.kv.publish_prefix(victim.sid, eff)
            if self.draft_kv is not None and victim.draft_sid is not None:
                self.draft_kv.publish_prefix(victim.draft_sid, eff)
            if self.migrator is not None:
                # ship the just-published prefix so a PEER replica can
                # resume this stream from the migrated blocks; a failure
                # only costs the peer a re-prefill
                try:
                    self.migrator.export_prefix(self.kv, eff)
                except Exception:
                    pass
            self._release(victim)
            req.resume_tokens = list(victim.generated)
            req.prefix_keys = None  # the effective prompt grew
            waiting.insert(0, req)
            self.metrics.inc("preemptions_total")
            self.metrics.active_sequences = len(self.active)

    def _admit_degraded(self, head, waiting: List):
        """The stage >= 2 fallbacks after a plain admission failed:
        tighten prefix-cache eviction (stage >= 3), then preempt
        lower-priority sequences one at a time until the head fits or
        no victims remain."""
        mgr = self.degrade
        if mgr.tighten_cache():
            n = self.kv.drop_prefix_cache()
            if self.draft_kv is not None:
                n += self.draft_kv.drop_prefix_cache()
            if n:
                self.metrics.inc("prefix_blocks_evicted_total", n)
            adm = self._admit_one(head)
            if adm is not None:
                return adm
        if not mgr.preemption_enabled:
            return None
        pr = clamp_priority(getattr(head, "priority", None))
        while True:
            victim = self._pick_victim(pr)
            if victim is None:
                return None
            self._preempt(victim, waiting)
            adm = self._admit_one(head)
            if adm is not None:
                return adm

    def admit_from(self, waiting: List, drain: bool = False) -> int:
        """Admit request(s) from the FIFO ``waiting`` list (in place):
        reserve cache blocks, prefill (grouped by prompt bucket up to
        the prefill batch bucket), emit first tokens. Head-of-line
        order is preserved — a request that does not fit YET blocks the
        ones behind it rather than starving — except under the
        degradation ladder, where the scan turns priority-aware and a
        blocked higher class may preempt lower-class live sequences.
        ``drain=True`` (shutdown drain) bypasses every ladder gate so
        preempted-but-queued sequences always drain. Returns
        admissions."""
        admitted = 0
        while waiting and self.slots_free > 0:
            idx = self._pick_index(waiting, drain)
            head = waiting[idx]
            try:
                adm = self._admit_one(head, drain=drain)
                if adm is None and not drain and self.degrade is not None:
                    adm = self._admit_degraded(head, waiting)
            except InjectedFault:
                # serving.admission chaos: the request stays queued and
                # is retried on the next worker poll — recoverable
                break
            if adm is None:
                # count each REQUEST's blocking once, not every worker
                # poll it stays blocked through (the loop re-tries per
                # decode step — thousands of polls per blocked second)
                if head is not self._blocked_head:
                    self._blocked_head = head
                    self.metrics.inc("admission_blocked_total")
                break
            if head is self._blocked_head:
                self._blocked_head = None
            sid, cached, dsid, dcached = adm
            waiting.remove(head)
            group = [(head, sid, cached, dsid, dcached)]
            is_extend = cached > 0
            tb = (self.engine.suffix_bucket_for(
                      len(_eff_prompt(head)) - cached)
                  if is_extend
                  else self.engine.prompt_bucket_for(
                      len(_eff_prompt(head))))
            # widen the prefill with same-bucket/same-path followers
            # when the engine was configured for batched prefill (the
            # plain FIFO path only — a degraded/priority pick keeps
            # its admission solo)
            while (idx == 0
                   and waiting and self.slots_free > len(group)
                   and len(group) < self.engine.config.max_prefill_batch):
                nxt = waiting[0]
                neff = _eff_prompt(nxt)
                ncached = self.kv.match_prefix(
                    neff, keys=self._request_keys(nxt))
                if (ncached > 0) != is_extend:
                    break
                nb = (self.engine.suffix_bucket_for(
                          len(neff) - ncached) if is_extend
                      else self.engine.prompt_bucket_for(len(neff)))
                if nb != tb:
                    break
                try:
                    nadm = self._admit_one(nxt, drain=drain)
                except InjectedFault:
                    break
                if nadm is None:
                    break
                group.append((waiting.pop(0),) + nadm)
            admitted += len(group)
            self._prefill_group(group)
            self.metrics.active_sequences = len(self.active)
        return admitted

    def _prefill_group(self, group) -> None:
        seqs = [_Sequence(req, sid, self.kv.table_row(sid),
                          cached_tokens=cached,
                          draft_sid=dsid,
                          draft_row=(None if dsid is None
                                     else self.draft_kv.table_row(dsid)),
                          draft_cached=dcached)
                for req, sid, cached, dsid, dcached in group]
        is_extend = seqs[0].cached_tokens > 0
        effs = [_eff_prompt(s.req) for s in seqs]
        try:
            # the grouped prefill executes once for several requests;
            # its engine spans attach to the group head's trace
            with obs_trace.attach(seqs[0].req.trace):
                # the emitted token's STREAM position per row: 0 for a
                # fresh request, the resumed span's length after a
                # preemption — seeded sampling keys stay positional
                steps = [len(s.generated) for s in seqs]
                if is_extend:
                    firsts = self.engine.extend_prefill(
                        [np.asarray(eff[s.cached_tokens:])
                         for s, eff in zip(seqs, effs)],
                        np.stack([s.table_row for s in seqs]),
                        np.asarray([s.cached_tokens for s in seqs],
                                   np.int32),
                        params=self._sampling(seqs), steps=steps)
                else:
                    firsts = self.engine.prefill(
                        [np.asarray(eff) for eff in effs],
                        np.stack([s.table_row for s in seqs]),
                        np.asarray([len(eff) for eff in effs],
                                   np.int32),
                        params=self._sampling(seqs), steps=steps)
        except Exception as e:
            if len(seqs) == 1:
                if self.breaker is not None:  # the real poison request
                    self.breaker.record_failure()
                self._retire(seqs[0], error=e, started=False)
                return
            for s in seqs:  # poison isolation: re-prefill one by one
                self._prefill_group([(s.req, s.sid, s.cached_tokens,
                                      s.draft_sid, s.draft_cached)])
            return
        if self.draft is not None:
            # the draft mirrors the (effective) prompt into its own
            # pools — through prefix sharing where its index hits
            # (suffix-only extend), full prefill otherwise; the draft's
            # first-token guess is discarded. A draft failure is NOT a
            # request failure: the typed DraftEngineError drops the
            # session to plain decode permanently (bit-identical
            # streams, speculation lost).
            try:
                with obs_trace.attach(seqs[0].req.trace):
                    for s, eff in zip(seqs, effs):
                        faults.fire("decoding.draft_step")
                        if s.draft_cached > 0:
                            self.draft.extend_prefill(
                                [np.asarray(eff[s.draft_cached:])],
                                s.draft_row[None, :],
                                np.asarray([s.draft_cached], np.int32),
                                params=self._sampling([s]))
                        else:
                            self.draft.prefill(
                                [np.asarray(eff)],
                                s.draft_row[None, :],
                                np.asarray([len(eff)], np.int32),
                                params=self._sampling([s]))
                        self.draft_kv.commit_prefix(s.draft_sid)
            except Exception as e:
                self._disable_draft(e, pending=seqs)
        if self.breaker is not None:
            self.breaker.record_success()
        for s, eff in zip(seqs, effs):
            self.kv.commit_prefix(s.sid)  # prefix blocks now shareable
            if self.migrator is not None \
                    and getattr(self.migrator, "export_on_commit", False):
                # prefill-role replicas ship every committed prefix to
                # the content-addressed store (fleet disaggregation)
                try:
                    self.migrator.export_prefix(self.kv, eff)
                except Exception:
                    pass
        now = time.monotonic()
        for s, tok in zip(seqs, firsts):
            if not s.generated:
                # a preemption-resumed sequence (generated preloaded)
                # streamed its real first token before eviction — a
                # resume prefill is not a first token, so it must not
                # inflate the TTFT histogram
                self.metrics.note_ttft((now - s.req.enqueue_t) * 1e3)
            self.metrics.inc("tokens_generated")
            done = s.note_token(tok)
            if done:
                self._retire(s)
            else:
                self.active.append(s)

    # ------------------------------------------------------------------
    def _disable_draft(self, exc, pending=()) -> None:
        """PERMANENT per-session fallback to plain decode on a draft-
        engine failure: record the typed
        DraftEngineError, release every draft reservation, drop the
        draft engine. Streams are unaffected — speculation only ever
        proposed tokens the target verified, so plain decode continues
        them bit-identically."""
        err = (exc if isinstance(exc, DraftEngineError)
               else DraftEngineError(
                   "draft engine failed (%r) — speculation disabled "
                   "for this session, falling back to plain decode"
                   % (exc,)))
        if err is not exc:
            err.__cause__ = exc
        self.draft_error = err
        self.draft = None
        self.spec_k = 0
        if self.draft_kv is not None:
            for s in list(self.active) + list(pending):
                if s.draft_sid is not None:
                    self.draft_kv.release(s.draft_sid)
                    s.draft_sid = None
                    s.draft_row = None
        self.draft_kv = None
        self.metrics.inc("spec_disabled_total")
        with RecordEvent("resilience/degrade.draft_fallback"):
            pass

    def _spec_active(self) -> bool:
        """Speculate this iteration? False once the draft permanently
        failed, and False (REVERSIBLY) while the degradation ladder is
        at the feature-shedding stage."""
        if self.draft is None:
            return False
        if self.degrade is not None and not self.degrade.spec_enabled():
            if not self._spec_shed:
                self._spec_shed = True
                self.metrics.inc("spec_disabled_total")
            return False
        self._spec_shed = False  # pressure cleared: speculation resumes
        return True

    def step(self) -> int:
        """One decode iteration over the live set; retires finished
        sequences. Returns tokens emitted (under speculation a single
        iteration can emit several verified tokens per sequence)."""
        if not self.active:
            return 0
        self._expire_active()
        if not self.active:
            return 0
        seqs = list(self.active)
        if self._spec_active():
            return self._step_speculative(seqs)
        return self._step_plain(seqs)

    def _step_plain(self, seqs) -> int:
        t0 = time.perf_counter()
        try:
            # one bucketed decode step serves every live trace; its
            # engine spans attach to the first traced sequence (each
            # sequence's streamed tokens still carry their own context)
            with obs_trace.attach(next(
                    (s.req.trace for s in seqs
                     if s.req.trace is not None), None)):
                nxt = self.engine.decode(
                    np.asarray([s.next_token for s in seqs]),
                    np.asarray([s.position for s in seqs], np.int32),
                    np.stack([s.table_row for s in seqs]),
                    params=self._sampling(seqs),
                    steps=[len(s.generated) for s in seqs])
        except Exception as e:
            if self.breaker is not None:
                self.breaker.record_failure()
            self._isolate_step_failure(seqs, e)
            return 0
        if self.breaker is not None:
            self.breaker.record_success()
        dt = time.perf_counter() - t0
        emitted = 0
        for s, tok in zip(seqs, nxt):
            emitted += 1
            if s.note_token(tok):
                self.active.remove(s)
                self._retire(s)
        # throughput EMA counts tokens actually accepted into streams
        self.metrics.note_decode_step(emitted, dt)
        self.metrics.active_sequences = len(self.active)
        return emitted

    def _step_speculative(self, seqs) -> int:
        """One speculative iteration: draft ``k`` tokens per row on the
        draft engine, verify them in ONE multi-token target step, emit
        the longest verified prefix + the target's correction. The
        draft's pools track the target's positions exactly (rejected
        draft K/V is overwritten before it can ever be attended — the
        frontier-overwrite invariant)."""
        t0 = time.perf_counter()
        n = len(seqs)
        # per-row draft window, clamped so the final accepted token can
        # never overshoot the budget (or the worst-case reservation)
        k_row = [max(0, min(self.spec_k,
                            s.req.max_new_tokens - len(s.generated) - 1))
                 for s in seqs]
        kmax = max(k_row)
        drafts = np.zeros((n, max(kmax, 1)), np.int64)
        params = self._sampling(seqs)
        trace_ctx = next((s.req.trace for s in seqs
                          if s.req.trace is not None), None)
        try:
            # the DRAFT leg guards separately: its failure is never a
            # request failure — the typed DraftEngineError drops this
            # session to plain decode permanently and THIS iteration
            # re-runs plain (bit-identical streams, speculation lost)
            with obs_trace.attach(trace_ctx):
                if kmax > 0:
                    toks = np.asarray([s.next_token for s in seqs])
                    poss = np.asarray([s.position for s in seqs],
                                      np.int32)
                    dtab = np.stack([s.draft_row for s in seqs])
                    for j in range(kmax):
                        faults.fire("decoding.draft_step")
                        toks = self.draft.decode(
                            toks, poss, dtab, params=params,
                            steps=[len(s.generated) + j for s in seqs])
                        drafts[:, j] = toks
                        poss = poss + 1
        except Exception as e:
            self._disable_draft(e)
            return self._step_plain(seqs)
        try:
            with obs_trace.attach(trace_ctx):
                windows = np.zeros((n, kmax + 1), np.int64)
                windows[:, 0] = [s.next_token for s in seqs]
                for i, s in enumerate(seqs):
                    windows[i, 1:1 + k_row[i]] = drafts[i, :k_row[i]]
                targets = self.engine.verify(
                    windows,
                    np.asarray([k + 1 for k in k_row], np.int32),
                    np.asarray([s.position for s in seqs], np.int32),
                    np.stack([s.table_row for s in seqs]),
                    params=params,
                    steps=[len(s.generated) for s in seqs])
        except Exception as e:
            if self.breaker is not None:
                self.breaker.record_failure()
            if self._pools_alive():
                # a failed verify degrades to ONE plain round: any
                # window K/V it wrote sits beyond the decode frontier
                # and is overwritten before it can ever be attended
                # (the frontier-overwrite invariant), so re-deciding
                # this iteration with plain decode is exact
                return self._step_plain(seqs)
            self._isolate_step_failure(seqs, e)
            return 0
        if self.breaker is not None:
            self.breaker.record_success()
        accepted = []
        for i in range(n):
            m = 0
            while m < k_row[i] and int(drafts[i, m]) == int(targets[i, m]):
                m += 1
            accepted.append(m)
        # a window accepted whole leaves its last draft token's K/V out
        # of the draft's pool (the draft proposed it but was never fed
        # it); one more draft step over those rows writes it, so the
        # next window's drafts attend over it. Its failure is a draft
        # failure like any other: the fallback, never a request failure
        full = [i for i in range(n) if kmax > 0 and accepted[i] == kmax]
        if full:
            try:
                with obs_trace.attach(trace_ctx):
                    self.draft.decode(
                        drafts[full, kmax - 1],
                        np.asarray([seqs[i].position for i in full],
                                   np.int32) + kmax,
                        np.stack([seqs[i].draft_row for i in full]),
                        params=None if params is None
                        else [params[i] for i in full],
                        steps=[len(seqs[i].generated) + kmax
                               for i in full])
            except Exception as e:
                self._disable_draft(e)
        dt = time.perf_counter() - t0
        emitted = 0
        for i, s in enumerate(seqs):
            row = targets[i]
            m = accepted[i]
            self.metrics.inc("spec_proposed_total", k_row[i])
            self.metrics.inc("spec_accepted_total", m)
            done = False
            # emit the verified prefix + the target's own token at the
            # first mismatch (or its extension when all drafts held)
            for tok in row[:m + 1]:
                emitted += 1
                done = s.note_token(tok)
                if done:
                    break
            if done:
                self.active.remove(s)
                self._retire(s)
        # accepted tokens, not steps: a multi-token verify reports its
        # real throughput (the DecodeMetrics.tokens_per_sec contract)
        self.metrics.note_decode_step(emitted, dt)
        self.metrics.active_sequences = len(self.active)
        return emitted

    def _expire_active(self) -> None:
        now = time.monotonic()
        for s in list(self.active):
            if s.req.deadline_t is not None and now > s.req.deadline_t:
                self.active.remove(s)
                self.metrics.inc("deadline_expired")
                err = DeadlineExceededError(
                    "generation exceeded its deadline after %d tokens"
                    % len(s.generated))
                err.tokens = list(s.generated)
                self._retire(s, error=err)

    def _pools_alive(self) -> bool:
        """Whether the engine's KV pools survived a failed execution
        (the port writes them in place, so they survive unless the
        scope lost them)."""
        return all(self.engine.scope.find_var(name) is not None
                   for name, _, _ in self.engine.pair.pool_specs)

    def _isolate_step_failure(self, seqs, exc) -> None:
        """Poison isolation, decode flavor: re-step each sequence alone
        (decode bucket 1, PLAIN decode — a speculative failure degrades
        to the non-speculative path for the round); only the one(s)
        that fail alone carry the error. If the failure consumed the
        donated pools themselves the engine cannot continue — every
        live sequence fails with its partial stream flushed."""
        if not self._pools_alive() or len(seqs) == 1:
            for s in seqs:
                if s in self.active:
                    self.active.remove(s)
                err = GenerationInterruptedError(
                    "decode step failed mid-generation: %r" % (exc,),
                    tokens=s.generated)
                err.__cause__ = exc
                self._retire(s, error=err)
            self.metrics.active_sequences = len(self.active)
            return
        for s in seqs:
            def _solo(seq=s):
                tok, = self.engine.decode(
                    np.asarray([seq.next_token]),
                    np.asarray([seq.position], np.int32),
                    seq.table_row[None, :],
                    params=self._sampling([seq]),
                    steps=[len(seq.generated)])
                return tok

            try:
                # solo re-step under the shared retry policy: transient
                # failures cost a counted retry, not the generation
                tok = self.restep_policy.call(
                    _solo, retriable=Exception,
                    on_retry=lambda a, e: self.metrics.inc(
                        "retries_total"),
                    span="resilience/decode_restep")
            except RetryError as re_err:
                e = re_err.last
                self.active.remove(s)
                err = GenerationInterruptedError(
                    "decode step failed for this sequence: %r" % (e,),
                    tokens=s.generated)
                err.__cause__ = e
                self._retire(s, error=err)
                continue
            self.metrics.note_decode_step(1, 0)
            if s.note_token(tok):
                self.active.remove(s)
                self._retire(s)
        self.metrics.active_sequences = len(self.active)

    # ------------------------------------------------------------------
    def _release(self, s: _Sequence) -> None:
        self.kv.release(s.sid)
        if self.draft_kv is not None and s.draft_sid is not None:
            self.draft_kv.release(s.draft_sid)

    def _retire(self, s: _Sequence, error: Optional[BaseException] = None,
                started: bool = True) -> None:
        self._release(s)
        if error is not None:
            self.metrics.inc("request_errors")
            if started:
                self.metrics.inc("sequences_interrupted")
            deliver(s.req.future, exc=error)
            return
        self.metrics.inc("sequences_completed")
        self.metrics.inc("responses_total")
        deliver(s.req.future, list(s.generated))

    def interrupt_all(self, reason: str) -> None:
        """Fail every live sequence with its partial stream (non-drain
        shutdown): typed error, tokens-so-far attached, futures always
        resolved."""
        for s in self.active:
            self._release(s)
            self.metrics.inc("request_errors")
            self.metrics.inc("sequences_interrupted")
            deliver(s.req.future, exc=GenerationInterruptedError(
                reason, tokens=s.generated))
        self.active.clear()
        self.metrics.active_sequences = 0
    # NOTE: after a speculative solo re-step (plain decode path) the
    # sequence continues speculating next iteration — the draft pools
    # self-heal because drafting always re-feeds from the sequence's
    # current (token, position) cursor and overwrites stale slots
    # before they can be attended.
