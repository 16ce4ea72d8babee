"""DecodeEngine: the execution layer of the decode subsystem
(counterpart of paddle_tpu/decoding/engine.py).

Owns the derived prefill/decode Program pair (rewrite.py) — plus the
EXTEND program when prefix caching or speculative decoding needs it —
the executor that runs them, and the bucket discipline that keeps every
call on a fixed set of shapes:

* prefill executes at ``(prefill_batch_bucket, prompt_bucket)`` shapes —
  prompts pad up to the next prompt bucket, rows pad with block-table
  ``-1`` rows whose cache writes are dropped;
* decode executes at ``decode_bucket`` batch shapes with ``T = 1`` —
  inactive rows carry ``positions = -1``;
* extend executes at ``(prefill_batch_bucket, suffix_bucket)`` shapes
  for prefix-cache suffix prefills and at
  ``(decode_bucket, speculate_k + 1)`` shapes for speculative verify
  steps — window slots past a row's length are masked by ``seq_lens``.

On a card every bucket is a captured CUDA graph (``Executor.run_graph``)
— the port's counterpart of the JAX engine's compiled buckets —
``warm_up()`` captures the full set, so traffic never pays a capture,
and a step costs one feed copy, one replay and one fetch copy. The
graphs of one engine share one memory pool: they replay one at a time
on one stream, and nothing a replay leaves behind lives in the pool (the
fetch buffers and the scope's tensors are allocated outside it). A
failed capture raises; nothing falls back to eager runs. On a CPU place
the programs run eagerly, since the CPU was asked for.

Every run is a timed ``metrics.span`` (``decoding/engine.*``, a
profiler span that joins the request's trace when ``obs.trace`` is on).
The ``decoding.prefill``, ``decoding.step`` and ``decoding.verify_step``
fault points fire on the host before the launch or replay, where the
JAX package fires them — never inside a captured region.

Decode-shape autotune (``DecodingConfig(autotune=True)``): ``warm_up``
first sweeps the paged kernel's launch knobs at exactly the shapes the
bucket config serves (:meth:`DecodeEngine.decode_tuning_problems`), on
the engine's device, publishing the winners to the tuning store; then it
prefetches the store's records, so every capture below resolves its
configs from memory.

Threading contract: single-threaded execution — the DecodeSession's
worker is the only caller after ``warm_up``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

import torch

from ..core import dtype_utils
from ..core.enforce import enforce
from ..core.scope import global_scope
from ..executor import Executor
from ..resilience import faults
from ..serving.metrics import DecodeMetrics
from .cache import CacheConfig
from .rewrite import (BLOCK_TABLES, CACHED_LENS, NEXT_TOKENS, POSITIONS,
                      SEQ_LENS, STEP_TOKENS, derive_decode_programs)
from .sampling import sampling_feed_arrays

PREFILL_SPAN = "decoding/engine.prefill"
DECODE_SPAN = "decoding/engine.decode"
EXTEND_SPAN = "decoding/engine.extend"
VERIFY_SPAN = "decoding/engine.verify"


def _pow2_buckets(lo: int, hi: int) -> List[int]:
    out = []
    b = lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return sorted(set(out))


class DecodingConfig:
    """Knobs for the decode stack (engine + batcher + session), with the
    JAX package's defaults.

    cache: the paged-pool geometry (CacheConfig — prefix caching and
        int8 KV pools live there).
    prompt_buckets: prompt lengths prefill runs at; prompts pad up to
        the next bucket. Default: powers of two from ``block_size`` to
        ``max_context``.
    decode_buckets: decode-step batch sizes; the largest is the
        continuous batcher's ``max_active`` slot count.
    prefill_batch_buckets: how many admissions one prefill (or suffix
        prefill) executes.
    suffix_buckets: window lengths the EXTEND program runs prefix-cache
        suffix prefills at (default: powers of two from 1 to
        ``max_context``; used only when ``cache.prefix_cache``).
    sampling: build the seeded per-request sampling heads
        (temperature/top-k/top-p, decoding/sampling.py) instead of the
        greedy heads. Default False: the greedy programs.
    speculate_k: draft-token window for speculative decoding (0 = off);
        a DecodeSession additionally needs a draft engine to use it.
        Adds the ``(decode_bucket, k + 1)`` verify shapes to warm-up.
    max_new_tokens: default generation budget per request.
    queue_capacity / default_deadline_ms / warm_up: the session's
        backpressure bound, default deadline and start-up warm-up (on a
        card: the captures of every bucket).
    breaker: a ``resilience.CircuitBreaker`` (as in ServingConfig);
        None (default) = disabled.
    degrade: a ``resilience.DegradationConfig`` (or a built
        ``DegradationManager``) enabling the ordered degradation ladder
        — token-budget admission per priority class, priority
        preemption, speculation shedding, stage-4 load shedding. None
        (default) = disabled, byte-identical admission; the ladder is a
        runtime plane and never changes programs.
    autotune: sweep the ``paged_attention`` kernel's launch knobs at
        exactly the (batch-bucket, q_tokens, window, block_size, heads,
        head_dim, kv_dtype) points this bucket config serves, as the
        first step of ``warm_up`` — winners persist in the tuning store
        (the ``tuning_cache_dir`` flag), so a second process warms with
        zero re-sweeps. Default False = no sweeps; the kernel runs its
        tuned or default configs.
    """

    def __init__(self, cache: Optional[CacheConfig] = None,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 decode_buckets: Sequence[int] = (1, 2, 4, 8),
                 prefill_batch_buckets: Sequence[int] = (1,),
                 suffix_buckets: Optional[Sequence[int]] = None,
                 sampling: bool = False,
                 speculate_k: int = 0,
                 max_new_tokens: int = 32,
                 queue_capacity: int = 256,
                 default_deadline_ms: Optional[float] = None,
                 warm_up: bool = True,
                 breaker=None,
                 degrade=None,
                 autotune: bool = False):
        self.cache = cache or CacheConfig()
        mc = self.cache.max_context
        if prompt_buckets:
            self.prompt_buckets = sorted(set(int(b)
                                             for b in prompt_buckets))
            enforce(self.prompt_buckets[0] >= 1, "prompt buckets >= 1")
            enforce(self.prompt_buckets[-1] <= mc,
                    "prompt bucket %d exceeds max_context %d"
                    % (self.prompt_buckets[-1], mc))
        else:
            self.prompt_buckets = _pow2_buckets(
                min(self.cache.block_size, mc), mc)
        self.decode_buckets = sorted(set(int(b) for b in decode_buckets))
        enforce(self.decode_buckets[0] >= 1, "decode buckets >= 1")
        self.prefill_batch_buckets = sorted(
            set(int(b) for b in prefill_batch_buckets))
        enforce(self.prefill_batch_buckets[0] >= 1,
                "prefill batch buckets >= 1")
        if suffix_buckets:
            self.suffix_buckets = sorted(set(int(b)
                                             for b in suffix_buckets))
            enforce(self.suffix_buckets[0] >= 1, "suffix buckets >= 1")
            enforce(self.suffix_buckets[-1] <= mc,
                    "suffix bucket %d exceeds max_context %d"
                    % (self.suffix_buckets[-1], mc))
        else:
            self.suffix_buckets = _pow2_buckets(1, mc)
        self.sampling = bool(sampling)
        self.speculate_k = int(speculate_k)
        enforce(self.speculate_k >= 0, "speculate_k must be >= 0")
        enforce(self.speculate_k < mc,
                "speculate_k %d must be < max_context %d"
                % (self.speculate_k, mc))
        self.max_new_tokens = int(max_new_tokens)
        self.queue_capacity = int(queue_capacity)
        self.default_deadline_ms = default_deadline_ms
        self.warm_up = bool(warm_up)
        self.breaker = breaker
        self.degrade = degrade
        self.autotune = bool(autotune)

    @property
    def max_active(self) -> int:
        """Decode slot count = the largest decode bucket."""
        return self.decode_buckets[-1]

    @property
    def max_prefill_batch(self) -> int:
        return self.prefill_batch_buckets[-1]

    @property
    def needs_extend(self) -> bool:
        """Whether the EXTEND program is derived and warmed: prefix
        caching (suffix prefills) or speculation (verify steps)."""
        return self.cache.prefix_cache or self.speculate_k > 0


def _bucket_for(buckets: Sequence[int], n: int) -> Optional[int]:
    for b in buckets:
        if b >= n:
            return b
    return None


class DecodeEngine:
    """Executes the prefill/decode(/extend) programs at bucketed shapes
    on one place (default ``CUDAPlace(0)``): on a card as captured CUDA
    graphs, one per bucket, on the CPU eagerly.

    ``_capture=False`` runs the programs eagerly on a card too, and
    ``_share_pool=False`` captures each graph into a pool of its own:
    private switches for comparing streams, times and memory against the
    captured default."""

    def __init__(self, program, token_name: str, logits_name: str,
                 scope=None, config: Optional[DecodingConfig] = None,
                 place=None, metrics: Optional[DecodeMetrics] = None,
                 _capture: bool = True, _share_pool: bool = True):
        self.config = config or DecodingConfig()
        self.metrics = metrics or DecodeMetrics()
        self._exe = Executor(place)
        self.device = self._exe.device
        self.pair = derive_decode_programs(
            program, token_name, logits_name, self.config.cache,
            with_extend=self.config.needs_extend,
            sampling=self.config.sampling)
        self.scope = scope if scope is not None else global_scope()
        self.pair.init_scope(self.scope, self.device)
        self._token_dtype = self.pair.prefill.global_block().var(
            token_name).dtype
        self.captured = bool(_capture) and self.device.type == "cuda"
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.captured and _share_pool else None)

    @property
    def cache_config(self) -> CacheConfig:
        return self.config.cache

    @property
    def sampling(self) -> bool:
        return self.pair.sampling

    @property
    def num_compiled(self) -> int:
        """CUDA graphs captured (one per bucket and fetch): after
        ``warm_up`` it equals ``warm_bucket_count()`` and traffic never
        adds one; 0 on the CPU and with ``_capture=False``."""
        return self._exe.num_compiled

    def _extend_warm_shapes(self) -> List[Tuple[int, int, str]]:
        """The (batch, window, fetch) extend shapes warm_up runs: suffix
        prefills pair prefill batch buckets with suffix buckets and
        fetch the last-position token; verify steps pair decode buckets
        with the one ``speculate_k + 1`` window and fetch the
        per-position token row (another fetch is another graph).
        Deduplicated."""
        cfg = self.config
        shapes = set()
        if cfg.cache.prefix_cache:
            for pb in cfg.prefill_batch_buckets:
                for wb in cfg.suffix_buckets:
                    shapes.add((pb, wb, NEXT_TOKENS))
        if cfg.speculate_k > 0:
            for db in cfg.decode_buckets:
                shapes.add((db, cfg.speculate_k + 1, STEP_TOKENS))
        return sorted(shapes)

    def decode_tuning_problems(self) -> List[dict]:
        """The exact ``paged_attention`` tuning points this engine's
        bucket config serves: one per (batch bucket, q_tokens) pair the
        decode/verify/suffix legs run at, crossed with each distinct
        (heads, head_dim) pool geometry — deduplicated by the kernel's
        shape bucket, so the sweep list is the minimal cover of what
        ``warm_up`` captures. The JAX engine's list for the same
        config."""
        from ..tuning import get_tunable

        cfg = self.config
        cc = cfg.cache
        kv = "int8" if cc.kv_dtype == "int8" else "f32"
        window = cc.max_blocks_per_seq * cc.block_size
        geoms = sorted({(s[1][2], s[1][3])
                        for s in self.pair.pool_specs
                        if s[0].endswith(".k")})
        points = {(db, 1) for db in cfg.decode_buckets}
        if cfg.speculate_k > 0:
            points |= {(db, cfg.speculate_k + 1)
                       for db in cfg.decode_buckets}
        if cc.prefix_cache:
            points |= {(pb, wb) for pb in cfg.prefill_batch_buckets
                       for wb in cfg.suffix_buckets}
        k = get_tunable("paged_attention")
        out, seen = [], set()
        for b, t in sorted(points):
            for heads, head_dim in geoms:
                p = {"batch": b, "q_tokens": t, "window": window,
                     "block_size": cc.block_size, "heads": heads,
                     "head_dim": head_dim, "kv_dtype": kv}
                key = tuple(sorted(k.bucket_key(p).items()))
                if key not in seen:
                    seen.add(key)
                    out.append(p)
        return out

    def decode_tuning_dtype(self) -> str:
        """The dtype the paged launches look their configs up by: the
        queries', which the pools share unless they are int8 (then the
        attention's own dtype, read from the decode program)."""
        gb = self.pair.decode.global_block()
        op = next(op for op in gb.ops
                  if op.type == "paged_attention_decode")
        return dtype_utils.name(gb.var(op.input("Q")[0]).dtype)

    def autotune_decode_shapes(self, iters: int = 16,
                               samples: int = 3) -> int:
        """Sweep ``paged_attention`` at every decode_tuning_problems()
        point on the engine's device; winners publish to the active
        TuningStore, so a second process resolves them with zero
        re-sweeps, and a point that already has a store record is
        returned without measuring. A geometry no candidate is valid
        for (the generic route's, which reads no knob) is skipped with
        a warning. Returns the number of points swept or reused."""
        import warnings

        from .. import tuning as _tuning

        k = _tuning.get_tunable("paged_attention")
        dtype = self.decode_tuning_dtype()
        n = 0
        for problem in self.decode_tuning_problems():
            if not k.candidates(problem):
                warnings.warn(
                    "decode autotune: no eligible paged_attention "
                    "config for %r (machine-checked constraints) — the "
                    "kernel runs its generic route" % (problem,))
                continue
            _tuning.sweep("paged_attention", problem, dtype=dtype,
                          device=self.device, iters=iters,
                          samples=samples)
            n += 1
        return n

    def warm_bucket_count(self) -> int:
        return (len(self.config.prefill_batch_buckets)
                * len(self.config.prompt_buckets)
                + len(self.config.decode_buckets)
                + len(self._extend_warm_shapes()))

    def prompt_bucket_for(self, length: int) -> Optional[int]:
        return _bucket_for(self.config.prompt_buckets, length)

    def suffix_bucket_for(self, length: int) -> Optional[int]:
        return _bucket_for(self.config.suffix_buckets, length)

    def warm_up(self) -> int:
        """Run every (prefill batch x prompt), decode, suffix and verify
        bucket once with inert feeds (block tables all -1, so every
        cache write drops and warm-up cannot disturb live pools; extend
        rows carry ``cached`` 0 and length 0): on a card each run
        captures its bucket's graph. Returns ``num_compiled``.

        Tuned kernel configs prefetch from the tuning store first, so
        every capture below resolves its launch configs from memory —
        the contract of ``serving.BucketedEngine.warm_up``. With
        ``config.autotune`` the decode-shape sweep runs before that, so
        the captures use the configs it just elected."""
        from .. import tuning as _tuning

        if self.config.autotune:
            self.autotune_decode_shapes()
        progs = [self.pair.prefill, self.pair.decode]
        if self.pair.extend is not None:
            progs.append(self.pair.extend)
        _tuning.prefetch(*progs)
        cfg = self.config
        for pb in cfg.prefill_batch_buckets:
            for tb in cfg.prompt_buckets:
                rows = [np.zeros(tb, np.int64)] * pb
                self.prefill(rows, np.stack([self._empty_row()] * pb),
                             np.zeros(pb, np.int32), _warm=True)
        for db in cfg.decode_buckets:
            self.decode(np.zeros(db, np.int64), np.full(db, -1, np.int32),
                        np.stack([self._empty_row()] * db), _warm=True)
        for bb, wb, fetch in self._extend_warm_shapes():
            self._run_extend(np.zeros((bb, wb), self._token_dtype),
                             np.stack([self._empty_row()] * bb),
                             np.zeros(bb, np.int32), np.zeros(bb, np.int32),
                             fetch=fetch, params=None, steps=None,
                             span=EXTEND_SPAN, hist=None)
        return self.num_compiled

    def release(self) -> None:
        """Free the device memory this engine holds: its captured graphs
        and its KV pools (None in the scope from here on). For a
        replica being killed, once no call of the engine is running;
        the engine serves nothing after it."""
        self._exe._cache.clear()
        for name, _, _ in self.pair.pool_specs:
            self.scope.set_var(name, None)

    def _empty_row(self) -> np.ndarray:
        return self.cache_config.empty_table_row()

    def _sampling_feed(self, params, steps, bucket: int) -> dict:
        """The five per-row sampling feed arrays (only when the pair was
        derived with the sampling heads)."""
        if not self.pair.sampling:
            return {}
        params = params or []
        steps = steps if steps is not None else [0] * len(params)
        return sampling_feed_arrays(params, steps, bucket)

    def _run(self, program, feed, fetch: str) -> np.ndarray:
        """One run of a derived program: its bucket's graph on a card,
        eagerly on the CPU (or with ``_capture=False``)."""
        if self.captured:
            out, = self._exe.run_graph(program, feed=feed,
                                       fetch_list=[fetch], scope=self.scope,
                                       pool=self._pool)
        else:
            out, = self._exe.run(program, feed=feed, fetch_list=[fetch],
                                 scope=self.scope)
        return out

    def prefill(self, token_rows: Sequence[np.ndarray],
                tables: np.ndarray, seq_lens: np.ndarray,
                params=None, steps=None,
                _warm: bool = False) -> np.ndarray:
        """Run one prefill for ``len(token_rows)`` sequences: pads the
        batch to the next prefill batch bucket and every prompt to the
        next prompt bucket, writes the prompt K/V into the pools at the
        table slots, returns the first generated token per row.
        ``params``/``steps``: per-row SamplingParams and the stream
        index of the emitted token (default 0) for the sampling head."""
        n = len(token_rows)
        enforce(n >= 1, "prefill needs at least one row")
        pb = _bucket_for(self.config.prefill_batch_buckets, n)
        enforce(pb is not None,
                "prefill batch %d exceeds the largest prefill batch "
                "bucket %d" % (n, self.config.max_prefill_batch))
        longest = max(len(r) for r in token_rows)
        tb = self.prompt_bucket_for(longest)
        enforce(tb is not None,
                "prompt length %d exceeds the largest prompt bucket %d"
                % (longest, self.config.prompt_buckets[-1]))
        tokens = np.zeros((pb, tb), dtype=self._token_dtype)
        for i, r in enumerate(token_rows):
            tokens[i, :len(r)] = np.asarray(r)
        mb = self.cache_config.max_blocks_per_seq
        tab = np.full((pb, mb), -1, np.int32)
        tab[:n] = np.asarray(tables, np.int32)
        lens = np.zeros(pb, np.int32)
        lens[:n] = np.asarray(seq_lens, np.int32)
        if not _warm:
            self.metrics.inc("prefills_total")
            self.metrics.inc("prefill_rows_total", n)
            self.metrics.inc("prefill_tokens_computed_total",
                             int(np.sum(lens[:n])))
            # chaos hook: exercises per-sequence re-prefill isolation
            faults.fire("decoding.prefill")
            self.metrics.inc("batched_rows_total", pb)
            self.metrics.inc("padded_rows_total", pb - n)
        feed = {self.pair.token_name: tokens, BLOCK_TABLES: tab,
                SEQ_LENS: lens}
        feed.update(self._sampling_feed(
            params, steps if steps is not None else [0] * n, pb))
        with self.metrics.span(PREFILL_SPAN,
                               None if _warm
                               else self.metrics.prefill_latency):
            out = self._run(self.pair.prefill, feed, NEXT_TOKENS)
        return out[:n]

    def extend_prefill(self, suffix_rows: Sequence[np.ndarray],
                       tables: np.ndarray, cached_lens: np.ndarray,
                       params=None, steps=None) -> np.ndarray:
        """Prefix-cache suffix prefill: run ONLY the un-cached suffix of
        each prompt against the already-populated shared prefix blocks
        (``cached_lens[b]`` positions). Pads the batch to the next
        prefill batch bucket and the window to the next suffix bucket;
        returns the first generated token per row."""
        enforce(self.pair.extend is not None,
                "extend_prefill needs CacheConfig(prefix_cache=True)")
        n = len(suffix_rows)
        enforce(n >= 1, "extend_prefill needs at least one row")
        bb = _bucket_for(self.config.prefill_batch_buckets, n)
        enforce(bb is not None,
                "extend batch %d exceeds the largest prefill batch "
                "bucket %d" % (n, self.config.max_prefill_batch))
        longest = max(len(r) for r in suffix_rows)
        wb = self.suffix_bucket_for(longest)
        enforce(wb is not None,
                "suffix length %d exceeds the largest suffix bucket %d"
                % (longest, self.config.suffix_buckets[-1]))
        tokens = np.zeros((bb, wb), dtype=self._token_dtype)
        lens = np.zeros(bb, np.int32)
        for i, r in enumerate(suffix_rows):
            tokens[i, :len(r)] = np.asarray(r)
            lens[i] = len(r)
        mb = self.cache_config.max_blocks_per_seq
        tab = np.full((bb, mb), -1, np.int32)
        tab[:n] = np.asarray(tables, np.int32)
        cached = np.zeros(bb, np.int32)
        cached[:n] = np.asarray(cached_lens, np.int32)
        self.metrics.inc("prefills_total")
        self.metrics.inc("prefill_rows_total", n)
        self.metrics.inc("prefill_tokens_computed_total",
                         int(np.sum(lens[:n])))
        faults.fire("decoding.prefill")
        self.metrics.inc("batched_rows_total", bb)
        self.metrics.inc("padded_rows_total", bb - n)
        return self._run_extend(
            tokens, tab, cached, lens, fetch=NEXT_TOKENS, params=params,
            steps=steps if steps is not None else [0] * n,
            span=EXTEND_SPAN, hist=self.metrics.extend)[:n]

    def verify(self, windows: np.ndarray, window_lens: np.ndarray,
               cached_lens: np.ndarray, tables: np.ndarray,
               params=None, steps=None) -> np.ndarray:
        """Speculative verify: one multi-token target step over the live
        set. ``windows[b]`` = [last_token, draft_1..draft_k] (``window_lens
        [b]`` real slots, padded to the ``speculate_k + 1`` bucket);
        returns the per-position target tokens ``[n, speculate_k + 1]``
        — the greedy or sampled token the TARGET model produces at each
        window position."""
        enforce(self.pair.extend is not None and
                self.config.speculate_k > 0,
                "verify needs DecodingConfig(speculate_k >= 1)")
        n = len(windows)
        enforce(n >= 1, "verify needs at least one row")
        db = _bucket_for(self.config.decode_buckets, n)
        enforce(db is not None,
                "active set %d exceeds the largest decode bucket %d"
                % (n, self.config.max_active))
        w = self.config.speculate_k + 1
        enforce(np.shape(windows)[1] <= w,
                "verify window wider than speculate_k + 1")
        tokens = np.zeros((db, w), dtype=self._token_dtype)
        tokens[:n, :np.shape(windows)[1]] = np.asarray(windows)
        lens = np.zeros(db, np.int32)
        lens[:n] = np.asarray(window_lens, np.int32)
        cached = np.zeros(db, np.int32)
        cached[:n] = np.asarray(cached_lens, np.int32)
        mb = self.cache_config.max_blocks_per_seq
        tab = np.full((db, mb), -1, np.int32)
        tab[:n] = np.asarray(tables, np.int32)
        self.metrics.inc("verify_steps_total")
        self.metrics.inc("verify_rows_total", n)
        self.metrics.inc("decode_rows_total", n)
        # chaos hook: a failing verify degrades the round to plain
        # decoding (its own site, so a plan can target speculation)
        faults.fire("decoding.verify_step")
        self.metrics.inc("batched_rows_total", db)
        self.metrics.inc("padded_rows_total", db - n)
        return self._run_extend(tokens, tab, cached, lens,
                                fetch=STEP_TOKENS, params=params,
                                steps=steps, span=VERIFY_SPAN,
                                hist=self.metrics.verify)[:n]

    def _run_extend(self, tokens, tab, cached, lens, fetch: str, params,
                    steps, span: str, hist) -> np.ndarray:
        feed = {self.pair.token_name: tokens, BLOCK_TABLES: tab,
                CACHED_LENS: cached, SEQ_LENS: lens}
        feed.update(self._sampling_feed(params, steps, len(tokens)))
        with self.metrics.span(span, hist):
            return self._run(self.pair.extend, feed, fetch)

    def decode(self, tokens: np.ndarray, positions: np.ndarray,
               tables: np.ndarray, params=None, steps=None,
               _warm: bool = False) -> np.ndarray:
        """One decode step for ``len(tokens)`` sequences (their latest
        token, its position and their table rows); pads the batch to the
        next decode bucket with inactive rows. Returns the next token
        per row."""
        n = len(tokens)
        enforce(n >= 1, "decode needs at least one row")
        db = _bucket_for(self.config.decode_buckets, n)
        enforce(db is not None,
                "active set %d exceeds the largest decode bucket %d"
                % (n, self.config.max_active))
        toks = np.zeros((db, 1), dtype=self._token_dtype)
        toks[:n, 0] = np.asarray(tokens)
        pos = np.full(db, -1, np.int32)
        pos[:n] = np.asarray(positions, np.int32)
        mb = self.cache_config.max_blocks_per_seq
        tab = np.full((db, mb), -1, np.int32)
        tab[:n] = np.asarray(tables, np.int32)
        if not _warm:
            self.metrics.inc("decode_steps_total")
            self.metrics.inc("decode_rows_total", n)
            # chaos hook: exercises the batcher's solo re-steps
            faults.fire("decoding.step")
            self.metrics.inc("batched_rows_total", db)
            self.metrics.inc("padded_rows_total", db - n)
        feed = {self.pair.token_name: toks, BLOCK_TABLES: tab,
                POSITIONS: pos}
        feed.update(self._sampling_feed(params, steps, db))
        with self.metrics.span(DECODE_SPAN,
                               None if _warm
                               else self.metrics.decode_step):
            out = self._run(self.pair.decode, feed, NEXT_TOKENS)
        return out[:n]
