"""Prefix caching in paddle_tpu_torch.decoding, held to paddle_tpu's on
the CPU.

* ``KVCacheManager``: one seeded random sequence of admissions,
  commits, publishes, releases, adoptions and drops through both
  packages' managers gives equal tables, cached lengths, hex-equal chain
  keys and equal block counts; the JAX package's manager cases pass on
  the port.
* The extend op (suffix window against a populated prefix) agrees with
  the JAX package's jitted ``_paged_extend_attention`` within 1e-5 and
  writes bit-equal pool rows, leaving the others untouched.
* ``derive_decode_programs(with_extend=True)`` gives the JAX package's
  extend program (op types, symbol table, feeds, fetches).
* A suffix prefill over a prefilled prefix gives the full prefill's
  next-token logits, and the JAX extend program's, within 1e-5.
* The shared-prefix workload of tests/test_decoding_fleet.py: 7 hits,
  1 miss, 7·16 prompt tokens avoided, streams token-identical to the
  JAX package's plain greedy streams and to the port without prefix
  caching; abort plus drain under shared prefixes leaks no block.
"""

import concurrent.futures as cf
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.decoding as jdec
import paddle_tpu_torch as tfluid
import paddle_tpu_torch.decoding as tdec
from paddle_tpu.decoding import rewrite as j_rewrite
from paddle_tpu_torch.decoding import rewrite as t_rewrite

from _torch_port import (CACHE, carried_scope, jax_lm, symbol_table,
                         torch_lm)

torch.set_num_threads(1)

CPU = tfluid.CPUPlace()
# small bucket sets keep the JAX package's compiles cheap
BUCKETS = dict(decode_buckets=(1, 2, 4), suffix_buckets=(1, 2, 4, 8, 16))
SHARED = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3]


@pytest.fixture(scope="module")
def lm():
    j_main, j_scope, j_logits = jax_lm()
    t_main, _, t_logits = torch_lm()
    t_scope = carried_scope(j_main, j_scope, t_main)
    return j_main, j_scope, j_logits, t_main, t_scope, t_logits


def _config(pkg, prefix_cache, **kw):
    return pkg.DecodingConfig(
        cache=pkg.CacheConfig(prefix_cache=prefix_cache, **CACHE),
        **{**BUCKETS, "max_new_tokens": 12, **kw})


def _serve(pkg, lm, prefix_cache, **kw):
    if pkg is jdec:
        main, scope, logits = lm[:3]
        return jdec.serve_decoding(main, "tokens", logits.name, scope=scope,
                                   config=_config(jdec, prefix_cache, **kw))
    main, scope, logits = lm[3:]
    return tdec.serve_decoding(main, "tokens", logits.name, scope=scope,
                               config=_config(tdec, prefix_cache, **kw),
                               place=CPU)


# ------------------------------------------------------------- manager


def _state(kv, live, prompts):
    return {"tables": {s: kv.table_row(s).tolist() for s in live},
            "counts": (kv.free_blocks, kv.used_blocks, kv.live_sequences,
                       kv.cached_blocks, kv.evictable_blocks,
                       kv.reclaimable_blocks),
            "keys": [kv.prefix_keys(p) for p in prompts],
            "match": [kv.match_prefix(p) for p in prompts],
            "spans": [kv.export_span(p) for p in prompts]}


def test_manager_differential_against_jax():
    cfg = dict(num_blocks=14, block_size=4, max_blocks_per_seq=6,
               prefix_cache=True)
    assert tdec.CacheConfig(**cfg).digest() == \
        jdec.CacheConfig(**cfg).digest() == "paged14x4x6"
    jkv = jdec.KVCacheManager(jdec.CacheConfig(**cfg))
    tkv = tdec.KVCacheManager(tdec.CacheConfig(**cfg))
    rng = np.random.RandomState(7)
    stems = [rng.randint(0, 50, 16).tolist() for _ in range(3)]
    prompts = [stems[i % 3][:rng.randint(1, 17)]
               + rng.randint(0, 50, rng.randint(0, 5)).tolist()
               for i in range(12)]
    prompts = [p for p in prompts if p]
    live, ops, hits = [], [], 0
    for step in range(160):
        r = rng.rand()
        if r < 0.4 or not live:
            p = prompts[rng.randint(len(prompts))]
            new = int(rng.randint(1, 24 - len(p) + 1)) \
                if len(p) < 24 else 0
            if new == 0:
                continue
            ja, ta = jkv.admit_tokens(p, new), tkv.admit_tokens(p, new)
            assert ta == ja, step
            if ta is not None:
                live.append((ta[0], p))
                hits += ta[1] > 0
            ops.append("admit")
        elif r < 0.6:
            sid, _ = live[rng.randint(len(live))]
            jkv.commit_prefix(sid)
            tkv.commit_prefix(sid)
            ops.append("commit")
        elif r < 0.7:
            sid, p = live[rng.randint(len(live))]
            grown = p + rng.randint(0, 50, rng.randint(0, 6)).tolist()
            assert tkv.publish_prefix(sid, grown) == \
                jkv.publish_prefix(sid, grown)
            ops.append("publish")
        elif r < 0.88:
            sid, _ = live.pop(rng.randint(len(live)))
            jkv.release(sid)
            tkv.release(sid)
            ops.append("release")
        elif r < 0.95:
            key = jkv.prefix_keys(prompts[rng.randint(len(prompts))])
            key = key[-1] if key else "k%d" % step
            assert tkv.adopt_cached_block(key) == \
                jkv.adopt_cached_block(key)
            ops.append("adopt")
        else:
            assert tkv.drop_prefix_cache() == jkv.drop_prefix_cache()
            ops.append("drop")
        assert _state(tkv, [s for s, _ in live], prompts) == \
            _state(jkv, [s for s, _ in live], prompts), (step, ops[-1])
    # the walk reached every operation, and prefix hits
    assert set(ops) == {"admit", "commit", "publish", "release", "adopt",
                        "drop"}
    assert hits >= 5
    keys = tkv.prefix_keys(prompts[0])
    assert keys and all(len(k) == 64 for k in keys)
    for sid, _ in live:
        jkv.release(sid)
        tkv.release(sid)
    assert tkv.reclaimable_blocks == jkv.reclaimable_blocks == 14
    assert tkv.import_span(keys) == jkv.import_span(keys)


@pytest.mark.parametrize("kw", [{}, {"kv_dtype": "int8"},
                                {"prefix_cache": True},
                                {"kv_dtype": "int8", "prefix_cache": True}],
                         ids=["plain", "int8", "prefix", "int8_prefix"])
def test_cache_config_digest_and_repr_match_jax(kw):
    geo = dict(num_blocks=512, block_size=16, max_blocks_per_seq=32)
    t, j = tdec.CacheConfig(**geo, **kw), jdec.CacheConfig(**geo, **kw)
    assert t.digest() == j.digest()
    assert repr(t) == repr(j)
    assert t.digest() == ("paged512x16x32-int8kv" if kw.get("kv_dtype")
                          else "paged512x16x32")


def _case_hash_refcount_lru(dec):
    kv = dec.KVCacheManager(dec.CacheConfig(num_blocks=8, block_size=4,
                                            max_blocks_per_seq=4,
                                            prefix_cache=True))
    prompt = [1, 2, 3, 4, 5, 6, 7, 8, 9]  # 2 full blocks + 1 token
    sid, cached = kv.admit_tokens(prompt, 3)
    assert cached == 0  # nothing committed yet
    assert kv.match_prefix(prompt) == 0
    kv.commit_prefix(sid)
    assert kv.cached_blocks == 2
    assert kv.match_prefix(prompt) == 8
    # a second identical prompt shares both full blocks
    sid2, cached2 = kv.admit_tokens(prompt, 3)
    assert cached2 == 8
    t1, t2 = kv.table_row(sid), kv.table_row(sid2)
    assert list(t1[:2]) == list(t2[:2])      # shared prefix blocks
    assert t1[2] != t2[2]                    # private tails
    # a prompt diverging inside block 2 shares only block 1
    sid3, cached3 = kv.admit_tokens([1, 2, 3, 4, 9, 9, 9, 9, 9], 3)
    assert cached3 == 4
    kv.commit_prefix(sid3)  # publishes its divergent second block
    for s in (sid, sid2, sid3):
        kv.release(s)
    assert kv.live_sequences == 0
    assert kv.reclaimable_blocks == kv.config.num_blocks
    assert kv.cached_blocks == 3  # 2 shared + sid3's divergent block
    # cached content still hits after release
    sid4, cached4 = kv.admit_tokens(prompt, 3)
    assert cached4 == 8
    kv.release(sid4)
    # memory pressure evicts LRU cached blocks rather than refusing
    sids = []
    for i in range(2):
        got = kv.admit_tokens([10 + i] * 13, 3)  # 4 blocks each
        assert got is not None
        sids.append(got[0])
    assert kv.cached_blocks < 3  # something was evicted
    for s in sids:
        kv.release(s)
    kv.drop_prefix_cache()
    assert kv.free_blocks == kv.config.num_blocks


def _case_never_shares_the_whole_prompt(dec):
    """At least the final prompt position is always computed fresh."""
    kv = dec.KVCacheManager(dec.CacheConfig(num_blocks=8, block_size=4,
                                            max_blocks_per_seq=4,
                                            prefix_cache=True))
    prompt = [1, 2, 3, 4, 5, 6, 7, 8]  # exactly 2 full blocks
    sid, _ = kv.admit_tokens(prompt, 2)
    kv.commit_prefix(sid)
    assert kv.match_prefix(prompt) == 4  # only block 1 is shareable
    kv.release(sid)


def _case_eviction_counter(dec):
    """A fresh reservation reclaiming a cached block counts it."""
    from paddle_tpu_torch.serving.metrics import DecodeMetrics

    m = DecodeMetrics()
    kv = dec.KVCacheManager(dec.CacheConfig(num_blocks=4, block_size=4,
                                            max_blocks_per_seq=4,
                                            prefix_cache=True), metrics=m)
    sid, _ = kv.admit_tokens(list(range(9)), 3)
    kv.commit_prefix(sid)
    kv.release(sid)
    assert kv.evictable_blocks == 2
    kv.release(kv.admit_tokens([7] * 13, 3)[0])
    assert m.report()["prefix_blocks_evicted_total"] == 2


@pytest.mark.parametrize("case", [_case_hash_refcount_lru,
                                  _case_never_shares_the_whole_prompt,
                                  _case_eviction_counter],
                         ids=["hash_refcount_lru", "never_whole_prompt",
                              "eviction_counter"])
def test_prefix_manager_cases(case):
    case(tdec)


# ------------------------------------------------------------ extend op


def _extend_problem(seed=0, B=3, T=4, H=2, D=8, nb=10, bs=4, mb=4):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.standard_normal((B, T, H * D)).astype(np.float32)
               for _ in range(3))
    kc = rng.standard_normal((nb, bs, H, D)).astype(np.float32)
    vc = rng.standard_normal((nb, bs, H, D)).astype(np.float32)
    tables = np.stack([rng.permutation(nb)[:mb] for _ in range(B)]
                      ).astype(np.int32)
    tables[1, 3:] = -1
    tables[2, :] = -1                      # an inactive padding row
    cached = np.array([5, 8, 0], np.int32)
    lens = np.array([4, 3, 0], np.int32)   # row 0 runs past the window
    return q, k, v, kc, vc, tables, cached, lens


def test_extend_op_matches_jax():
    import jax
    import jax.numpy as jnp

    prob = _extend_problem()
    q, k, v, kc, vc, tables, cached, lens = prob
    H, bs = 2, 4
    j_fn = jax.jit(lambda *a: j_rewrite._paged_extend_attention(
        *a, n_head=H, block_size=bs))
    j_out, j_kc, j_vc = (np.asarray(x) for x in j_fn(
        *(jnp.asarray(a) for a in prob)))
    t_args = [torch.from_numpy(a.copy()) for a in prob]
    t_out, t_kc, t_vc = t_rewrite._paged_extend_attention(
        *t_args, n_head=H, block_size=bs)
    assert t_kc is t_args[3] and t_vc is t_args[4]   # written in place
    np.testing.assert_allclose(t_out.numpy(), j_out, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t_kc.numpy(), j_kc)
    np.testing.assert_array_equal(t_vc.numpy(), j_vc)
    # exactly the valid window slots were written; the rest unchanged
    written = np.zeros(kc.shape[:2], bool)
    for b in range(3):
        for t in range(lens[b]):
            p = cached[b] + t
            if p < 16 and tables[b, p // bs] >= 0:
                written[tables[b, p // bs], p % bs] = True
    assert written.sum() == 6
    np.testing.assert_array_equal(t_kc.numpy()[~written], kc[~written])
    assert not np.array_equal(t_kc.numpy()[written], kc[written])


# ----------------------------------------------------- derived programs


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
def test_derived_extend_program_matches_jax(lm, kv_dtype):
    j_main, _, j_logits, t_main, _, t_logits = lm
    cfg = dict(CACHE, prefix_cache=True, kv_dtype=kv_dtype)
    jp = jdec.derive_decode_programs(j_main, "tokens", j_logits.name,
                                     jdec.CacheConfig(**cfg),
                                     with_extend=True)
    tp = tdec.derive_decode_programs(t_main, "tokens", t_logits.name,
                                     tdec.CacheConfig(**cfg),
                                     with_extend=True)
    for j_prog, t_prog in ((jp.prefill, tp.prefill), (jp.decode, tp.decode),
                           (jp.extend, tp.extend)):
        assert [op.type for op in t_prog.global_block().ops] == \
            [op.type for op in j_prog.global_block().ops]
        assert symbol_table(t_prog) == symbol_table(j_prog)
    assert (tp.extend_feeds, tp.extend_fetches) == \
        (jp.extend_feeds, jp.extend_fetches)
    att = [op for op in tp.extend.global_block().ops
           if op.type == "paged_attention_extend"]
    j_att = [op for op in jp.extend.global_block().ops
             if op.type == "paged_attention_extend"]
    assert [(op.inputs, op.outputs) for op in att] == \
        [(op.inputs, op.outputs) for op in j_att]
    assert [op.attrs.get("kv_dtype") for op in att] == [kv_dtype] * 2


# ------------------------------------------------------- suffix prefill


def _suffix_vs_full(dec, engine, run):
    """Prefill the 16-token shared prefix, then extend by a 2-token
    suffix; and prefill the whole 18-token prompt into other blocks.
    Returns (extend next logits, extend step tokens, full next
    logits)."""
    prompt = SHARED + [2, 3]
    kv = dec.KVCacheManager(engine.cache_config)
    sid = kv.admit(len(prompt), 4)
    sid_full = kv.admit(len(prompt), 4)
    table = kv.table_row(sid)[None]
    run(engine.pair.prefill,
        {"tokens": np.asarray([SHARED], np.int64),
         dec.BLOCK_TABLES: table, dec.SEQ_LENS: np.asarray([16], np.int32)},
        [dec.NEXT_TOKENS])
    ext_logits, steps = run(
        engine.pair.extend,
        {"tokens": np.asarray([[2, 3, 0, 0]], np.int64),
         dec.BLOCK_TABLES: table,
         dec.CACHED_LENS: np.asarray([16], np.int32),
         dec.SEQ_LENS: np.asarray([2], np.int32)},
        [dec.NEXT_LOGITS, dec.STEP_TOKENS])
    full = np.zeros((1, 32), np.int64)
    full[0, :18] = prompt
    full_logits, = run(
        engine.pair.prefill,
        {"tokens": full, dec.BLOCK_TABLES: kv.table_row(sid_full)[None],
         dec.SEQ_LENS: np.asarray([18], np.int32)}, [dec.NEXT_LOGITS])
    return np.asarray(ext_logits), np.asarray(steps), np.asarray(full_logits)


def test_suffix_prefill_matches_full_prefill_and_jax(lm):
    j_main, j_scope, j_logits, t_main, t_scope, t_logits = lm
    t_engine = tdec.DecodeEngine(t_main, "tokens", t_logits.name,
                                 scope=t_scope,
                                 config=_config(tdec, True, warm_up=False),
                                 place=CPU)
    t_exe = tfluid.Executor(CPU)
    t_ext, t_steps, t_full = _suffix_vs_full(
        tdec, t_engine,
        lambda prog, feed, fetch: t_exe.run(prog, feed=feed,
                                            fetch_list=fetch, scope=t_scope))
    j_engine = jdec.DecodeEngine(j_main, "tokens", j_logits.name,
                                 scope=j_scope,
                                 config=_config(jdec, True, warm_up=False))

    def j_run(prog, feed, fetch):
        with jfluid.scope_guard(j_engine.scope):
            return jfluid.Executor().run(prog, feed=feed, fetch_list=fetch)

    j_ext, j_steps, _ = _suffix_vs_full(jdec, j_engine, j_run)
    np.testing.assert_allclose(t_ext, t_full, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_ext, j_ext, rtol=1e-5, atol=1e-5)
    assert t_steps.shape == (1, 4) and t_steps.dtype == np.int32
    np.testing.assert_array_equal(t_steps[:, :2], j_steps[:, :2])
    assert t_steps[0, 1] == np.argmax(t_ext[0])


# ------------------------------------------------- end-to-end workload


def _fire(session, prompts):
    with cf.ThreadPoolExecutor(max_workers=4) as pool:
        return list(pool.map(
            lambda p: session.generate(p, max_new_tokens=8, timeout=300),
            prompts))


def test_shared_prefix_workload_matches_jax(lm):
    prompts = [SHARED + [t] for t in range(8)]
    j = _serve(jdec, lm, False)
    try:
        want = [j.generate(p, max_new_tokens=8, timeout=300)
                for p in prompts]
    finally:
        j.shutdown(drain=True, timeout=60)
    reports = {}
    for prefix_cache in (False, True):
        s = _serve(tdec, lm, prefix_cache)
        try:
            assert _fire(s, prompts) == want
        finally:
            s.shutdown(drain=True, timeout=60)
        reports[prefix_cache] = s.metrics.report()
    on, off = reports[True], reports[False]
    assert (on["prefix_cache_hits_total"],
            on["prefix_cache_misses_total"]) == (7, 1)
    assert on["prefill_tokens_avoided_total"] == 7 * 16
    assert on["prefix_hit_rate"] == pytest.approx(7 / 8)
    assert off["prefill_tokens_avoided_total"] == 0
    assert (off["prefix_cache_hits_total"],
            off["prefix_cache_misses_total"]) == (0, 0)
    # one full prefill and 7 suffix prefills of one token each
    assert on["prefill_latency"]["count"] == 1 and \
        on["extend"]["count"] == 7
    assert on["prefills_total"] == off["prefills_total"] == 8
    assert on["prefill_tokens_computed_total"] == 17 + 7
    assert off["prefill_tokens_computed_total"] == 8 * 17


def test_abort_and_drain_under_shared_prefixes_leaves_pool_free(lm):
    """Interleaved completions, a mid-generation abort (drain=False) and
    queued kills under shared prefixes leave the manager with no live
    sequence and a fully reclaimable pool."""
    s = _serve(tdec, lm, True, max_new_tokens=16)
    shared = SHARED[:9]
    started = threading.Event()
    futs = [s.submit(shared + [i], max_new_tokens=16,
                     on_token=lambda t: started.set())
            for i in range(4)]
    assert started.wait(timeout=60)
    s.shutdown(drain=False, timeout=60)
    for f in futs:
        assert f.exception(timeout=10) is not None  # flushed, typed
    kv = s.kv
    assert kv.live_sequences == 0
    assert kv.reclaimable_blocks == kv.config.num_blocks
    kv.drop_prefix_cache()
    assert kv.free_blocks == kv.config.num_blocks
