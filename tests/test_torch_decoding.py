"""paddle_tpu_torch.decoding held to paddle_tpu.decoding on the CPU.

The same small causal LM (vocab 37, 2 layers, 2 heads, d_model 32) is
built with the same calls in both packages and the JAX package's
perturbed weights are carried into the port. Then:

* ``derive_decode_programs`` gives the same pool specs, op sequences,
  feeds and fetches;
* prefill and decode logits agree with the JAX package's at f32
  rtol/atol 1e-5, and prefill matches the unpaged forward;
* ``KVCacheManager`` hands out the same table rows;
* ``serve_decoding`` on ``CPUPlace()`` gives token streams identical to
  the JAX package's (``pallas_paged_attention`` off, and on in
  interpret mode) and to sequential one-at-a-time generation;
* the typed serving errors are raised where the JAX package raises
  them.
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
from paddle_tpu.core import flags as jflags
from paddle_tpu.serving import errors as jerrors
from paddle_tpu_torch.serving import errors as terrors

from _torch_port import (CACHE, VOCAB, carried_scope, jax_lm,
                         symbol_table, torch_lm)

torch.set_num_threads(1)

CPU = tfluid.CPUPlace()


@pytest.fixture(scope="module")
def lm():
    j_main, j_scope, j_logits = jax_lm()
    t_main, _, t_logits = torch_lm()
    t_scope = carried_scope(j_main, j_scope, t_main)
    return j_main, j_scope, j_logits, t_main, t_scope, t_logits


def _config(pkg, **kw):
    kw.setdefault("decode_buckets", (1, 2, 4, 8))
    return pkg.DecodingConfig(cache=pkg.CacheConfig(**CACHE), **kw)


def _serve_jax(lm, pallas, **kw):
    j_main, j_scope, j_logits = lm[:3]
    old = jflags.get_flag("pallas_paged_attention")
    jflags.set_flags({"pallas_paged_attention": pallas})  # read at derive
    try:
        return jdec.serve_decoding(j_main, "tokens", j_logits.name,
                                   scope=j_scope, config=_config(jdec, **kw))
    finally:
        jflags.set_flags({"pallas_paged_attention": old})


def _serve_torch(lm, **kw):
    t_main, t_scope, t_logits = lm[3:]
    return tdec.serve_decoding(t_main, "tokens", t_logits.name,
                               scope=t_scope, config=_config(tdec, **kw),
                               place=CPU)


def _concurrent(session, reqs):
    """Every request from its own client thread at once."""
    with cf.ThreadPoolExecutor(max_workers=len(reqs)) as pool:
        futs = [pool.submit(session.generate, p, max_new_tokens=m,
                            timeout=300) for p, m in reqs]
        return [f.result() for f in futs]


# ---------------------------------------------------------------- rewrite


def test_derived_pairs_match(lm):
    j_main, _, j_logits, t_main, _, t_logits = lm
    jp = jdec.derive_decode_programs(j_main, "tokens", j_logits.name,
                                     jdec.CacheConfig(**CACHE))
    tp = tdec.derive_decode_programs(t_main, "tokens", t_logits.name,
                                     tdec.CacheConfig(**CACHE))
    assert [(n, s, np.dtype(d)) for n, s, d in tp.pool_specs] == \
        [(n, s, np.dtype(d)) for n, s, d in jp.pool_specs]
    assert tp.n_layers == jp.n_layers == 2
    assert tp.pool_bytes == jp.pool_bytes
    for j_prog, t_prog in ((jp.prefill, tp.prefill),
                           (jp.decode, tp.decode)):
        assert [op.type for op in t_prog.global_block().ops] == \
            [op.type for op in j_prog.global_block().ops]
        assert symbol_table(t_prog) == symbol_table(j_prog)
    assert (tp.prefill_feeds, tp.decode_feeds, tp.fetches) == \
        (jp.prefill_feeds, jp.decode_feeds, jp.fetches)
    # the input program is not mutated
    assert all(op.type == "fused_attention"
               for op in t_main.global_block().ops
               if "attention" in op.type)


def test_derive_refusals(lm):
    t_main, _, t_logits = lm[3:]
    cfg = tdec.CacheConfig(**CACHE)
    p = tfluid.Program()
    with tfluid.program_guard(p, tfluid.Program()):
        x = tfluid.layers.data(name="tokens", shape=[-1, 4], dtype="int64",
                               append_batch_size=False)
        y = tfluid.layers.scale(x, scale=2.0)
    with pytest.raises(tfluid.EnforceError, match="no causal fused_attention"):
        tdec.derive_decode_programs(p, "tokens", y.name, cfg)
    p2 = t_main.clone(for_test=True)
    p2.global_block().create_var(name=tdec.BLOCK_TABLES, shape=(-1, 4),
                                 dtype="int32")
    with pytest.raises(tfluid.EnforceError, match="already defines"):
        tdec.derive_decode_programs(p2, "tokens", t_logits.name, cfg)
    for kw in ({"with_extend": True}, {"sampling": True}):
        with pytest.raises(NotImplementedError, match="not ported"):
            tdec.derive_decode_programs(t_main, "tokens", t_logits.name,
                                        cfg, **kw)
    for kw in ({"prefix_cache": True}, {"kv_dtype": "int8"}):
        with pytest.raises(NotImplementedError, match="not ported"):
            tdec.CacheConfig(**CACHE, **kw)


# ------------------------------------------------- prefill / decode ops


def _run_prefill_then_decode(dec, engine, prompts, executor):
    """Prefill ``prompts`` (padded to bucket 8) into fresh table rows,
    then one decode step at bucket ``len(prompts) + 1`` whose last row
    is inactive; returns (prefill logits, decode logits)."""
    kv = dec.KVCacheManager(engine.cache_config)
    sids = [kv.admit(len(p), 4) for p in prompts]
    tables = np.stack([kv.table_row(s) for s in sids])
    lens = np.asarray([len(p) for p in prompts], np.int32)
    toks = np.zeros((len(prompts), 8), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    pre_logits, pre_tok = executor(
        engine.pair.prefill,
        {"tokens": toks, dec.BLOCK_TABLES: tables, dec.SEQ_LENS: lens},
        [dec.NEXT_LOGITS, dec.NEXT_TOKENS])
    pad_tables = np.concatenate(
        [tables, engine.cache_config.empty_table_row()[None]])
    dec_logits, = executor(
        engine.pair.decode,
        {"tokens": np.append(np.asarray(pre_tok), 0)[:, None]
            .astype(np.int64),
         dec.BLOCK_TABLES: pad_tables,
         dec.POSITIONS: np.append(lens, -1).astype(np.int32)},
        [dec.NEXT_LOGITS])
    for s in sids:
        kv.release(s)
    return np.asarray(pre_logits), np.asarray(dec_logits)


def test_prefill_and_decode_logits_match(lm):
    """Prefill reproduces the unpaged forward's logits at the last
    prompt position, and a decode step continues from the pools it
    wrote — both equal to the JAX package's at f32 rtol/atol 1e-5."""
    j_main, j_scope, j_logits, t_main, t_scope, t_logits = lm
    prompts = [[3, 1, 4, 1, 5], [2, 7, 1, 8, 2, 8, 1]]
    config = dict(prompt_buckets=(8,), decode_buckets=(3,), warm_up=False)

    t_engine = tdec.DecodeEngine(t_main, "tokens", t_logits.name,
                                 scope=t_scope, config=_config(tdec, **config),
                                 place=CPU)
    t_exe = tfluid.Executor(CPU)
    t_pre, t_dec = _run_prefill_then_decode(
        tdec, t_engine, prompts,
        lambda prog, feed, fetch: t_exe.run(prog, feed=feed,
                                            fetch_list=fetch, scope=t_scope))

    j_engine = jdec.DecodeEngine(j_main, "tokens", j_logits.name,
                                 scope=j_scope, config=_config(jdec, **config))

    def j_run(prog, feed, fetch):
        with jfluid.scope_guard(j_engine.scope):
            return jfluid.Executor().run(prog, feed=feed, fetch_list=fetch)

    j_pre, j_dec = _run_prefill_then_decode(jdec, j_engine, prompts, j_run)
    np.testing.assert_allclose(t_pre, j_pre, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_dec[:2], j_dec[:2], rtol=1e-5, atol=1e-5)
    assert np.isfinite(t_dec).all()

    # prefill == the port's own unpaged forward at seq_len - 1
    for i, p in enumerate(prompts):
        ref = t_exe.run(t_main, feed={"tokens": np.asarray([p], np.int64)},
                        fetch_list=[t_logits], scope=t_scope)[0][0]
        np.testing.assert_allclose(t_pre[i], ref[len(p) - 1], rtol=1e-5,
                                   atol=1e-5)


def test_prompt_bucket_one_serves_single_token_prompts(lm):
    """Prompt bucket 1 feeds prefill ``[B, 1]`` ids: the embedding's
    trailing-dim-1 squeeze is swapped out on the prefill half too, so
    bucket 1 gives the stream the padded wider bucket gives — and the
    JAX package's."""
    streams = []
    for buckets in ((1, 8), (8,)):
        s = _serve_torch(lm, prompt_buckets=buckets, decode_buckets=(1, 2))
        try:
            streams.append(s.generate([7], max_new_tokens=3, timeout=120))
        finally:
            s.shutdown(drain=True, timeout=60)
    assert streams[0] == streams[1]
    j = _serve_jax(lm, False, prompt_buckets=(1, 8), decode_buckets=(1, 2))
    try:
        assert j.generate([7], max_new_tokens=3, timeout=120) == streams[0]
    finally:
        j.shutdown(drain=True, timeout=60)


# ---------------------------------------------------------------- cache


def test_kv_manager_table_rows_match_jax():
    cfg = dict(num_blocks=10, block_size=4, max_blocks_per_seq=4)
    jkv = jdec.KVCacheManager(jdec.CacheConfig(**cfg))
    tkv = tdec.KVCacheManager(tdec.CacheConfig(**cfg))
    rng = np.random.RandomState(2)
    live = []
    for _ in range(40):
        if live and rng.rand() < 0.4:
            sid = live.pop(rng.randint(len(live)))
            jkv.release(sid)
            tkv.release(sid)
        else:
            prompt, new = int(rng.randint(1, 9)), int(rng.randint(1, 8))
            js, ts = jkv.admit(prompt, new), tkv.admit(prompt, new)
            assert js == ts
            if ts is not None:
                live.append(ts)
        assert (tkv.free_blocks, tkv.used_blocks, tkv.live_sequences) == \
            (jkv.free_blocks, jkv.used_blocks, jkv.live_sequences)
        for sid in live:
            np.testing.assert_array_equal(tkv.table_row(sid),
                                          jkv.table_row(sid))
            assert tkv.table_row(sid).dtype == np.int32
        assert tkv.can_admit(9, 7) == jkv.can_admit(9, 7)
    with pytest.raises(tfluid.EnforceError, match="max_context"):
        tkv.admit(9, 8)


# ------------------------------------------------------- e2e acceptance


def _requests():
    rng = np.random.RandomState(5)
    return [(rng.randint(0, VOCAB, size=rng.randint(1, 20)).tolist(),
             int(rng.randint(2, 9))) for _ in range(8)]


@pytest.fixture(scope="module")
def jax_streams(lm):
    """The JAX package's concurrent streams, pallas_paged_attention off
    and on (interpret mode)."""
    out = {}
    for pallas in (False, True):
        s = _serve_jax(lm, pallas)
        try:
            out[pallas] = _concurrent(s, _requests())
        finally:
            s.shutdown(drain=True, timeout=60)
    return out


def test_served_streams_match_jax_and_sequential(lm, jax_streams):
    reqs = _requests()
    s = _serve_torch(lm)
    try:
        sequential = [s.generate(p, max_new_tokens=m, timeout=120)
                      for p, m in reqs]
        streamed = {}

        def fire(i):
            toks = []
            out = s.generate(reqs[i][0], max_new_tokens=reqs[i][1],
                             timeout=300, on_token=toks.append)
            streamed[i] = toks
            return out

        with cf.ThreadPoolExecutor(max_workers=len(reqs)) as pool:
            concurrent = list(pool.map(fire, range(len(reqs))))
    finally:
        s.shutdown(drain=True, timeout=60)
    assert [len(t) for t in concurrent] == [m for _, m in reqs]
    assert concurrent == sequential
    assert concurrent == jax_streams[False]
    assert concurrent == jax_streams[True]
    for i, out in enumerate(concurrent):
        assert streamed[i] == out
    rep = s.metrics.report()
    assert rep["sequences_completed"] == 2 * len(reqs)
    assert rep["ttft_ms"]["count"] == 2 * len(reqs)


def _raised(fn):
    try:
        fn()
    except Exception as e:  # the class is what is compared
        return type(e).__name__
    return None


def test_typed_errors_match_jax(lm):
    sessions = {"jax": _serve_jax(lm, False), "torch": _serve_torch(lm)}
    raised = {}
    for name, s in sessions.items():
        try:
            raised[name] = [
                _raised(lambda: s.submit(list(range(VOCAB)) * 2,
                                         max_new_tokens=1)),
                # fits the prompt buckets but not prompt + max_new_tokens
                _raised(lambda: s.submit([1] * 20, max_new_tokens=20)),
                _raised(lambda: s.submit([4, 4], max_new_tokens=4,
                                         deadline_ms=0.0).result(30)),
            ]
        finally:
            s.shutdown(drain=True, timeout=60)
        raised[name].append(_raised(lambda: s.submit([1], max_new_tokens=1)))
    assert raised["torch"] == raised["jax"] == [
        "PromptTooLongError", "PromptTooLongError",
        "DeadlineExceededError", "ServerClosedError"]
    # the same retriable/fatal split
    for cls in ("PromptTooLongError", "DeadlineExceededError",
                "ServerClosedError", "QueueFullError",
                "GenerationInterruptedError"):
        assert issubclass(getattr(terrors, cls),
                          terrors.RetriableServingError) == \
            issubclass(getattr(jerrors, cls), jerrors.RetriableServingError)


def test_drain_false_flushes_partial_streams(lm):
    """shutdown(drain=False) mid-generation resolves every future: the
    in-flight ones with GenerationInterruptedError carrying exactly the
    tokens streamed so far, queued ones with ServerClosedError."""
    s = _serve_torch(lm, decode_buckets=(1, 2), max_new_tokens=24)
    started = threading.Event()
    streamed = {}

    def cb(i):
        def on_token(tok):
            streamed.setdefault(i, []).append(tok)
            started.set()
        return on_token

    futs = [s.submit([3 + i, 1, 4], max_new_tokens=24, on_token=cb(i))
            for i in range(4)]
    assert started.wait(timeout=60), "no token generated in 60s"
    s.shutdown(drain=False, timeout=60)
    interrupted = 0
    for i, f in enumerate(futs):
        exc = f.exception(timeout=10)
        if isinstance(exc, terrors.GenerationInterruptedError):
            interrupted += 1
            assert exc.tokens == streamed.get(i, [])
        elif exc is not None:
            assert isinstance(exc, terrors.ServerClosedError), exc
            assert i not in streamed
    assert interrupted >= 1
    assert not s.running
