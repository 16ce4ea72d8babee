"""The decode engine's buckets as captured CUDA graphs, and the sync-free
pool write they rest on.

On the CPU:

* ``rewrite._write_pools`` (no host read: a dropped write is issued as a
  copy of the last kept write, or of slot 0's own bytes when none is
  kept) equals the ``nonzero``-filtered write it replaced and the JAX
  package's scatter with ``mode="drop"``, with dropped slots, a call
  that keeps nothing, and int8 codes with their scales;
* ``Executor.run_graph`` on the CPU is ``run``, and a CPU engine runs
  eagerly and captures nothing (``num_compiled`` stays 0 through warm-up
  and traffic).

Tests marked ``cuda`` need a card and skip here. On the card a greedy,
a prefix-cached int8, a sampling and a speculative session stream
exactly what the eager engine (``_capture=False``) streams;
``num_compiled == warm_bucket_count()`` for the target and the draft
after warm-up and after traffic; a replayed decode step and a first
call (eager run and capture) make no host sync under
``torch.cuda.set_sync_debug_mode("error")`` (the fetch's one wait is
outside it); a pool replaced in the scope is copied into the graph's
buffer (a wrong shape raises); the kernel's launch counter counts every
replay. JAX is imported only inside the CPU tests that use it, so the
card tests run on a machine without JAX:

    python -m pytest tests/test_torch_decode_graphs.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
import paddle_tpu_torch.decoding as tdec
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.decoding import rewrite
from paddle_tpu_torch.decoding.engine import DecodeEngine
from paddle_tpu_torch.decoding.session import DecodeSession
from paddle_tpu_torch.models.causal_lm import causal_lm

torch.set_num_threads(1)

NB, BS, H, D = 6, 4, 2, 3
LM = dict(vocab_size=37, n_layer=2, n_head=2, d_model=32, d_inner_hid=64)
DRAFT_LM = dict(vocab_size=37, n_layer=1, n_head=2, d_model=16,
                d_inner_hid=32)
CACHE = dict(num_blocks=24, block_size=8, max_blocks_per_seq=4)


# ------------------------------------------------------ the pool write


def _nonzero_write(k_cache, v_cache, slots, valid, k_rows, v_rows,
                   k_scale=None, v_scale=None):
    """The write ``_write_pools`` replaced: kept rows found with
    ``nonzero`` (a host sync), then an ``index_copy_`` of those only."""
    keep = valid.reshape(-1).nonzero().squeeze(1)
    slots = slots.reshape(-1)[keep]
    for pool, scale, rows in ((k_cache, k_scale, k_rows),
                              (v_cache, v_scale, v_rows)):
        flat = pool.view(-1, *pool.shape[2:])
        rows = rows.reshape(-1, *pool.shape[2:])[keep]
        if scale is None:
            flat.index_copy_(0, slots, rows.to(pool.dtype))
        else:
            codes, sc = rewrite._quantize_rows(rows)
            flat.index_copy_(0, slots, codes)
            scale.view(-1).index_copy_(0, slots, sc)


def _jax_write(pools, slots, valid, k_rows, v_rows, int8):
    """The JAX package's scatter: dropped writes routed to ``nb * bs``
    and dropped by ``mode="drop"`` (the int8 one jitted, as the decode
    programs run it: XLA's scale is the absmax times f32(1/127))."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.decoding import rewrite as jrw

    idx = jnp.asarray(np.where(valid, slots, NB * BS).reshape(-1))
    out = []
    for i, rows in enumerate((k_rows, v_rows)):
        rows = jnp.asarray(rows.reshape(-1, H, D))
        if int8:
            codes, sc = jax.jit(jrw._q8_scatter)(
                jnp.asarray(pools[i].reshape(-1, H, D)),
                jnp.asarray(pools[2 + i].reshape(-1)), rows, idx)
            out += [np.asarray(codes).reshape(pools[i].shape),
                    np.asarray(sc).reshape(pools[2 + i].shape)]
        else:
            out.append(np.asarray(jnp.asarray(pools[i].reshape(-1, H, D))
                                  .at[idx].set(rows, mode="drop")
                                  ).reshape(pools[i].shape))
    return out if not int8 else [out[0], out[2], out[1], out[3]]


def _write_case(seed, shape, n_valid, int8):
    rng = np.random.RandomState(seed)
    n = int(np.prod(shape))
    slots = rng.permutation(NB * BS)[:n].reshape(shape).astype(np.int64)
    valid = np.zeros(n, bool)
    valid[rng.permutation(n)[:n_valid]] = True
    valid = valid.reshape(shape)
    # dropped rows carry slots a torch index would fault or wrap on
    slots = np.where(valid, slots, rng.choice([-1, -8, NB * BS + 5],
                                              size=shape))
    k_rows = rng.standard_normal(shape + (H, D)).astype(np.float32)
    v_rows = rng.standard_normal(shape + (H, D)).astype(np.float32)
    if int8:
        pools = [rng.randint(-127, 128, (NB, BS, H, D)).astype(np.int8)
                 for _ in range(2)]
        pools += [rng.uniform(0.01, 0.05, (NB, BS)).astype(np.float32)
                  for _ in range(2)]
    else:
        pools = [rng.standard_normal((NB, BS, H, D)).astype(np.float32)
                 for _ in range(2)]
    return pools, slots, valid, k_rows, v_rows


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("shape,n_valid", [((3,), 2), ((3,), 0),
                                           ((2, 5), 6), ((2, 5), 10),
                                           ((1,), 1)])
def test_sync_free_write_matches_nonzero_write_and_jax(shape, n_valid,
                                                      int8):
    pools, slots, valid, k_rows, v_rows = _write_case(
        sum(shape) + n_valid, shape, n_valid, int8)
    outs = []
    for fn in (rewrite._write_pools, _nonzero_write):
        ts = [torch.from_numpy(p.copy()) for p in pools]
        scales = ts[2:] if int8 else [None, None]
        fn(ts[0], ts[1], torch.from_numpy(slots), torch.from_numpy(valid),
           torch.from_numpy(k_rows), torch.from_numpy(v_rows), *scales)
        outs.append([t.numpy() for t in ts])
    want = _jax_write(pools, slots, valid, k_rows, v_rows, int8)
    for got, ref, jax_ref in zip(outs[0], outs[1], want):
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, jax_ref)
    if n_valid == 0:  # nothing kept: the pools are unchanged
        for got, before in zip(outs[0], pools):
            np.testing.assert_array_equal(got, before)


# ------------------------------------------------------- the CPU engine


def _lm(lm=LM, seed=0, place=None):
    """(program, scope, logits) of the port's causal LM with numpy-seeded
    weights on ``place``."""
    place = place or fluid.CPUPlace()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, logits = causal_lm(**lm)
    rng = np.random.RandomState(seed)
    arrays = {p.name: (0.3 * rng.standard_normal(p.shape)).astype(
        np.float32) for p in main.all_parameters()}
    scope = fluid.Scope()
    fluid.params_from_numpy(arrays, scope, place, program=main)
    return main, scope, logits


def _config(**kw):
    cache = dict(CACHE, prefix_cache=kw.pop("prefix_cache", False),
                 kv_dtype=kw.pop("kv_dtype", None))
    kw.setdefault("decode_buckets", (1, 2, 4))
    kw.setdefault("prompt_buckets", (8, 32))
    kw.setdefault("suffix_buckets", (4, 16))
    return tdec.DecodingConfig(cache=tdec.CacheConfig(**cache),
                               max_new_tokens=8, **kw)


def test_run_graph_on_the_cpu_is_run():
    main, scope, logits = _lm()
    exe = fluid.Executor(fluid.CPUPlace())
    feed = {"tokens": np.asarray([[3, 1, 4, 1]], np.int64)}
    want, = exe.run(main, feed=feed, fetch_list=[logits], scope=scope)
    got, = exe.run_graph(main, feed=feed, fetch_list=[logits], scope=scope)
    np.testing.assert_array_equal(got, want)
    assert exe.num_compiled == 0


def test_a_cpu_engine_captures_nothing():
    main, scope, logits = _lm()
    engine = DecodeEngine(main, "tokens", logits.name, scope=scope,
                          config=_config(prefix_cache=True, speculate_k=2),
                          place=fluid.CPUPlace())
    assert not engine.captured
    assert engine.warm_up() == 0
    session = DecodeSession(engine)
    try:
        out = [session.generate([5, 6, 7, 8, 9, 1, 2, 3, t],
                                max_new_tokens=4, timeout=120)
               for t in range(2)]
    finally:
        session.shutdown(drain=True, timeout=60)
    assert all(len(s) == 4 for s in out)
    assert engine.num_compiled == 0
    assert engine.warm_bucket_count() == 2 * 1 + 3 + 2 + 3


# ------------------------------------------------------------- the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the engine's buckets are captured "
                    "CUDA graphs there, and a graph has no CPU mode")
    return fluid.CUDAPlace(0)


PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, t] for t in range(5)] + [
    [7, 7], [2, 7, 1, 8, 2, 8, 1, 8, 2, 8, 4, 5, 9, 0, 4, 5, 2, 3]]


def _session(model, capture, draft=None, **kw):
    """A session that is not started yet (so a burst submitted before
    ``start`` is admitted in one order and batched the same way in every
    run), with an optional draft engine."""
    main, scope, logits = model
    cfg = _config(**kw)
    engine = DecodeEngine(main, "tokens", logits.name, scope=scope,
                          config=cfg, place=fluid.CUDAPlace(0),
                          _capture=capture)
    draft_engine = None
    if draft is not None:
        d_main, d_scope, d_logits = draft
        c = cfg.cache
        draft_engine = DecodeEngine(
            d_main, "tokens", d_logits.name, scope=d_scope,
            config=tdec.DecodingConfig(
                cache=tdec.CacheConfig(
                    num_blocks=c.num_blocks, block_size=c.block_size,
                    max_blocks_per_seq=c.max_blocks_per_seq,
                    kv_dtype=c.kv_dtype, prefix_cache=c.prefix_cache),
                prompt_buckets=cfg.prompt_buckets,
                decode_buckets=cfg.decode_buckets,
                prefill_batch_buckets=(1,), sampling=cfg.sampling,
                max_new_tokens=cfg.max_new_tokens),
            place=fluid.CUDAPlace(0), _capture=capture)
    return DecodeSession(engine, draft_engine=draft_engine,
                         auto_start=False)


def _burst(session, sampling=None):
    """Every prompt queued, then the session started (warm-up first)."""
    try:
        futs = [session.submit(p, max_new_tokens=8, sampling=(
            sampling[i % len(sampling)] if sampling else None))
            for i, p in enumerate(PROMPTS)]
        session.start()
        return [f.result(timeout=300) for f in futs]
    finally:
        session.shutdown(drain=True, timeout=120)


CARD_CASES = {
    "greedy": dict(),
    "prefix_int8": dict(prefix_cache=True, kv_dtype="int8"),
    "sampling": dict(sampling=True),
    "speculative": dict(speculate_k=3, prefix_cache=True, sampling=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_cuda_captured_streams_equal_eager_streams(case):
    _card()
    kw = CARD_CASES[case]
    sampling = None
    if kw.get("sampling"):
        sampling = [tdec.GREEDY,
                    tdec.SamplingParams(0.8, 40, 0.95, seed=3),
                    tdec.SamplingParams(1.1, 0, 1.0, seed=2 ** 31 - 1)]
    streams, engines = {}, {}
    for capture in (True, False):
        model = _lm(place=fluid.CUDAPlace(0))
        draft = (_lm(DRAFT_LM, seed=1, place=fluid.CUDAPlace(0))
                 if kw.get("speculate_k") else None)
        session = _session(model, capture, draft, **kw)
        engines[capture] = [e for e in (session.engine,
                                        session.draft_engine)
                            if e is not None]
        streams[capture] = _burst(session, sampling)
    assert streams[True] == streams[False]
    assert all(len(s) == 8 for s in streams[True])
    # every bucket captured at warm-up, and the traffic added none
    for e in engines[True]:
        assert e.captured
        assert e.num_compiled == e.warm_bucket_count()
    for e in engines[False]:
        assert not e.captured and e.num_compiled == 0


def _decode_feed(engine, n=2):
    """A live decode step's arguments for ``n`` sequences whose prompts
    were prefilled."""
    kv = tdec.KVCacheManager(engine.cache_config)
    toks, poss, rows = [], [], []
    for i in range(n):
        prompt = [1 + i, 2, 3, 4, 5]
        sid = kv.admit(len(prompt), 4)
        row = kv.table_row(sid)
        first, = engine.prefill([np.asarray(prompt)], row[None, :],
                                np.asarray([len(prompt)], np.int32))
        toks.append(int(first))
        poss.append(len(prompt))
        rows.append(row)
    return np.asarray(toks), np.asarray(poss, np.int32), np.stack(rows)


@pytest.mark.cuda
def test_cuda_replay_and_capture_make_no_host_sync():
    """Every bucket's graph — prefill, decode, suffix extend and verify,
    with the sampling heads — replayed, and captured anew over a second
    scope (the first call's eager run and capture), each launched under
    ``set_sync_debug_mode("error")``; the fetch's one wait comes after.
    A decode step over live rows too."""
    _card()
    main, scope, logits = _lm(place=fluid.CUDAPlace(0))
    engine = DecodeEngine(main, "tokens", logits.name, scope=scope,
                          config=_config(sampling=True, prefix_cache=True,
                                         speculate_k=2),
                          place=fluid.CUDAPlace(0))
    calls, real = [], engine._exe.run_graph

    def record(program, feed=None, fetch_list=None, scope=None,
               pool=None):
        calls.append((program, dict(feed), tuple(fetch_list)))
        return real(program, feed=feed, fetch_list=fetch_list, scope=scope,
                    pool=pool)

    engine._exe.run_graph = record
    engine.warm_up()
    engine._exe.run_graph = real
    assert len(calls) == engine.warm_bucket_count()
    assert {p for p, _, _ in calls} == {engine.pair.prefill,
                                         engine.pair.decode,
                                         engine.pair.extend}
    toks, poss, rows = _decode_feed(engine)
    live = {"tokens": toks[:, None], rewrite.BLOCK_TABLES: rows,
            rewrite.POSITIONS: poss}
    live.update(engine._sampling_feed(
        [tdec.SamplingParams(0.8, 40, 0.95, seed=1), None], [1, 1], 2))
    calls.append((engine.pair.decode, live, (rewrite.NEXT_TOKENS,)))
    scope2 = fluid.Scope()
    for n in scope.local_var_names():
        scope2.set_var(n, scope.find_var(n).clone())
    for program, feed, fetch in calls:
        _, graph = engine._exe._graph_for(program, feed, fetch,
                                          engine.scope, engine._pool)
        _, first = engine._exe._graph_for(program, feed, fetch, scope2,
                                          None)
        assert graph.graph is not None and first.graph is None
        for run in (graph, first):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                run.launch(feed)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            out, = run.fetch()
            assert ((out >= 0) & (out < 37)).all()
        assert first.graph is not None
    out, = graph.fetch()  # the live decode step: replay and capture agree
    np.testing.assert_array_equal(out, first.fetch()[0])


@pytest.mark.cuda
def test_cuda_replaced_pool_is_copied_in_or_raises():
    """A pool replaced in the scope (``set_var`` of a new tensor) is
    copied into the graph's buffer before the replay: the captured step
    gives the eager step's token over the same new pools."""
    _card()
    engines = []
    for capture in (True, False):
        main, scope, logits = _lm(place=fluid.CUDAPlace(0))
        engine = DecodeEngine(main, "tokens", logits.name, scope=scope,
                              config=_config(), place=fluid.CUDAPlace(0),
                              _capture=capture)
        engine.warm_up()
        engines.append(engine)
    args = [_decode_feed(e) for e in engines]
    assert all(np.array_equal(a, b) for a, b in zip(*args))
    rng = np.random.RandomState(4)
    names = [n for n, _, _ in engines[0].pair.pool_specs]
    new = {n: rng.standard_normal(tuple(engines[0].scope.find_var(n).shape)
                                  ).astype(np.float32) for n in names}
    before = {n: engines[0].scope.find_var(n) for n in names}
    for e in engines:
        for n in names:
            e.scope.set_var(n, torch.from_numpy(new[n]).to("cuda"))
    got, want = (e.decode(*args[0]) for e in engines)
    np.testing.assert_array_equal(got, want)
    # the scope holds the graph's own buffers again, now with the new
    # values (and the step's write)
    for n in names:
        cur = engines[0].scope.find_var(n)
        assert cur.data_ptr() == before[n].data_ptr()
        assert torch.equal(cur, engines[1].scope.find_var(n))
    engines[0].scope.set_var(names[0], torch.zeros(3, device="cuda"))
    with pytest.raises(EnforceError, match="captured graph holds"):
        engines[0].decode(*args[0])


@pytest.mark.cuda
def test_cuda_launch_counters_count_replays():
    _card()
    from paddle_tpu_torch.ops import paged_window_attention as pwa

    main, scope, logits = _lm(place=fluid.CUDAPlace(0))
    engine = DecodeEngine(main, "tokens", logits.name, scope=scope,
                          config=_config(speculate_k=3),
                          place=fluid.CUDAPlace(0))
    engine.warm_up()
    toks, poss, rows = _decode_feed(engine)
    for name in pwa.counts:
        setattr(pwa, name, 0)
    for i in range(5):
        toks = engine.decode(toks, poss + i, rows)
    assert pwa.launches == pwa.split_launches == 5 * LM["n_layer"]
    windows = np.stack([toks, toks, toks, toks], 1)
    engine.verify(windows, np.asarray([4, 4], np.int32), poss + 5, rows)
    assert pwa.split_launches == 6 * LM["n_layer"]
    assert pwa.generic_launches == pwa.tile_launches == 0
