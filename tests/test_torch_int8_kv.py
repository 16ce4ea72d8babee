"""Int8 KV pools in paddle_tpu_torch.decoding, held to paddle_tpu's on
the CPU.

* The quantized pool write (absmax/127 per written position, round half
  to even, codes and scales at the same kept slots) is bit-equal to the
  JAX package's ``_q8_scatter``: a zero row, explicit .5 ties and
  dropped slots included.
* The int8 pool specs equal the JAX package's (names, shapes, dtypes,
  bytes), under half the f32 pools' bytes.
* The int8 prefill, decode and extend ops agree with the JAX package's
  jitted ``_q8`` ops within 1e-5 and write bit-equal codes and scales.
* Served int8 streams, with prefix caching off and on, are
  token-identical to the JAX package's int8 streams; the int8 decode's
  next-token logits are within 1e-4 of the JAX package's; two int8
  sessions give equal streams.
"""

import concurrent.futures as cf

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.decoding as jdec
import paddle_tpu_torch as tfluid
import paddle_tpu_torch.decoding as tdec
from paddle_tpu.decoding import rewrite as j_rewrite
from paddle_tpu_torch.decoding import rewrite as t_rewrite

from _torch_port import CACHE, VOCAB, carried_scope, jax_lm, torch_lm

torch.set_num_threads(1)

CPU = tfluid.CPUPlace()
# small bucket sets keep the JAX package's compiles cheap
BUCKETS = dict(decode_buckets=(1, 2, 4), suffix_buckets=(1, 2, 4, 8, 16))
SHARED = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3]
H, D, NB, BS, MB = 2, 8, 10, 4, 4


@pytest.fixture(scope="module")
def lm():
    j_main, j_scope, j_logits = jax_lm()
    t_main, _, t_logits = torch_lm()
    t_scope = carried_scope(j_main, j_scope, t_main)
    return j_main, j_scope, j_logits, t_main, t_scope, t_logits


def _config(pkg, prefix_cache=False, **kw):
    return pkg.DecodingConfig(
        cache=pkg.CacheConfig(kv_dtype="int8", prefix_cache=prefix_cache,
                              **CACHE),
        **{**BUCKETS, "max_new_tokens": 12, **kw})


def _jit(fn, **kw):
    import jax

    return jax.jit(lambda *a: fn(*a, **kw))


def _jnp(arrays):
    import jax.numpy as jnp

    return [jnp.asarray(a) for a in arrays]


# ------------------------------------------------------ quantized write


def _rows(seed):
    """[32, H, D] K or V rows: random ones at two magnitudes, an
    all-zero row (2), a row whose scale is exactly 1 with .5 ties
    (round half to even, 4), and one with the same ties at a scale of 2
    (5)."""
    rng = np.random.RandomState(seed)
    rows = (rng.standard_normal((32, H, D))
            * np.array([0.01, 3.0])[None, :, None]).astype(np.float32)
    rows[2] = 0.0
    ties = np.zeros((H, D), np.float32)
    ties[0, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    rows[4] = ties
    rows[5] = 2 * ties
    return rows


def test_q8_scatter_bit_equal_to_jax():
    k_rows, v_rows = _rows(3), _rows(5)
    rng = np.random.RandomState(4)
    slots = rng.permutation(NB * BS)[:32].astype(np.int64)
    valid = rng.rand(32) > 0.2
    valid[[2, 4, 5]] = True
    codes0 = rng.randint(-127, 128, (NB * BS, H, D)).astype(np.int8)
    scales0 = rng.uniform(0.01, 1, NB * BS).astype(np.float32)

    fn = _jit(j_rewrite._q8_scatter)
    j_idx = np.where(valid, slots, NB * BS).astype(np.int32)
    want = [[np.asarray(x) for x in fn(*_jnp((codes0, scales0, rows,
                                              j_idx)))]
            for rows in (k_rows, v_rows)]

    t = [torch.from_numpy(a.copy()) for a in (codes0, codes0, scales0,
                                              scales0)]
    kc, vc = t[0].view(NB, BS, H, D), t[1].view(NB, BS, H, D)
    t_rewrite._write_pools(kc, vc, torch.from_numpy(slots),
                           torch.from_numpy(valid),
                           torch.from_numpy(k_rows),
                           torch.from_numpy(v_rows),
                           t[2].view(NB, BS), t[3].view(NB, BS))
    for (codes, scales), (j_codes, j_scales) in zip(
            ((t[0], t[2]), (t[1], t[3])), want):
        np.testing.assert_array_equal(codes.numpy(), j_codes)
        np.testing.assert_array_equal(scales.numpy().view(np.int32),
                                      j_scales.view(np.int32))
    # the cases are what they claim to be (row i lands at slots[i])
    assert t[2][slots[2]].item() == 0.0 and (t[0][slots[2]] == 0).all()
    for i, scale in ((4, 1.0), (5, 2.0)):                     # ties
        assert t[2][slots[i]].item() == scale
        assert t[0][slots[i], 0, :6].tolist() == [127, 2, -4, 0, 0, 2]
    assert (~valid).sum() >= 3
    for slot in slots[~valid]:                                # dropped
        np.testing.assert_array_equal(t[0][slot].numpy(), codes0[slot])
        assert t[2][slot].item() == scales0[slot]
    # some rows tell a true division by 127 from the reciprocal multiply
    amax = np.abs(k_rows).max(axis=(1, 2))
    assert (amax / np.float32(127) != amax * np.float32(1 / 127)).any()


# ------------------------------------------------------------ pool specs


def test_pool_specs_match_jax_pair8(lm):
    j_main, _, j_logits, t_main, _, t_logits = lm
    cfg8 = dict(CACHE, kv_dtype="int8")
    jp = jdec.derive_decode_programs(j_main, "tokens", j_logits.name,
                                     jdec.CacheConfig(**cfg8))
    tp = tdec.derive_decode_programs(t_main, "tokens", t_logits.name,
                                     tdec.CacheConfig(**cfg8))
    t32 = tdec.derive_decode_programs(t_main, "tokens", t_logits.name,
                                      tdec.CacheConfig(**CACHE))
    assert [(n, s, np.dtype(d)) for n, s, d in tp.pool_specs] == \
        [(n, s, np.dtype(d)) for n, s, d in jp.pool_specs]
    assert [n for n, _, _ in tp.pool_specs][:4] == [
        "kv_cache@l0.k", "kv_cache@l0.v", "kv_cache@l0.kscale",
        "kv_cache@l0.vscale"]
    assert tp.pool_bytes == jp.pool_bytes
    assert tp.pool_bytes < t32.pool_bytes / 2
    assert tp.n_layers == 2
    scope = tfluid.Scope()
    tp.init_scope(scope, torch.device("cpu"))
    assert scope.find_var("kv_cache@l1.k").dtype == torch.int8
    assert scope.find_var("kv_cache@l1.vscale").shape == (24, 8)


# ------------------------------------------------------------ int8 ops


def _problem(mode, seed=0, B=3, T=4):
    rng = np.random.RandomState(seed)
    if mode == "decode":
        T = 1
    q, k, v = (rng.standard_normal((B, T, H * D)).astype(np.float32)
               for _ in range(3))
    codes = [rng.randint(-127, 128, (NB, BS, H, D)).astype(np.int8)
             for _ in range(2)]
    scales = [rng.uniform(0.005, 0.05, (NB, BS)).astype(np.float32)
              for _ in range(2)]
    tables = np.stack([rng.permutation(NB)[:MB] for _ in range(B)]
                      ).astype(np.int32)
    tables[1, 3:] = -1
    if mode == "prefill":
        mid = [np.array([4, 3, 0], np.int32)]          # seq_lens
    elif mode == "decode":
        mid = [np.array([7, 11, -1], np.int32)]        # positions
    else:
        mid = [np.array([5, 8, 0], np.int32),          # cached_lens
               np.array([4, 3, 0], np.int32)]          # seq_lens
    return ([q, k, v, codes[0], codes[1], tables] + mid
            + [scales[0], scales[1]])


_J_FN = {"prefill": j_rewrite._paged_prefill_attention_q8,
         "decode": j_rewrite._paged_decode_attention_q8,
         "extend": j_rewrite._paged_extend_attention_q8}
_T_FN = {"prefill": t_rewrite._paged_prefill_attention,
         "decode": t_rewrite._paged_decode_attention,
         "extend": t_rewrite._paged_extend_attention}


@pytest.mark.parametrize("mode", ["prefill", "decode", "extend"])
def test_int8_ops_match_jax(mode):
    prob = _problem(mode)
    want = [np.asarray(x) for x in _jit(_J_FN[mode], n_head=H,
                                        block_size=BS)(*_jnp(prob))]
    args = [torch.from_numpy(a.copy()) for a in prob]
    got = _T_FN[mode](*args, n_head=H, block_size=BS)
    assert len(got) == 5
    # pools and scale pools are written in place
    assert all(g is a for g, a in zip(got[1:], (args[3], args[4],
                                                args[-2], args[-1])))
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-5,
                               atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    # something was written
    assert not np.array_equal(got[1].numpy(), prob[3])


# ---------------------------------------------------------- served streams


def _requests():
    rng = np.random.RandomState(9)
    return ([(SHARED + [t], 8) for t in range(4)]
            + [(rng.randint(0, VOCAB, size=rng.randint(1, 20)).tolist(),
                int(rng.randint(2, 9))) for _ in range(4)])


def _streams(session, reqs):
    with cf.ThreadPoolExecutor(max_workers=4) as pool:
        return list(pool.map(
            lambda r: session.generate(r[0], max_new_tokens=r[1],
                                       timeout=300), reqs))


def _serve(pkg, lm, prefix_cache):
    if pkg is jdec:
        main, scope, logits = lm[:3]
        return jdec.serve_decoding(main, "tokens", logits.name, scope=scope,
                                   config=_config(jdec, prefix_cache))
    main, scope, logits = lm[3:]
    return tdec.serve_decoding(main, "tokens", logits.name, scope=scope,
                               config=_config(tdec, prefix_cache), place=CPU)


@pytest.fixture(scope="module")
def jax_int8_streams(lm):
    """The JAX package's int8 streams, one request at a time (a prefix
    hit's suffix prefill reads the dequantized pool, so hit/miss order
    matters under int8: sequential runs fix it)."""
    out = {}
    for prefix_cache in (False, True):
        s = _serve(jdec, lm, prefix_cache)
        try:
            out[prefix_cache] = [s.generate(p, max_new_tokens=m,
                                            timeout=300)
                                 for p, m in _requests()]
        finally:
            s.shutdown(drain=True, timeout=60)
    return out


@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["no_prefix", "prefix"])
def test_int8_streams_match_jax(lm, jax_int8_streams, prefix_cache):
    s = _serve(tdec, lm, prefix_cache)
    try:
        got = [s.generate(p, max_new_tokens=m, timeout=300)
               for p, m in _requests()]
    finally:
        s.shutdown(drain=True, timeout=60)
    assert got == jax_int8_streams[prefix_cache]
    assert [len(g) for g in got] == [m for _, m in _requests()]
    rep = s.metrics.report()
    if prefix_cache:
        assert rep["prefix_cache_hits_total"] == 3
        assert rep["prefill_tokens_avoided_total"] == 3 * 16


def test_int8_sessions_are_deterministic(lm):
    """Two int8 sessions, each serving the burst concurrently, give the
    same streams."""
    streams = []
    for _ in range(2):
        s = _serve(tdec, lm, False)
        try:
            streams.append(_streams(s, _requests()))
        finally:
            s.shutdown(drain=True, timeout=60)
    assert streams[0] == streams[1]


# ----------------------------------------------------- engine-level logits


def _prefill_then_decode(dec, engine, run):
    """Prefill two prompts into int8 pools, then one decode step (with an
    inactive third row); returns the decode's next-token logits."""
    prompts = [[3, 1, 4, 1, 5], [2, 7, 1, 8, 2, 8, 1]]
    kv = dec.KVCacheManager(engine.cache_config)
    sids = [kv.admit(len(p), 4) for p in prompts]
    tables = np.stack([kv.table_row(s) for s in sids])
    lens = np.asarray([len(p) for p in prompts], np.int32)
    toks = np.zeros((2, 8), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    first, = run(engine.pair.prefill,
                 {"tokens": toks, dec.BLOCK_TABLES: tables,
                  dec.SEQ_LENS: lens}, [dec.NEXT_TOKENS])
    logits, = run(engine.pair.decode,
                  {"tokens": np.append(np.asarray(first), 0)[:, None]
                      .astype(np.int64),
                   dec.BLOCK_TABLES: np.concatenate(
                       [tables, engine.cache_config.empty_table_row()[None]]),
                   dec.POSITIONS: np.append(lens, -1).astype(np.int32)},
                  [dec.NEXT_LOGITS])
    return np.asarray(logits)[:2]


def test_int8_decode_logits_match_jax(lm):
    j_main, j_scope, j_logits, t_main, t_scope, t_logits = lm
    kw = dict(prompt_buckets=(8,), decode_buckets=(3,), warm_up=False)
    t_engine = tdec.DecodeEngine(t_main, "tokens", t_logits.name,
                                 scope=t_scope, config=_config(tdec, **kw),
                                 place=CPU)
    t_exe = tfluid.Executor(CPU)
    got = _prefill_then_decode(
        tdec, t_engine,
        lambda prog, feed, fetch: t_exe.run(prog, feed=feed,
                                            fetch_list=fetch, scope=t_scope))
    j_engine = jdec.DecodeEngine(j_main, "tokens", j_logits.name,
                                 scope=j_scope, config=_config(jdec, **kw))

    def j_run(prog, feed, fetch):
        with jfluid.scope_guard(j_engine.scope):
            return jfluid.Executor().run(prog, feed=feed, fetch_list=fetch)

    want = _prefill_then_decode(jdec, j_engine, j_run)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.isfinite(got).all()
    assert t_scope.find_var("kv_cache@l0.k").dtype == torch.int8
