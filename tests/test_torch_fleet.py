"""paddle_tpu_torch.fleet, held to paddle_tpu.fleet (tests/test_fleet.py):
the prefix-affinity router, disaggregated prefill/decode replicas and
content-addressed KV-block migration, on the CPU.

The port's counterparts of tests/test_fleet.py's 27 tests, at the same
sizes and over the same seeded weights (``_torch_fleet_worker.build_lm``
draws the JAX worker's noise in its order, so a seed is one model in
either package), plus the checks across the packages:

* a migration entry published by either package's store is restored by
  the other's migrator and decodes the JAX package's stream token for
  token (f32 and int8 pools);
* the wire dicts and the Prometheus text are equal;
* both packages' routers, over the same scripted replicas' health,
  route the same requests to the same replicas;
* a restore writes the pools in place: every pool's ``data_ptr()`` is
  unchanged.

Streams are compared token for token against a sequential single-replica
oracle of the port, which is itself held to the JAX package's oracle.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import _fleet_worker as jfw
import _torch_fleet_worker as fw
import paddle_tpu_torch as tfluid
from paddle_tpu import fleet as jfleet
from paddle_tpu.decoding import CacheConfig as JCacheConfig
from paddle_tpu.decoding import DecodingConfig as JDecodingConfig
from paddle_tpu.decoding import KVCacheManager as JKVCacheManager
from paddle_tpu.decoding import SamplingParams as JSamplingParams
from paddle_tpu.decoding import serve_decoding as j_serve_decoding
from paddle_tpu.decoding.engine import DecodeEngine as JDecodeEngine
from paddle_tpu_torch import fleet
from paddle_tpu_torch.decoding import (CacheConfig, DecodingConfig,
                                       KVCacheManager, SamplingParams,
                                       derive_decode_programs,
                                       serve_decoding)
from paddle_tpu_torch.decoding.engine import DecodeEngine
from paddle_tpu_torch.obs import metrics as obs_metrics
from paddle_tpu_torch.obs import record as obs_record
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.resilience.faults import FaultPlan, FaultRule
from paddle_tpu_torch.serving import OverloadedError

torch.set_num_threads(1)

_HERE = os.path.dirname(os.path.abspath(__file__))

CACHE = dict(num_blocks=24, block_size=4, max_blocks_per_seq=6)
SEED = 7

SHARED_A = [3, 1, 4, 1, 5, 9, 2, 6]   # two full blocks at block_size 4
SHARED_B = [2, 7, 1, 8, 2, 8, 1, 8]


def _config(**over):
    kw = dict(cache=CacheConfig(prefix_cache=True, **CACHE),
              decode_buckets=(1, 2, 4), max_new_tokens=16,
              sampling=True)
    kw.update(over)
    return DecodingConfig(**kw)


def _session(seed=SEED, **over):
    main, scope, logits = fw.build_lm(seed)
    return serve_decoding(main, "tokens", logits.name, scope=scope,
                          config=_config(**over), place=tfluid.CPUPlace())


def _engine(seed=SEED, **over):
    """A bare DecodeEngine (no session thread) — the prefill role."""
    main, scope, logits = fw.build_lm(seed)
    return DecodeEngine(main, "tokens", logits.name, scope=scope,
                        config=_config(**over), place=tfluid.CPUPlace())


def _fleet(store_root, n_decode=2, prefill=True, seed=SEED,
           router_kw=None):
    """(router, replicas, store): 1 prefill + n decode replicas over one
    shared MigrationStore, every replica holding the same weights."""
    store = fleet.MigrationStore(str(store_root))
    reps = []
    for i in range(n_decode):
        s = _session(seed)
        mig = fleet.BlockMigrator(store, s.engine)
        reps.append(fleet.LocalReplica("decode-%d" % i, s,
                                       migrator=mig))
    if prefill:
        eng = _engine(seed)
        mig = fleet.BlockMigrator(store, eng, export=True)
        reps.append(fleet.LocalReplica(
            "prefill-0", fleet.PrefillWorker(eng, mig),
            role="prefill", migrator=mig))
    cfg = fleet.FleetConfig(cache=CacheConfig(prefix_cache=True,
                                              **CACHE),
                            health_interval_s=0.1,
                            **(router_kw or {}))
    return fleet.Router(reps, cfg), reps, store


def _mixed_requests(n=24):
    """Mixed greedy/sampled/priority requests over two shared prefix
    families (tests/test_fleet.py's workload)."""
    reqs = []
    for i in range(n):
        shared = SHARED_A if i % 2 == 0 else SHARED_B
        prompt = shared + [10 + (i % 7), 1 + (i % 5)]
        sampling = None
        if i % 3 == 1:
            sampling = SamplingParams(temperature=0.8, top_k=5,
                                      seed=100 + i)
        elif i % 3 == 2:
            sampling = SamplingParams(temperature=0.7, top_p=0.9,
                                      seed=200 + i)
        reqs.append({"prompt": prompt,
                     "max_new_tokens": 6 + (i % 4),
                     "sampling": sampling, "priority": i % 3})
    return reqs


def _oracle(requests, seed=SEED):
    """The port's single-replica SEQUENTIAL oracle streams."""
    s = _session(seed)
    try:
        return [s.generate(r["prompt"],
                           max_new_tokens=r["max_new_tokens"],
                           sampling=r.get("sampling"),
                           priority=r.get("priority"))
                for r in requests]
    finally:
        s.shutdown(drain=True, timeout=120)


def _j_sampling(p):
    return None if p is None else JSamplingParams(
        temperature=p.temperature, top_k=p.top_k, top_p=p.top_p,
        seed=p.seed)


def _j_config(kv_dtype=None):
    return JDecodingConfig(
        cache=JCacheConfig(prefix_cache=True, kv_dtype=kv_dtype, **CACHE),
        decode_buckets=(1, 2, 4), max_new_tokens=16, sampling=True,
        warm_up=False)


def _j_session(kv_dtype=None):
    main, scope, logits = jfw.build_lm(SEED)
    return j_serve_decoding(main, "tokens", logits.name, scope=scope,
                            config=_j_config(kv_dtype))


def _j_oracle(requests, kv_dtype=None):
    """The JAX package's single-replica sequential oracle streams."""
    s = _j_session(kv_dtype)
    try:
        return [s.generate(r["prompt"],
                           max_new_tokens=r["max_new_tokens"],
                           sampling=_j_sampling(r.get("sampling")),
                           priority=r.get("priority"))
                for r in requests]
    finally:
        s.shutdown(drain=True, timeout=120)


@pytest.fixture(scope="module")
def mixed8():
    """Eight mixed requests, the port's oracle for them, held to the
    JAX package's oracle token for token."""
    reqs = _mixed_requests(8)
    got = _oracle(reqs)
    assert got == _j_oracle(reqs)
    return reqs, got


# ------------------------------------------- error wire round-trip


def _error_instances():
    from paddle_tpu_torch.serving import errors as E

    classes = sorted(
        (c for c in vars(E).values()
         if isinstance(c, type) and issubclass(c, E.ServingError)),
        key=lambda c: c.__name__)
    out = []
    for cls in classes:
        if issubclass(cls, E.GenerationInterruptedError):
            out.append(cls("cut at 3", tokens=[7, 8, 9]))
        elif issubclass(cls, E.OverloadedError):
            out.append(cls("stage 4 shed", retry_after_s=1.25))
        else:
            out.append(cls("why: %s" % cls.__name__))
    return out


@pytest.mark.parametrize(
    "exc", _error_instances(), ids=lambda e: type(e).__name__)
def test_error_wire_roundtrip_every_class(exc):
    """Every serving error class round-trips its wire form, and the
    wire dict is the JAX package's, field for field (the fleet's
    ``_error_to_wire``, and the other package's ``from_wire`` reads it
    back as the same class)."""
    from paddle_tpu.serving import errors as JE
    from paddle_tpu_torch.fleet import worker as tworker
    from paddle_tpu_torch.serving import errors as E

    wire = tworker._error_to_wire(exc)
    assert wire["error"] == type(exc).__name__
    assert wire["message"] == str(exc)
    assert wire == json.loads(json.dumps(wire))
    back = E.from_wire(wire)
    assert type(back) is type(exc) and str(back) == str(exc)
    assert E.is_retriable(back) == E.is_retriable(exc)
    if isinstance(exc, E.GenerationInterruptedError):
        assert back.tokens == exc.tokens == [7, 8, 9]
    if isinstance(exc, E.OverloadedError):
        assert back.retry_after_s == exc.retry_after_s == 1.25
    assert back.to_wire() == wire
    jcls = getattr(JE, type(exc).__name__)
    jexc = (jcls("cut at 3", tokens=[7, 8, 9])
            if issubclass(jcls, JE.GenerationInterruptedError) else
            jcls("stage 4 shed", retry_after_s=1.25)
            if issubclass(jcls, JE.OverloadedError) else
            jcls("why: %s" % jcls.__name__))
    assert jexc.to_wire() == wire
    assert type(JE.from_wire(wire)).__name__ == type(exc).__name__


def test_error_wire_unknown_class_degrades():
    from paddle_tpu_torch.serving import errors as E

    got = E.from_wire({"error": "NoSuchError", "message": "m"})
    assert type(got) is RuntimeError and "NoSuchError" in str(got)
    got = E.from_wire({"error": "is_retriable", "message": "m"})
    assert type(got) is RuntimeError
    assert not E.is_retriable(got)


def test_sampling_wire_matches_the_jax_package():
    from paddle_tpu.fleet import worker as jworker
    from paddle_tpu_torch.fleet import worker as tworker

    p = SamplingParams(temperature=0.7, top_k=5, top_p=0.9, seed=11)
    wire = tworker._sampling_to_wire(p)
    assert wire == jworker._sampling_to_wire(_j_sampling(p))
    back = tworker._sampling_from_wire(wire)
    assert (back.temperature, back.top_k, back.top_p, back.seed) == (
        0.7, 5, 0.9, 11)
    assert tworker._sampling_to_wire(None) is None


# ------------------------------------------------------ migration store


def _arrays():
    return {"kv_cache@l0.k": np.arange(24, dtype=np.float32)
            .reshape(4, 2, 3),
            "kv_cache@l0.v": np.ones((4, 2, 3), np.float32)}


def test_store_roundtrip_first_publisher_wins(tmp_path):
    store = fleet.MigrationStore(str(tmp_path / "s"))
    key = "ab" * 32
    assert not store.contains(key) and store.fetch(key) is None
    assert store.publish(key, _arrays())
    assert store.contains(key) and store.keys() == [key]
    got = store.fetch(key)
    for n, a in _arrays().items():
        np.testing.assert_array_equal(got[n], a)
    assert store.publish(key, _arrays()) is False
    # the manifest is the JAX package's, field for field
    jstore = jfleet.MigrationStore(str(tmp_path / "j"))
    assert jstore.publish(key, _arrays())
    assert jstore.meta(key) == store.meta(key)
    store.evict(key)
    assert not store.contains(key)
    assert store.keys() == []


def test_store_bf16_rows_round_trip(tmp_path):
    """numpy has no bfloat16: a bf16 pool's rows travel as 16-bit
    patterns and come back as ``torch.bfloat16``, the dtype the
    manifest names."""
    store = fleet.MigrationStore(str(tmp_path / "s"))
    rows = torch.randn(4, 2, 3).to(torch.bfloat16)
    assert store.publish("cd" * 32, {"pool": rows})
    assert store.meta("cd" * 32)["geometry"]["pool"] == {
        "shape": [4, 2, 3], "dtype": "bfloat16"}
    got = store.fetch("cd" * 32)["pool"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, rows)


def test_store_corruption_corpus(tmp_path):
    """Truncated, flipped, torn-meta and missing-blob entries all
    fetch as None, never raise, and the poison is evicted."""
    store = fleet.MigrationStore(str(tmp_path / "s"))

    def entry(key):
        assert store.publish(key, _arrays())
        return store._entry_dir(key)

    d = entry("aa" + "0" * 62)
    blob = os.path.join(d, "blocks.npz")
    raw = bytearray(open(blob, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(blob, "wb").write(bytes(raw))
    assert store.fetch("aa" + "0" * 62) is None
    assert not store.contains("aa" + "0" * 62)

    d = entry("bb" + "0" * 62)
    blob = os.path.join(d, "blocks.npz")
    raw = open(blob, "rb").read()
    open(blob, "wb").write(raw[:len(raw) // 2])
    assert store.fetch("bb" + "0" * 62) is None
    assert not store.contains("bb" + "0" * 62)

    d = entry("cc" + "0" * 62)
    open(os.path.join(d, "meta.json"), "w").write("{not json")
    assert store.fetch("cc" + "0" * 62) is None
    assert not store.contains("cc" + "0" * 62)

    d = entry("dd" + "0" * 62)
    os.unlink(os.path.join(d, "blocks.npz"))
    assert store.fetch("dd" + "0" * 62) is None

    # an injected corruption on the wire fails the same check
    entry("ee" + "0" * 62)
    faults.install_plan(FaultPlan(seed=0, faults=[
        FaultRule("fleet.migrate", "corrupt", hits=[0])]))
    try:
        assert store.fetch("ee" + "0" * 62) is None
    finally:
        faults.clear_plan()
    assert not store.contains("ee" + "0" * 62)


def _pool_ptrs(engine):
    return {name: engine.scope.find_var(name).data_ptr()
            for name, _, _ in engine.pair.pool_specs}


def test_migrator_export_restore_roundtrip(tmp_path):
    """A prefill-role migrator exports a committed span; a second
    engine's migrator restores it block for block IN PLACE (every pool
    keeps its address) and the next admission matches the restored
    span as committed prefix."""
    store = fleet.MigrationStore(str(tmp_path / "s"))
    eng_a = _engine(SEED)
    worker = fleet.PrefillWorker(
        eng_a, fleet.BlockMigrator(store, eng_a, export=True))
    prompt = SHARED_A + [10, 2]
    out = worker.prefill(prompt)
    assert out["exported"] >= 2
    again = worker.prefill(prompt)
    assert again["exported"] == 0 and again["cached"] == len(prompt)

    eng_b = _engine(SEED)
    ptrs = _pool_ptrs(eng_b)
    kv = KVCacheManager(eng_b.cache_config)
    mig = fleet.BlockMigrator(store, eng_b)
    restored = mig.preload(kv, prompt)
    assert restored >= 2 and mig.stats()["restored"] == restored
    assert _pool_ptrs(eng_b) == ptrs
    sid, cached = kv.admit_tokens(prompt, 4)
    assert cached == restored * CACHE["block_size"]
    kv.release(sid)
    for key in kv.prefix_keys(prompt)[:restored]:
        b_a = worker.kv.cached_block(key)
        b_b = kv.cached_block(key)
        assert b_a is not None and b_b is not None
        for name, _, _ in eng_a.pair.pool_specs:
            torch.testing.assert_close(eng_a.scope.get(name)[b_a],
                                       eng_b.scope.get(name)[b_b],
                                       rtol=0, atol=0)


def test_stale_geometry_payload_refused(tmp_path):
    """A payload whose manifest records another cache geometry is
    refused from the manifest alone (corrupt counter, entry evicted),
    and the stream falls back to a full prefill, unchanged; a truncated
    payload fails verification the same way."""
    store = fleet.MigrationStore(str(tmp_path / "s"))
    eng = _engine(SEED)
    prompt = SHARED_A + [10, 2]
    keys = KVCacheManager(eng.cache_config).prefix_keys(prompt)
    for key in keys:
        stale = {n: np.zeros((8,) + tuple(eng.scope.get(n).shape[2:]),
                             np.float32)
                 for n, _, _ in eng.pair.pool_specs}
        assert store.publish(key, stale)
    prompt_b = SHARED_B + [10, 2]
    oracle = _oracle([{"prompt": prompt, "max_new_tokens": 6},
                      {"prompt": prompt_b, "max_new_tokens": 6}])
    sess = _session(SEED)
    mig = fleet.BlockMigrator(store, sess.engine)
    sess.batcher.migrator = mig
    try:
        got = sess.generate(prompt, max_new_tokens=6)
        assert got == oracle[0]
        assert mig.stats()["corrupt"] >= 1
        assert mig.stats()["restored"] == 0
        assert not store.contains(keys[0])

        keys_b = KVCacheManager(eng.cache_config).prefix_keys(prompt_b)
        rows = {n: np.zeros(tuple(eng.scope.get(n).shape[1:]), np.float32)
                for n, _, _ in eng.pair.pool_specs}
        assert store.publish(keys_b[0], rows)
        blob = os.path.join(store._entry_dir(keys_b[0]), "blocks.npz")
        raw = open(blob, "rb").read()
        open(blob, "wb").write(raw[:len(raw) // 2])
        corrupt_before = mig.stats()["corrupt"]
        got_b = sess.generate(prompt_b, max_new_tokens=6)
        assert got_b == oracle[1]
        assert mig.stats()["corrupt"] == corrupt_before + 1
        assert not store.contains(keys_b[0])
    finally:
        sess.shutdown(drain=True, timeout=120)


def test_migrator_int8_scales_ride_along(tmp_path):
    """Under int8 KV the payload carries the code pools AND the scale
    pools; a restore is byte-identical across both."""
    store = fleet.MigrationStore(str(tmp_path / "s"))
    q8 = CacheConfig(prefix_cache=True, kv_dtype="int8", **CACHE)
    eng_a = _engine(SEED, cache=q8)
    worker = fleet.PrefillWorker(
        eng_a, fleet.BlockMigrator(store, eng_a, export=True))
    prompt = SHARED_A + [10, 2]
    assert worker.prefill(prompt)["exported"] >= 2
    names = {name for name, _, _ in eng_a.pair.pool_specs}
    assert any(".kscale" in n or ".vscale" in n for n in names)
    for key in store.keys():
        meta = store.meta(key)
        assert set(meta["pools"]) == names
        assert set(meta["geometry"]) == names
    eng_b = _engine(SEED, cache=q8)
    ptrs = _pool_ptrs(eng_b)
    kv = KVCacheManager(eng_b.cache_config)
    assert fleet.BlockMigrator(store, eng_b).preload(kv, prompt) >= 2
    assert _pool_ptrs(eng_b) == ptrs
    for key, b_b in kv.export_span(prompt):
        b_a = worker.kv.cached_block(key)
        for name, _, _ in eng_a.pair.pool_specs:
            assert torch.equal(eng_a.scope.get(name)[b_a],
                               eng_b.scope.get(name)[b_b])


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_entries_cross_between_the_packages(tmp_path, kv_dtype):
    """An entry the JAX package's PrefillWorker publishes is restored
    by the port's migrator, and one the port publishes by the JAX
    package's; either way the restoring session decodes the JAX
    package's stream token for token, with the whole shared span
    restored rather than prefilled."""
    prompt = SHARED_A + [10, 2]
    sp = SamplingParams(temperature=0.8, top_k=5, seed=33)
    req = {"prompt": prompt, "max_new_tokens": 8, "sampling": sp}
    want = _j_oracle([req], kv_dtype)[0]
    cache = CacheConfig(prefix_cache=True, kv_dtype=kv_dtype, **CACHE)

    # JAX entry -> port restore
    jstore_root = str(tmp_path / "from_jax")
    jmain, jscope, jlogits = jfw.build_lm(SEED)
    jeng = JDecodeEngine(jmain, "tokens", jlogits.name, scope=jscope,
                         config=_j_config(kv_dtype))
    jstore = jfleet.MigrationStore(jstore_root)
    jworker = jfleet.PrefillWorker(
        jeng, jfleet.BlockMigrator(jstore, jeng, export=True))
    assert jworker.prefill(prompt)["exported"] == 2
    sess = _session(SEED, cache=cache)
    mig = fleet.BlockMigrator(fleet.MigrationStore(jstore_root),
                              sess.engine)
    sess.batcher.migrator = mig
    try:
        assert sess.generate(prompt, max_new_tokens=8, sampling=sp) == want
        assert mig.stats()["restored"] == 2
        assert sess.metrics.get("prefill_tokens_avoided_total") == 8
    finally:
        sess.shutdown(drain=True, timeout=120)

    # port entry -> JAX restore
    tstore_root = str(tmp_path / "from_port")
    eng = _engine(SEED, cache=cache)
    tworker = fleet.PrefillWorker(
        eng, fleet.BlockMigrator(fleet.MigrationStore(tstore_root), eng,
                                 export=True))
    assert tworker.prefill(prompt)["exported"] == 2
    assert sorted(fleet.MigrationStore(tstore_root).keys()) == sorted(
        jstore.keys())
    jsess = _j_session(kv_dtype)
    jmig = jfleet.BlockMigrator(jfleet.MigrationStore(tstore_root),
                                jsess.engine)
    jsess.batcher.migrator = jmig
    try:
        assert jsess.generate(prompt, max_new_tokens=8,
                              sampling=_j_sampling(sp)) == want
        assert jmig.stats()["restored"] == 2
    finally:
        jsess.shutdown(drain=True, timeout=120)


def test_chain_keys_match_the_jax_package():
    for kv_dtype in (None, "int8"):
        t = KVCacheManager(CacheConfig(prefix_cache=True,
                                       kv_dtype=kv_dtype, **CACHE))
        j = JKVCacheManager(JCacheConfig(prefix_cache=True,
                                         kv_dtype=kv_dtype, **CACHE))
        for prompt in (SHARED_A + [10, 2], SHARED_B * 2):
            assert t.prefix_keys(prompt) == j.prefix_keys(prompt)


# ------------------------------------------------- fleet metrics units


def test_relabel_exposition():
    text = ("# HELP x y\n"
            "# TYPE x counter\n"
            'x{a="1"} 3\n'
            "plain_total 7\n"
            'odd{} 1\n')
    out = fleet.relabel_exposition(text, 'r"0\n')
    assert 'x{replica="r\\"0\\n",a="1"} 3' in out
    assert 'plain_total{replica="r\\"0\\n"} 7' in out
    assert 'odd{replica="r\\"0\\n"} 1' in out
    assert "# HELP x y" in out and out.endswith("\n")
    assert out == jfleet.relabel_exposition(text, 'r"0\n')


def test_metrics_port_discovery():
    """N /metrics servers on one host bind ephemeral ports without
    collisions, and the bound port is discoverable."""
    s1 = obs_metrics.start_http_server(port=0)
    s2 = obs_metrics.start_http_server(port=0)
    try:
        assert s1.port != s2.port and s1.port > 0 and s2.port > 0
        assert obs_metrics.http_endpoint() == (s2.addr, s2.port)
        assert "pdtpu_obs_http_port" in obs_metrics.render_prometheus()
        health = obs_metrics.health_snapshot()
        assert health["sources"]["metrics_http"]["port"] == s2.port
    finally:
        s2.close()
        s1.close()
    assert obs_metrics.http_endpoint() is None


def test_fleet_metrics_counts_and_report():
    """The counters and their exposition lines are the JAX package's."""
    from paddle_tpu.obs import metrics as j_obs_metrics

    lines = []
    for pkg, mod, reg in ((fleet, fleet, obs_metrics),
                          (jfleet, jfleet, j_obs_metrics)):
        m = mod.FleetMetrics("fx")
        m.inc("requests")
        m.routed("r0")
        m.routed("r0")
        m.set_live(3)
        m.set_stage(2)
        rep = m.report()
        assert rep["requests"] == 1 and rep["routed"] == 2
        text = reg.render_prometheus()
        assert ('pdtpu_fleet_routed_total{fleet="fx",replica="r0"} 2'
                in text)
        assert 'pdtpu_fleet_replicas_live{fleet="fx"} 3' in text
        lines.append(sorted(ln for ln in text.splitlines()
                            if "pdtpu_fleet" in ln))
    assert lines[0] == lines[1]


# --------------------------------------------------- pressure satellite


def test_session_health_pressure_bounds():
    s = _session()
    try:
        h = s.health()
        assert isinstance(h["pressure"], float)
        assert 0.0 <= h["pressure"] <= 1.0
        assert "queue_depth" in h and "degradation_stage" in h
    finally:
        s.shutdown(drain=True, timeout=60)


def test_session_health_prefix_cache_occupancy():
    s = _session()
    try:
        h0 = s.health()["prefix_cache"]
        assert h0["cached_blocks"] == 0
        assert h0["hit_rate_window"] is None
        assert h0["reclaimable_frac"] == 1.0
        prompt = SHARED_A + [10, 2]
        s.generate(prompt, max_new_tokens=3)
        s.generate(prompt, max_new_tokens=3)
        h1 = s.health()["prefix_cache"]
        assert h1["cached_blocks"] >= 2
        assert h1["hit_rate_window"] == 0.5
        assert 0.0 <= h1["reclaimable_frac"] <= 1.0
        assert s.health()["prefix_cache"]["hit_rate_window"] is None
        s.generate(prompt, max_new_tokens=3)
        assert s.health()["prefix_cache"]["hit_rate_window"] == 1.0
        text = obs_metrics.render_prometheus()
        sink = s.metrics.sink
        for g in ("prefix_cached_blocks", "prefix_reclaimable_frac",
                  "prefix_hit_rate_window"):
            assert ('pdtpu_serving_gauge{gauge="%s",sink="%s"}'
                    % (g, sink)) in text
    finally:
        s.shutdown(drain=True, timeout=60)


def test_prefill_worker_health_and_noop(tmp_path):
    eng = _engine()
    w = fleet.PrefillWorker(
        eng, fleet.BlockMigrator(store=fleet.MigrationStore(
            str(tmp_path / "s")), engine=eng, export=True))
    h = w.health()
    assert h["role"] == "prefill" and 0.0 <= h["pressure"] <= 1.0
    assert w.prefill([1, 2]) == {"exported": 0, "cached": 0}


# --------------------------------------------- routing decisions (unit)


class _StubReplica:
    role = "decode"

    def __init__(self, name, pressure=0.0):
        self.name = name
        self.pressure = pressure
        self.dead = False
        self.record_dir = None
        self.submits = []

    def health(self):
        if self.dead:
            return None
        return {"status": "serving", "pressure": self.pressure,
                "degradation_stage": 0}

    def submit(self, payload, on_token=None):
        self.submits.append(payload)
        fut = Future()
        fut.set_result([1, 2, 3])
        return fut

    def drain(self, timeout=None):
        self.dead = True

    def kill(self):
        self.dead = True


def _stub_router(stubs, mod=fleet, cache_cls=CacheConfig, **kw):
    cfg = mod.FleetConfig(cache=cache_cls(prefix_cache=True, **CACHE),
                          health_interval_s=30.0, **kw)
    return mod.Router(stubs, cfg)


def test_affinity_then_spillover_under_pressure():
    a, b = _StubReplica("a"), _StubReplica("b")
    r = _stub_router([a, b])
    try:
        prompt = SHARED_A + [9]
        assert r.generate(prompt, max_new_tokens=3) == [1, 2, 3]
        assert len(a.submits) == 1
        assert r.generate(prompt, max_new_tokens=3) == [1, 2, 3]
        assert len(a.submits) == 2 and r.metrics.counts[
            "affinity_hits"] >= 1
        a.pressure = 0.95
        r._poll_once()
        assert r.generate(prompt, max_new_tokens=3) == [1, 2, 3]
        assert len(b.submits) == 1
        assert r.metrics.counts["spillovers"] >= 1
    finally:
        r.close()


def test_routers_of_both_packages_route_alike():
    """The same scripted health (pressure changes between requests)
    over stub replicas: both packages' routers send every request to
    the same replica with the same payload."""
    script = [(SHARED_A + [9], {}), (SHARED_A + [9], {}),
              (SHARED_B + [1, 2], {}), (SHARED_A + [3], {"a": 0.95}),
              (SHARED_B + [5], {"b": 0.9, "a": 0.2}),
              (SHARED_B + [5], {"c": 0.99}), ([4, 4, 4], {})]
    routes = []
    for mod, cache_cls in ((fleet, CacheConfig), (jfleet, JCacheConfig)):
        stubs = [_StubReplica(n) for n in "abc"]
        r = _stub_router(stubs, mod=mod, cache_cls=cache_cls)
        got = []
        try:
            for prompt, pressures in script:
                for s in stubs:
                    s.pressure = pressures.get(s.name, s.pressure)
                r._poll_once()
                before = [len(s.submits) for s in stubs]
                assert r.generate(prompt, max_new_tokens=3,
                                  timeout=30) == [1, 2, 3]
                got.append([s.name for s, n in zip(stubs, before)
                            if len(s.submits) > n])
            got.append(r.metrics.report())
            got.append([s.submits for s in stubs])
        finally:
            r.close()
        routes.append(got)
    assert routes[0] == routes[1]


def test_no_live_replica_is_typed_overload():
    from paddle_tpu_torch.serving.errors import is_retriable

    a = _StubReplica("a")
    r = _stub_router([a])
    try:
        a.dead = True
        r._poll_once()
        with pytest.raises(OverloadedError) as e:
            r.generate([1, 2, 3, 4, 5], max_new_tokens=2, timeout=30)
        assert e.value.retry_after_s
        assert is_retriable(e.value)
    finally:
        r.close()


def test_route_fault_injection_sheds_and_reroutes():
    a, b = _StubReplica("a", pressure=0.3), _StubReplica("b")
    r = _stub_router([a, b])
    try:
        faults.install_plan(FaultPlan(seed=0, faults=[
            FaultRule("fleet.route", "raise", hits=[0]),
            FaultRule("fleet.route", "corrupt", hits=[1]),
        ]))
        with pytest.raises(OverloadedError):
            r.generate([5, 5, 5, 5, 5], max_new_tokens=2, timeout=30)
        assert r.metrics.counts["route_overloaded"] == 1
        assert r.generate([5, 5, 5, 5, 5], max_new_tokens=2,
                          timeout=30) == [1, 2, 3]
        assert len(b.submits) == 1 and len(a.submits) == 0
    finally:
        faults.clear_plan()
        r.close()


def test_round_robin_policy_rotates_warmth_blind():
    with pytest.raises(Exception):
        fleet.FleetConfig(policy="nope")
    a, b = _StubReplica("a"), _StubReplica("b")
    r = _stub_router([a, b], policy="round_robin")
    try:
        prompt = SHARED_A + [9]
        for _ in range(4):
            assert r.generate(prompt, max_new_tokens=3,
                              timeout=60) == [1, 2, 3]
        assert len(a.submits) == 2 and len(b.submits) == 2
        assert r.metrics.counts["affinity_misses"] >= 2
    finally:
        r.close()


def test_prefill_replica_payload_import_continues_stream(tmp_path):
    """A KV payload prefilled on a prefill-ONLY replica, restored into a
    decode replica, continues the stream unchanged, and the decode
    replica prefills ONLY the suffix."""
    prompt = SHARED_A + [10, 2]
    sp = SamplingParams(temperature=0.8, top_k=5, seed=33)
    oracle = _oracle([{"prompt": prompt, "max_new_tokens": 8,
                       "sampling": sp}])
    store = fleet.MigrationStore(str(tmp_path / "s"))
    eng_p = _engine(SEED)
    worker = fleet.PrefillWorker(
        eng_p, fleet.BlockMigrator(store, eng_p, export=True))
    exported = worker.prefill(prompt)["exported"]
    assert exported == 2

    sess = _session(SEED)
    mig = fleet.BlockMigrator(store, sess.engine)
    sess.batcher.migrator = mig
    try:
        got = sess.generate(prompt, max_new_tokens=8, sampling=sp)
        assert got == oracle[0]
        assert mig.stats()["restored"] == exported
        avoided = sess.metrics.get("prefill_tokens_avoided_total")
        assert avoided == exported * CACHE["block_size"]
        computed = sess.metrics.get("prefill_tokens_computed_total")
        assert computed == len(prompt) - avoided
    finally:
        sess.shutdown(drain=True, timeout=120)


def test_dead_replica_bundle_collected(tmp_path):
    rd = str(tmp_path / "rec")
    obs_record.enable(dir=rd, interval_s=60.0)
    try:
        bundle = obs_record.dump(reason="pre-death")
        assert bundle and obs_record.validate_bundle(bundle) == []
    finally:
        obs_record.disable()
    a, b = _StubReplica("a"), _StubReplica("b")
    a.record_dir = rd
    r = _stub_router([a, b])
    try:
        a.dead = True
        r._poll_once()
        h = r.health()
        assert h["replicas"]["a"] is None and h["live"] == 1
        assert h["bundles"]["a"] == bundle
        assert h["fleet"]["replica_deaths"] == 1
        assert h["fleet"]["bundles_collected"] == 1
    finally:
        r.close()


# ------------------------------------------- the acceptance fleet runs


def test_fleet_24_concurrent_with_affinity(tmp_path):
    """A 4-replica fleet (1 prefill + 3 decode) serves 24 concurrent
    mixed requests; every stream equals the sequential oracle, with
    affinity hits, migrated-block restores and suffix-only prefills."""
    reqs = _mixed_requests(24)
    oracle = _oracle(reqs)
    router, reps, store = _fleet(tmp_path / "store", n_decode=3)
    try:
        futs = []
        for i, r in enumerate(reqs):
            fut = router.submit(r["prompt"],
                                max_new_tokens=r["max_new_tokens"],
                                sampling=r.get("sampling"),
                                priority=r.get("priority"))
            futs.append(fut)
            if i < 2:
                fut.result(timeout=600)
        got = [f.result(timeout=600) for f in futs]
        assert got == oracle
        h = router.health()
        assert h["live"] == 4 and h["status"] == "serving"
        assert h["fleet"]["requests"] == 24
        assert h["fleet"]["affinity_hits"] > 0
        assert h["fleet"]["prefills_delegated"] > 0
        assert len(store.keys()) > 0
        restored = sum(r.migrator.stats()["restored"]
                       for r in reps if r.role == "decode")
        assert restored > 0
        avoided = sum(
            r.target.metrics.get("prefill_tokens_avoided_total")
            for r in reps if r.role == "decode")
        assert avoided >= restored * CACHE["block_size"]
    finally:
        router.drain(timeout=120)


def test_fleet_migration_corruption_degrades_to_reprefill(tmp_path,
                                                         mixed8):
    """Every migrated payload corrupt on the wire: verification rejects
    them all, decode replicas re-prefill locally, streams unchanged."""
    reqs, oracle = mixed8
    router, reps, store = _fleet(tmp_path / "store")
    try:
        faults.install_plan(FaultPlan(seed=3, faults=[
            FaultRule("fleet.migrate", "corrupt", prob=1.0)]))
        futs = []
        for i, r in enumerate(reqs):
            fut = router.submit(r["prompt"],
                                max_new_tokens=r["max_new_tokens"],
                                sampling=r.get("sampling"),
                                priority=r.get("priority"))
            futs.append(fut)
            if i < 2:
                fut.result(timeout=600)
        got = [f.result(timeout=600) for f in futs]
        assert got == oracle
        corrupt = sum(r.migrator.stats()["corrupt"]
                      for r in reps if r.role == "decode")
        restored = sum(r.migrator.stats()["restored"]
                       for r in reps if r.role == "decode")
        assert corrupt > 0 and restored == 0
    finally:
        faults.clear_plan()
        router.drain(timeout=120)


def _slow_tokens(reps, delay_s=0.01):
    """Slow every decode replica's streaming a little, so a kill lands
    mid-stream on the CPU."""
    for r in reps:
        if r.role != "decode":
            continue
        orig = r.target.submit

        def submit(prompt, _orig=orig, **kw):
            cb = kw.pop("on_token", None)

            def slow(tok):
                time.sleep(delay_s)
                if cb is not None:
                    cb(tok)
            return _orig(prompt, on_token=slow, **kw)
        r.target.submit = submit


def test_replica_death_mid_stream_resumes_on_survivor(tmp_path):
    """Kill the busiest decode replica once streams are in flight: the
    router resumes every interrupted stream on the survivor, full
    streams equal to the oracle (and to the JAX package's), no token
    re-streamed; the killed replica's pools are freed."""
    reqs = [
        {"prompt": SHARED_A + [11, 2], "max_new_tokens": 14,
         "sampling": None},
        {"prompt": SHARED_A + [12, 3], "max_new_tokens": 14,
         "sampling": SamplingParams(temperature=0.9, top_k=5, seed=11)},
        {"prompt": SHARED_B + [13, 4], "max_new_tokens": 14,
         "sampling": SamplingParams(temperature=0.7, top_p=0.9, seed=5)},
    ]
    oracle = _oracle(reqs)
    assert oracle == _j_oracle(reqs)
    router, reps, _ = _fleet(tmp_path / "store", prefill=False)
    _slow_tokens(reps)
    try:
        streams = [[] for _ in reqs]
        seen3 = threading.Event()

        def mk(i):
            def cb(tok):
                streams[i].append(int(tok))
                if len(streams[i]) >= 3:
                    seen3.set()
            return cb

        futs = [router.submit(r["prompt"],
                              max_new_tokens=r["max_new_tokens"],
                              sampling=r.get("sampling"),
                              on_token=mk(i))
                for i, r in enumerate(reqs)]
        assert seen3.wait(timeout=300), "no stream reached 3 tokens"
        victim = max(reps, key=lambda r: (-1 if r.dead else
                                          r.target.metrics
                                          .active_sequences))
        victim.kill()
        got = [f.result(timeout=600) for f in futs]
        assert got == oracle
        for i in range(len(reqs)):
            assert streams[i] == got[i]
        h = router.health()
        assert h["fleet"]["replica_deaths"] >= 1
        assert h["fleet"]["resumes"] >= 1
        assert h["replicas"][victim.name] is None
        assert all(victim.target.engine.scope.find_var(n) is None
                   for n, _, _ in victim.target.engine.pair.pool_specs)
    finally:
        router.drain(timeout=120)


def test_seeded_resume_on_survivor_restores_migrated_prefix(tmp_path):
    """A seeded-sampled stream cut by a replica death resumes on the
    other replica unchanged, with the survivor's prefix blocks restored
    from the migrated payload, no token re-streamed."""
    req = {"prompt": SHARED_A + [11, 2], "max_new_tokens": 14,
           "sampling": SamplingParams(temperature=0.8, top_k=5, seed=77)}
    oracle = _oracle([req])
    router, reps, store = _fleet(tmp_path / "store")
    _slow_tokens(reps)
    try:
        streamed = []
        seen3 = threading.Event()

        def cb(tok):
            streamed.append(int(tok))
            if len(streamed) >= 3:
                seen3.set()

        fut = router.submit(req["prompt"],
                            max_new_tokens=req["max_new_tokens"],
                            sampling=req["sampling"], on_token=cb)
        assert seen3.wait(timeout=300), "stream never reached 3 tokens"
        decode = [r for r in reps if r.role == "decode"]
        victim = max(decode, key=lambda r: (-1 if r.dead else
                                            r.target.metrics
                                            .active_sequences))
        victim.kill()
        got = fut.result(timeout=600)
        assert got == oracle[0]
        assert streamed == got
        survivor, = [r for r in decode if r is not victim]
        assert survivor.migrator.stats()["restored"] > 0
        assert router.metrics.counts["resumes"] >= 1
        assert router.metrics.counts["replica_deaths"] >= 1
    finally:
        router.drain(timeout=120)


def test_injected_replica_death_fault_site(tmp_path, mixed8):
    """fleet.replica_death (raise): the second submit kills that replica
    in place; the router retries on a survivor, streams unchanged."""
    reqs, oracle = mixed8
    reqs, oracle = reqs[:4], oracle[:4]
    router, reps, _ = _fleet(tmp_path / "store", prefill=False)
    try:
        faults.install_plan(FaultPlan(seed=1, faults=[
            FaultRule("fleet.replica_death", "raise", hits=[1])]))
        got = [router.generate(r["prompt"],
                               max_new_tokens=r["max_new_tokens"],
                               sampling=r.get("sampling"),
                               priority=r.get("priority"), timeout=600)
               for r in reqs]
        assert got == oracle
        assert sum(1 for r in reps if r.dead) == 1
        assert router.metrics.counts["replica_deaths"] == 1
        assert router.metrics.counts["retries"] >= 1
    finally:
        faults.clear_plan()
        router.drain(timeout=120)


# ------------------------------------------------- default-off contract


def test_fleet_default_off_byte_identical(tmp_path, mixed8):
    """Both directions: a plain session has no migrator and streams the
    pre-fleet tokens; the same requests through a full fleet produce
    the same streams; program stamps never change."""
    main, _, logits = fw.build_lm(SEED)
    pair = derive_decode_programs(main, "tokens", logits.name,
                                  CacheConfig(**CACHE))
    assert pair.prefill._decode_stamp == "decoding/paged24x4x6/prefill"
    # the port always runs the paged kernel: the JAX package's stamp of
    # its pallas_paged_attention route
    assert pair.decode._decode_stamp == \
        "decoding/paged24x4x6/decode+pallas"
    reqs, oracle = mixed8
    reqs, oracle = reqs[:6], oracle[:6]
    plain = _session()
    try:
        assert plain.batcher.migrator is None
        off = [plain.generate(r["prompt"],
                              max_new_tokens=r["max_new_tokens"],
                              sampling=r.get("sampling"),
                              priority=r.get("priority"))
               for r in reqs]
    finally:
        plain.shutdown(drain=True, timeout=120)
    router, _, _ = _fleet(tmp_path / "store")
    try:
        on = [router.generate(r["prompt"],
                              max_new_tokens=r["max_new_tokens"],
                              sampling=r.get("sampling"),
                              priority=r.get("priority"), timeout=600)
              for r in reqs]
    finally:
        router.drain(timeout=120)
    assert on == off == oracle


# ------------------------------------- cross-process replicas (wire)


def _worker_env():
    env = dict(os.environ)
    env.pop("PYTEST_CURRENT_TEST", None)
    env.pop("PDTPU_FAULT_PLAN", None)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(_HERE), _HERE]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    return env


def _spawn_worker(tmp_path, spec, tag):
    spec_p = str(tmp_path / ("spec_%s.json" % tag))
    out_p = str(tmp_path / ("out_%s.json" % tag))
    with open(spec_p, "w") as f:
        json.dump(spec, f)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(_HERE, "_torch_fleet_worker.py"),
         spec_p, out_p],
        env=_worker_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    return proc, out_p


def _wait_handshakes(fleet_dir, names, procs, timeout=300):
    deadline = time.time() + timeout
    while time.time() < deadline:
        found = {h["name"] for h in fleet.discover(fleet_dir)}
        if set(names) <= found:
            return
        for p in procs:
            if p.poll() is not None:
                raise AssertionError(
                    "worker died before ready: rc=%s\n%s" % (
                        p.returncode,
                        p.stderr.read().decode(errors="replace")
                        [-3000:]))
        time.sleep(0.2)
    raise AssertionError("handshakes never appeared: %s" % names)


def test_sigkill_worker_resume_and_fleet_scrape(tmp_path):
    """Two decode WORKER PROCESSES behind the router; one SIGKILLs
    itself mid-stream. Every stream resumes on the survivor unchanged
    (oracle computed in a worker process), no token re-streamed, and
    the fleet scrape aggregates the survivor's /metrics with
    per-replica labels."""
    fleet_dir = str(tmp_path / "fleet")
    store_root = str(tmp_path / "store")
    base = {"mode": "replica", "fleet_dir": fleet_dir,
            "store_root": store_root, "seed": SEED, "cache": CACHE,
            "max_new_tokens": 16}
    reqs = [
        {"prompt": SHARED_A + [11, 2], "max_new_tokens": 12,
         "sampling": None},
        {"prompt": SHARED_A + [12, 3], "max_new_tokens": 12,
         "sampling": {"temperature": 0.8, "top_k": 5, "seed": 21}},
        {"prompt": SHARED_B + [13, 4], "max_new_tokens": 12,
         "sampling": {"temperature": 0.7, "top_p": 0.9, "seed": 9}},
    ]
    pa, _ = _spawn_worker(
        tmp_path, dict(base, name="wa", kill_after_tokens=5), "a")
    pb, _ = _spawn_worker(tmp_path, dict(base, name="wb"), "b")
    po, oracle_out = _spawn_worker(
        tmp_path, {"mode": "oracle", "seed": SEED, "cache": CACHE,
                   "max_new_tokens": 16, "requests": reqs}, "o")
    router = None
    try:
        _wait_handshakes(fleet_dir, ["wa", "wb"], [pa, pb])
        handshakes = {h["name"]: h for h in fleet.discover(fleet_dir)}
        remotes = [fleet.RemoteReplica(handshakes["wa"]),
                   fleet.RemoteReplica(handshakes["wb"])]
        router = fleet.Router(
            remotes,
            fleet.FleetConfig(cache=CacheConfig(prefix_cache=True,
                                                **CACHE),
                              health_interval_s=0.5,
                              prefill_delegation=False,
                              request_timeout_s=600.0))
        streams = [[] for _ in reqs]

        def mk(i):
            return lambda tok: streams[i].append(int(tok))

        futs = [router.submit(r["prompt"],
                              max_new_tokens=r["max_new_tokens"],
                              sampling=fleet.worker
                              ._sampling_from_wire(r.get("sampling")),
                              on_token=mk(i))
                for i, r in enumerate(reqs)]
        got = [f.result(timeout=600) for f in futs]

        assert pa.wait(timeout=120) == -signal.SIGKILL
        assert po.wait(timeout=600) == 0
        with open(oracle_out) as f:
            oracle = json.load(f)["streams"]
        assert got == oracle
        for i in range(len(reqs)):
            assert streams[i] == got[i]
        assert router.metrics.counts["replica_deaths"] >= 1
        assert router.metrics.counts["resumes"] >= 1

        text = fleet.aggregate_scrape([handshakes["wb"]],
                                      local_replica="router")
        assert 'replica="wb"' in text and 'replica="router"' in text
        assert "pdtpu_fleet_events_total" in text
    finally:
        if router is not None:
            router.drain(timeout=60)
        for p in (pa, pb, po):
            if p.poll() is None:
                p.kill()
            p.wait(timeout=60)


def test_remote_prefill_worker_process(tmp_path):
    """A prefill-ROLE worker process warms the shared store through the
    wire; a local engine restores the span instead of recomputing
    it."""
    fleet_dir = str(tmp_path / "fleet")
    store_root = str(tmp_path / "store")
    pp, _ = _spawn_worker(
        tmp_path, {"mode": "replica", "role": "prefill", "name": "wp",
                   "fleet_dir": fleet_dir, "store_root": store_root,
                   "seed": SEED, "cache": CACHE,
                   "max_new_tokens": 16}, "p")
    try:
        _wait_handshakes(fleet_dir, ["wp"], [pp])
        hs, = fleet.discover(fleet_dir)
        assert hs["role"] == "prefill" and hs["pid"] == pp.pid
        assert sorted(hs) == ["host", "metrics_port", "name", "pid",
                              "port", "record_dir", "role"]
        remote = fleet.RemoteReplica(hs)
        assert remote.health(timeout=10)["role"] == "prefill"
        prompt = SHARED_A + [10, 2]
        out = remote.prefill(prompt, timeout=300)
        assert out["exported"] >= 2
        store = fleet.MigrationStore(store_root)
        assert len(store.keys()) >= 2
        eng = _engine(SEED)
        kv = KVCacheManager(eng.cache_config)
        assert fleet.BlockMigrator(store, eng).preload(kv, prompt) >= 2
        remote.drain(timeout=60)
        assert pp.wait(timeout=120) == 0
        out, _ = pp.communicate(timeout=60)
        assert b"WORKER_DONE" in out
    finally:
        if pp.poll() is None:
            pp.kill()
            pp.wait(timeout=60)
