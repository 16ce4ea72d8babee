"""paddle_tpu_torch.tuning held to paddle_tpu.tuning on the CPU.

The port's kernel-autotuning tier against the JAX package's:

* the same tuning keys, canonical JSON, pow2 buckets and bucket keys
  for the same problems, and one on-disk store format: a store either
  package writes, the other lists, verifies and reads back;
* lookup: defaults without a store; a store hit whose memo survives the
  store's deletion; a constraint-violating entry evicted; the corruption
  corpus evicts and never crashes; version skew is a miss; gc runs in
  LRU order;
* the sweep publishes a winner and reuses it without re-measuring,
  records its spans, prunes early; a second process warm-starts with
  zero re-sweeps;
* manifests embed and seed tuned configs, an untuned manifest is left
  as it was, serving ``warm_up`` prefetches, graph keys gain a stamp
  only when something tuned reaches the program;
* the consumers: ``plan_route`` with no store plans what it planned
  before tuning existed, and reads the tuned knobs when they are
  stored; the fused update's and flash's knobs; the decode engine's
  tuning problems equal the JAX engine's, and an autotuned port engine
  serves the JAX package's greedy streams;
* the CLI.

On the CPU the sweep times the plain versions (the host's time, keyed
to device kind ``cpu``); the card's kernels are swept in
tests/test_torch_tuning_card.py and in chip_smoke.py's tuning phase.
"""

import json
import os
import shutil
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import pytest
import torch

import paddle_tpu.decoding as jdec
import paddle_tpu.tuning as jt
import paddle_tpu_torch as tfluid
import paddle_tpu_torch.decoding as tdec
from paddle_tpu.tuning.store import CONFIG_FILE, META_FILE
from paddle_tpu.tuning.store import TunedRecord as JRecord
from paddle_tpu_torch import tuning
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.tuning.store import TunedRecord

from _torch_port import CACHE, VOCAB, carried_scope, jax_lm, torch_lm

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CPU = tfluid.CPUPlace()
TINY_CE = {"n_tokens": 64, "d_model": 16, "vocab": 512}
DECODE = {"batch": 4, "q_tokens": 1, "window": 32, "block_size": 8,
          "heads": 2, "head_dim": 16, "kv_dtype": "f32"}


@pytest.fixture
def store_dir(tmp_path):
    d = str(tmp_path / "tuning_store")
    tuning.clear_memo()
    tuning.reset_tuning_metrics()
    flags.set_flags({"tuning_cache_dir": d})
    try:
        yield d
    finally:
        flags.set_flags({"tuning_cache_dir": ""})
        tuning.clear_memo()


@pytest.fixture
def no_store():
    tuning.clear_memo()
    tuning.reset_tuning_metrics()
    flags.set_flags({"tuning_cache_dir": ""})
    yield
    tuning.clear_memo()


def _publish(store, kernel, problem, config, dtype="float32",
             version=None):
    k = tuning.get_tunable(kernel)
    rec = TunedRecord(kernel, version or k.version, "cpu", dtype,
                      k.bucket_key(problem), config)
    assert store.put(rec)
    return rec


def _entry_dirs(root):
    out = []
    for shard in os.listdir(root):
        sd = os.path.join(root, shard)
        if os.path.isdir(sd) and len(shard) == 2:
            out += [os.path.join(sd, f) for f in os.listdir(sd)]
    return out


# ------------------------------------------------ keys across packages

PROBLEMS = {
    "paged_attention": [DECODE, {"batch": 5, "q_tokens": 9},
                        dict(DECODE, kv_dtype="int8", batch=16)],
    "fused_optimizer_update": [{"numel": 60519680, "n_accs": 2,
                                "n_shared": 2}, {"numel": 3}],
    "fused_ce": [TINY_CE, {"n_tokens": 8191, "d_model": 500,
                           "vocab": 32000}],
    "flash_attention": [{"seq_q": 200, "seq_k": 333, "head_dim": 64,
                         "causal": False}, {"seq": 100}],
}


@pytest.mark.parametrize("kernel", sorted(PROBLEMS))
def test_keys_and_buckets_match_jax(kernel):
    k, jk = tuning.get_tunable(kernel), jt.get_tunable(kernel)
    for problem in PROBLEMS[kernel]:
        bucket = k.bucket_key(problem)
        assert bucket == jk.bucket_key(problem)
        for dtype in ("float32", "bfloat16"):
            args = (kernel, "v1", "NVIDIA H100 80GB HBM3", dtype, bucket)
            assert tuning.tuning_key(*args) == jt.tuning_key(*args)
    assert k.bucket_key(None) == jk.bucket_key(None) == {}
    from paddle_tpu.tuning.store import canonical_json as j_canonical
    from paddle_tpu_torch.tuning.store import canonical_json

    obj = {"b": [1, 2.5, {"z": True}], "a": "x"}
    assert canonical_json(obj) == j_canonical(obj)
    for n in (0, 1, 3, 64, 65, 8191, 8192):
        for lo in (1, 8):
            assert tuning.pow2_bucket(n, lo) == jt.pow2_bucket(n, lo)


def test_registry_declares_hopper_spaces_with_todays_defaults():
    assert tuning.list_tunables() == ["flash_attention", "fused_ce",
                                      "fused_optimizer_update",
                                      "paged_attention"]
    from paddle_tpu_torch.ops import fused_ce, fused_optimizer
    from paddle_tpu_torch.ops import flash_attention as fa

    want = {"paged_attention": {"split_waves": pa.DEFAULT_SPLIT_WAVES,
                                "tile_waves": pa.DEFAULT_TILE_WAVES},
            "fused_optimizer_update": {
                "blocks_per_sm": fused_optimizer.DEFAULT_BLOCKS_PER_SM},
            "fused_ce": {"chunk_cap": fused_ce.DEFAULT_CHUNK_CAP},
            "flash_attention": {"tile": fa.BUILT_TILE}}
    for name, defaults in want.items():
        k = tuning.get_tunable(name)
        assert k.defaults == defaults
        assert k.validate_config(dict(k.defaults)) == k.defaults
        assert len(k.version) == 12
    assert pa.TARGET_BLOCKS == 8 * 132 and pa.TILE_TARGET_BLOCKS == 4 * 132
    # the flash space is its one built point, refused off it with the
    # reason the constraint gives
    flash = tuning.get_tunable("flash_attention")
    assert flash.candidates() == [{"tile": 64}]
    with pytest.raises(EnforceError, match="outside the declared"):
        flash.validate_config({"tile": 128})


def test_paged_constraints_keep_each_route_to_its_knob():
    k = tuning.get_tunable("paged_attention")
    split = k.candidates(DECODE)
    assert sorted(c["split_waves"] for c in split) == [1, 2, 4, 8, 16]
    assert {c["tile_waves"] for c in split} == {pa.DEFAULT_TILE_WAVES}
    tile = k.candidates(dict(DECODE, q_tokens=64))
    assert sorted(c["tile_waves"] for c in tile) == [0, 1, 2, 4, 8]
    assert {c["split_waves"] for c in tile} == {pa.DEFAULT_SPLIT_WAVES}
    # the generic route reads neither knob: no candidate at all
    assert k.candidates(dict(DECODE, head_dim=12)) == []
    assert k.candidates(dict(DECODE, window=8 * 4096)) == []
    with pytest.raises(EnforceError, match="route_knob"):
        k.validate_config({"split_waves": 8, "tile_waves": 0}, DECODE)


def test_editing_a_kernel_source_changes_its_version(tmp_path):
    from pathlib import Path

    from paddle_tpu_torch.tuning.registry import source_version

    src = Path(pa.__file__).resolve().parents[1] / "csrc" / \
        "paged_attention.cu"
    copy = tmp_path / "paged_attention.cu"
    copy.write_bytes(src.read_bytes())
    before = source_version(copy)
    assert before == source_version(src)
    copy.write_bytes(src.read_bytes() + b"\n// edited\n")
    assert source_version(copy) != before


# ---------------------------------------------------------------- store


def test_store_written_by_either_package_reads_in_the_other(tmp_path):
    fields = ("paged_attention", "abc123", "NVIDIA H100 80GB HBM3",
              "bfloat16", jt.get_tunable("paged_attention").bucket_key(
                  DECODE))
    config = {"split_waves": 2, "tile_waves": 4}
    meas = [{"config": config, "ms": 0.0125}]
    for writer, reader in ((jt, tuning), (tuning, jt)):
        root = str(tmp_path / writer.__name__.replace(".", "_"))
        rec_cls = JRecord if writer is jt else TunedRecord
        rec = rec_cls(*fields, config, best_ms=0.0125, measurements=meas)
        assert writer.TuningStore(root).put(rec)
        store = reader.TuningStore(root)
        assert store.verify() == {rec.key: True}
        (entry,) = store.entries()
        assert entry["kernel"] == "paged_attention"
        assert entry["device_kind"] == "NVIDIA H100 80GB HBM3"
        got = store.get(rec.key)
        assert got.to_dict() == rec.to_dict()
        assert [r.key for r in store.records()] == [rec.key]
    # the payloads are the same bytes
    blobs = [open(os.path.join(d, CONFIG_FILE), "rb").read()
             for name in ("paddle_tpu_tuning", "paddle_tpu_torch_tuning")
             for d in _entry_dirs(str(tmp_path / name))]
    assert blobs[0] == blobs[1]
    metas = [json.load(open(os.path.join(d, META_FILE)))
             for name in ("paddle_tpu_tuning", "paddle_tpu_torch_tuning")
             for d in _entry_dirs(str(tmp_path / name))]
    assert sorted(metas[0]) == sorted(metas[1])


def test_store_roundtrip_and_first_publisher_wins(store_dir):
    store = tuning.TuningStore(store_dir)
    rec = _publish(store, "fused_ce", TINY_CE, {"chunk_cap": 1024})
    assert store.get(rec.key).config == {"chunk_cap": 1024}
    loser = TunedRecord(rec.kernel, rec.version, rec.device_kind,
                        rec.dtype, rec.bucket, {"chunk_cap": 8192})
    assert loser.key == rec.key and not store.put(loser)
    assert store.get(rec.key).config == {"chunk_cap": 1024}
    assert store.entries()[0]["hits"] >= 2


@pytest.mark.parametrize("mutate", ["truncate", "flip", "meta",
                                    "missing", "format"])
def test_corruption_corpus_evicts_never_crashes(store_dir, mutate):
    store = tuning.TuningStore(store_dir)
    rec = _publish(store, "fused_ce", TINY_CE, {"chunk_cap": 1024})
    (d,) = _entry_dirs(store_dir)
    cfg_p = os.path.join(d, CONFIG_FILE)
    if mutate == "truncate":
        with open(cfg_p, "r+b") as f:
            f.truncate(os.path.getsize(cfg_p) // 2)
    elif mutate == "flip":
        blob = bytearray(open(cfg_p, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        open(cfg_p, "wb").write(bytes(blob))
    elif mutate == "meta":
        open(os.path.join(d, META_FILE), "w").write("{not json")
    elif mutate == "missing":
        os.unlink(cfg_p)
    else:
        meta = json.load(open(os.path.join(d, META_FILE)))
        meta["store_format"] = 999
        json.dump(meta, open(os.path.join(d, META_FILE), "w"))
    assert store.get(rec.key) is None
    assert not os.path.isdir(d)
    assert tuning.lookup("fused_ce", TINY_CE, device="cpu") == \
        {"chunk_cap": 4096}


def test_version_skew_is_a_miss_and_gc_runs_lru(store_dir):
    store = tuning.TuningStore(store_dir)
    _publish(store, "fused_ce", TINY_CE, {"chunk_cap": 1024},
             version="stale-kernel-rev")
    assert tuning.lookup("fused_ce", TINY_CE, device="cpu") == \
        {"chunk_cap": 4096}
    assert len(store.entries()) == 1
    assert store.clear() == 1
    a = _publish(store, "fused_ce", TINY_CE, {"chunk_cap": 1024})
    b = _publish(store, "fused_ce", dict(TINY_CE, n_tokens=128),
                 {"chunk_cap": 2048})
    store.get(b.key)  # b is hotter
    evicted = store.gc(max_bytes=store.total_bytes() // 2)
    assert a.key in evicted and b.key not in evicted
    assert store.gc(0) == [b.key]
    # verify reports without evicting
    c = _publish(store, "fused_ce", TINY_CE, {"chunk_cap": 1024})
    (d,) = _entry_dirs(store_dir)
    open(os.path.join(d, CONFIG_FILE), "ab").write(b"x")
    assert store.verify() == {c.key: False} and os.path.isdir(d)


def test_compile_cache_store_is_the_jax_packages(tmp_path):
    from paddle_tpu.compile_cache.store import CacheStore as JCacheStore
    from paddle_tpu_torch.compile_cache import CacheStore

    for writer, reader in ((JCacheStore, CacheStore),
                           (CacheStore, JCacheStore)):
        root = str(tmp_path / writer.__module__.split(".")[0])
        assert writer(root).put("ab" * 32, "module text", b"\x00\x01",
                                meta={"env": {"k": 1}, "kind": "step"})
        entry = reader(root).get("ab" * 32, env={"k": 1})
        assert entry.read_module() == "module text"
        assert entry.read_executable() == b"\x00\x01"
        assert reader(root).verify() == {"ab" * 32: True}
        assert reader(root).get("ab" * 32, env={"k": 2}) is None  # skew
        assert reader(root).entries() == []


# --------------------------------------------------------------- lookup


def test_lookup_defaults_without_store_then_one_dict_lookup(no_store):
    assert tuning.lookup("fused_ce", TINY_CE, device="cpu") == \
        {"chunk_cap": 4096}
    m = tuning.tuning_metrics()
    assert m["defaults"] == 1 and m["store_hits"] == 0
    tuning.lookup("fused_ce", TINY_CE, device="cpu")
    assert tuning.tuning_metrics()["memo_hits"] == 1
    assert tuning.lookup("no_such_kernel", {}) == {}  # never raises
    # the registry mirrors the counts
    from paddle_tpu_torch.obs import metrics as obs_metrics

    fam = obs_metrics.counter("pdtpu_tuning_total", labels=("event",))
    assert fam.labels(event="memo_hits").value >= 1


def test_lookup_resolves_store_then_memo_survives_deletion(store_dir,
                                                           monkeypatch):
    store = tuning.TuningStore(store_dir)
    _publish(store, "fused_ce", TINY_CE, {"chunk_cap": 1024})
    assert tuning.lookup("fused_ce", TINY_CE, device="cpu") == \
        {"chunk_cap": 1024}
    assert tuning.tuning_metrics()["store_hits"] == 1
    shutil.rmtree(store_dir)
    # every later call is a dict lookup: no store read at all
    monkeypatch.setattr(tuning.TuningStore, "get",
                        lambda *a, **k: pytest.fail("store read"))
    for _ in range(3):
        assert tuning.lookup("fused_ce", TINY_CE, device="cpu") == \
            {"chunk_cap": 1024}
    assert tuning.tuning_metrics()["memo_hits"] == 3


def test_lookup_evicts_constraint_violating_stored_config(store_dir):
    store = tuning.TuningStore(store_dir)
    k = tuning.get_tunable("paged_attention")
    # a decode problem that changes the query-tile knob: a writer with
    # other constraint semantics could have stored it
    rec = TunedRecord("paged_attention", k.version, "cpu", "float32",
                      k.bucket_key(DECODE),
                      {"split_waves": 1, "tile_waves": 0})
    assert store.put(rec)
    assert tuning.lookup("paged_attention", DECODE, device="cpu") == \
        k.defaults
    assert tuning.tuning_metrics()["rejected"] == 1
    assert store.get(rec.key, touch=False) is None


# ---------------------------------------------------------------- sweep


def test_sweep_publishes_winner_and_reuses_without_remeasuring(store_dir):
    from paddle_tpu_torch import profiler

    store = tuning.TuningStore(store_dir)
    profiler.reset_profiler()
    rec = tuning.sweep("fused_ce", TINY_CE, iters=2, samples=2,
                       store=store, device="cpu")
    assert rec.config in [{"chunk_cap": c}
                          for c in (1024, 2048, 4096, 8192)]
    assert rec.best_ms > 0 and rec.device_kind == "cpu"
    assert len(rec.measurements) == 4
    assert not any("error" in m for m in rec.measurements)
    counts = profiler.event_counts()
    measured = tuning.tuning_metrics()["candidates_measured"]
    assert counts["tuning/sweep"] == 1
    assert counts["tuning/sample"] >= 2 * measured - 3  # pruned: 1 each
    assert store.get(rec.key, touch=False) is not None
    again = tuning.sweep("fused_ce", TINY_CE, iters=2, samples=1,
                         store=store, device="cpu")
    assert again.config == rec.config
    m = tuning.tuning_metrics()
    assert m["candidates_measured"] == measured and m["sweep_reused"] == 1
    # the winner resolves for the same problem
    assert tuning.lookup("fused_ce", TINY_CE, device="cpu") == rec.config


def test_sweep_early_pruning_skips_slow_candidates(no_store):
    import time as _time

    from paddle_tpu_torch.tuning import registry

    calls = []

    def build_measure(problem, config, dtype, iters, device):
        def run():
            calls.append(config["delay_ms"])
            _time.sleep(config["delay_ms"] / 1e3)
        return run

    tuning.register_tunable(tuning.TunableKernel(
        "_toy_prune", space={"delay_ms": (1, 200)},
        defaults={"delay_ms": 1}, version="1",
        build_measure=build_measure))
    try:
        rec = tuning.sweep("_toy_prune", {}, iters=1, samples=3,
                           prune_factor=4.0, store=None, publish=False,
                           device="cpu")
    finally:
        registry._REGISTRY.pop("_toy_prune")
    assert rec.config == {"delay_ms": 1}
    assert calls.count(1) == 4 and calls.count(200) == 2
    pruned = [m for m in rec.measurements if m.get("pruned")]
    assert len(pruned) == 1 and pruned[0]["config"] == {"delay_ms": 200}


def test_sweep_retimes_every_candidate_when_one_is_host_paced(
        no_store, monkeypatch):
    """One election, one yardstick: a candidate that cannot be queued
    behind the spin sends every candidate back to be timed host-paced."""
    from paddle_tpu_torch.tuning import registry

    # the package's ``sweep`` is the function: take the module itself
    sweep_mod = sys.modules["paddle_tpu_torch.tuning.sweep"]
    timed = []

    def build_measure(problem, config, dtype, iters, device):
        return config["n"]

    def fake_measure(run, iters, samples=3, prune_above_ms=None,
                     device=None, host_paced=False):
        timed.append((run, host_paced))
        if run == 2 and not host_paced:
            raise sweep_mod.HostPaced()
        return {1: 5.0, 2: 3.0, 3: 4.0}[run] + (10.0 * host_paced)

    monkeypatch.setattr(sweep_mod, "measure_min_ms", fake_measure)
    tuning.register_tunable(tuning.TunableKernel(
        "_toy_paced", space={"n": (1, 2, 3)}, defaults={"n": 1},
        version="1", build_measure=build_measure))
    try:
        rec = tuning.sweep("_toy_paced", {}, store=None, publish=False,
                           device="cpu")
    finally:
        registry._REGISTRY.pop("_toy_paced")
    # the first pass stops at the paced candidate; all three are retimed
    assert timed == [(1, False), (2, False), (1, True), (2, True),
                     (3, True)]
    assert [m["ms"] for m in rec.measurements] == [15.0, 13.0, 14.0]
    assert rec.config == {"n": 2} and rec.best_ms == 13.0
    assert {m["timing"] for m in rec.measurements} == {"host"}


def test_memo_hits_reach_the_registry_when_it_is_read(no_store):
    from paddle_tpu_torch.obs import metrics as obs_metrics

    for _ in range(4):
        tuning.lookup("fused_ce", TINY_CE, device="cpu")
    snap = obs_metrics.snapshot()["pdtpu_tuning_total"]["values"]
    hits = {v["labels"]["event"]: v["value"] for v in snap}
    assert hits["memo_hits"] >= 3
    assert tuning.tuning_metrics()["memo_hits"] == 3


def test_memo_hits_are_counted_exactly_across_threads(no_store):
    import threading

    tuning.lookup("fused_ce", TINY_CE, device="cpu")
    tuning.reset_tuning_metrics()
    n_threads, calls = 8, 2000

    def work():
        for _ in range(calls):
            tuning.lookup("fused_ce", TINY_CE, device="cpu")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    m = tuning.tuning_metrics()
    assert m["memo_hits"] == m["lookups"] == n_threads * calls


def test_paged_measure_serves_ragged_windows():
    from paddle_tpu_torch.tuning.kernels import decode_lengths

    lengths = decode_lengths(16, 1, 512)
    assert lengths == sorted(set(lengths)) and len(lengths) == 16
    # ragged, mostly short: a quarter of the window on average
    assert lengths[0] == 2 and lengths[-1] == 388
    assert 120 <= sum(lengths) / 16 <= 135
    assert all(0 <= n <= 512 - 4 for n in decode_lengths(8, 4, 512))
    assert decode_lengths(1, 1, 8) == [1]


def test_sweep_needs_a_card_unless_the_cpu_is_asked_for(no_store):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is that card")
    with pytest.raises(EnforceError, match="no CUDA device"):
        tuning.sweep("fused_ce", TINY_CE)


_WORKER = r"""
import json, sys
import torch
torch.set_num_threads(1)
from paddle_tpu_torch import tuning
from paddle_tpu_torch.core import flags
flags.set_flags({"tuning_cache_dir": sys.argv[1]})
problems = {"fused_ce": {"n_tokens": 64, "d_model": 16, "vocab": 512},
            "fused_optimizer_update": {"numel": 4096, "n_accs": 2,
                                       "n_shared": 2},
            "paged_attention": {"batch": 4, "q_tokens": 1, "window": 32,
                                "block_size": 8, "heads": 2,
                                "head_dim": 16, "kv_dtype": "f32"}}
configs = {}
for name, problem in problems.items():
    if sys.argv[2] == "sweep":
        tuning.sweep(name, problem, iters=2, samples=1, device="cpu")
    configs[name] = tuning.lookup(name, problem, device="cpu")
print(json.dumps({"metrics": tuning.tuning_metrics(), "configs": configs}))
"""


def test_cross_process_warm_start_zero_resweeps(tmp_path):
    store_dir = str(tmp_path / "store")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO

    def run(mode):
        proc = subprocess.run([sys.executable, "-c", _WORKER, store_dir,
                               mode], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return json.loads(proc.stdout.strip().splitlines()[-1])

    cold = run("sweep")
    assert cold["metrics"]["sweeps"] == 3
    warm = run("sweep")  # a second process sweeping: every key reused
    assert warm["metrics"]["sweeps"] == 0
    assert warm["metrics"]["sweep_reused"] == 3
    assert warm["metrics"]["candidates_measured"] == 0
    assert warm["metrics"]["store_hits"] == 3
    assert warm["metrics"]["defaults"] == 0
    assert warm["configs"] == cold["configs"]


# ------------------------------------------------------- the consumers


class _Plan(NamedTuple):
    route: str
    n_splits: int
    split_len: int


def _parent_plan(B, T, H, Dk, Dv, mb, bs, q_dtype, quant) -> _Plan:
    """plan_route as it was before the knobs became tunable (fixed
    targets of 8 and 4 waves of 132 SMs)."""
    item = 1 if quant else torch.empty((), dtype=q_dtype).element_size()
    aligned = mb <= 2048 and all(
        d % 8 == 0 and d <= 128 and (d * item) % 16 == 0 for d in (Dk, Dv))
    S = mb * bs
    if not aligned:
        return _Plan("generic", 1, S)
    if T > 8:
        mma = q_dtype == torch.bfloat16 and Dk % 16 == 0 and Dv % 16 == 0
        route = "tile_mma" if mma else "tile"
        rows = 128 if mma and T > 64 else 64
        blocks, tile = B * H * -(-T // rows), 64
        target = 4 * 132 if blocks < 2 * 132 else 1
    else:
        route, blocks, target, tile = "split", B * H, 8 * 132, 32
    want = -(-target // blocks)
    tiles = -(-S // tile)
    split_len = max(1, tiles // want) * tile
    n_splits = -(-S // split_len)
    if n_splits == 1 and route != "split":
        return _Plan(route, 1, S)
    return _Plan(route, n_splits, split_len)


def test_plan_route_without_a_store_plans_as_before(no_store):
    n = 0
    for B in (1, 2, 4, 16, 64):
        for T in (1, 4, 9, 64, 65, 512):
            for H, D, mb, bs in ((8, 64, 32, 16), (2, 16, 4, 8),
                                 (3, 12, 4, 6), (12, 128, 128, 16)):
                for dt, quant in ((torch.float32, False),
                                  (torch.bfloat16, False),
                                  (torch.float32, True)):
                    args = (B, T, H, D, D, mb, bs, dt, quant)
                    got = pa.plan_route(*args, device="cpu")
                    assert _Plan(*got[:3]) == _parent_plan(*args), args
                    n += 1
    assert n == 360


def test_plan_route_reads_the_tuned_knobs(store_dir):
    store = tuning.TuningStore(store_dir)
    args = (16, 1, 8, 64, 64, 32, 16, torch.float32, False)
    problem = pa.tuning_problem(16, 1, 8, 64, 32, 16, False)
    assert pa.plan_route(*args, device="cpu").n_splits == 16
    tuning.clear_memo()
    _publish(store, "paged_attention", problem,
             {"split_waves": 1, "tile_waves": pa.DEFAULT_TILE_WAVES})
    plan = pa.plan_route(*args, device="cpu")
    # one wave over 128 (head, sequence) blocks: 2 splits of 256 keys
    assert (plan.route, plan.n_splits, plan.split_len) == ("split", 2, 256)
    assert pa.plan_route(*args, config={"split_waves": 4}).n_splits == 6
    # tile_waves=0: the query-tile route never splits its keys
    one = pa.plan_route(1, 64, 8, 64, 64, 32, 16, torch.float32, False,
                        config={"tile_waves": 0})
    assert (one.route, one.n_splits, one.scratch) == ("tile", 1, ((), ()))
    # on the CPU the wrapper is the plain version, whatever the knobs
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(2, 1, 2, 16).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.randn(9, 8, 2, 16).astype(np.float32))
              for _ in range(2))
    tables = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    cached = torch.tensor([20, 31], dtype=torch.int32)
    want = pa.plain_window_attention(q, kp, vp, tables, cached)
    for cfg in ({"split_waves": 1}, None):
        got = pa.paged_window_attention(q, kp, vp, tables, cached,
                                        config=cfg)
        assert torch.equal(got, want)


def test_fused_update_knob_and_flash_built_tile(store_dir):
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops.fused_optimizer import (fused_flat_update,
                                                      tuning_problem)

    gen = torch.Generator().manual_seed(0)
    p0, g = torch.randn(300, generator=gen), torch.randn(300, generator=gen)
    outs = []
    for cap in (None, 2, 32):  # the grid changes no arithmetic
        p = p0.clone()
        accs = [torch.zeros(300), torch.zeros(300)]
        shared = [torch.tensor(0.9), torch.tensor(0.999)]
        fused_flat_update("adam", p, g, torch.tensor(1e-3), accs, shared,
                          True, (1.0, 0.9, 0.999, 1e-8), blocks_per_sm=cap)
        outs.append(p)
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert tuning_problem(p0, accs, shared) == {"numel": 300, "n_accs": 2,
                                                "n_shared": 2}
    # the flash tunable's one point is the built tile; a stored tile the
    # library was not built with never resolves
    store = tuning.TuningStore(store_dir)
    k = tuning.get_tunable("flash_attention")
    problem = {"seq_q": 8, "seq_k": 8, "head_dim": 64, "causal": False}
    assert tuning.lookup("flash_attention", problem, device="cpu") == \
        {"tile": fa.BUILT_TILE}
    assert store.put(TunedRecord("flash_attention", k.version, "cpu",
                                 "float32", k.bucket_key(problem),
                                 {"tile": 128}))
    tuning.clear_memo()
    assert tuning.lookup("flash_attention", problem, device="cpu") == \
        {"tile": fa.BUILT_TILE}
    assert tuning.tuning_metrics()["rejected"] == 1


# ----------------------------------------- stamps, manifests, serving


def _ce_program():
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = 11
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[16], dtype="float32")
        y = tfluid.layers.data(name="y", shape=[1], dtype="int64")
        h = tfluid.layers.fc(x, size=16, act="relu")
        loss, _ = tfluid.layers.fused_linear_softmax_ce(h, y, size=512)
        avg = tfluid.layers.reduce_mean(loss)
    return main, startup, avg


def test_graph_key_stamp_absent_untuned_present_when_tuned(store_dir):
    from paddle_tpu_torch.executor import _tuning_key

    main, _, _ = _ce_program()
    assert _tuning_key(main) == () and tuning.program_stamp(main) == ""
    store = tuning.TuningStore(store_dir)
    _publish(store, "fused_optimizer_update",
             {"numel": 4096, "n_accs": 2, "n_shared": 2},
             {"blocks_per_sm": 4})
    tuning.clear_memo()
    assert _tuning_key(main) == ()  # an unrelated kernel's entry
    _publish(store, "fused_ce", TINY_CE, {"chunk_cap": 1024})
    tuning.clear_memo()
    stamp = tuning.program_stamp(main)
    assert stamp and _tuning_key(main) == (("tuning", stamp),)
    # a sweep later in the process changes the stamp (a captured graph
    # keyed by the old one is never replayed with other configs)
    tuning.sweep("fused_ce", dict(TINY_CE, n_tokens=2), iters=1,
                 samples=1, device="cpu")
    assert tuning.program_stamp(main) not in ("", stamp)


def test_manifest_embeds_and_seeds_tuned_configs(tmp_path, store_dir):
    store = tuning.TuningStore(store_dir)
    rec = _publish(store, "fused_ce", TINY_CE, {"chunk_cap": 1024})
    main, startup, avg = _ce_program()
    model_dir = str(tmp_path / "model")
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    tfluid.io.save_inference_model(model_dir, ["x", "y"], [avg], exe,
                                   main_program=main, scope=scope,
                                   export_stablehlo=False)
    manifest = json.load(open(os.path.join(model_dir, "__model__.json")))
    assert [r["config"] for r in manifest["tuned_configs"]] == \
        [{"chunk_cap": 1024}]
    # a FRESH store and memo (the deployment host): loading seeds both
    fresh = str(tmp_path / "fresh_store")
    flags.set_flags({"tuning_cache_dir": fresh})
    tuning.clear_memo()
    tfluid.io.load_inference_model(model_dir, exe, scope=tfluid.Scope(),
                                   program=main)
    assert tuning.tuning_metrics()["seeded"] == 1
    assert tuning.lookup("fused_ce", TINY_CE, device="cpu") == \
        {"chunk_cap": 1024}
    assert tuning.TuningStore(fresh).get(rec.key, touch=False) is not None
    # without any store, the memo alone serves the seeded config
    flags.set_flags({"tuning_cache_dir": ""})
    tuning.clear_memo()
    tfluid.io.load_inference_model(model_dir, exe, scope=tfluid.Scope(),
                                   program=main)
    assert tuning.lookup("fused_ce", TINY_CE, device="cpu") == \
        {"chunk_cap": 1024}


def test_untuned_manifest_stays_as_it_was(tmp_path, store_dir):
    main, startup, avg = _ce_program()
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    exe.run(startup, scope=scope)

    def save(name):
        d = str(tmp_path / name)
        tfluid.io.save_inference_model(d, ["x", "y"], [avg], exe,
                                       main_program=main, scope=scope,
                                       export_stablehlo=False)
        return open(os.path.join(d, "__model__.json"), "rb").read()

    flags.set_flags({"tuning_cache_dir": ""})
    bare = save("bare")
    assert b"tuned_configs" not in bare
    # a store holding only an unrelated kernel's entry changes nothing
    flags.set_flags({"tuning_cache_dir": store_dir})
    _publish(tuning.TuningStore(store_dir), "paged_attention", DECODE,
             {"split_waves": 2, "tile_waves": 4})
    assert save("unrelated") == bare


def test_serving_warm_up_prefetches_store(store_dir):
    store = tuning.TuningStore(store_dir)
    # keyed at the shape the bucket-2 run looks up: 2 rows of the head
    _publish(store, "fused_ce", dict(TINY_CE, n_tokens=2),
             {"chunk_cap": 1024})
    main, startup, avg = _ce_program()
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    engine = tfluid.serving.BucketedEngine.from_program(
        main, ["x", "y"], [avg], scope=scope, place=CPU,
        config=tfluid.serving.ServingConfig(buckets=[2]))
    before = tuning.tuning_metrics()
    engine.warm_up()
    m = tuning.tuning_metrics()
    assert m["prefetched"] == before["prefetched"] + 1
    # the bucket run resolved the TUNED config from the prefetched memo
    assert m["store_hits"] == before["store_hits"]
    assert m["memo_hits"] > before["memo_hits"]
    assert m["defaults"] == before["defaults"]


# ---------------------------------------------------- decode autotune


@pytest.fixture(scope="module")
def lm():
    j_main, j_scope, j_logits = jax_lm()
    t_main, _, t_logits = torch_lm()
    t_scope = carried_scope(j_main, j_scope, t_main)
    return j_main, j_scope, j_logits, t_main, t_scope, t_logits


DECODE_CONFIGS = {
    "default": {},
    "speculative": {"speculate_k": 3},
    "prefix": {"cache_kw": {"prefix_cache": True},
               "suffix_buckets": (1, 4, 16),
               "prefill_batch_buckets": (1, 2)},
    "int8": {"cache_kw": {"kv_dtype": "int8"}, "decode_buckets": (1, 3)},
}


def _config(pkg, cache_kw=(), **kw):
    kw.setdefault("decode_buckets", (1, 2, 4, 8))
    return pkg.DecodingConfig(cache=pkg.CacheConfig(**CACHE,
                                                    **dict(cache_kw)),
                              **kw)


@pytest.mark.parametrize("name", sorted(DECODE_CONFIGS))
def test_decode_tuning_problems_match_jax_engine(lm, name):
    j_main, j_scope, j_logits, t_main, t_scope, t_logits = lm
    kw = DECODE_CONFIGS[name]
    j = jdec.DecodeEngine(j_main, "tokens", j_logits.name, scope=j_scope,
                          config=_config(jdec, **kw))
    t = tdec.DecodeEngine(t_main, "tokens", t_logits.name, scope=t_scope,
                          config=_config(tdec, **kw), place=CPU)
    assert t.decode_tuning_problems() == j.decode_tuning_problems()
    assert t.decode_tuning_dtype() == "float32"


def _requests():
    rng = np.random.RandomState(5)
    return [(rng.randint(0, VOCAB, size=rng.randint(1, 20)).tolist(),
             int(rng.randint(2, 9))) for _ in range(6)]


def test_autotuned_engine_serves_the_jax_streams(lm, store_dir):
    j_main, j_scope, j_logits, t_main, t_scope, t_logits = lm
    js = jdec.serve_decoding(j_main, "tokens", j_logits.name,
                             scope=j_scope, config=_config(jdec))
    try:
        want = [js.generate(p, max_new_tokens=m, timeout=120)
                for p, m in _requests()]
    finally:
        js.shutdown(drain=True, timeout=60)
    s = tdec.serve_decoding(t_main, "tokens", t_logits.name, scope=t_scope,
                            config=_config(tdec, autotune=True), place=CPU)
    try:
        got = [s.generate(p, max_new_tokens=m, timeout=120)
               for p, m in _requests()]
    finally:
        s.shutdown(drain=True, timeout=60)
    assert got == want
    m = tuning.tuning_metrics()
    assert m["sweeps"] == 4  # one per decode bucket
    assert m["prefetched"] >= 4
    store = tuning.TuningStore(store_dir)
    recs = store.records()
    assert sorted(r.bucket["batch"] for r in recs) == [1, 2, 4, 8]
    assert all(r.kernel == "paged_attention" and r.device_kind == "cpu"
               and not any("error" in x for x in r.measurements)
               for r in recs)
    # a second engine on the same store warms up without measuring
    tuning.clear_memo()
    e2 = tdec.DecodeEngine(t_main, "tokens", t_logits.name, scope=t_scope,
                           config=_config(tdec, autotune=True), place=CPU)
    e2.warm_up()
    m2 = tuning.tuning_metrics()
    assert m2["sweeps"] == 4 and m2["sweep_reused"] == 4
    # the decode artifact carries the pair's tuned configs
    d = os.path.join(os.path.dirname(store_dir), "decode_model")
    tfluid.io.save_decode_model(d, "tokens", t_logits, tfluid.Executor(CPU),
                                main_program=t_main, scope=t_scope,
                                cache_config=tdec.CacheConfig(**CACHE))
    manifest = json.load(open(os.path.join(d, "__model__.json")))
    assert sorted(r["bucket"]["batch"] for r in manifest["tuned_configs"]
                  if r["kernel"] == "paged_attention") == [1, 2, 4, 8]


# ------------------------------------------------------------------ CLI


def test_cli_smoke(store_dir, capsys):
    from paddle_tpu_torch.tools import tuning as cli

    assert cli.main(["sweep", "--kernel", "fused_ce", "--problem",
                     "n_tokens=64,d_model=16,vocab=512", "--iters", "2",
                     "--samples", "1", "--subset", "chunk_cap=1024|4096",
                     "--device", "cpu", "--dir", store_dir]) == 0
    assert cli.main(["ls", "--dir", store_dir]) == 0
    assert cli.main(["verify", "--dir", store_dir]) == 0
    out = capsys.readouterr().out
    assert "fused_ce" in out and "1 entries, 0 bad" in out
    (d,) = _entry_dirs(store_dir)
    open(os.path.join(d, CONFIG_FILE), "ab").write(b"x")
    assert cli.main(["verify", "--dir", store_dir]) == 1
    assert cli.main(["gc", "--max-bytes", "0", "--dir", store_dir]) == 0
    assert cli.main(["clear", "--dir", store_dir]) == 0
    assert cli.main(["ls", "--dir", store_dir]) == 0
    assert "0 entries" in capsys.readouterr().out
    # the flag resolves the store; with none set it is a usage error
    assert cli.main(["ls"]) == 0
    flags.set_flags({"tuning_cache_dir": ""})
    with pytest.raises(SystemExit) as exc:
        cli.main(["ls"])
    assert exc.value.code == 2
    with pytest.raises(SystemExit):
        cli.main(["sweep", "--kernel", "all", "--problem", "n_tokens=1",
                  "--dir", store_dir])
