"""paddle_tpu_torch.compile_cache held to paddle_tpu's on the CPU.

* **Fingerprints.** The same MLP, built in both packages, has the same
  canonical ids and the same desc once each op's function is taken out
  (the port's ``backward`` op carries two attrs of its own by design:
  ``_error_clips`` and ``_sparse_sites``); over the pairs of
  ``tests/test_compile_cache.py`` (alpha-renamed, an op attr changed, a
  feed dtype or shape changed, the env or the config changed) the
  port's fingerprints are equal or unequal exactly where the JAX
  package's are.
* **Exports.** ``save_inference_model`` and ``save_trainable_program``
  through a ``compile_cache_dir``: cold then warm in one process, and a
  warm start in a second process, count only hits and write ``.pt2``
  files sha256-equal to the cold ones; permuted feed orders do not
  share an entry; with the flag unset the files and the manifest are
  those of a cached export; a corrupted payload and a truncated meta
  count ``bad_entry`` and are exported and published again; ``gc``
  evicts the least recently hit entry first.
* **The store across packages.** ``paddle_tpu.compile_cache.CacheStore``
  verifies every port-written entry and the port's store every
  JAX-written one; ``tools.cache`` exits as the JAX CLI does on the
  same directories.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu.compile_cache import CacheStore as JCacheStore
from paddle_tpu.compile_cache import CompilationUnit as JCompilationUnit
from paddle_tpu.core import flags as jflags
from paddle_tpu.core import unique_name as j_unique_name
from paddle_tpu_torch.compile_cache import (CacheStore, CompilationUnit,
                                            cache_metrics,
                                            environment_signature,
                                            recent_fingerprints,
                                            reset_cache_metrics)
from paddle_tpu_torch.compile_cache import runtime
from paddle_tpu_torch.compile_cache.store import EXECUTABLE_FILE, META_FILE
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.inference import NativeConfig, create_paddle_predictor

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = fluid.CPUPlace()
BUCKETS = [1, 4]

# the program both the test and its second process build (exec'd in
# each): an MLP classifier with seeded weights
_BUILD = r'''
def build_mlp(fluid, seed=0):
    import numpy as np
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        h = fluid.layers.fc(input=x, size=8, act="relu")
        out = fluid.layers.fc(input=h, size=3, act="softmax")
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(seed)
    fluid.params_from_numpy(
        {p.name: rng.randn(*p.shape).astype("float32")
         for p in main.all_parameters()}, scope, fluid.CPUPlace(),
        program=main)
    return main, out, scope, exe
'''
exec(_BUILD)

_CHILD = _BUILD + r'''
import hashlib, json, os, sys
import torch
torch.set_num_threads(1)
import paddle_tpu_torch as fluid
from paddle_tpu_torch.compile_cache import cache_metrics
fluid.set_flags({"compile_cache_dir": sys.argv[1]})
main, out, scope, exe = build_mlp(fluid)
fluid.io.save_inference_model(sys.argv[2], ["x"], [out], exe,
                              main_program=main, scope=scope,
                              export_batch_sizes=[1, 4])
print(json.dumps(cache_metrics()))
'''


@pytest.fixture
def cache_dir(tmp_path):
    d = str(tmp_path / "compile_cache")
    reset_cache_metrics()
    flags.set_flags({"compile_cache_dir": d})
    try:
        yield d
    finally:
        flags.set_flags({"compile_cache_dir": ""})


def _export(d, feeds=("x",), built=None):
    main, out, scope, exe = built or build_mlp(fluid)
    fluid.io.save_inference_model(d, list(feeds), [out], exe,
                                  main_program=main, scope=scope,
                                  export_batch_sizes=BUCKETS)
    with open(os.path.join(d, "__model__.json")) as f:
        return json.load(f)


def _shas(d):
    return {f: hashlib.sha256(open(os.path.join(d, f), "rb").read())
            .hexdigest() for f in sorted(os.listdir(d))
            if f.endswith(".pt2")}


def _predict(d, rows):
    pred = create_paddle_predictor(NativeConfig(model_dir=d,
                                                use_gpu=False))
    (r,) = pred.run({"x": rows})
    return np.asarray(r.data)


def _rows(n, seed=1):
    return np.random.RandomState(seed).randn(n, 13).astype("float32")


# ------------------------------------------------------------ fingerprints


def _mlp(pkg, train=True):
    guard = (j_unique_name.guard if pkg is jfluid
             else fluid.unique_name.guard)
    main, startup = pkg.Program(), pkg.Program()
    with guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[13], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        h = pkg.layers.fc(input=x, size=8, act="relu")
        pred = pkg.layers.fc(input=h, size=1, act=None)
        avg = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        if train:
            pkg.optimizer.SGD(learning_rate=0.05).minimize(avg)
    return main, avg


def _scale(pkg, factor):
    p = pkg.Program()
    with pkg.program_guard(p, pkg.Program()):
        x = pkg.layers.data(name="x", shape=[4], dtype="float32")
        out = pkg.layers.scale(x, scale=factor)
    return p, out


def _no_fn(desc):
    d = json.loads(json.dumps(desc))
    for block in d["blocks"]:
        for op in block:
            op.pop("fn")
    return d


# attrs only the port's ops carry (the backward op's clip and sparse
# bookkeeping, which the JAX package keeps in its closure)
PORT_ONLY_ATTRS = {"backward": {"_error_clips", "_sparse_sites"}}


@pytest.mark.parametrize("train", [False, True])
def test_units_have_the_jax_canon_and_desc(train):
    jm, ja = _mlp(jfluid, train)
    tm, ta = _mlp(fluid, train)
    ju = JCompilationUnit(jm, ("x", "y"), (ja.name,))
    tu = CompilationUnit(tm, ("x", "y"), (ta.name,))
    assert tu.canon == ju.canon
    jd, td = _no_fn(ju.desc), _no_fn(tu.desc)
    for op in td["blocks"][0]:
        drop = PORT_ONLY_ATTRS.get(op["type"], set())
        op["attrs"] = [a for a in op["attrs"] if a[0] not in drop]
    assert td == jd


def _pairs(pkg):
    """{pair name: (fingerprint a, fingerprint b)} over the JAX test's
    pairs, in ``pkg``."""
    guard = (j_unique_name.guard if pkg is jfluid
             else fluid.unique_name.guard)
    out = {}
    # alpha-renamed: two builds, the second after the first's names
    m1, a1 = _mlp(pkg)
    with guard():
        with pkg.program_guard(pkg.Program(), pkg.Program()):
            # shifts the fc counters of the next build
            pkg.layers.fc(input=pkg.layers.data(name="z", shape=[2],
                                                dtype="float32"), size=2)
        m2, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(m2, startup):
            x = pkg.layers.data(name="x", shape=[13], dtype="float32")
            y = pkg.layers.data(name="y", shape=[1], dtype="float32")
            h = pkg.layers.fc(input=x, size=8, act="relu")
            pred = pkg.layers.fc(input=h, size=1, act=None)
            a2 = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
            pkg.optimizer.SGD(learning_rate=0.05).minimize(a2)
    unit = JCompilationUnit if pkg is jfluid else CompilationUnit
    u1 = unit(m1, ("x", "y"), (a1.name,))
    u2 = unit(m2, ("x", "y"), (a2.name,))
    assert m1.all_parameters()[0].name != m2.all_parameters()[0].name
    fa = {"x": ((16, 13), "float32"), "y": ((16, 1), "float32")}
    env = {"v": "x"}
    cfg = {"kind": "step"}
    out["alpha_renamed"] = (
        u1.fingerprint(fa, {m1.all_parameters()[0].name:
                            ((13, 8), "float32")}, cfg, env=env),
        u2.fingerprint(fa, {m2.all_parameters()[0].name:
                            ((13, 8), "float32")}, cfg, env=env))
    p2, o2 = _scale(pkg, 2.0)
    p3, o3 = _scale(pkg, 3.0)
    s2 = unit(p2, ("x",), (o2.name,))
    s3 = unit(p3, ("x",), (o3.name,))
    fa = {"x": ((2, 4), "float32")}
    base = s2.fingerprint(fa, {}, {}, env=env)
    out["op_attr"] = (base, s3.fingerprint(fa, {}, {}, env=env))
    out["feed_dtype"] = (base, s2.fingerprint({"x": ((2, 4), "float64")},
                                              {}, {}, env=env))
    out["feed_shape"] = (base, s2.fingerprint({"x": ((3, 4), "float32")},
                                              {}, {}, env=env))
    out["env"] = (base, s2.fingerprint(fa, {}, {}, env={"v": "y"}))
    out["config"] = (s2.fingerprint(fa, {}, {"donate": True}, env=env),
                     s2.fingerprint(fa, {}, {"donate": False}, env=env))
    out["same"] = (base, s2.fingerprint(fa, {}, {}, env=env))
    return out


def test_fingerprints_agree_with_the_jax_package_pair_by_pair():
    jp, tp = _pairs(jfluid), _pairs(fluid)
    want = {k: a == b for k, (a, b) in jp.items()}
    got = {k: a == b for k, (a, b) in tp.items()}
    assert got == want
    assert want == {"alpha_renamed": True, "op_attr": False,
                    "feed_dtype": False, "feed_shape": False,
                    "env": False, "config": False, "same": True}


def test_environment_signature_pins_torch_and_the_platform():
    env = environment_signature()
    assert env["torch"] == torch.__version__
    assert env["cuda"] == (torch.version.cuda or "")
    assert {"python", "platform", "platform_version", "device_kind",
            "num_devices"} <= set(env)
    assert "jax" not in env and "jaxlib" not in env
    if not torch.cuda.is_available():
        assert (env["platform"], env["device_kind"]) == ("cpu", "cpu")


# ----------------------------------------------------------------- exports


def test_cold_then_warm_export_in_one_process(cache_dir, tmp_path):
    cold = _export(str(tmp_path / "cold"))
    m = cache_metrics()
    assert (m["miss"], m["publish"], m["hit"]) == (2, 2, 0)
    assert m["bytes_written"] > 0
    assert CacheStore(cache_dir).stats()["entries"] == 2
    reset_cache_metrics()
    warm = _export(str(tmp_path / "warm"))
    m = cache_metrics()
    assert (m["hit"], m["miss"], m["publish"], m["bad_entry"]) == \
        (2, 0, 0, 0)
    assert m["bytes_read"] > 0
    assert warm == cold
    assert _shas(str(tmp_path / "warm")) == _shas(str(tmp_path / "cold"))
    rows = _rows(4)
    assert np.array_equal(_predict(str(tmp_path / "warm"), rows),
                          _predict(str(tmp_path / "cold"), rows))
    kinds = [r["kind"] for r in recent_fingerprints()[-4:]]
    assert kinds == ["export"] * 4
    for e in CacheStore(cache_dir).entries():
        assert e["kind"] == "export" and e["has_executable"]


def test_second_process_counts_only_hits(cache_dir, tmp_path):
    _export(str(tmp_path / "cold"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, cache_dir, str(tmp_path / "child")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    m = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (m["hit"], m["miss"], m["publish"], m["bad_entry"]) == \
        (2, 0, 0, 0)
    assert _shas(str(tmp_path / "child")) == _shas(str(tmp_path / "cold"))


def test_permuted_feed_orders_do_not_share_an_entry(cache_dir, tmp_path):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        a = fluid.layers.data(name="a", shape=[4], dtype="float32")
        b = fluid.layers.data(name="b", shape=[4], dtype="float32")
        out = fluid.layers.elementwise_add(fluid.layers.scale(a, scale=2.0),
                                           b)  # asymmetric in a, b
    scope, exe = fluid.Scope(), fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    for d, feeds in (("ab", ["a", "b"]), ("ba", ["b", "a"])):
        fluid.io.save_inference_model(str(tmp_path / d), feeds, [out], exe,
                                      main_program=main, scope=scope)
    assert cache_metrics()["hit"] == 0
    assert CacheStore(cache_dir).stats()["entries"] == 2
    feed = {"a": np.ones((2, 4), "float32"),
            "b": np.zeros((2, 4), "float32")}
    for d in ("ab", "ba"):
        (r,) = create_paddle_predictor(NativeConfig(
            model_dir=str(tmp_path / d), use_gpu=False)).run(feed)
        assert np.allclose(r.data, 2.0), d


def test_flag_off_writes_what_a_cached_export_writes(tmp_path):
    reset_cache_metrics()
    off = _export(str(tmp_path / "off"))
    assert cache_metrics() == runtime._zero_metrics()
    flags.set_flags({"compile_cache_dir": str(tmp_path / "cc")})
    try:
        on = _export(str(tmp_path / "on"))
    finally:
        flags.set_flags({"compile_cache_dir": ""})
    assert off == on
    assert sorted(os.listdir(tmp_path / "off")) == \
        sorted(os.listdir(tmp_path / "on"))
    rows = _rows(4)
    assert np.array_equal(_predict(str(tmp_path / "off"), rows),
                          _predict(str(tmp_path / "on"), rows))


def _entry_of(cache_dir, bucket_file, model_dir):
    """The store entry whose payload is ``bucket_file`` of
    ``model_dir``."""
    want = open(os.path.join(model_dir, bucket_file), "rb").read()
    store = CacheStore(cache_dir)
    for e in store.entries():
        d = store.entry_dir(e["fingerprint"])
        if open(os.path.join(d, EXECUTABLE_FILE), "rb").read() == want:
            return d
    raise AssertionError("no entry holds %s" % bucket_file)


@pytest.mark.parametrize("damage", ["payload", "truncated_meta"])
def test_a_bad_entry_is_evicted_and_exported_again(cache_dir, tmp_path,
                                                   damage):
    _export(str(tmp_path / "cold"))
    d = _entry_of(cache_dir, "__model__.b4.pt2", str(tmp_path / "cold"))
    if damage == "payload":
        p = os.path.join(d, EXECUTABLE_FILE)
        data = bytearray(open(p, "rb").read())
        data[len(data) // 2] ^= 0xFF
        open(p, "wb").write(bytes(data))
    else:
        p = os.path.join(d, META_FILE)
        text = open(p).read()
        open(p, "w").write(text[:len(text) // 2])
    reset_cache_metrics()
    _export(str(tmp_path / "again"))
    m = cache_metrics()
    assert (m["bad_entry"], m["miss"], m["publish"], m["hit"]) == \
        (1, 1, 1, 1)
    assert all(CacheStore(cache_dir).verify().values())
    # the republished entry is what the export wrote, and a warm export
    # writes it again byte for byte
    again = _shas(str(tmp_path / "again"))
    reset_cache_metrics()
    _export(str(tmp_path / "warm"))
    assert cache_metrics()["hit"] == 2
    assert _shas(str(tmp_path / "warm")) == again
    rows = _rows(4)
    assert np.array_equal(_predict(str(tmp_path / "warm"), rows),
                          _predict(str(tmp_path / "cold"), rows))


def test_a_payload_that_does_not_load_is_a_bad_entry(cache_dir, tmp_path):
    """A payload whose checksums hold but which ``torch.export.load``
    refuses (written by a broken publisher) is evicted too."""
    _export(str(tmp_path / "cold"))
    store = CacheStore(cache_dir)
    fps = [e["fingerprint"] for e in store.entries()]
    for fp in fps:
        entry = store.get(fp, touch=False)
        text, meta = entry.read_module(), entry.meta
        store.evict(fp)
        store.put(fp, text, b"not a pt2 archive",
                  {k: meta[k] for k in ("kind", "env", "cc", "extra")})
    reset_cache_metrics()
    with pytest.warns(UserWarning, match="does not load"):
        _export(str(tmp_path / "again"))
    m = cache_metrics()
    assert (m["bad_entry"], m["miss"], m["publish"], m["hit"]) == \
        (2, 2, 2, 0)


def test_gc_evicts_the_least_recently_hit_first(cache_dir, tmp_path):
    _export(str(tmp_path / "a"))
    store = CacheStore(cache_dir)
    es = sorted(store.entries(), key=lambda e: e["fingerprint"])
    hot, cold = es
    now = time.time()
    for e, t in ((hot, now), (cold, now - 3600)):
        d = store.entry_dir(e["fingerprint"])
        meta = json.load(open(os.path.join(d, META_FILE)))
        meta["last_hit"] = t
        json.dump(meta, open(os.path.join(d, META_FILE), "w"))
    total = store.total_bytes()
    evicted = store.gc(max_bytes=total - 1)
    assert evicted == [cold["fingerprint"]]
    assert [e["fingerprint"] for e in store.entries()] == \
        [hot["fingerprint"]]


def _trainable(fluid_pkg):
    main, startup = fluid_pkg.Program(), fluid_pkg.Program()
    with fluid_pkg.unique_name.guard(), \
            fluid_pkg.program_guard(main, startup):
        x = fluid_pkg.layers.data(name="x", shape=[13], dtype="float32")
        y = fluid_pkg.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid_pkg.layers.fc(input=x, size=1, act=None)
        avg = fluid_pkg.layers.mean(
            fluid_pkg.layers.square_error_cost(pred, y))
        fluid_pkg.optimizer.Adam(learning_rate=0.01).minimize(avg)
    scope, exe = fluid_pkg.Scope(), fluid_pkg.Executor(CPU)
    exe.run(startup, scope=scope)
    return main, avg, scope, exe


def test_trainable_program_goes_through_the_cache(cache_dir, tmp_path):
    shapes = {"x": (8, 13), "y": (8, 1)}
    manifests = []
    for d in ("cold", "warm"):
        main, avg, scope, exe = _trainable(fluid)
        fluid.io.save_trainable_program(str(tmp_path / d), shapes, [avg],
                                        exe, main_program=main, scope=scope)
        manifests.append(json.load(open(tmp_path / d / "__train__.json")))
    m = cache_metrics()
    assert (m["miss"], m["publish"], m["hit"]) == (1, 1, 1)
    assert manifests[0] == manifests[1]
    assert manifests[0]["train_written_outputs"]
    assert _shas(str(tmp_path / "warm")) == _shas(str(tmp_path / "cold"))
    flags.set_flags({"compile_cache_dir": ""})
    main, avg, scope, exe = _trainable(fluid)
    fluid.io.save_trainable_program(str(tmp_path / "off"), shapes, [avg],
                                    exe, main_program=main, scope=scope)
    assert json.load(open(tmp_path / "off" / "__train__.json")) == \
        manifests[0]


# ------------------------------------------------- the store across packages


def _jax_entries(d, tmp_path):
    """A JAX-package store: the lowering of an exported MLP through
    ``save_inference_model``, and an entry with an executable payload
    written straight through its store."""
    jflags.set_flags({"compile_cache_dir": d})
    try:
        main, startup = jfluid.Program(), jfluid.Program()
        with j_unique_name.guard(), jfluid.program_guard(main, startup):
            x = jfluid.layers.data(name="x", shape=[13], dtype="float32")
            out = jfluid.layers.fc(input=x, size=3, act="softmax")
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            exe = jfluid.Executor(jfluid.CPUPlace())
            exe.run(startup)
            jfluid.io.save_inference_model(str(tmp_path / "jax_model"),
                                           ["x"], [out], exe,
                                           main_program=main)
    finally:
        jflags.set_flags({"compile_cache_dir": ""})
    from paddle_tpu.compile_cache import environment_signature as jenv

    JCacheStore(d).put("cd" * 32, "module text", b"\x00executable",
                       {"kind": "step", "env": jenv(), "cc": None})


def test_each_package_verifies_the_others_entries(cache_dir, tmp_path):
    _export(str(tmp_path / "port"))
    port_verify = JCacheStore(cache_dir).verify()
    assert len(port_verify) == 2 and all(port_verify.values())
    jdir = str(tmp_path / "jax_cache")
    _jax_entries(jdir, tmp_path)
    jax_verify = CacheStore(jdir).verify()
    assert len(jax_verify) >= 2 and all(jax_verify.values())
    assert CacheStore(jdir).stats() == JCacheStore(jdir).stats()


def test_the_cache_cli_exits_as_the_jax_cli(cache_dir, tmp_path, capsys):
    from paddle_tpu.tools import cache as jcli
    from paddle_tpu_torch.tools import cache as tcli

    _export(str(tmp_path / "m"))
    jdir = str(tmp_path / "jax_cache")
    _jax_entries(jdir, tmp_path)
    flags.set_flags({"compile_cache_dir": ""})

    def both(argv):
        rcs = []
        for cli in (jcli, tcli):
            try:
                rcs.append(cli.main(argv))
            except SystemExit as e:
                rcs.append(e.code)
            capsys.readouterr()
        return rcs

    for d in (cache_dir, jdir):
        for cmd in (["stats"], ["ls"], ["verify"]):
            assert both(cmd + ["--dir", d]) == [0, 0], (cmd, d)
    # a tampered payload: verify exits 1 in both
    store = CacheStore(cache_dir)
    e = store.entries()[0]
    with open(os.path.join(store.entry_dir(e["fingerprint"]),
                           EXECUTABLE_FILE), "ab") as f:
        f.write(b"tampered")
    assert both(["verify", "--dir", cache_dir]) == [1, 1]
    # no directory anywhere: a usage error; no command: the help, 2
    assert both(["stats"]) == [2, 2]
    assert both([]) == [2, 2]
    assert both(["gc", "--max-bytes", "0", "--dir", cache_dir]) == [0, 0]
    assert CacheStore(cache_dir).stats()["entries"] == 0
    assert both(["clear", "--dir", jdir]) == [0, 0]
    assert CacheStore(jdir).stats()["entries"] == 0
