"""paddle_tpu_torch's io: variables, the inference model and the decode
model, held to paddle_tpu's files.

* ``save_vars``/``save_params``/``save_persistables`` and their
  ``load_*`` round trip every persistable bit for bit, one ``.npy`` a
  variable and combined in one ``.npz``.
* **bf16 round trip.** A bfloat16 tensor is written as the JAX package
  writes an ml_dtypes array: a raw ``'<V2'`` member, byte-equal. It
  reads back as bfloat16 where something names the dtype (the
  program's variable, the scope's tensor, an artifact's var table); a
  raw member that nothing names raises. The JAX package's
  ``save_persistables`` of a program with bfloat16 moments loads into
  the port bit for bit.
* **Flat groups.** An unfused program's save loads into a fused
  program with one write of each flat buffer (no per-view write), and
  the values land in the views.
* **Artifacts.** ``save_inference_model`` of the same program with the
  same weights (fit_a_line-style MLP; the tiny Transformer-base's
  prediction with dropout 0.1) writes a ``__model__.json`` equal to the
  JAX package's — feeds, fetches, ``param_names``, the op types, slots
  and attrs in order, the var table, after the pass pipeline — and
  ``__params__.npz`` members equal bit for bit. ``load_inference_model
  (program=)`` serves what ``Executor.run`` gives on the trained scope.
  ``export_stablehlo`` writes the ``torch.export`` program
  (``torch_export``) without a warning, ``export_batch_sizes`` one per
  bucket; a load without ``program`` raises, pointing at the
  predictor.
* **Decode artifact.** The JAX package's ``save_decode_model`` (with
  ``pallas_paged_attention`` off and on: stamps without and with
  ``+pallas``) loads in the port (``load_decode_model(program=)``), and
  the reloaded scope serves the streams of the carried-over weights;
  the port's own artifact records the JAX package's ``decode_pair``
  section, its decode stamp carrying ``+pallas``.
"""

import json
import os
import warnings
import zipfile

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import flags as j_flags
from paddle_tpu.core import unique_name as j_unique_name
from paddle_tpu_torch.core import npz
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.core.scope import Scope

from _torch_port import (CACHE, TB, _feed, _flags, carried_scope,
                         jax_lm, torch_lm)

torch.set_num_threads(1)

CPU = tfluid.CPUPlace()


def _mlp(pkg, bf16_moments=False, fuse=False):
    guard = j_unique_name.guard if pkg is jfluid else \
        tfluid.unique_name.guard
    main, startup = pkg.Program(), pkg.Program()
    with _flags("jax" if pkg is jfluid else "torch",
                {"bf16_moments": bf16_moments,
                 "fuse_optimizer_state": fuse}), \
            guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[13], dtype="float32")
        h = pkg.layers.fc(input=x, size=16, act="relu")
        pred = pkg.layers.fc(input=h, size=1)
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, pred, loss


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(8, 13).astype(np.float32)
    return {"x": x, "y": x[:, :1] * 2.0 + 0.5}


def _trained_port(steps=3, **kw):
    main, startup, pred, loss = _mlp(tfluid, **kw)
    scope, exe = Scope(), tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    for s in range(steps):
        exe.run(main, feed=_batch(s), fetch_list=[loss], scope=scope)
    return main, startup, pred, loss, scope, exe


def _persistables(program):
    return [v.name for v in program.list_vars() if v.persistable]


def _bits(t):
    t = t.detach()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("filename", [None, "all_state"])
@pytest.mark.parametrize("bf16", [False, True])
def test_persistables_round_trip_bit_for_bit(tmp_path, filename, bf16):
    main, startup, _, _, scope, exe = _trained_port(bf16_moments=bf16)
    tfluid.io.save_persistables(exe, str(tmp_path), main_program=main,
                                filename=filename, scope=scope)
    fresh = Scope()
    exe.run(startup, scope=fresh)
    tfluid.io.load_persistables(exe, str(tmp_path), main_program=main,
                                filename=filename, scope=fresh)
    names = _persistables(main)
    if bf16:
        assert any(scope.find_var(n).dtype == torch.bfloat16 for n in names)
    for n in names:
        got, want = fresh.find_var(n), scope.find_var(n)
        assert got.dtype == want.dtype, n
        assert torch.equal(_bits(got), _bits(want)), n


def test_bf16_members_are_the_jax_packages_bytes(tmp_path):
    vals = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    t = torch.tensor(vals).bfloat16()
    npz.savez(str(tmp_path / "t"), {"m": npz.host_array(t),
                                    "s": npz.host_array(t[0, 0])})
    np.savez(str(tmp_path / "j"), m=vals.astype(ml_dtypes.bfloat16),
             s=vals[0, 0].astype(ml_dtypes.bfloat16))
    zt, zj = zipfile.ZipFile(tmp_path / "t.npz"), \
        zipfile.ZipFile(tmp_path / "j.npz")
    for member in ("m.npy", "s.npy"):
        assert zt.read(member) == zj.read(member)
        assert b"'descr': '<V2'" in zt.read(member)
    npz.save(str(tmp_path / "m.npy"), npz.host_array(t))
    np.save(str(tmp_path / "mj.npy"), vals.astype(ml_dtypes.bfloat16))
    assert (tmp_path / "m.npy").read_bytes() == \
        (tmp_path / "mj.npy").read_bytes()


def test_a_raw_member_reads_as_bf16_only_where_a_dtype_says_so(tmp_path):
    vals = np.random.RandomState(1).randn(4).astype(np.float32)
    raw = np.load(_save_raw(tmp_path, vals))["m"]
    assert npz.is_raw16(raw)
    want = torch.tensor(vals).bfloat16()
    # named: bfloat16 asked for, by dtype or by the scope's tensor
    assert torch.equal(_bits(npz.to_tensor(raw, "bfloat16")), _bits(want))
    scope = Scope()
    scope.set_var("m", torch.zeros(4, dtype=torch.bfloat16))
    tfluid.ckpt.apply_state(scope, {"m": raw}, place=CPU)
    assert torch.equal(_bits(scope.find_var("m")), _bits(want))
    # not named: no dtype, or another one
    with pytest.raises(EnforceError, match="nothing names its dtype"):
        npz.to_tensor(raw)
    with pytest.raises(EnforceError, match="asked for float32"):
        npz.to_tensor(raw, "float32")
    with pytest.raises(EnforceError, match="nothing names its dtype"):
        tfluid.ckpt.apply_state(Scope(), {"m": raw}, place=CPU)
    # a var the program does not declare and the scope does not hold
    main = _mlp(tfluid)[0]
    np.save(str(tmp_path / "orphan.npy"),
            vals.astype(ml_dtypes.bfloat16))
    with pytest.raises(EnforceError, match="nothing names its dtype"):
        tfluid.io.load_vars(tfluid.Executor(CPU), str(tmp_path),
                            main_program=main, vars=["orphan"],
                            scope=Scope())


def _save_raw(tmp_path, vals):
    p = str(tmp_path / "raw.npz")
    np.savez(p, m=vals.astype(ml_dtypes.bfloat16))
    return p


def test_jax_persistables_with_bf16_moments_load_bit_for_bit(tmp_path):
    j_main, j_startup, _, j_loss = _mlp(jfluid, bf16_moments=True)
    jscope = jfluid.Scope()
    with _flags("jax", {"bf16_moments": True}), \
            jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(j_startup)
        for s in range(2):
            jexe.run(j_main, feed=_batch(s), fetch_list=[j_loss.name])
        jfluid.io.save_persistables(jexe, str(tmp_path), main_program=j_main,
                                    filename="state")
    t_main, t_startup, _, _ = _mlp(tfluid, bf16_moments=True)
    scope, exe = Scope(), tfluid.Executor(CPU)
    exe.run(t_startup, scope=scope)
    tfluid.io.load_persistables(exe, str(tmp_path), main_program=t_main,
                                filename="state", scope=scope)
    n_bf16 = 0
    for n in _persistables(t_main):
        want = np.asarray(jscope.find_var(n))
        got = scope.find_var(n)
        if want.dtype.name == "bfloat16":
            n_bf16 += 1
            assert got.dtype == torch.bfloat16, n
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=n)
    assert n_bf16 == 8  # two moments of four parameters


class _CountingScope(Scope):
    def __init__(self):
        super().__init__()
        self.writes = {}

    def set_var(self, name, value):
        self.writes[name] = self.writes.get(name, 0) + 1
        super().set_var(name, value)

    def _write_view(self, name, spec, value):
        raise AssertionError("a per-view write of %r" % name)


@pytest.mark.parametrize("via", ["load_persistables", "apply_state"])
def test_unfused_state_loads_into_a_fused_program_in_one_write(
        tmp_path, via):
    u_main, _, _, _, u_scope, exe = _trained_port()
    f_main, f_startup, _, _ = _mlp(tfluid, fuse=True)
    views = f_main._flat_state_views
    flats = sorted({spec[0] for spec in views.values()})
    assert len(flats) == 3  # the parameters and two moments
    scope = _CountingScope()
    exe.run(f_startup, scope=scope)
    scope.writes.clear()
    if via == "load_persistables":
        tfluid.io.save_persistables(exe, str(tmp_path), main_program=u_main,
                                    scope=u_scope)
        tfluid.io.load_persistables(exe, str(tmp_path), main_program=f_main,
                                    scope=scope)
    else:
        state = {n: u_scope.find_var(n).numpy()
                 for n in _persistables(u_main)}
        tfluid.ckpt.apply_state(scope, state, f_main)
    assert {n: scope.writes.get(n) for n in flats} == {n: 1 for n in flats}
    for n in views:
        assert torch.equal(scope.find_var(n), u_scope.find_var(n)), n


# ------------------------------------------------------------- artifacts


def _tb_predict(pkg):
    guard, build = ((j_unique_name.guard,
                     __import__("paddle_tpu.models.transformer",
                                fromlist=["x"]).transformer_base)
                    if pkg is jfluid else
                    (tfluid.unique_name.guard,
                     __import__("paddle_tpu_torch.models.transformer",
                                fromlist=["x"]).transformer_base))
    main, startup = pkg.Program(), pkg.Program()
    with warnings.catch_warnings(), guard(), \
            pkg.program_guard(main, startup):
        warnings.filterwarnings("ignore")
        _, cost, predict = build(**{**TB, "dropout_rate": 0.1},
                                 attn_impl="fused")
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(cost)
    return main, startup, predict, cost


ARTIFACT_MODELS = {
    "mlp": (lambda pkg: _mlp(pkg), ["x"],
            lambda: {"x": _batch()["x"]}),
    "transformer": (_tb_predict, ["src_word", "src_mask", "trg_word",
                                  "trg_mask"],
                    lambda: {k: v for k, v in _feed().items()
                             if k != "lbl_word"}),
}


def _both_artifacts(model, tmp_path):
    build, feeds, _ = ARTIFACT_MODELS[model]
    j_main, j_startup, j_pred, _ = build(jfluid)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(j_startup)
        jdir = str(tmp_path / "jax")
        jfluid.io.save_inference_model(
            jdir, feeds, [j_pred], jexe,
            main_program=j_main.clone(for_test=True),
            export_stablehlo=False)
    t_main, t_startup, t_pred, _ = build(tfluid)
    scope, exe = Scope(), tfluid.Executor(CPU)
    exe.run(t_startup, scope=scope)
    tfluid.state_from_numpy(
        {v.name: np.asarray(jscope.find_var(v.name))
         for v in t_main.list_vars() if v.persistable},
        scope, CPU, program=t_main)
    tdir = str(tmp_path / "torch")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the export succeeds silently
        tfluid.io.save_inference_model(
            tdir, feeds, [t_pred], exe,
            main_program=t_main.clone(for_test=True), scope=scope)
    return jdir, tdir, t_main, t_pred, scope, exe


@pytest.mark.parametrize("model", list(ARTIFACT_MODELS))
def test_inference_artifact_equals_the_jax_packages(tmp_path, model):
    jdir, tdir, t_main, t_pred, scope, exe = _both_artifacts(model,
                                                             tmp_path)
    jm = json.load(open(os.path.join(jdir, "__model__.json")))
    tm = json.load(open(os.path.join(tdir, "__model__.json")))
    # the compiled artifact is a torch.export program, not StableHLO
    assert tm["torch_export"] == "__model__.pt2"
    assert tm["torch_export_batch_size"] == 1
    assert os.path.exists(os.path.join(tdir, "__model__.pt2"))
    assert not any(k.startswith(("stablehlo", "torch_export_error"))
                   for k in tm)
    assert "tuned_configs" not in tm
    for key in ("format_version", "feed_names", "fetch_names",
                "param_names", "vars", "ops"):
        assert tm[key] == jm[key], key
    assert any(op["type"] == "fc_act_fused" for op in tm["ops"])
    jp = np.load(os.path.join(jdir, "__params__.npz"))
    tp = np.load(os.path.join(tdir, "__params__.npz"))
    assert sorted(tp.files) == sorted(jp.files) == tm["param_names"]
    for n in tp.files:
        np.testing.assert_array_equal(tp[n], jp[n], err_msg=n)
    # load with the program: the pruned clone serves Executor.run's result
    feed = ARTIFACT_MODELS[model][2]()
    want, = exe.run(t_main.clone(for_test=True).prune([t_pred.name]),
                    feed=feed, fetch_list=[t_pred], scope=scope)
    fresh = Scope()
    prog, feeds, fetches = tfluid.io.load_inference_model(
        tdir, tfluid.Executor(CPU), scope=fresh,
        program=t_main.clone(for_test=True))
    assert (feeds, fetches) == (jm["feed_names"], jm["fetch_names"])
    got, = exe.run(prog, feed=feed, fetch_list=fetches, scope=fresh)
    np.testing.assert_array_equal(got, want)


def test_inference_artifact_refusals(tmp_path):
    """Bucket sizes below 1 raise before anything is written; an
    explicit bucket request is met (one program per bucket); a load
    without ``program=`` points at the predictor; a trainable program
    written by the JAX package (no ``torch_export``) is refused."""
    main, startup, pred, _, scope, exe = _trained_port()
    with pytest.raises(EnforceError, match="export_batch_sizes"):
        tfluid.io.save_inference_model(str(tmp_path / "b"), ["x"], [pred],
                                       exe, main_program=main, scope=scope,
                                       export_batch_sizes=[0, 4])
    tfluid.io.save_inference_model(str(tmp_path / "b"), ["x"], [pred], exe,
                                   main_program=main, scope=scope,
                                   export_batch_sizes=[1, 4])
    tm = json.load(open(str(tmp_path / "b" / "__model__.json")))
    assert tm["torch_export_buckets"] == {"1": "__model__.pt2",
                                          "4": "__model__.b4.pt2"}
    tfluid.io.save_inference_model(str(tmp_path / "a"), ["x"], [pred], exe,
                                   main_program=main, scope=scope,
                                   export_stablehlo=False)
    assert "torch_export" not in json.load(
        open(str(tmp_path / "a" / "__model__.json")))
    with pytest.raises(EnforceError, match="paddle_tpu_torch.inference"):
        tfluid.io.load_inference_model(str(tmp_path / "a"), exe,
                                       scope=Scope())
    with open(str(tmp_path / "a" / "__train__.json"), "w") as f:
        json.dump({"train_state_names": []}, f)
    with pytest.raises(EnforceError, match="torch_export"):
        tfluid.io.load_trainable_program(str(tmp_path / "a"), place=CPU)


# ---------------------------------------------------------- decode model


@pytest.fixture(scope="module")
def lm():
    j_main, j_scope, j_logits = jax_lm()
    t_main, _, t_logits = torch_lm()
    return j_main, j_scope, j_logits, t_main, t_logits, \
        carried_scope(j_main, j_scope, t_main)


REQUESTS = [([3, 1, 4, 1, 5], 6), ([9, 2, 6], 5), ([5] * 11, 4)]


def _streams(t_main, t_logits, scope, cache):
    from paddle_tpu_torch.decoding import DecodingConfig, serve_decoding

    s = serve_decoding(t_main, "tokens", t_logits.name, scope=scope,
                       config=DecodingConfig(cache=cache,
                                             decode_buckets=(1, 2, 4)),
                       place=CPU)
    try:
        return [s.generate(p, max_new_tokens=m, timeout=120)
                for p, m in REQUESTS]
    finally:
        s.shutdown(drain=True, timeout=60)


@pytest.mark.parametrize("pallas", [False, True])
def test_jax_decode_artifact_loads_and_serves_in_the_port(tmp_path, lm,
                                                          pallas):
    from paddle_tpu import decoding as jdec

    j_main, j_scope, j_logits, t_main, t_logits, carried = lm
    old = j_flags.get_flag("pallas_paged_attention")
    j_flags.set_flags({"pallas_paged_attention": pallas})
    try:
        with jfluid.scope_guard(j_scope):
            section = jfluid.io.save_decode_model(
                str(tmp_path), "tokens", j_logits, None,
                main_program=j_main, cache_config=jdec.CacheConfig(**CACHE),
                scope=j_scope)
    finally:
        j_flags.set_flags({"pallas_paged_attention": old})
    assert section["decode"]["stamp"].endswith("+pallas") == pallas
    scope = Scope()
    pair, loaded = tfluid.io.load_decode_model(
        str(tmp_path), tfluid.Executor(CPU), scope=scope, program=t_main)
    assert loaded == section
    assert pair.decode._decode_stamp.endswith("+pallas")
    for p in t_main.all_parameters():
        assert torch.equal(scope.find_var(p.name), carried.find_var(p.name))
    assert _streams(t_main, t_logits, scope, pair.config) == \
        _streams(t_main, t_logits, carried, pair.config)


def test_ports_decode_artifact_records_the_jax_section(tmp_path, lm):
    from paddle_tpu import decoding as jdec
    from paddle_tpu_torch.decoding import CacheConfig

    j_main, j_scope, j_logits, t_main, t_logits, carried = lm
    with jfluid.scope_guard(j_scope):
        want = jfluid.io.save_decode_model(
            str(tmp_path / "j"), "tokens", j_logits, None,
            main_program=j_main, cache_config=jdec.CacheConfig(**CACHE),
            scope=j_scope)
    got = tfluid.io.save_decode_model(
        str(tmp_path / "t"), "tokens", t_logits, tfluid.Executor(CPU),
        main_program=t_main, cache_config=CacheConfig(**CACHE),
        scope=carried)
    assert got["decode"]["stamp"] == want["decode"]["stamp"] + "+pallas"
    got["decode"]["stamp"] = want["decode"]["stamp"]
    assert got == want
    jm = json.load(open(tmp_path / "j" / "__model__.json"))
    tm = json.load(open(tmp_path / "t" / "__model__.json"))
    for key in ("feed_names", "fetch_names", "param_names", "vars"):
        assert tm[key] == jm[key], key
    assert [op["type"] for op in tm["ops"]] == \
        [op["type"] for op in jm["ops"]]
    pair, section = tfluid.io.load_decode_model(
        str(tmp_path / "t"), tfluid.Executor(CPU), scope=Scope(),
        program=t_main)
    assert section["n_layers"] == 2 and pair.n_layers == 2
    assert section["kv_pools"][0]["shape"][:2] == \
        [CACHE["num_blocks"], CACHE["block_size"]]
