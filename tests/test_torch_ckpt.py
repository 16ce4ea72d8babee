"""paddle_tpu_torch.ckpt held to paddle_tpu.ckpt's files and rules.

* Both formats in both directions: the port's dense checkpoints (f32,
  bfloat16, int32 and 0-d values) and elastic ones (the same less
  bfloat16) load in the JAX package with every member equal bit for
  bit, and the JAX package's of all four load in the port, bfloat16
  included; the elastic files carry the JAX package's layout
  (``meta.json``, ``manifest_0.json`` fields, npz member keys and
  headers) and record ``"bfloat16"`` for bfloat16 tensors, whose
  members are raw ``'<V2'`` bits in both packages.
* The recovery rules of ``ckpt/base.py``: first publisher wins, a
  corrupt newest serial falls back to the previous valid one (an
  explicit serial raises), scroll-delete keeps the newest N, the orphan
  sweep reclaims only stale temp files, ``clean_checkpoint``.
* The restore-lint: a shape mismatch raises under ``strict`` and is
  skipped otherwise; missing and extra entries are warnings; a dense
  raw two-byte member fits a bfloat16 variable and not an f32 one.
* ``AsyncCheckpointSaver.save`` snapshots on the caller's thread: a
  tensor updated in place after ``save()`` returns does not reach the
  checkpoint; the saves publish serials in order.
* The ``checkpoint`` shim re-exports ckpt's objects; sharded layouts and
  multi-process saves raise NotImplementedError naming ROADMAP Queue A 9.

The JAX package's elastic reader cannot read a bfloat16 member back (its
own files' too: ROADMAP Queue C 6), so the port-to-JAX check of the
elastic format holds f32, int32 and 0-d values.
"""

import json
import os
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu import ckpt as jckpt
from paddle_tpu_torch import ckpt
from paddle_tpu_torch.core import npz
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.core.scope import Scope

torch.set_num_threads(1)

CPU = tfluid.CPUPlace()


def _state(seed=0):
    """Port tensors: f32, bf16, int32, a 0-d f32."""
    rng = np.random.RandomState(seed)
    return {"w": torch.tensor(rng.randn(4, 3).astype(np.float32)),
            "m": torch.tensor(rng.randn(7).astype(np.float32)).bfloat16(),
            "counter": torch.tensor(5 + seed, dtype=torch.int32),
            "lr": torch.tensor(np.float32(0.01))}


def _jax_view(t):
    """The JAX package's host value of a port tensor (ml_dtypes bf16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 and \
        a.dtype.kind in "Vf" else a


def _save(fmt, root, state, **kw):
    if fmt == "dense":
        return ckpt.save_checkpoint(root, state, **kw)
    return ckpt.save_checkpoint_elastic(root, state, **kw)


@pytest.mark.parametrize("fmt", ["dense", "elastic"])
def test_ports_checkpoint_loads_in_the_jax_package(tmp_path, fmt):
    """f32, int32 and 0-d values; in the dense format a bfloat16 one too
    (the JAX package reads it back as its raw bits). The JAX package's
    elastic reader cannot cast a raw member to bfloat16 — its own files
    included, whose members are byte-equal to the port's
    (test_elastic_layout_is_the_jax_packages) — so the elastic case
    leaves bfloat16 out (ROADMAP Queue C 6)."""
    root = str(tmp_path)
    state = _state()
    if fmt == "elastic":
        del state["m"]
    serial = _save(fmt, root, state, trainer_args={"step_id": 3})
    assert serial == 0 and jckpt.is_valid(root, 0)
    jstate, args = jckpt.load_checkpoint(root)
    assert args == {"step_id": 3}
    assert sorted(jstate) == sorted(state)
    for n, t in state.items():
        got = np.asarray(jstate[n])
        assert got.shape == tuple(t.shape), n
        np.testing.assert_array_equal(_bits(got), _bits(_jax_view(t)),
                                      err_msg=n)
    if fmt == "elastic":
        entries = jckpt.manifest_entries(root, 0)
        assert entries["w"] == ((4, 3), "float32")
        assert entries["lr"] == ((), "float32")


@pytest.mark.parametrize("fmt", ["dense", "elastic"])
def test_jax_checkpoint_loads_in_the_port(tmp_path, fmt):
    root = str(tmp_path)
    state = _state(1)
    jstate = {n: _jax_view(t) for n, t in state.items()}
    if fmt == "dense":
        jckpt.save_checkpoint(root, jstate, trainer_args={"step_id": 7})
    else:
        jckpt.save_checkpoint_elastic(root, jstate,
                                      trainer_args={"step_id": 7})
    assert ckpt.is_valid(root, 0)
    got, args = ckpt.load_checkpoint(root)
    assert args == {"step_id": 7}
    for n, t in state.items():
        v = got[n]
        if fmt == "dense" and t.dtype == torch.bfloat16:
            assert npz.is_raw16(v)  # nothing in a dense serial names it
        elif t.dtype == torch.bfloat16:
            assert isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16
    # into a scope whose tensors name every dtype: bit for bit
    scope = Scope()
    for n, t in state.items():
        scope.set_var(n, torch.zeros_like(t))
    ckpt.apply_state(scope, got)
    for n, t in state.items():
        assert scope.find_var(n).dtype == t.dtype, n
        np.testing.assert_array_equal(_bits(_jax_view(scope.find_var(n))),
                                      _bits(_jax_view(t)), err_msg=n)


def test_elastic_layout_is_the_jax_packages(tmp_path):
    state = _state()
    ckpt.save_checkpoint_elastic(str(tmp_path / "t"), state,
                                 trainer_args={"step_id": 1})
    jckpt.save_checkpoint_elastic(
        str(tmp_path / "j"), {n: _jax_view(t) for n, t in state.items()},
        trainer_args={"step_id": 1})
    td, jd = (str(tmp_path / w / "checkpoint_0") for w in "tj")
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
    tmeta = json.load(open(os.path.join(td, "meta.json")))
    jmeta = json.load(open(os.path.join(jd, "meta.json")))
    assert tmeta == jmeta
    tman = json.load(open(os.path.join(td, "manifest_0.json")))
    jman = json.load(open(os.path.join(jd, "manifest_0.json")))
    assert tman["vars"] == jman["vars"]
    assert {k: v for k, v in tman.items() if k != "payloads"} == \
        {k: v for k, v in jman.items() if k != "payloads"}
    import zipfile

    tz = zipfile.ZipFile(os.path.join(td, "shards_0.npz"))
    jz = zipfile.ZipFile(os.path.join(jd, "shards_0.npz"))
    assert sorted(tz.namelist()) == sorted(jz.namelist())
    for member in tz.namelist():
        assert tz.read(member) == jz.read(member), member
    assert tman["payloads"]["shards_0.npz"]["size"] == \
        jman["payloads"]["shards_0.npz"]["size"]


def test_first_publisher_wins_and_corrupt_serials_fall_back(tmp_path):
    from paddle_tpu_torch.ckpt.manifest import publish_serial, snapshot_state

    root = str(tmp_path)
    ckpt.save_checkpoint_elastic(root, _state(0))
    assert not publish_serial(root, 0, snapshot_state(_state(1)))
    ckpt.save_checkpoint(root, _state(1), max_num_checkpoints=5)
    assert ckpt.list_checkpoints(root) == [0, 1]
    assert ckpt.latest_valid_serial(root) == 1
    # flip one payload byte of the newest serial
    p = os.path.join(ckpt.serial_dir(root, 1), "state.npz")
    data = bytearray(open(p, "rb").read())
    data[-20] ^= 0xFF
    open(p, "wb").write(bytes(data))
    assert ckpt.latest_valid_serial(root) == 0 == jckpt.latest_valid_serial(
        root)
    state, _ = ckpt.load_checkpoint(root)
    assert torch.equal(torch.from_numpy(state["w"]), _state(0)["w"])
    with pytest.raises(IOError):
        ckpt.load_checkpoint(root, serial=1)
    # the elastic digest: a truncated payload invalidates the serial
    q = os.path.join(ckpt.serial_dir(root, 0), "shards_0.npz")
    open(q, "ab").write(b"x")
    assert ckpt.latest_valid_serial(root) is None
    assert ckpt.restore(root, scope=Scope()) == (None, None)


def test_scroll_delete_orphans_and_clean(tmp_path):
    root = str(tmp_path)
    for s in range(4):
        ckpt.save_checkpoint(root, _state(s), max_num_checkpoints=2)
    assert ckpt.list_checkpoints(root) == [2, 3]
    stale = os.path.join(root, ".ckpt_tmp_dead")
    young = os.path.join(root, ".ckpt_tmp_live")
    os.makedirs(stale)
    os.makedirs(young)
    leftover = os.path.join(ckpt.serial_dir(root, 3), ".tmp_shards_0.npz")
    open(leftover, "w").write("x")
    old = time.time() - 7200
    os.utime(stale, (old, old))
    os.utime(leftover, (old, old))
    removed = ckpt.sweep_orphans(root)
    assert sorted(removed) == sorted([stale, leftover])
    assert os.path.isdir(young)
    ckpt.clean_checkpoint(root, delete_dir=True)
    assert not os.path.exists(root)


def _program(shape=(4, 3)):
    main, startup = tfluid.Program(), tfluid.Program()
    gb = main.global_block()
    gb.create_var(name="w", shape=shape, dtype="float32", persistable=True)
    gb.create_var(name="m", shape=(7,), dtype="bfloat16", persistable=True)
    gb.create_var(name="counter", shape=(), dtype="int32", persistable=True)
    gb.create_var(name="missing", shape=(2,), dtype="float32",
                  persistable=True)
    return main


def test_restore_lint_and_strictness(tmp_path):
    root = str(tmp_path)
    ckpt.save_checkpoint(root, _state())
    codes = sorted((d.code, d.var) for d in ckpt.check_restore(
        root, _program()))
    assert codes == [("ckpt-extra-var", "lr"),
                     ("ckpt-missing-var", "missing")]
    bad = _program(shape=(3, 4))
    with pytest.raises(EnforceError, match="shape-mismatch"):
        ckpt.restore(root, program=bad, scope=Scope(), place=CPU)
    scope = Scope()
    scope.set_var("m", torch.zeros(7, dtype=torch.bfloat16))
    state, _ = ckpt.restore(root, program=bad, scope=scope, strict=False,
                            place=CPU)
    assert "w" not in state and scope.find_var("w") is None
    assert torch.equal(scope.find_var("m"), _state()["m"])
    # the dense raw member against an f32 declaration
    main = _program()
    main.global_block().vars["m"].dtype = np.dtype("float32")
    diags = ckpt.check_restore(root, main)
    assert [(d.code, d.var) for d in diags if d.is_error] == \
        [("dtype-mismatch", "m")]


def test_async_snapshot_is_taken_before_save_returns(tmp_path):
    root = str(tmp_path)
    w = torch.zeros(1000)
    with ckpt.AsyncCheckpointSaver(root, max_num_checkpoints=5) as saver:
        futs = []
        for step in range(3):
            futs.append(saver.save({"w": w}, trainer_args={"step": step}))
            w.add_(1.0)  # the next step, in place
        saver.wait()
        assert [f.result() for f in futs] == [0, 1, 2]
    for serial in range(3):
        state, args = ckpt.load_checkpoint(root, serial)
        assert args == {"step": serial}
        assert (state["w"] == serial).all()


def test_shim_and_refusals(tmp_path, monkeypatch):
    from paddle_tpu_torch import checkpoint
    from paddle_tpu_torch.ckpt import saver

    for name in checkpoint.__all__:
        assert getattr(checkpoint, name) is getattr(ckpt, name), name
    # a legacy sharded serial (the JAX package's md5 format) is refused
    sharded = tmp_path / "sharded" / "checkpoint_0"
    sharded.mkdir(parents=True)
    (sharded / "meta.json").write_text(json.dumps(
        {"format": "sharded", "serial": 0, "process_count": 1}))
    monkeypatch.setattr(saver, "_process_count", lambda: 2)
    # a program's sharding-plan layouts, once refused here, are ported:
    # an unsharded program has none (tests/test_torch_sharding.py has a
    # sharded program's checkpoint round trip)
    assert ckpt.program_state_shardings(None, {}) is None
    for call in (lambda: ckpt.load_checkpoint_sharded(str(tmp_path)),
                 lambda: ckpt.save_checkpoint_sharded(str(tmp_path), {}),
                 lambda: ckpt.save_checkpoint_elastic(str(tmp_path), {}),
                 lambda: ckpt.AsyncCheckpointSaver(str(tmp_path)).save({}),
                 lambda: ckpt.manifest_entries(str(tmp_path / "sharded"),
                                               0)):
        with pytest.raises(NotImplementedError, match="Queue A 9"):
            call()
    assert ckpt.CheckpointConfig().checkpoint_dir.endswith(
        "paddle_tpu_checkpoints")
