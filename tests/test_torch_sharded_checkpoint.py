"""Checkpoints across ranks in paddle_tpu_torch, against paddle_tpu's.

Worlds of gloo ranks on the CPU (``tests/_torch_ranks.py``), from the
JAX package's start state of tests/test_sharded_checkpoint.py's MLP
(Momentum, ZeRO ``ReduceStrategy.Reduce``):

* four ranks run five uninterrupted steps; then three, a legacy sharded
  and an elastic save from every rank (each writes the blocks it owns),
  and the restore onto the same mesh — blocks re-sliced from the shards,
  or whole values the run cuts — resumes steps 3-4 at rtol 1e-6 (the
  JAX test's bar, tests/test_sharded_checkpoint.py:57);
* two ranks restore the four's elastic checkpoint and the JAX package's
  sharded and elastic checkpoints written on its 4-device mesh: every
  block equal to the saved state's slice, steps 3-4 at rtol 2e-5 (two
  ranks sum the gradient in another order than four);
* one process reads them all back equal to the saved state, and the JAX
  package reads the port's (float32 state: Queue C 6 allows that way);
* the pipelined Transformer's stage blocks (pp=2 x dp=2) restore whole
  on one process and train on as the ranks did; a ``shard_program``
  run's blocks restore exactly onto its mesh and onto fsdp=4 under
  other rules (tests/test_ckpt.py:150,226);
* SIGKILL of a rank mid-save (tests/test_multiprocess_checkpoint.py:81):
  the half-written serial never becomes valid, and a fresh world of two
  resumes the last valid one at rtol 2e-5 of one device;
* ``Trainer(parallel=True, checkpoint_config=...)`` across four ranks:
  a run that dies after its step-3 checkpoint, resumed by a new
  Trainer, ends where one process's uninterrupted run does (rtol 1e-5).

In one process: the validity rule (every process of a save wrote its
part), a multi-process save needs an explicit serial, the scroll-delete
keeps the last valid serial, the async saver skips partial serials
(tests/test_sharded_checkpoint.py:138-201).
"""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique_name
from paddle_tpu_torch import ckpt

import _torch_ranks as R

torch.set_num_threads(1)

SAME_MESH_RTOL = 1e-6   # tests/test_sharded_checkpoint.py:110
OTHER_MESH_RTOL = 2e-5  # tests/test_multiprocess_checkpoint.py:140


def _devices(n):
    import jax

    if len(jax.devices()) < n:
        pytest.skip("needs %d virtual devices" % n)
    return jax.devices()[:n]


def _save_state(path, main, startup, fluid=jfluid):
    """The parameters ``startup`` gives (of the JAX package, or of the
    port: its parameters only, the start state of every rank)."""
    if fluid is not jfluid:
        scope = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
        np.savez(path, **{p.name: fluid.fetch_var(p.name, scope)
                          for p in main.global_block().all_parameters()})
        return
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    np.savez(path, **{v.name: np.asarray(scope.find_var(v.name))
                      for v in main.list_vars()
                      if v.persistable and scope.find_var(v.name)
                      is not None})


def _jax_zero_checkpoints(out):
    """The JAX package's ZeRO run at dp=4 from zero.npz: 3 steps, then
    its sharded and elastic saves and the whole state."""
    import jax.numpy as jnp

    from paddle_tpu import checkpoint as jck

    with j_unique_name.guard():
        main, startup, loss = R.build_zero_mlp(jfluid)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        with np.load(out / "zero.npz") as z:
            for n in z.files:
                scope.set_var(n, jnp.asarray(z[n]))
        bs = jfluid.BuildStrategy()
        bs.reduce_strategy = jfluid.parallel.ReduceStrategy.Reduce
        pe = jfluid.ParallelExecutor(
            main_program=main, loss_name=loss.name, scope=scope,
            mesh=jfluid.parallel.make_mesh({"dp": 4},
                                           devices=_devices(4)),
            build_strategy=bs)
        for s in range(3):
            pe.run(feed=R.zero_feed(s), fetch_list=[loss.name])
        names = sorted(scope.local_var_names())
        state = {n: scope.get(n) for n in names}
        jck.save_checkpoint_sharded(str(out / "jax_sharded"), state,
                                    trainer_args={"step": 3})
        jck.save_checkpoint_elastic(str(out / "jax_elastic"), state,
                                    trainer_args={"step": 3})
        np.savez(out / "jax_saved.npz",
                 **{n: np.asarray(v) for n, v in state.items()})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from paddle_tpu.models.transformer import transformer_base as jtb

    out = tmp_path_factory.mktemp("ckpt_ranks")
    with j_unique_name.guard():
        main, startup, _ = R.build_zero_mlp(jfluid)
    _save_state(str(out / "zero.npz"), main, startup)
    with j_unique_name.guard():
        main, startup, _ = R.build_pp_tb(jfluid, jtb)
    _save_state(str(out / "pp_tb.npz"), main, startup)
    with j_unique_name.guard():
        main, startup, _ = R.build_mlp(jfluid)
    _save_state(str(out / "mlp.npz"), main, startup)
    _jax_zero_checkpoints(out)
    res = R.launch(4, ["ckpt_save"], str(out), timeout=300)
    from paddle_tpu_torch.models.transformer import transformer_base as ttb

    for key in R.UPDATE_FLAGS:
        main, startup, _ = R.build_update_tb(tfluid, ttb, key)
        _save_state(str(out / ("update_%s.npz" % key)), main, startup,
                    tfluid)
    res.update(R.launch(2, ["ckpt_restore2", "ckpt_update"], str(out),
                        timeout=240))
    res.update(R.launch(2, ["ckpt_kill"], str(out), timeout=200,
                        codes=[0, -9]))
    res.update(R.launch(2, ["ckpt_resume"], str(out), timeout=200))
    return out, res


def _saved(out, name="zero_saved.npz"):
    with np.load(out / name) as z:
        return {k: z[k] for k in z.files}


def test_sharded_and_elastic_saves_resume_on_the_same_mesh(ranks):
    _out, res = ranks
    for rank in res["ckpt_save"]:
        oracle = rank["oracle"]
        assert rank["first3"] == oracle[:3]
        for fmt in ("sharded", "elastic"):
            assert rank["targs_" + fmt] == {"step": 3}
            np.testing.assert_allclose(rank["resumed_" + fmt], oracle[3:],
                                       rtol=SAME_MESH_RTOL)
        # the ZeRO velocities whose first dimension four ranks divide
        # were handed over as blocks (fc.b_1's [1] stays whole), and the
        # sharded restore gave each rank its quarter of them
        vel = [n for n in rank["shards"] if "velocity" in n]
        assert sorted(vel) == ["fc.b_0_velocity_0", "fc.w_0_velocity_0",
                               "fc.w_1_velocity_0"]
        for n, first in zip(sorted(vel), (8, 4, 8)):
            assert rank["block_shapes"][n][0] == first, n
        assert rank["block_shapes"]["fc.b_1_velocity_0"] == [1]


@pytest.mark.parametrize("root", ["elastic", "jax_sharded", "jax_elastic"])
def test_four_ranks_checkpoints_restore_on_two(ranks, root):
    _out, res = ranks
    oracle = res["ckpt_save"][0]["oracle"]
    for rank in res["ckpt_restore2"]:
        got = rank[root]
        assert got["targs"] == {"step": 3}
        bad = [n for n, (_s, ok) in got["gaps"].items() if not ok]
        assert not bad, bad
        np.testing.assert_allclose(got["resumed"], oracle[3:],
                                   rtol=OTHER_MESH_RTOL)


@pytest.mark.parametrize("root", ["sharded", "elastic", "jax_sharded",
                                  "jax_elastic"])
def test_checkpoints_restore_on_one_process(ranks, root):
    """4 -> 1: the assembled state equals what the ranks saved, and one
    process resumes steps 3-4."""
    out, res = ranks
    want = _saved(out, "jax_saved.npz" if root.startswith("jax")
                  else "zero_saved.npz")
    state, targs = ckpt.load_checkpoint(str(out / root))
    assert targs == {"step": 3} and set(state) == set(want)
    for n, v in want.items():
        np.testing.assert_array_equal(np.asarray(state[n]), v, err_msg=n)
    main, startup, loss = R.build_zero_mlp(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    ckpt.restore(str(out / root), program=main, scope=scope)
    resumed = R._losses(exe, main, loss, [R.zero_feed(s) for s in (3, 4)],
                        scope)
    np.testing.assert_allclose(resumed, res["ckpt_save"][0]["oracle"][3:],
                               rtol=OTHER_MESH_RTOL)


@pytest.mark.parametrize("root", ["sharded", "elastic"])
def test_the_jax_package_reads_the_ranks_checkpoints(ranks, root):
    from paddle_tpu import checkpoint as jck

    out, _res = ranks
    want = _saved(out)
    state, targs = jck.load_checkpoint(str(out / root))
    assert targs == {"step": 3}
    for n, v in want.items():
        np.testing.assert_array_equal(np.asarray(state[n]), v, err_msg=n)


def test_plan_checkpoint_restores_exactly_and_onto_other_rules(ranks):
    """tests/test_ckpt.py:150,226: a ``shard_program`` run at data=2 x
    fsdp=2 saves its blocks; restored onto the same mesh each rank holds
    exactly the blocks it saved and the run continues bit-equal to the
    uninterrupted one; restored onto fsdp=4 under the default rules it
    continues within the order of the sums (rtol 1e-4, the
    tests/test_torch_sharding.py bar)."""
    for rank in ranks[1]["ckpt_save"]:
        runs = rank["plan"]
        assert rank["plan_blocks"] > 0 and rank["plan_exact"]
        assert runs["same"] == runs["saved"]
        np.testing.assert_allclose(runs["other"], runs["saved"], rtol=1e-4)


def test_pipeline_stage_blocks_restore_whole(ranks):
    """The pipelined Transformer's stacked weights, saved as each
    stage's blocks from pp=2 x dp=2, read back whole; one process
    trains on from them as the ranks did."""
    from paddle_tpu_torch.models.transformer import transformer_base

    out, res = ranks
    want = _saved(out, "pp_saved.npz")
    state, _ = ckpt.load_checkpoint(str(out / "pp"))
    stacked = [n for n in want if n.startswith("pp_enc.")]
    assert len(stacked) == 12
    for n, v in want.items():
        np.testing.assert_array_equal(np.asarray(state[n]), v, err_msg=n)
    main, startup, loss = R.build_pp_tb(tfluid, transformer_base)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    ckpt.restore(str(out / "pp"), program=main, scope=scope)
    got = R._losses(exe, main, loss, [R.pp_feed()] * 2, scope)
    np.testing.assert_allclose(got, res["ckpt_save"][0]["pp_losses"],
                               rtol=OTHER_MESH_RTOL)


def test_sigkill_mid_save_leaves_the_last_valid_serial(ranks):
    out, res = ranks
    root = str(out / "killed")
    assert ckpt.latest_valid_serial(root) == 0
    assert os.path.isdir(ckpt.serial_dir(root, 1))
    assert not ckpt.is_valid(root, 1)  # rank 1 never wrote its part
    got = res["ckpt_resume"]
    main, startup, loss = R.build_zero_mlp(tfluid)
    exe, scope = R._start(tfluid, main, startup, str(out / "zero.npz"))
    one = R._losses(exe, main, loss, [R.zero_feed(s) for s in range(5)],
                    scope)
    np.testing.assert_allclose(res["ckpt_kill"][0]["first3"], one[:3],
                               rtol=OTHER_MESH_RTOL)
    for rank in got:
        assert rank["serial"] == 0 and rank["targs"] == {"step": 3}
        np.testing.assert_allclose(rank["resumed"], one[3:],
                                   rtol=OTHER_MESH_RTOL)


def test_trainer_parallel_checkpoints_and_resumes_across_ranks(ranks):
    _out, res = ranks
    batches = R.trainer_batches()
    t = tfluid.Trainer(R.trainer_func(tfluid),
                       lambda: tfluid.optimizer.Adam(learning_rate=0.01),
                       place=tfluid.CPUPlace())
    losses = []
    t.train(num_epochs=1, reader=lambda: iter(batches),
            feed_order=["x", "y"],
            event_handler=lambda e: losses.append(float(e.metrics[0]))
            if isinstance(e, tfluid.EndStepEvent) else None)
    w = tfluid.fetch_var(t.train_program.all_parameters()[0].name, t.scope)
    for rank in res["ckpt_save"]:
        np.testing.assert_allclose(rank["trainer_first"], losses[:3],
                                   rtol=1e-5)
        np.testing.assert_allclose(rank["trainer_resumed"], losses[3:],
                                   rtol=1e-5)
        np.testing.assert_allclose(rank["trainer_w"], w, rtol=1e-5,
                                   atol=1e-7)


# ------------------------------------------------------------ one process


# a restored step after an update on one card against the ranks' own:
# with f32 activations and moments only the order of the gradient's sums
# differs (read 1.2e-7); with the recipe's bf16 activations one card's
# whole-batch gradient and the ranks' sum of two half-batch gradients
# part by bf16 rounding (read 2.5e-5), held at the limit of the
# data-parallel recipe against one card (chip_smoke.py's PARALLEL_TOL)
UPDATE_RTOL = {"f32": 1e-6, "bf16": 1e-4}


@pytest.mark.parametrize("key", sorted(R.UPDATE_FLAGS))
def test_a_restored_update_is_the_ranks_update(ranks, key):
    """Two ranks' elastic checkpoint of the recipe-flagged Transformer
    (ZeRO, row-sparse tables, fused Adam state) restored on one process:
    every value equal to a rank's saved block in dtype, shape and bits
    (``chip_smoke.restored_mismatches``, leg (g)'s check);
    the first step's loss the ranks' step 4 (rtol 1e-5, atol 1e-6: the
    same state, the batch split only) and the next, after one restored
    update, the ranks' step 5 at ``UPDATE_RTOL``. The batch has as many
    tokens as a table has rows."""
    from paddle_tpu_torch.models.transformer import transformer_base

    out, res = ranks
    own = res["ckpt_update"][0][key]
    assert own == res["ckpt_update"][1][key]
    main, startup, loss = R.build_update_tb(tfluid, transformer_base, key)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    _state, targs = ckpt.restore(str(out / ("update_" + key)),
                                 program=main, scope=scope)
    assert targs == {"step": 3}
    from chip_smoke import restored_mismatches

    for r in range(2):
        compared, bad = restored_mismatches(scope, torch.load(
            str(out / ("update_%s.%d.pt" % (key, r))), weights_only=True))
        assert not bad and compared >= 8, (compared, bad)
    got = R._losses(exe, main, loss, [R.update_feed()] * 2, scope)
    np.testing.assert_allclose(got[0], own[3], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1], own[4], rtol=UPDATE_RTOL[key])


def test_validity_requires_every_process(tmp_path):
    """tests/test_sharded_checkpoint.py:138: a serial whose meta claims
    a process that never wrote its part is invalid; recovery falls back
    to the previous valid serial, and a corrupt payload leaves none."""
    root = str(tmp_path / "ckpt")
    w = np.ones(8, "float32")
    for save in (ckpt.save_checkpoint_sharded, ckpt.save_checkpoint_elastic):
        r = os.path.join(root, save.__name__)
        s0 = save(r, {"w": w})
        s1 = save(r, {"w": w})
        assert ckpt.latest_valid_serial(r) == s1
        meta_p = os.path.join(ckpt.serial_dir(r, s1), "meta.json")
        with open(meta_p) as f:
            meta = json.load(f)
        meta["process_count"] = 2
        with open(meta_p, "w") as f:
            json.dump(meta, f)
        assert ckpt.latest_valid_serial(r) == s0
        with open(os.path.join(ckpt.serial_dir(r, s0), "shards_0.npz"),
                  "ab") as f:
            f.write(b"junk")
        assert ckpt.latest_valid_serial(r) is None


def test_multiprocess_save_needs_serial(monkeypatch, tmp_path):
    """tests/test_sharded_checkpoint.py:164."""
    from paddle_tpu_torch.ckpt import saver

    monkeypatch.setattr(saver, "_process_count", lambda: 2)
    for save in (ckpt.save_checkpoint_sharded, ckpt.save_checkpoint_elastic):
        with pytest.raises(ValueError, match="explicit serial"):
            save(str(tmp_path), {"w": np.ones(4)})


def test_scroll_delete_never_drops_last_valid(tmp_path):
    """tests/test_sharded_checkpoint.py:170: process 0 finishing serial
    N must not prune the last valid serial while N is incomplete."""
    from paddle_tpu_torch.ckpt.base import _scroll_delete
    from paddle_tpu_torch.ckpt.saver import (_snapshot_local_shards,
                                             _write_sharded)

    root = str(tmp_path / "ckpt")
    w = np.ones(8, "float32")
    s0 = ckpt.save_checkpoint_sharded(root, {"w": w}, max_num_checkpoints=1)
    entries = _snapshot_local_shards({"w": w})
    _write_sharded(root, s0 + 1, entries, pid=0, pcount=2,
                   max_num_checkpoints=1)
    assert ckpt.latest_valid_serial(root) == s0
    assert os.path.isdir(ckpt.serial_dir(root, s0))
    _write_sharded(root, s0 + 1, entries, pid=1, pcount=2,
                   max_num_checkpoints=1)
    assert ckpt.latest_valid_serial(root) == s0 + 1
    _scroll_delete(root, 1)
    assert not os.path.isdir(ckpt.serial_dir(root, s0))


def test_async_saver_skips_partial_serials(tmp_path):
    """tests/test_sharded_checkpoint.py:201."""
    root = str(tmp_path / "ckpt")
    s0 = ckpt.save_checkpoint_sharded(root, {"w": np.ones(8, "float32")})
    partial = os.path.join(root, "checkpoint_%d" % (s0 + 1))
    os.makedirs(partial)
    with open(os.path.join(partial, "shards_1.npz"), "wb") as f:
        f.write(b"stale")
    saver = ckpt.AsyncCheckpointSaver(root)
    serial = saver.save({"w": np.ones(8, "float32")}).result()
    saver.close()
    assert serial == s0 + 2
