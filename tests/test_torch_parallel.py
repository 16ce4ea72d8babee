"""paddle_tpu_torch.parallel against paddle_tpu.parallel.

On a world of four gloo ranks on the CPU (``tests/_torch_ranks.py``),
from the JAX package's start state: the ParallelExecutor with both
reduce strategies against one device (rtol 2e-5, the JAX test's bar),
momentum accumulators held as ``dp`` slices, a feed list of dicts,
remat, ``run_steps``; sparse (rows, values) gradients under dp and
under ZeRO; the fused flat state under both strategies (the flat
moments held as slices); dropout under dp (the ParallelExecutor and a
``shard_program`` mesh) equal to the one-device step; and
``Trainer(parallel=True)``.

Two ranks: the communication analysis's prediction against the ranks'
collectives (``comm.STATS``) at data=1 x fsdp=1 x tp=2, and bit-equal
losses with and without ``comm_overlap`` at data=2.

In one process: the ``DistributeTranspiler`` plan's specs equal the JAX
package's; ``init_distributed``'s env contract and its bounded,
typed failure on a dead coordinator; the refusals that remain.
Two processes: ``tools.launch`` starts a connected world and fails
fast (tests/test_launch.py's mould).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique_name

import _torch_ranks as R

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PE_RTOL = 2e-5  # tests/test_parallel_executor.py:72


def _save_state(path, main, startup):
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    np.savez(path, **{v.name: np.asarray(scope.find_var(v.name))
                      for v in main.list_vars()
                      if v.persistable and scope.find_var(v.name)
                      is not None})
    return scope


def _jax_run(main, loss, feed, steps, scope, table=None):
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        losses = [float(exe.run(main, feed=feed,
                                fetch_list=[loss.name])[0])
                  for _ in range(steps)]
        return losses, (np.asarray(scope.find_var(table))
                        if table else None)


def _port_run(build, state_path, feed, steps, table=None):
    main, startup, loss = build()
    exe, scope = R._start(tfluid, main, startup, state_path)
    losses = R._losses(exe, main, loss, [feed] * steps, scope)
    return losses, (tfluid.fetch_var(table, scope) if table else None)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel_ranks")
    refs = {}
    with j_unique_name.guard():
        refs["pe"] = R.build_pe_mlp(jfluid)
    _save_state(str(out / "pe.npz"), *refs["pe"][:2])
    with j_unique_name.guard():
        m, s, _ = R.build_pe_mlp(jfluid, opt="momentum")
    _save_state(str(out / "pe_momentum.npz"), m, s)
    with j_unique_name.guard():
        refs["sparse"] = R.build_sparse(jfluid)
    _save_state(str(out / "sparse.npz"), *refs["sparse"][:2])
    for size in (1, 4):
        for fuse in (False, True):
            with j_unique_name.guard():
                m, s, _ = R.build_fused(jfluid, fuse, size)
            _save_state(str(out / ("fused_%d_%d.npz" % (size, fuse))), m, s)
    with j_unique_name.guard():
        refs["dropout"] = R.build_pe_mlp(jfluid, dropout=0.5)
    _save_state(str(out / "dropout.npz"), *refs["dropout"][:2])
    res = R.launch(4, ["pe", "sparse", "fused", "dropout", "trainer",
                       "embedding"], str(out), timeout=300)
    return out, refs, res


def _jax_pe_ref(out, refs, name, feed, steps, table=None):
    main, startup, loss = refs[name]
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        import jax.numpy as jnp

        with np.load(out / (name + ".npz")) as z:
            for n in z.files:
                scope.set_var(n, jnp.asarray(z[n]))
    return _jax_run(main, loss, feed, steps, scope, table)


@pytest.mark.parametrize("strategy,steps", [("AllReduce", 5),
                                            ("Reduce", 4)])
def test_pe_matches_one_device(ranks, strategy, steps):
    out, refs, res = ranks
    data = R.pe_data()
    jax_one, _ = _jax_pe_ref(out, refs, "pe", data, steps)
    one, _ = _port_run(lambda: R.build_pe_mlp(tfluid), str(out / "pe.npz"),
                       data, steps)
    for rank in res["pe"]:
        assert rank["device_count"] == 4
        np.testing.assert_allclose(rank[strategy], jax_one, rtol=PE_RTOL)
        np.testing.assert_allclose(rank[strategy], one, rtol=PE_RTOL)


def test_pe_momentum_accumulators_are_dp_slices(ranks):
    got = ranks[2]["pe"][0]
    assert np.isfinite(got["momentum"]).all()
    sliced = 0
    for n, (whole, held) in got["accs"].items():
        if got["layouts"][n] == ["dp"]:
            assert held == [whole[0] // 4] + whole[1:], n
            sliced += 1
        else:
            assert held == whole, n
    assert sliced >= 2  # the [16, 32] and [32, 1] velocities


def test_pe_feed_list_remat_and_run_steps(ranks):
    got = ranks[2]["pe"][0]
    assert got["feed_list"] == pytest.approx(got["AllReduce"][0],
                                             rel=1e-6)
    np.testing.assert_allclose(got["remat"]["True"], got["remat"]["False"],
                               rtol=1e-6)
    np.testing.assert_allclose(got["run_steps"], got["AllReduce"][:3],
                               rtol=1e-6)
    # bcast_params made every rank's fc.w_0 rank 0's (each had added its
    # rank to it)
    sums = [r["bcast"] for r in ranks[2]["pe"]]
    assert sums == [sums[0]] * 4


@pytest.mark.parametrize("strategy", ["AllReduce", "Reduce"])
def test_sparse_gradients_under_dp(ranks, strategy):
    """tests/test_sparse_grad_parallel.py:41,74: each rank's ids' rows
    are concatenated over the ranks, so the replicated table (and under
    Reduce its row-sliced moments) updates as on one device."""
    out, refs, res = ranks
    feed = {"ids": R.SPARSE_IDS}
    jax_one, jt = _jax_pe_ref(out, refs, "sparse", feed, 3, "ptable")
    one, ot = _port_run(lambda: R.build_sparse(tfluid),
                        str(out / "sparse.npz"), feed, 3, "ptable")
    got = res["sparse"][0]
    for want, table in ((jax_one, jt), (one, ot)):
        np.testing.assert_allclose(got[strategy], want, rtol=1e-5)
        np.testing.assert_allclose(got[strategy + "_table"], table,
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("size", [1, 4])
def test_fused_state_pe_parity(ranks, size):
    """tests/test_fused_state.py:386: the fused flat state trains as the
    per-parameter state under both strategies. Under Reduce the flat
    moments are held as dp slices (ZeRO) when four ranks divide the
    group (484 elements: 121 a rank, each slice a tensor of its own),
    and stay whole when they do not (433), by the JAX package's rule."""
    got = ranks[2]["fused"][0]
    for strat in ("AllReduce", "Reduce"):
        np.testing.assert_allclose(got["%s_%d_1" % (strat, size)],
                                   got["%s_%d_0" % (strat, size)],
                                   rtol=2e-6, atol=0)
    np.testing.assert_allclose(got["Reduce_%d_1" % size],
                               got["AllReduce_%d_1" % size], rtol=2e-6)
    flat = got["flat_%d" % size]
    assert len(flat) == 2  # the two Adam moments
    for whole, held in flat.values():
        assert held == ([whole[0] // 4] if whole[0] % 4 == 0 else whole)
        assert whole[0] == {1: 433, 4: 484}[size]
    assert got["launches"] == 0  # CPU tensors: the plain version


def test_dropout_under_dp_equals_one_device(ranks):
    """Each rank draws its block of the whole batch's mask (the dropout
    counter offset by its first element), so the step is the one-device
    step: the ParallelExecutor and a data=4 ``shard_program`` mesh both
    follow the port's and the JAX package's one-device runs."""
    out, refs, res = ranks
    data = R.pe_data(16)
    jax_one, _ = _jax_pe_ref(out, refs, "dropout", data, 3)
    one_main = []

    def build():
        one_main.append(R.build_pe_mlp(tfluid, dropout=0.5))
        return one_main[-1]

    one, w = _port_run(build, str(out / "dropout.npz"), data, 3, "fc.w_0")
    got = res["dropout"][0]
    for how in ("pe", "plan"):
        np.testing.assert_allclose(got[how], one, rtol=1e-5)
        np.testing.assert_allclose(got[how], jax_one, rtol=1e-5)
        np.testing.assert_allclose(got[how + "_w"], w, rtol=1e-5,
                                   atol=1e-7)


def test_trainer_parallel_matches_one_process(ranks):
    got = ranks[2]["trainer"]
    rng = np.random.RandomState(4)
    batches = [[(rng.rand(16).astype("float32"),
                 rng.rand(1).astype("float32")) for _ in range(8)]
               for _ in range(4)]
    # every rank trained the same parameters
    for rank in got[1:]:
        np.testing.assert_array_equal(rank["w"], got[0]["w"])
    assert len(got[0]["losses"]) == 4 and np.isfinite(got[0]["losses"]).all()
    # one process, the same seeds: the same steps
    t = tfluid.Trainer(_train_func(),
                       lambda: tfluid.optimizer.SGD(learning_rate=0.1),
                       place=tfluid.CPUPlace())
    losses = []
    t.train(num_epochs=1, reader=lambda: iter(batches),
            feed_order=["x", "y"],
            event_handler=lambda e: losses.append(float(e.metrics[0]))
            if isinstance(e, tfluid.EndStepEvent) else None)
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-5)
    w = tfluid.fetch_var(t.train_program.all_parameters()[0].name, t.scope)
    np.testing.assert_allclose(got[0]["w"], w, rtol=1e-5, atol=1e-7)
    # Inferencer(parallel=True): each rank infers its 2 of the 8 rows,
    # and the whole prediction comes back on every rank
    x = np.random.RandomState(5).rand(8, 16).astype("float32")
    want = x @ w + tfluid.fetch_var(
        t.train_program.all_parameters()[1].name, t.scope)
    for rank in got:
        assert np.shape(rank["infer"]) == (8, 1)
        np.testing.assert_allclose(rank["infer"], want, rtol=1e-5,
                                   atol=1e-6)


def _train_func():
    def train_func():
        x = tfluid.layers.data(name="x", shape=[16], dtype="float32")
        y = tfluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = tfluid.layers.fc(input=x, size=1, act=None)
        return tfluid.layers.mean(tfluid.layers.square_error_cost(pred, y))
    return train_func


# ------------------------------------------------------------ one process


def test_transpiler_plan_specs_equal_the_jax_packages():
    import jax

    from paddle_tpu.parallel import make_mesh as j_make_mesh

    plans = {}
    for pkg, fluid, mesh in (
            ("jax", jfluid, j_make_mesh({"dp": 8},
                                        devices=jax.devices()[:8])),
            ("torch", tfluid, tfluid.make_mesh({"dp": 8},
                                               devices=range(8)))):
        guard = j_unique_name.guard if pkg == "jax" \
            else tfluid.unique_name.guard
        with guard():
            main, _, _ = R.build_sparse(fluid)
        t = fluid.DistributeTranspiler()
        plan = t.transpile(trainer_id=0, program=main, mesh=mesh)
        assert t.get_trainer_program() is main is t.get_pserver_program()
        plans[pkg] = (plan.var_specs, plan.build_strategy.reduce_strategy.name,
                      {v.name: getattr(v, "sharding_spec", None)
                       for v in main.list_vars()})
    assert plans["torch"] == plans["jax"]
    from paddle_tpu.parallel.transpiler import HashName as JH
    from paddle_tpu_torch.parallel.transpiler import HashName as TH

    eps = ["a:1", "b:2", "c:3"]
    names = ["fc.w_0", "emb", "fc.b_0", "x"]
    assert TH(eps).dispatch(names) == JH(eps).dispatch(names)


def test_init_distributed_env_contract_and_dead_coordinator(monkeypatch):
    from paddle_tpu_torch.parallel import env

    monkeypatch.setattr(env, "_initialized", False)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    env.init_distributed()  # a world of one: nothing to join
    assert env.trainer_id() == 0 and env.num_trainers() == 1
    monkeypatch.setattr(env, "_initialized", False)
    with pytest.raises(ValueError, match="one device per process"):
        env.init_distributed(local_device_count=2)
    monkeypatch.setattr(env, "_initialized", False)
    with pytest.raises(ValueError, match="PADDLE_COORDINATOR"):
        env.init_distributed(num_processes=2)
    # rank 1 of 2 against a coordinator nobody serves: two bounded
    # attempts, then the typed error
    monkeypatch.setattr(env, "_initialized", False)
    t0 = time.time()
    with pytest.raises(env.DistributedInitError) as e:
        env.init_distributed("localhost:%d" % R.free_port(), 2, 1,
                             timeout_s=1.0, max_attempts=2, backend="gloo")
    assert e.value.attempts == 2 and time.time() - t0 < 30
    import torch.distributed as dist

    assert not dist.is_initialized()


_WORKER = r"""
import json, os, sys
sys.path.insert(0, %(root)r)
import torch, torch.distributed as dist
from paddle_tpu_torch import parallel
parallel.init_distributed()
t = torch.tensor([parallel.trainer_id()])
out = [torch.zeros_like(t) for _ in range(parallel.num_trainers())]
dist.all_gather(out, t)
with open(os.path.join(sys.argv[1], "w%%d.json" %% parallel.trainer_id()),
          "w") as f:
    json.dump({"rank": parallel.trainer_id(),
               "nproc": parallel.num_trainers(),
               "allgathered": [int(x) for x in out]}, f)
"""


def test_launch_two_process_world_and_fail_fast(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER % {"root": REPO})
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.launch", "--nproc",
         "2", "--backend", "gloo", str(worker), str(tmp_path)],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    infos = [json.load(open(tmp_path / ("w%d.json" % r))) for r in (0, 1)]
    assert {i["rank"] for i in infos} == {0, 1}
    for info in infos:
        assert info["nproc"] == 2 and info["allgathered"] == [0, 1]
    bad = tmp_path / "bad.py"
    bad.write_text("import sys, time\n"
                   "if __import__('os').environ['PADDLE_TRAINER_ID'] == '1':"
                   "\n    sys.exit(3)\ntime.sleep(60)\n")
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.launch", "--nproc",
         "2", str(bad)], capture_output=True, text=True, timeout=120,
        cwd=REPO)
    assert proc.returncode == 3 and time.time() - t0 < 30


def test_remaining_refusals_name_queue_a9():
    """Ring attention, the pipeline, distributed embeddings and N->M
    restores, once refused naming Queue A 9, are ported (ranks:
    tests/test_torch_{pipeline,ring_attention,expert_parallel,
    sharded_checkpoint}.py): each builds, and off a world of ranks runs
    its plain math. What stays refused names its queue item: a mesh of
    several ranks never runs single-device in one process. The
    communication analysis, once refused naming (g3), is ported: a
    ParallelExecutor program carries no plan, so its report is planless
    (the ranks hold a plan's prediction to their collectives:
    test_prediction_agrees_with_the_ranks_collectives)."""
    from paddle_tpu_torch.models.transformer import transformer_base
    from paddle_tpu_torch.parallel.ring_attention import _plain_attention

    q = torch.randn(1, 8, 2, 4)
    mesh = tfluid.make_mesh({"sp": 4}, devices=range(4))
    torch.testing.assert_close(
        tfluid.parallel.ring_attention(q, q, q, mesh, causal=True),
        _plain_attention(q, q, q, True, None))
    for kw in ({"attn_impl": "ring"}, {"pp_encoder": True},
               {"distributed_embedding": True}):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.unique_name.guard(), \
                tfluid.program_guard(main, startup):
            _feeds, loss, _ = transformer_base(**dict(R.TB, **kw))
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        got = exe.run(main, feed=R.tb_feeds(1)[0], fetch_list=[loss],
                      scope=scope)[0]
        assert np.isfinite(got).all(), kw
    from paddle_tpu_torch import ckpt

    assert ckpt.load_checkpoint_sharded("unused") == (None, None)
    pe = tfluid.ParallelExecutor(
        main_program=R.build_pe_mlp(tfluid)[0], use_cuda=False,
        mesh=tfluid.make_mesh({"dp": 4}, devices=range(4)))
    with pytest.raises(tfluid.EnforceError, match="tools.launch"):
        pe.run(feed=R.pe_data(8), fetch_list=[])
    main = R.build_pe_mlp(tfluid)[0]
    report = tfluid.analysis.check_program(main, with_comm=True)
    assert report.ok and report.comm.planless


def test_dropout_mask_block_is_the_whole_masks():
    """A rank's block of a batch (or of a layer's columns) draws its
    block of the whole tensor's mask: the plain version at an element
    offset, and the layer op under a tensor-parallel column block."""
    from paddle_tpu_torch.ops import dropout as dr

    x = torch.randn(8, 5, 12)
    counter = torch.tensor([3], dtype=torch.int32)
    whole = dr.plain_dropout(x, 11, counter, 0.4)
    for i in range(4):
        blk = x[2 * i:2 * i + 2]
        np.testing.assert_array_equal(
            dr.plain_dropout(blk, 11, counter, 0.4, i * blk.numel()),
            whole[2 * i:2 * i + 2])
    cols = x[:, :, 4:8].contiguous()
    out, nxt = dr.dropout(cols, 11, counter, 0.4, 0, (4, 12))
    np.testing.assert_array_equal(out, whole[:, :, 4:8])
    assert int(nxt) == 4


def test_row_sharded_embedding_over_ep(ranks):
    """``sharded_lookup`` over four ``ep`` ranks, each holding 3 of the
    12 padded rows (``shard_table_rows`` as the JAX package's), is the
    whole table's lookup; each rank's table gradient counts its own
    rows' ids."""
    import jax

    from paddle_tpu.sharding import make_mesh as j_make_mesh
    from paddle_tpu.sharding import shard_table_rows as j_rows

    jm = j_make_mesh({"ep": 4}, devices=jax.devices()[:4])
    tm = tfluid.sharding.make_mesh({"ep": 4}, devices=range(4))
    for vocab in (10, 12, 1):
        assert tfluid.sharding.shard_table_rows(vocab, tm) == \
            j_rows(vocab, jm)
    ids = np.array([[0, 4, 9], [7, 7, 3]])
    for r, got in enumerate(ranks[2]["embedding"]):
        assert got["rows"] == 12 and got["held"] == [3, 3]
        np.testing.assert_array_equal(got["lookup"], got["want"])
        counts = [3 * int((ids == row).sum())
                  for row in range(3 * r, 3 * r + 3)]
        np.testing.assert_array_equal(got["grad"], counts)


# ------------------------------------------------- communication analysis


@pytest.fixture(scope="module")
def comm_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("comm_ranks")
    with j_unique_name.guard():
        m, s, _ = R.build_mlp(jfluid)
    _save_state(str(out / "mlp.npz"), m, s)
    return R.launch(2, ["comm"], str(out), timeout=240)["comm"]


def test_prediction_agrees_with_the_ranks_collectives(comm_ranks):
    """On two ranks at data=1 x fsdp=1 x tp=2 (no batch split): a
    row-parallel fc is one predicted all-reduce and one
    ``ReduceFromGroup`` all-reduce of the same bytes (the Megatron FFN
    pair). The ``tp=True`` Transformer shows the difference ROADMAP
    Queue C 2 records: its weights' ``mp`` specs are dropped on a
    training mesh (which names ``tp``) and ``pos_encoding`` has no comm
    signature, so the JAX package's prediction (and the port's) holds no
    all-reduce, while the port's runtime sums each of the five
    row-parallel fcs over ``tp`` and gathers three column-parallel
    outputs."""
    for rank in comm_ranks:
        pred = rank["ffn_pred"]
        assert len(pred) == 1 and rank["ffn_rowparallel"] == 1
        kind, reason, op_type, _var, axes, nbytes = pred[0]
        assert (kind, reason, op_type, axes) == \
            ("all-reduce", "contraction", "mul", ["tp"])
        assert rank["ffn_stats"] == {"all_reduce": [1, int(nbytes)]}
        assert nbytes == 8 * 16 * 4  # the whole [8, 16] f32 output
        assert rank["tb_pred"] == []
        assert rank["tb_rowparallel"] == 5
        assert rank["tb_stats"]["all_reduce"][0] == 5
        assert rank["tb_stats"]["all_gather"][0] == 3
    assert comm_ranks[0]["ffn_loss"] == comm_ranks[1]["ffn_loss"]
    assert comm_ranks[0]["tb_loss"] == comm_ranks[1]["tb_loss"]


def test_comm_overlap_losses_bit_equal_on_the_dp_leg(comm_ranks):
    """The MLP at data=2 with each fc output pinned to ``fsdp``: the
    analysis predicts a gather where the first pin drops the batch's
    ``data`` shard, ``comm_overlap`` widens every pin to ``("data",)``
    (gathers 1 -> 0, stamped), and five steps of the rewritten program
    give the un-rewritten program's losses bit for bit: the port's
    constraint op is the identity."""
    for rank in comm_ranks:
        plain, over = rank["overlap_0"], rank["overlap_1"]
        assert plain["before"] == plain["after"] == over["before"] \
            == {"all-gather": 1, "all-reduce": 1}
        assert over["after"] == {"all-reduce": 1}
        assert plain["specs"] == [["fsdp"]] * 4 and plain["stamp"] is None
        assert over["specs"] == [["data"]] * 4
        assert over["stamp"] == \
            "comm_overlap=comm_overlap/bs:8/iter:4/reslot:1"
        assert over["losses"] == plain["losses"]
        assert np.isfinite(plain["losses"]).all()
