"""paddle_tpu_torch.sharding against paddle_tpu.sharding.

In one process: the mesh axes, the partition rules, ``clean_spec``'s
drops, the rule digest and ``shard_program``'s annotations, constraint
ops and stamp equal the JAX package's (on its MLP and on a tiny
Transformer-base); a one-device mesh leaves a program untouched; a
program with a backward op is refused; the per-device bytes of the
liveness report divide as the JAX package's; the compile-cache stamp
moves both ways; ``save_inference_model`` strips the mesh.

On a world of four gloo ranks on the CPU (``tests/_torch_ranks.py``),
from the JAX package's start state: the MLP's 20 steps at data=2 x
fsdp=2 and fsdp=2 x tp=2, held to the JAX package's run on a mesh of
the same shape and to the port's one-process run at rtol 1e-4 (the
ranks' reductions sum in another order than one device's); moments and
AMP masters held as fsdp blocks; ``run_steps`` against step-by-step
runs; a checkpoint round trip; the tensor-parallel Transformer-base
(``tp=True``) at data=2 x tp=2 for 10 steps, its attention on each
rank's heads, and on a dp=2 x mp=2 mesh, its weights held as blocks no
collective ever handles whole; and a loss term on the parameters alone
counted once at data=4.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import sharding as jsh
from paddle_tpu.core import unique_name as j_unique_name
from paddle_tpu_torch import sharding as tsh

import _torch_ranks as R

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6


def _jax_devices(n):
    import jax

    if len(jax.devices()) < n:
        pytest.skip("needs %d virtual devices" % n)
    return jax.devices()[:n]


def _meshes(**kw):
    n = int(np.prod(list(kw.values())))
    return (jsh.training_mesh(devices=_jax_devices(n), **kw),
            tsh.training_mesh(devices=range(n), **kw))


# ------------------------------------------------------------ pure logic


def test_mesh_rules_clean_spec_and_digest_equal_the_jax_packages():
    jm, tm = _meshes(data=2, fsdp=2, tp=2)
    assert tm.axis_names == jm.axis_names == ("data", "fsdp", "tp")
    assert tm.shape == jm.shape and tm.size() == jm.size() == 8
    assert tm.batch_size_multiple() == jm.batch_size_multiple() == 4
    rules = [(r"w_special", ("tp", None)), (r"\.w_", ("fsdp", "tp")),
             (r".*", ())]
    for name, shape in (("fc.w_0", (32, 32)), ("w_special", (32, 32)),
                        ("fc.w_0", ()), ("fc.w_0", (1,)), ("bias", (4,))):
        for rs in (rules, rules[:2]):
            assert tsh.match_partition_rules(rs, name, shape) == \
                jsh.match_partition_rules(rs, name, shape)
    from paddle_tpu.sharding.rules import dropped_axes as j_dropped
    from paddle_tpu_torch.sharding.rules import dropped_axes as t_dropped

    for spec, shape in ((("nope", "tp"), (8, 8)), (("fsdp",), (7,)),
                        (("fsdp", "tp", "data"), (8, 8)),
                        ((("data", "fsdp"),), (8,)),
                        ((("data", "fsdp"),), (6,)), (("fsdp", "tp"), (8, 8)),
                        (("tp", None), (5, 4)), ((), None)):
        assert tsh.clean_spec(tm, spec, shape) == \
            jsh.clean_spec(jm, spec, shape)
        assert t_dropped(tm, spec, shape) == j_dropped(jm, spec, shape)
        assert tsh.shard_count(tm, spec, shape) == \
            jsh.shard_count(jm, spec, shape)
        assert tsh.resolve_sharding(tm, spec, shape).spec == \
            tuple(jsh.resolve_sharding(jm, spec, shape).spec)
    assert tsh.default_rules() == jsh.default_rules()
    for rs in (rules, rules[::-1], tsh.default_rules()):
        assert tsh.rules_digest(rs) == jsh.rules_digest(rs)
    lay_t, lay_j = tsh.SpecLayout(), jsh.SpecLayout()
    for m in ("batch", "embeddings", "column_parallel", "row_parallel",
              "bias"):
        assert getattr(lay_t, m)() == getattr(lay_j, m)()
    assert tm.data_sharding(3).spec == tuple(jm.data_sharding(3).spec)
    assert tm.sharding("fsdp", "nope").spec == \
        tuple(jm.sharding("fsdp", "nope").spec)
    for kw in ({"data": -1, "tp": -1}, {"data": 3, "fsdp": -1},
               {"data": 3}):
        with pytest.raises(ValueError) as te:
            tsh.make_mesh(kw, devices=range(8))
        with pytest.raises(ValueError) as je:
            jsh.make_mesh(kw, devices=_jax_devices(8))
        assert str(te.value) == str(je.value)
    assert tsh.make_mesh({"tp": 2, "dp": -1}, devices=range(8)).shape == \
        jsh.make_mesh({"tp": 2, "dp": -1}, devices=_jax_devices(8)).shape


def _mlp_program(fluid, guard, mesh=None, rules=None):
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[-1, 16], dtype="float32",
                              append_batch_size=False)
        y = fluid.layers.data(name="y", shape=[-1, 1], dtype="float32",
                              append_batch_size=False)
        h = fluid.layers.fc(x, size=32, act="relu")
        h = fluid.layers.fc(h, size=32, act="relu")
        pred = fluid.layers.fc(h, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        if mesh is not None:
            fluid.sharding.shard_program(main, mesh, rules=rules)
    return main, startup, loss


def _tb_program(pkg, mesh):
    from paddle_tpu.models.transformer import transformer_base as jtb
    from paddle_tpu_torch.models.transformer import transformer_base as ttb

    fluid, tb = (jfluid, jtb) if pkg == "jax" else (tfluid, ttb)
    return R.build_tb(fluid, tb,
                      shard=lambda m: fluid.sharding.shard_program(m, mesh))


def _annotations(main):
    gb = main.global_block()
    return ({p.name: getattr(p, "sharding_spec", None)
             for p in main.all_parameters()},
            [(op.type, op.input_arg_names, op.attrs.get("spec"))
             for op in gb.ops if op.type == "sharding_constraint"],
            main._sharding_stamp, main._sharding_constraint_count)


@pytest.mark.parametrize("model", ["mlp", "tb"])
def test_shard_program_annotations_constraints_and_stamp(model):
    jm, tm = _meshes(data=2, fsdp=2, tp=2)
    if model == "mlp":
        rules = tsh.default_rules()
        rules.insert(0, (r"fc\.tmp_\d+$", (("data", "fsdp"),)))
        jmain = _mlp_program(jfluid, j_unique_name.guard, jm, rules)[0]
        tmain = _mlp_program(tfluid, tfluid.unique_name.guard, tm, rules)[0]
    else:
        jmain, tmain = _tb_program("jax", jm)[0], _tb_program("torch", tm)[0]
    ja, ta = _annotations(jmain), _annotations(tmain)
    assert ta == ja
    assert ta[3] == len(ta[1]) and (model == "tb" or ta[3] > 0)
    assert tmain._sharding_stamp.startswith("mesh:data=2,fsdp=2,tp=2/")
    clone = tmain.clone()
    assert clone._sharding_plan is tmain._sharding_plan
    assert clone._sharding_stamp == tmain._sharding_stamp
    # the plan resolves every persistable as the JAX package's does
    jp, tp = jmain._sharding_plan, tmain._sharding_plan
    for v in tmain.list_vars():
        if v.persistable and v.shape is not None:
            jv = jmain.global_block()._find_var_recursive(v.name)
            assert tp.spec_for(v, v.name) == jp.spec_for(jv, v.name), v.name


def test_one_device_mesh_leaves_the_program_untouched_and_backward_refused():
    from paddle_tpu_torch.compile_cache.fingerprint import CompilationUnit

    main, _, loss = _mlp_program(tfluid, tfluid.unique_name.guard)
    desc = CompilationUnit(main, ("x", "y"), (loss.name,)).desc
    v0, n0 = main._version, len(main.global_block().ops)
    for mesh in (tsh.make_mesh({"data": 1}, devices=[0]), None):
        assert tsh.shard_program(main, mesh) is main
    assert main._version == v0 and len(main.global_block().ops) == n0
    assert not hasattr(main, "_sharding_stamp")
    assert CompilationUnit(main, ("x", "y"), (loss.name,)).desc == desc
    from paddle_tpu_torch.executor import _sharding_config

    assert _sharding_config(main) == {}
    with tfluid.unique_name.guard(), tfluid.program_guard(main):
        tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    with pytest.raises(tfluid.EnforceError, match="append_backward"):
        tsh.shard_program(main, tsh.training_mesh(devices=range(4)))


def test_per_device_bytes_divide_as_the_jax_packages():
    jm, tm = _meshes(data=2, fsdp=2, tp=2)
    reps = {}
    for pkg, fluid, guard, mesh in (
            ("jax", jfluid, j_unique_name.guard, jm),
            ("torch", tfluid, tfluid.unique_name.guard, tm)):
        main, startup, loss = _mlp_program(fluid, guard, mesh)
        with guard(), fluid.program_guard(main, startup):
            fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
        reps[pkg] = fluid.analysis.analyze_liveness(main, assume_batch=8)
    j, t = reps["jax"], reps["torch"]
    assert t.sharded and t.n_shards == j.n_shards == 8
    for n in ("fc.w_0", "fc.w_0_moment1_0", "fc.w_0_moment2_0", "fc.b_0"):
        assert (t.lives[n].shard_count, t.lives[n].device_bytes) == \
            (j.lives[n].shard_count, j.lives[n].device_bytes), n
    assert t.lives["fc.w_0"].device_bytes == t.lives["fc.w_0"].bytes // 4
    assert t.persistable_device_bytes == j.persistable_device_bytes
    assert t.persistable_device_bytes < t.persistable_bytes


def test_cache_stamp_moves_both_ways():
    from paddle_tpu_torch.compile_cache.fingerprint import CompilationUnit
    from paddle_tpu_torch.compile_cache.runtime import _program_stamps
    from paddle_tpu_torch.executor import _sharding_config

    g = tfluid.unique_name.guard
    mesh8 = tsh.training_mesh(data=2, fsdp=2, tp=2, devices=range(8))
    a = _mlp_program(tfluid, g, mesh8)[0]
    b = _mlp_program(tfluid, g, mesh8,
                     [(r"fc\.w_\d+", ("tp", "fsdp")), (r".*", ())])[0]
    c = _mlp_program(tfluid, g, tsh.make_mesh({"data": 4, "fsdp": 2},
                                              devices=range(8)))[0]
    plain, _, loss = _mlp_program(tfluid, g)
    stamps = {a._sharding_stamp, b._sharding_stamp, c._sharding_stamp}
    assert len(stamps) == 3
    assert _sharding_config(plain) == {} and "sharding" not in \
        _program_stamps(plain)
    assert _sharding_config(a) == {"sharding": a._sharding_stamp} == \
        {"sharding": _program_stamps(a)["sharding"]}
    jm = jsh.training_mesh(data=2, fsdp=2, tp=2, devices=_jax_devices(8))
    ja = _mlp_program(jfluid, j_unique_name.guard, jm)[0]
    assert a._sharding_stamp == ja._sharding_stamp
    feed = {"x": ((8, 16), torch.float32), "y": ((8, 1), torch.float32)}

    def fp(p):
        return CompilationUnit(p, ("x", "y"), (loss.name,)).fingerprint(
            feed, {}, {"kind": "graph", **_program_stamps(p)})

    assert len({fp(a), fp(b), fp(c), fp(plain)}) == 4
    assert fp(plain) == CompilationUnit(
        plain, ("x", "y"), (loss.name,)).fingerprint(feed, {},
                                                     {"kind": "graph"})


def test_save_inference_model_strips_the_mesh(tmp_path):
    mesh = tsh.training_mesh(data=2, fsdp=2, tp=1, devices=range(4))
    main, startup, loss = _mlp_program(tfluid, tfluid.unique_name.guard,
                                       mesh)
    gb = main.global_block()
    pred = next(op for op in gb.ops
                if op.type == "square_error_cost").input_arg_names[0]
    place = tfluid.CPUPlace()
    scope = tfluid.Scope()
    exe = tfluid.Executor(place)
    exe.run(startup, scope=scope)
    tfluid.io.save_inference_model(str(tmp_path), ["x"], [gb.var(pred)],
                                   exe, main_program=main, scope=scope)
    assert getattr(main, "_sharding_plan", None) is not None
    manifest = json.load(open(tmp_path / "__model__.json"))
    assert not [o for o in manifest["ops"]
                if o["type"] == "sharding_constraint"]
    # a program over several ranks does not run single-device in this
    # process: it says how to start the ranks
    x = np.random.RandomState(0).rand(4, 16).astype("float32")
    with pytest.raises(tfluid.EnforceError, match="tools.launch"):
        exe.run(main, feed={"x": x, "y": x[:, :1]}, fetch_list=[loss],
                scope=scope)
    plain, _, _ = _mlp_program(tfluid, tfluid.unique_name.guard)
    want = exe.run(plain, feed={"x": x, "y": x[:, :1]}, fetch_list=[pred],
                   scope=scope)[0]
    scope2 = tfluid.Scope()
    loaded, feeds, fetches = tfluid.io.load_inference_model(
        str(tmp_path), exe, scope=scope2, program=plain)
    assert getattr(loaded, "_sharding_plan", None) is None
    got = exe.run(loaded, feed={"x": x}, fetch_list=fetches,
                  scope=scope2)[0]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ four ranks


def _save_state(path, main, startup, scope=None):
    """The JAX package's start state of ``main`` into ``path``."""
    scope = scope or jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    np.savez(path, **{v.name: np.asarray(scope.find_var(v.name))
                      for v in main.list_vars()
                      if v.persistable and scope.find_var(v.name)
                      is not None})
    return scope


def _jax_losses(main, loss, feeds, scope):
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        return [float(exe.run(main, feed=f, fetch_list=[loss.name])[0])
                for f in feeds]


def _port_losses(build, state_path, feeds):
    main, startup, loss = build()
    exe, scope = R._start(tfluid, main, startup, state_path)
    return R._losses(exe, main, loss, feeds, scope)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharding_ranks")
    refs = {}
    for name, kw in (("mlp", {}), ("mlp9", {"seed": 9}),
                     ("mlp_amp", {"use_amp": True})):
        with j_unique_name.guard():
            m, s, loss = R.build_mlp(jfluid, **kw)
        scope = _save_state(str(out / (name + ".npz")), m, s)
        refs[name] = (m, loss, scope)
    from paddle_tpu.models.transformer import transformer_base as jtb

    m, s, cost = R.build_tb(jfluid, jtb, tp=True)
    refs["tb"] = (m, cost, _save_state(str(out / "tb.npz"), m, s))
    m, s, cost = R.build_tb(jfluid, jtb)
    refs["tb_plain"] = (m, cost, _save_state(str(out / "tb_plain.npz"), m,
                                             s))
    m, s, cost = R.build_tb(jfluid, jtb, tp=True, opt="sgd", **R.TB_MP)
    refs["tb_mp"] = (m, cost, _save_state(str(out / "tb_mp.npz"), m, s))
    with j_unique_name.guard():
        m, s, loss = R.build_penalty(jfluid)
    refs["penalty"] = (m, loss, _save_state(str(out / "penalty.npz"), m, s))
    res = R.launch(4, ["mlp_data_fsdp", "mlp_fsdp_tp", "run_steps", "amp",
                       "ckpt", "tb_tp", "tb_mp", "penalty", "tb_ragged"],
                   str(out), timeout=300)
    return out, refs, res


@pytest.mark.parametrize("scenario,mesh", [
    ("mlp_data_fsdp", dict(data=2, fsdp=2, tp=1)),
    ("mlp_fsdp_tp", dict(data=1, fsdp=2, tp=2))])
def test_mlp_20_steps_match_the_jax_mesh_run_and_one_process(ranks, scenario,
                                                            mesh):
    out, refs, res = ranks
    feeds = R.mlp_feeds(20)
    jm = jsh.training_mesh(devices=_jax_devices(4), **mesh)
    with j_unique_name.guard():
        main, startup, loss = R.build_mlp(jfluid, mesh=jm)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        import jax.numpy as jnp

        with np.load(out / "mlp.npz") as z:
            for n in z.files:
                scope.set_var(n, jnp.asarray(z[n]))
    jax_mesh = _jax_losses(main, loss, feeds, scope)
    one = _port_losses(lambda: R.build_mlp(tfluid), str(out / "mlp.npz"),
                       feeds)
    for rank in res[scenario]:  # every rank fetches the same losses
        np.testing.assert_allclose(rank["losses"], jax_mesh, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(rank["losses"], one, rtol=RTOL,
                                   atol=ATOL)
        assert np.isfinite(rank["odd_loss"])  # indivisible batch: whole
    # fc.w_0 [16, 32] and its moments: blocks of (fsdp, tp)
    want = [8, 32] if mesh["tp"] == 1 else [8, 16]
    shapes = res[scenario][0]["shapes"]
    assert shapes["fc.w_0"] == want
    assert [s for n, s in shapes.items() if "moment" in n] == [want, want]


def test_run_steps_matches_per_step_runs(ranks):
    res = ranks[2]["run_steps"][0]
    np.testing.assert_allclose(res["run_steps"], res["run"], rtol=1e-6,
                               atol=1e-7)


def test_amp_masters_and_moments_are_fsdp_blocks(ranks):
    """The f32 masters and moments are fsdp blocks. AMP's losses are held
    at the JAX test's own bar (rtol 0.05, atol 1e-3, mean relative
    0.01), not 1e-4: the bf16 working copies round every product, so
    another order of the reductions (the ranks' sums; the JAX package's
    XLA fusions) moves roundings, by ~0.2 % between the port's sharded
    and one-process runs after 8 steps and ~1 % against the JAX
    package."""
    out, refs, res = ranks
    m, loss, scope = refs["mlp_amp"]
    feeds = R.mlp_feeds(8)
    jax_one = _jax_losses(m, loss, feeds, scope)
    one = _port_losses(lambda: R.build_mlp(tfluid, use_amp=True),
                       str(out / "mlp_amp.npz"), feeds)
    got = res["amp"][0]
    assert got["stamps"] == [True, True]
    assert got["master"] == ["torch.float32", [8, 32]]
    assert got["moment"] == ["torch.float32", [8, 32]]
    for want in (one, jax_one):
        np.testing.assert_allclose(got["losses"], want, rtol=0.05,
                                   atol=1e-3)
        rel = np.abs(np.subtract(got["losses"], want)) / np.abs(want)
        assert rel.mean() < 0.01, rel


def test_sharded_checkpoint_round_trip(ranks):
    got = ranks[2]["ckpt"][0]
    assert got["restored"] and got["whole"] == [16, 32]
    assert got["placed"] == [8, 32]  # the restore put the block back
    np.testing.assert_allclose(got["resumed"], got["ref"][3:], rtol=1e-5,
                               atol=1e-7)


def test_tensor_parallel_transformer_matches_the_jax_mesh_run(ranks):
    """TB with ``tp=True`` at data=2 x tp=2: each rank runs one of the two
    heads (the flash path's plain version sees H=1), and the 10 losses
    follow the JAX package's run on a data=2 x tp=2 mesh (where the
    ``mp`` specs find no axis and stay replicated) within rtol 1e-4."""
    out, refs, res = ranks
    from paddle_tpu.models.transformer import transformer_base as jtb

    jm = jsh.training_mesh(data=2, fsdp=1, tp=2, devices=_jax_devices(4))
    main, startup, cost = R.build_tb(
        jfluid, jtb, tp=True,
        shard=lambda m: jfluid.sharding.shard_program(m, jm))
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        import jax.numpy as jnp

        with np.load(out / "tb.npz") as z:
            for n in z.files:
                scope.set_var(n, jnp.asarray(z[n]))
    want = _jax_losses(main, cost, R.tb_feeds(10), scope)
    for rank in res["tb_tp"]:
        assert rank["heads"] == [1]
        np.testing.assert_allclose(rank["losses"], want, rtol=RTOL,
                                   atol=ATOL)
    assert res["tb_tp"][0]["losses"][-1] < res["tb_tp"][0]["losses"][0]


def _jax_mesh_losses(build, mesh, state_path, feeds):
    """The JAX package's losses of ``build(mesh)`` on ``mesh`` from the
    start state saved at ``state_path``."""
    import jax.numpy as jnp

    main, startup, loss = build(mesh)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        with np.load(state_path) as z:
            for n in z.files:
                scope.set_var(n, jnp.asarray(z[n]))
    return _jax_losses(main, loss, feeds, scope)


def test_tensor_parallel_weights_stay_blocks_on_an_mp_mesh(ranks):
    """TB with ``tp=True`` (SGD) on a dp=2 x mp=2 mesh, where the ``mp``
    specs shard every attention and FFN weight and the vocabulary
    projection: each rank holds its half of each weight, no all-gather
    or all-reduce of a step ever handles one whole (the forward reads
    the block, its gradient is the block's), and the 4 losses follow the
    JAX package's run on the same mesh and the port's one-process run
    at rtol 1e-4."""
    out, refs, res = ranks
    from paddle_tpu.models.transformer import transformer_base as jtb
    from paddle_tpu_torch.models.transformer import transformer_base as ttb

    feeds = R.tb_feeds(4)
    jm = jsh.make_mesh({"dp": 2, "mp": 2}, devices=_jax_devices(4))
    want = _jax_mesh_losses(
        lambda mesh: R.build_tb(
            jfluid, jtb, tp=True, opt="sgd", **R.TB_MP,
            shard=lambda m: jfluid.sharding.shard_program(m, mesh)),
        jm, str(out / "tb_mp.npz"), feeds)
    one = _port_losses(lambda: R.build_tb(tfluid, ttb, tp=True, opt="sgd",
                                          **R.TB_MP),
                       str(out / "tb_mp.npz"), feeds)
    for rank in res["tb_mp"]:
        weights = rank["weights"]
        assert len(weights) == 17  # 6 encoder, 10 decoder, vocabulary
        for name, (whole, held) in weights.items():
            assert int(np.prod(held)) * 2 == int(np.prod(whole)), name
        wholes = {tuple(w) for w, _ in weights.values()}
        handled = {tuple(shape) for _, shape in rank["seen"]}
        assert not wholes & handled, sorted(wholes & handled)
        assert {op for op, _ in rank["seen"]} == {"all_gather",
                                                  "all_reduce"}
        np.testing.assert_allclose(rank["losses"], want, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(rank["losses"], one, rtol=RTOL,
                                   atol=ATOL)


def test_parameter_only_loss_term_counts_once_under_data_parallelism(ranks):
    """loss = mean error + 0.05 * sum(w0^2) at data=4 (SGD): every rank
    computes the penalty alike, and its gradient counts once, not four
    times, so the 10 losses follow the JAX package's run on the same
    mesh, its one-device run and the port's one-process run at rtol
    1e-4."""
    out, refs, res = ranks
    feeds = R.mlp_feeds(10)
    m, loss, scope = refs["penalty"]
    jax_one = _jax_losses(m, loss, feeds, scope)
    jm = jsh.training_mesh(data=4, fsdp=1, tp=1, devices=_jax_devices(4))

    def build(mesh):
        with j_unique_name.guard():
            return R.build_penalty(jfluid, mesh=mesh)

    jax_mesh = _jax_mesh_losses(build, jm, str(out / "penalty.npz"), feeds)
    one = _port_losses(lambda: R.build_penalty(tfluid),
                       str(out / "penalty.npz"), feeds)
    for want in (jax_mesh, jax_one, one):
        for rank in res["penalty"]:
            np.testing.assert_allclose(rank["losses"], want, rtol=RTOL,
                                       atol=ATOL)


def test_token_weighted_loss_over_ragged_blocks_is_the_whole_batchs(ranks):
    """TB at data=2 x fsdp=2 on batches whose rows hold 1-8 tokens: each
    rank's block carries another token count, and the loss (a sum over
    tokens over their count) is the whole batch's on every rank — its
    sums added over the ranks, then its gradients — so the 5 losses
    follow the JAX package's one-device run and the port's one-process
    run at rtol 1e-4, not a mean of the ranks' means."""
    out, refs, res = ranks
    feeds = R.tb_feeds(5, ragged=True)
    m, cost, scope = refs["tb_plain"]
    jax_one = _jax_losses(m, cost, feeds, scope)
    from paddle_tpu_torch.models.transformer import transformer_base as ttb

    one = _port_losses(lambda: R.build_tb(tfluid, ttb),
                       str(out / "tb_plain.npz"), feeds)
    for rank in res["tb_ragged"]:
        np.testing.assert_allclose(rank["losses"], jax_one, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(rank["losses"], one, rtol=RTOL,
                                   atol=ATOL)
