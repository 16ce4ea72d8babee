"""paddle_tpu_torch.amp held to paddle_tpu.amp (mirrors tests/test_amp.py).

* The policy: the three default lists and the fingerprint equal the JAX
  package's, byte for byte; every op type classifies alike.
* ``rewrite_program`` on the MLP of tests/test_amp.py and on a
  Transformer at bench_amp.py's CPU config (1 layer, d_model 64, vocab
  500; bench_amp.py:108-110) gives the JAX rewrite's ops (types, inputs
  and outputs, so the same cast positions), symbol table (every var's
  dtype) and ``_amp_cast_count``; an inserted cast rounds a bf16 tie to
  even, as ``astype`` does.
* ``decorate(Adam)`` trains the same Transformer 20 steps in both
  packages from the JAX package's start state: losses within rtol 3e-3
  (bf16 compute on both sides; the bf16 matmuls of XLA's CPU backend
  and torch's round their sums at other places, and the loss moves by
  up to ~1e-3 of itself over the steps); masters and moments stay f32.
* The dynamic scaler's skip-and-recover sequence of
  ``test_scaler_skips_injected_overflow_then_recovers``: the same scale
  trajectory in both packages, the overflowed step bit-unchanged
  (parameters, moments, beta powers), and the losses of both within
  rtol 1e-2 (an MLP with bf16 matmuls, step after step).
* A skipped step leaves everything bit-unchanged under
  ``fuse_optimizer_state`` (the flat buffers, through the gated group
  op) and with row-sparse embeddings (the table and its moments,
  through the gated lazy row updates of SGD, Adagrad and Adam).
* The checkpoint tests of tests/test_amp.py:305-447: a resume is
  bit-exact with an uninterrupted run, every persistable is saveable
  before the first step, an AMP checkpoint loads into a non-AMP
  program; and a checkpoint the JAX package wrote continues in the port
  within rtol 2e-2 of the JAX package's own continuation (bf16 matmuls
  at lr 0.05 part by 0.2 % at the first step, by 1 % at the third).
* Serving: a rewritten inference program drives ``BucketedEngine``
  (within 5e-2 of the f32 program, as tests/test_amp.py holds it), and
  ``derive_decode_programs`` after the rewrite makes bf16 pools whose
  streams are the JAX package's.
* Default-off leaves programs untouched; the ``amp_bf16`` pass stamps
  as the direct call does; the static tier checks a decorated program
  clean and costs every amp op.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import amp as j_amp
from paddle_tpu.core import unique_name as j_unique_name
from paddle_tpu.models.transformer import transformer_base as j_transformer
from paddle_tpu_torch import amp as t_amp
from paddle_tpu_torch.models.transformer import \
    transformer_base as t_transformer

from _torch_port import _flags, symbol_table

torch.set_num_threads(1)

CPU = tfluid.CPUPlace()
# bench_amp.py's CPU config (bench_amp.py:108-110)
TB = dict(src_vocab_size=500, trg_vocab_size=500, max_length=16, n_layer=1,
          n_head=2, d_model=64, d_inner_hid=128, dropout_rate=0.0)
TB_B, TB_T = 2, 16


def _pkg(name):
    return ((jfluid, j_unique_name.guard, j_transformer) if name == "jax"
            else (tfluid, tfluid.unique_name.guard, t_transformer))


def _mlp_forward(fluid, with_softmax=False):
    x = fluid.layers.data(name="x", shape=[-1, 8], dtype="float32",
                          append_batch_size=False)
    h = fluid.layers.fc(x, size=16, act="relu")
    pred = fluid.layers.fc(h, size=4)
    return fluid.layers.softmax(pred) if with_softmax else pred


def _mlp_train(fluid):
    x = fluid.layers.data(name="x", shape=[-1, 8], dtype="float32",
                          append_batch_size=False)
    y = fluid.layers.data(name="y", shape=[-1, 1], dtype="float32",
                          append_batch_size=False)
    h = fluid.layers.fc(x, size=16, act="relu")
    pred = fluid.layers.fc(h, size=1)
    return fluid.layers.mean(fluid.layers.square_error_cost(pred, y))


def _mlp_feeds(steps, seed=3):
    rng = np.random.RandomState(seed)
    return [{"x": rng.rand(4, 8).astype("float32"),
             "y": rng.rand(4, 1).astype("float32")} for _ in range(steps)]


def _tb_feeds(steps, seed=0):
    rng = np.random.RandomState(seed)
    ids = lambda: rng.randint(1, 500, (TB_B, TB_T)).astype(  # noqa: E731
        "int64")
    return [{"src_word": ids(), "trg_word": ids(), "lbl_word": ids(),
             "src_mask": np.ones((TB_B, TB_T), "float32"),
             "trg_mask": np.ones((TB_B, TB_T), "float32")}
            for _ in range(steps)]


def _ops(program):
    return [(op.type, op.input_arg_names, op.output_arg_names)
            for op in program.global_block().ops]


def _jax_state(main, startup):
    """The JAX package's initialized persistables (name -> array)."""
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    return {v.name: np.asarray(scope.find_var(v.name))
            for v in main.list_vars() if v.persistable}


def _port_scope(main, startup, state):
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    tfluid.state_from_numpy(state, scope, CPU, program=main)
    return scope, exe


# ---------------------------------------------------------------- policy


def test_policy_lists_and_fingerprint_equal_the_jax_package():
    assert t_amp.DEFAULT_ALLOW == j_amp.DEFAULT_ALLOW
    assert t_amp.DEFAULT_DENY == j_amp.DEFAULT_DENY
    assert t_amp.DEFAULT_INFER == j_amp.DEFAULT_INFER
    kws = [{}, {"extra_allow": ["my_fused_op"],
                "extra_deny": ["elementwise_add"],
                "default_action": "infer"},
           {"extra_deny": ["conv2d"], "extra_infer": ["softmax"]},
           {"allow": ["mul"], "deny": ["softmax"], "infer": []}]
    ops = sorted(j_amp.DEFAULT_ALLOW | j_amp.DEFAULT_DENY
                 | j_amp.DEFAULT_INFER) + ["my_fused_op", "never_heard"]
    for kw in kws:
        tp, jp = t_amp.AmpPolicy(**kw), j_amp.AmpPolicy(**kw)
        assert tp.fingerprint() == jp.fingerprint()
        assert [tp.classify(o) for o in ops] == [jp.classify(o)
                                                 for o in ops]
        assert repr(tp) == repr(jp)
    assert t_amp.AmpPolicy().classify("never_heard") == "deny"
    with pytest.raises(ValueError, match="more than one extra_"):
        t_amp.AmpPolicy(extra_allow=["x_op"], extra_deny=["x_op"])


# ---------------------------------------------------------------- rewrite


def _forward(name, model):
    fluid, guard, transformer = _pkg(name)
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        if model == "transformer":
            _, out, _ = transformer(**TB)
        else:
            out = _mlp_forward(fluid, with_softmax=model == "mlp_softmax")
    return main, startup, out


@pytest.mark.parametrize("model", ["mlp", "mlp_softmax", "transformer"])
def test_rewrite_matches_the_jax_rewrite(model):
    progs = {}
    for name, amp in (("jax", j_amp), ("torch", t_amp)):
        main, _, _ = _forward(name, model)
        amp.rewrite_program(main)
        progs[name] = main
    jm, tm = progs["jax"], progs["torch"]
    assert _ops(tm) == _ops(jm)
    assert symbol_table(tm) == symbol_table(jm)
    assert tm._amp_cast_count == jm._amp_cast_count > 0
    assert tm._amp_stamp == jm._amp_stamp
    assert tm.clone()._amp_stamp == tm._amp_stamp
    types = [op.type for op in tm.global_block().ops]
    assert types.count("amp_cast_params") == 1
    # no cast chains: no inserted cast reads another cast's output
    casts = [op for op in tm.global_block().ops
             if op.type == "cast" and op.attrs.get("_amp_inserted")]
    outs = {n for op in casts for n in op.output_arg_names}
    assert not any(n in outs for op in casts for n in op.input_arg_names)
    # a second pass finds nothing left to cast, in both packages
    for amp, prog in ((j_amp, jm), (t_amp, tm)):
        amp.rewrite_program(prog)
        assert prog._amp_cast_count == 0


def test_rewritten_mlp_runs_and_checks_clean():
    main, startup, sm = _forward("torch", "mlp_softmax")
    t_amp.rewrite_program(main)
    report = tfluid.analysis.check_program(main, feed=("x",),
                                           fetch_list=[sm.name])
    assert not report.diagnostics, str(report)
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    out, = exe.run(main, feed={"x": np.ones((2, 8), "float32")},
                   fetch_list=[sm], scope=scope)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out.sum(1), 1.0, rtol=1e-3)


def test_inserted_cast_rounds_to_nearest_even():
    import jax.numpy as jnp

    main, _, _ = _forward("torch", "mlp")
    t_amp.rewrite_program(main)
    cast = next(op for op in main.global_block().ops
                if op.type == "cast" and op.attrs.get("_amp_inserted"))
    # ties between two bf16 values (1 + 2^-8 lies halfway between 1 and
    # 1 + 2^-7) round to the even one; off-tie values to the nearest
    x = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8),
                  1 + 2 ** -8 + 2 ** -20, 3.0e38, 1e-40], np.float32)
    got = cast.fn(torch.from_numpy(x)).float().numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(
        jnp.float32))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:3], [1.0, 1 + 2 ** -6, -1.0])
    params = next(op for op in main.global_block().ops
                  if op.type == "amp_cast_params")
    got, = params.fn(torch.from_numpy(x))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_rewrite_refuses_a_program_with_backward():
    fluid = tfluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = _mlp_train(fluid)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    with pytest.raises(tfluid.EnforceError, match="amp.decorate"):
        t_amp.rewrite_program(main)
    ga = tfluid.optimizer.GradientAccumulation(
        tfluid.optimizer.Adam(learning_rate=0.01), accumulate_steps=4)
    with pytest.raises(tfluid.EnforceError, match="minimize"):
        t_amp.decorate(ga)


def test_rewrite_retrofits_a_build_time_bf16_stream():
    flags = {"use_bfloat16": True, "bf16_activations": True}
    progs = {}
    for name, amp in (("jax", j_amp), ("torch", t_amp)):
        with _flags(name, flags):
            main, _, _ = _forward(name, "mlp_softmax")
        amp.rewrite_program(main)
        progs[name] = main
    assert _ops(progs["torch"]) == _ops(progs["jax"])
    assert symbol_table(progs["torch"]) == symbol_table(progs["jax"])
    gb = progs["torch"].global_block()
    sm = next(op for op in gb.ops if op.type == "softmax")
    assert tfluid.core.dtype_utils.name(
        gb.var(sm.input_arg_names[0]).dtype) == "float32"


# -------------------------------------------------------------- decorate


def _decorated(name, build, **amp_kw):
    fluid, guard, transformer = _pkg(name)
    amp = j_amp if name == "jax" else t_amp
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 5
    with guard(), fluid.program_guard(main, startup):
        loss = build(fluid, transformer)
        opt = amp.decorate(fluid.optimizer.Adam(
            learning_rate=amp_kw.pop("lr", 0.05)), **amp_kw)
        opt.minimize(loss)
    return main, startup, loss, opt


def _tb_loss(fluid, transformer):
    return transformer(**TB)[1]


def _mlp_loss(fluid, transformer):
    return _mlp_train(fluid)


def test_decorate_trains_the_transformer_like_the_jax_package():
    jm, js, jl, _ = _decorated("jax", _tb_loss, lr=1e-3)
    tm, ts, tl, _ = _decorated("torch", _tb_loss, lr=1e-3)
    assert _ops(tm) == _ops(jm)
    assert symbol_table(tm) == symbol_table(jm)
    state = _jax_state(jm, js)
    feeds = _tb_feeds(20)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        for n, a in state.items():
            scope.set_var(n, a)
        j_losses = [float(exe.run(jm, feed=f, fetch_list=[jl.name])[0])
                    for f in feeds]
    scope, exe = _port_scope(tm, ts, state)
    t_losses = [float(exe.run(tm, feed=f, fetch_list=[tl], scope=scope)[0])
                for f in feeds]
    np.testing.assert_allclose(t_losses, j_losses, rtol=3e-3)
    # masters and moments stay f32 under amp
    for v in tm.list_vars():
        if v.persistable and (isinstance(v, tfluid.Parameter)
                              or "moment" in v.name or "pow" in v.name):
            assert scope.get(v.name).dtype == torch.float32, v.name


def _overflow_run(name, state, feeds, at=3, **amp_kw):
    """Losses and scales of the MLP under ``decorate(Adam)`` with the
    injected overflow of tests/test_amp.py at step ``at``, and the port's
    state around that step."""
    main, startup, loss, opt = _decorated(name, _mlp_loss, **amp_kw)
    losses, scales, flags = [], [], []
    around = {}
    if name == "jax":
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            exe = jfluid.Executor(jfluid.CPUPlace())
            exe.run(startup)
            for n, a in state.items():
                scope.set_var(n, a)
            for i, f in enumerate(feeds):
                if i == at:
                    f = dict(f, x=np.full((4, 8), 1e30, "float32"))
                losses.append(float(exe.run(main, feed=f,
                                            fetch_list=[loss.name])[0]))
                scales.append(opt.get_loss_scaling(scope))
                flags.append(opt.found_overflow(scope))
        return main, losses, scales, flags, around
    scope, exe = _port_scope(main, startup, state)
    watched = [v.name for v in main.list_vars() if v.persistable and (
        isinstance(v, tfluid.Parameter) or "moment" in v.name
        or "pow" in v.name)]
    for i, f in enumerate(feeds):
        if i == at:
            f = dict(f, x=np.full((4, 8), 1e30, "float32"))
            around["before"] = {n: scope.get(n).clone() for n in watched}
        losses.append(float(exe.run(main, feed=f, fetch_list=[loss],
                                    scope=scope)[0]))
        if i == at:
            around["after"] = {n: scope.get(n).clone() for n in watched}
        scales.append(opt.get_loss_scaling(scope))
        flags.append(opt.found_overflow(scope))
    return main, losses, scales, flags, around


def test_scaler_skips_an_overflow_then_recovers_like_the_jax_package():
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=3,
              decr_every_n_nan_or_inf=1)
    jm, js, _, _ = _decorated("jax", _mlp_loss, **dict(kw))
    state = _jax_state(jm, js)
    feeds = _mlp_feeds(10)
    _, j_losses, j_scales, j_flags, _ = _overflow_run("jax", state, feeds,
                                                      **dict(kw))
    tm, t_losses, t_scales, t_flags, around = _overflow_run(
        "torch", state, feeds, **dict(kw))
    assert t_scales == j_scales == [1024.0, 1024.0, 2048.0, 1024.0, 1024.0,
                                    1024.0, 2048.0, 2048.0, 2048.0, 4096.0]
    assert t_flags == j_flags
    assert t_flags[3] and not any(t_flags[:3] + t_flags[4:])
    # the overflowed step advanced nothing: parameters, moments, powers
    assert around["before"].keys() == around["after"].keys()
    assert any("beta1_pow" in n for n in around["before"])
    for n, v in around["before"].items():
        assert torch.equal(v, around["after"][n]), n
    assert not np.isfinite(t_losses[3]) and not np.isfinite(j_losses[3])
    fin = [i for i in range(10) if i != 3]
    np.testing.assert_allclose(np.array(t_losses)[fin],
                               np.array(j_losses)[fin], rtol=1e-2)


def _embedding_loss(optimizer):
    def build(fluid, transformer):
        ids = fluid.layers.data(name="ids", shape=[-1, 3], dtype="int64",
                                append_batch_size=False)
        y = fluid.layers.data(name="y", shape=[-1, 1], dtype="float32",
                              append_batch_size=False)
        emb = fluid.layers.embedding(ids, size=[20, 8], is_sparse=True)
        h = fluid.layers.reduce_mean(emb, dim=1)
        pred = fluid.layers.fc(h, size=1)
        return fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    return build


@pytest.mark.parametrize("route", ["fused", "sparse_sgd", "sparse_adagrad",
                                   "sparse_adam"])
def test_skipped_step_leaves_flat_buffers_and_tables_unchanged(route):
    fluid = tfluid
    opt_cls = {"fused": fluid.optimizer.Adam,
               "sparse_sgd": fluid.optimizer.SGD,
               "sparse_adagrad": fluid.optimizer.Adagrad,
               "sparse_adam": fluid.optimizer.Adam}[route]
    build = _mlp_loss if route == "fused" else _embedding_loss(opt_cls)
    with _flags("torch", {"fuse_optimizer_state": route == "fused",
                          "bf16_moments": route == "fused"}):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            loss = build(fluid, None)
            opt = t_amp.decorate(opt_cls(learning_rate=0.05),
                                 init_loss_scaling=8.0,
                                 decr_every_n_nan_or_inf=1)
            opt.minimize(loss)
    types = [op.type for op in main.global_block().ops]
    if route == "fused":
        assert "adam_fused" in types
        feed = _mlp_feeds(1)[0]
        bad = dict(feed, x=np.full((4, 8), 1e30, "float32"))
    else:
        assert route.replace("sparse_", "") + "_sparse" in types
        rng = np.random.RandomState(0)
        feed = {"ids": rng.randint(0, 20, (4, 3)).astype("int64"),
                "y": rng.rand(4, 1).astype("float32")}
        # a label of 3e38 overflows the scaled loss's gradient
        bad = dict(feed, y=np.full((4, 1), 3e38, "float32"))
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    state = [n for n in scope.local_var_names()
             if isinstance(scope.get(n), torch.Tensor)
             and "loss_scaling" not in n and "found_inf" not in n]
    param = next(p.name for p in main.all_parameters()
                 if tuple(p.shape) == ((8, 16) if route == "fused"
                                       else (20, 8)))
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    before = {n: scope.get(n).clone() for n in state}
    w = tfluid.fetch_var(param, scope)
    exe.run(main, feed=bad, fetch_list=[loss], scope=scope)
    assert opt.found_overflow(scope)
    assert opt.get_loss_scaling(scope) == 4.0
    for n in state:
        assert torch.equal(scope.get(n), before[n]), n
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert not opt.found_overflow(scope)
    assert not np.array_equal(tfluid.fetch_var(param, scope), w)


# ------------------------------------------------------------ checkpoints


def _persistables(program, scope):
    return {v.name: tfluid.fetch_var(v.name, scope)
            for v in program.list_vars()
            if v.persistable and scope.has_var(v.name)}


def _ckpt_build(name):
    return _decorated(name, _mlp_loss, init_loss_scaling=256.0,
                      incr_every_n_steps=2)


def test_amp_checkpoint_roundtrip_is_bit_exact(tmp_path):
    feeds = _mlp_feeds(6)
    jm, js, _, _ = _ckpt_build("jax")
    state = _jax_state(jm, js)

    main, startup, loss, opt = _ckpt_build("torch")
    scope, exe = _port_scope(main, startup, state)
    ref = [float(exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0])
           for f in feeds]
    ref_state = _persistables(main, scope)

    main, startup, loss, opt = _ckpt_build("torch")
    scope, exe = _port_scope(main, startup, state)
    for f in feeds[:3]:
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    tfluid.checkpoint.save_checkpoint(str(tmp_path),
                                      _persistables(main, scope))

    main, startup, loss, opt = _ckpt_build("torch")
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    saved, _ = tfluid.checkpoint.load_checkpoint(str(tmp_path))
    tfluid.state_from_numpy(saved, scope, CPU, program=main)
    # the scaler's state (its grow counter too) came back with the
    # parameters: the trajectory continues exactly
    assert opt.get_loss_scaling(scope) == 512.0
    resumed = [float(exe.run(main, feed=f, fetch_list=[loss],
                             scope=scope)[0]) for f in feeds[3:]]
    assert resumed == ref[3:]
    res_state = _persistables(main, scope)
    assert sorted(res_state) == sorted(ref_state)
    for n in ref_state:
        np.testing.assert_array_equal(res_state[n], ref_state[n],
                                      err_msg=n)


def test_jax_amp_checkpoint_continues_in_the_port(tmp_path):
    from paddle_tpu import checkpoint as j_checkpoint

    feeds = _mlp_feeds(6)
    jm, js, jl, jo = _ckpt_build("jax")
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(js)
        j_losses = [float(exe.run(jm, feed=f, fetch_list=[jl.name])[0])
                    for f in feeds[:3]]
        j_checkpoint.save_checkpoint(
            str(tmp_path), {v.name: np.asarray(scope.get(v.name))
                            for v in jm.list_vars()
                            if v.persistable and scope.has_var(v.name)})
        j_losses += [float(exe.run(jm, feed=f, fetch_list=[jl.name])[0])
                     for f in feeds[3:]]
        j_scale = jo.get_loss_scaling(scope)
    main, startup, loss, opt = _ckpt_build("torch")
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    saved, _ = tfluid.checkpoint.load_checkpoint(str(tmp_path))
    assert set(saved) == {v.name for v in main.list_vars()
                          if v.persistable}
    tfluid.state_from_numpy(saved, scope, CPU, program=main)
    assert opt.get_loss_scaling(scope) == 512.0
    t_losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                              scope=scope)[0]) for f in feeds[3:]]
    # bf16 matmuls at lr 0.05: the first step parts by 0.2 %, the third
    # by 1 %
    np.testing.assert_allclose(t_losses, j_losses[3:], rtol=2e-2)
    assert opt.get_loss_scaling(scope) == j_scale


def test_persistables_saveable_before_the_first_step(tmp_path):
    main, startup, loss, _ = _decorated("torch", _mlp_loss)
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    state = _persistables(main, scope)
    missing = [v.name for v in main.list_vars()
               if v.persistable and v.name not in state]
    assert not missing, missing
    tfluid.io.save_persistables(exe, str(tmp_path), main, scope=scope)


def test_amp_checkpoint_loads_into_a_non_amp_program(tmp_path):
    feeds = _mlp_feeds(4)
    main, startup, loss, _ = _decorated("torch", _mlp_loss)
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    for f in feeds:
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    saved = _persistables(main, scope)
    params = {n: v for n, v in saved.items() if n.startswith("fc.")}
    tfluid.checkpoint.save_checkpoint(str(tmp_path), saved)

    main2, startup2 = tfluid.Program(), tfluid.Program()
    main2.random_seed = 5
    with tfluid.unique_name.guard(), tfluid.program_guard(main2, startup2):
        loss2 = _mlp_train(tfluid)
        tfluid.optimizer.Adam(learning_rate=0.05).minimize(loss2)
    scope2, exe2 = tfluid.Scope(), tfluid.Executor(CPU)
    exe2.run(startup2, scope=scope2)
    state, _ = tfluid.checkpoint.load_checkpoint(str(tmp_path))
    ours = {n: v for n, v in state.items()
            if main2.global_block().has_var(n)}
    assert len(ours) >= len(params)
    tfluid.state_from_numpy(ours, scope2, CPU, program=main2)
    for n, v in params.items():
        got = tfluid.fetch_var(n, scope2)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, v, err_msg=n)
    out, = exe2.run(main2, feed=feeds[0], fetch_list=[loss2], scope=scope2)
    assert np.isfinite(out).all()


def test_trainable_artifact_keeps_the_gate(tmp_path):
    """``save_trainable_program`` exports the gated group op with its
    flag: the reloaded step skips an overflowed batch, bit for bit, and
    continues as ``Executor.run`` does."""
    with _flags("torch", {"fuse_optimizer_state": True}):
        main, startup, loss, opt = _decorated(
            "torch", _mlp_loss, init_loss_scaling=8.0,
            decr_every_n_nan_or_inf=1)
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    feeds = _mlp_feeds(5)
    feeds[2] = dict(feeds[2], x=np.full((4, 8), 1e30, "float32"))
    exe.run(main, feed=feeds[0], fetch_list=[loss], scope=scope)
    d = str(tmp_path / "art")
    tfluid.io.save_trainable_program(d, {"x": (4, 8), "y": (4, 1)}, [loss],
                                     exe, main_program=main, scope=scope)
    loaded = tfluid.io.load_trainable_program(d, place=CPU)
    got = [float(loaded.run(feeds[1])[0])]
    before = {n: t.clone() for n, t in loaded.state_dict().items()}
    got.append(float(loaded.run(feeds[2])[0]))
    after = loaded.state_dict()
    held = [n for n in before if n.startswith("fused_")]
    assert held and all(torch.equal(after[n], before[n]) for n in held)
    got += [float(loaded.run(f)[0]) for f in feeds[3:]]
    want = [float(exe.run(main, feed=f, fetch_list=[loss],
                          scope=scope)[0]) for f in feeds[1:]]
    assert not np.isfinite(got[1]) and not np.isfinite(want[1])
    assert got[:1] + got[2:] == want[:1] + want[2:]
    for n, t in loaded.state_dict().items():
        assert torch.equal(t, scope.get(n)), n


# -------------------------------------------------------------- serving


def test_bucketed_engine_serves_a_rewritten_program():
    from paddle_tpu_torch import serving

    main, startup, sm = _forward("torch", "mlp_softmax")
    main.random_seed = 3
    infer = t_amp.rewrite_program(main.clone(for_test=True))
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    x = np.random.RandomState(0).rand(3, 8).astype("float32")
    ref, = exe.run(main, feed={"x": x}, fetch_list=[sm], scope=scope)
    engine = serving.BucketedEngine(
        serving.ServingConfig(buckets=[2, 4]), program=infer,
        feed_names=["x"], fetch_list=[sm], scope=scope, place=CPU)
    engine.warm_up()
    out, = engine.run({"x": x})
    assert out.shape == (3, 4) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0.05, atol=5e-3)
    bf = [v for v in infer.list_vars()
          if tfluid.core.dtype_utils.name(v.dtype) == "bfloat16"]
    assert bf, "the rewrite put nothing on the bf16 stream"


def test_bf16_decode_pools_after_the_rewrite_match_the_jax_package():
    from paddle_tpu.decoding import CacheConfig as JCacheConfig
    from paddle_tpu.decoding import \
        derive_decode_programs as j_derive
    from paddle_tpu_torch.decoding import (CacheConfig, DecodingConfig,
                                           derive_decode_programs,
                                           serve_decoding)

    from _torch_port import CACHE, carried_scope, jax_lm, torch_lm

    j_main, j_scope, j_logits = jax_lm()
    t_main, _, t_logits = torch_lm()
    scope = carried_scope(j_main, j_scope, t_main)
    j_bf = j_amp.rewrite_program(j_main.clone(for_test=True))
    t_bf = t_amp.rewrite_program(t_main.clone(for_test=True))
    assert symbol_table(t_bf) == symbol_table(j_bf)
    j_pair = j_derive(j_bf, "tokens", j_logits.name, JCacheConfig(**CACHE))
    t_pair = derive_decode_programs(t_bf, "tokens", t_logits.name,
                                    CacheConfig(**CACHE))
    assert {tfluid.core.dtype_utils.name(dt)
            for _, _, dt in t_pair.pool_specs} == {"bfloat16"}
    assert [(n, s) for n, s, _ in t_pair.pool_specs] == \
        [(n, s) for n, s, _ in j_pair.pool_specs]
    from paddle_tpu.decoding import DecodingConfig as JDecodingConfig
    from paddle_tpu.decoding import serve_decoding as j_serve

    streams = {}
    for name, (serve, prog, logits, sc, cfg, kw) in {
            "jax": (j_serve, j_bf, j_logits, j_scope, JDecodingConfig(
                cache=JCacheConfig(**CACHE), decode_buckets=(1, 2)), {}),
            "torch": (serve_decoding, t_bf, t_logits, scope, DecodingConfig(
                cache=CacheConfig(**CACHE), decode_buckets=(1, 2)),
                {"place": CPU})}.items():
        s = serve(prog, "tokens", logits.name, scope=sc, config=cfg, **kw)
        try:
            streams[name] = [s.generate(p, max_new_tokens=6)
                             for p in ([3, 1, 4], [5, 9, 2, 6, 5])]
        finally:
            s.shutdown(drain=True, timeout=60)
    assert streams["torch"] == streams["jax"]


# ------------------------------------------------------- default off, tiers


def test_amp_default_off_leaves_programs_untouched():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        loss = _mlp_train(tfluid)
        tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    assert not hasattr(main, "_amp_stamp")
    assert not any(op.attrs.get("_amp_inserted") or "ApplyFlag" in op.inputs
                   for b in main.blocks for op in b.ops)


def test_amp_pass_stamps_as_the_direct_call():
    from paddle_tpu_torch.passes import AmpRewritePass, PassManager

    direct, _, _ = _forward("torch", "mlp")
    t_amp.rewrite_program(direct)
    via, _, _ = _forward("torch", "mlp")
    out = PassManager([AmpRewritePass()]).apply(via)
    assert out._amp_stamp == direct._amp_stamp == \
        AmpRewritePass().fingerprint()
    assert _ops(out) == _ops(direct)


def test_static_tier_checks_and_costs_a_decorated_program():
    from paddle_tpu_torch.obs import cost

    main, _, loss, _ = _decorated("torch", _mlp_loss)
    report = tfluid.analysis.check_program(main, feed=("x", "y"),
                                           fetch_list=[loss.name])
    assert report.ok, str(report)
    rep = cost.report(main, feed_shapes={"x": (4, 8), "y": (4, 1)})
    amp_ops = {"amp_cast_params", "amp_scale_loss",
               "amp_check_finite_and_unscale", "amp_update_loss_scaling"}
    assert amp_ops <= {op.type for op in main.global_block().ops}
    assert not amp_ops & set(rep.unknown_op_types())
