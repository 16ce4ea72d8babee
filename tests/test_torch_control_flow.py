"""The port's control flow against the JAX package and the oracles of
tests/test_control_flow.py and test_control_flow_extra.py: While,
Switch, StaticRNN, DynamicRNN, the comparison ops, tensor arrays, rank
tables, split/merge, IfElse, ConditionalBlock, Print, is_empty,
ParallelDo — and what a captured CUDA graph can take of them.

A captured block stays one composite op whose fn runs the sub-ops;
StaticRNN/DynamicRNN/Switch keep static shapes and capture, while
``while``, ``conditional_block`` and ``print`` read a device value on
the host: ``Executor.run_steps``/``run_graph`` on a card refuse them
with GraphCaptureError naming the op (``executor.check_capturable``),
and on the CPU ``run_steps`` is a loop of ``run`` that runs them.

Tolerances: f32 at rtol 1e-5 against the JAX package; integer and bool
outputs exact.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.executor import check_capturable

from _torch_port import package, train_both

torch.set_num_threads(1)


def run(pkg, build, feed=None, fetch_names=None):
    """Build ``build(fluid, L)`` (returns the fetch vars) in one package
    and run it once from its startup program on the CPU."""
    fluid, guard = package(pkg)
    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    with fluid.scope_guard(scope), guard(), \
            fluid.program_guard(main, startup):
        fetch = build(fluid, fluid.layers)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        return [np.asarray(o) for o in exe.run(main, feed=feed or {},
                                                fetch_list=fetch)]


def both(build, feed=None, rtol=1e-5):
    t, j = run("torch", build, feed), run("jax", build, feed)
    for a, b in zip(t, j):
        assert a.shape == b.shape
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a.astype(np.int64),
                                          b.astype(np.int64))
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-6)
    return t


def _while_sum(fluid, L):
    i = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    total = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    limit = L.fill_constant(shape=[1], dtype="float32", value=10.0)
    cond = L.less_than(i, limit)
    w = L.While(cond)
    with w.block():
        ni = L.increment(i, value=1.0)
        L.assign(L.elementwise_add(total, ni), total)
        L.less_than(i, limit, cond=cond)
    return [total, i]


def test_while_loop_sums_to_limit():
    total, i = both(_while_sum)
    assert float(np.squeeze(total)) == 55.0 and float(np.squeeze(i)) == 10.0


def test_while_needs_its_condition_reassigned():
    with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
        L = tfluid.layers
        i = L.fill_constant(shape=[1], dtype="float32", value=0.0)
        cond = L.less_than(i, L.fill_constant(shape=[1], dtype="float32",
                                              value=3.0))
        with pytest.raises(tfluid.EnforceError, match="re-assign"):
            with L.While(cond).block():
                L.increment(i)


@pytest.mark.parametrize("x_val,want", [(0.5, 10.0), (1.5, 20.0),
                                        (5.0, 30.0)])
def test_switch_selects_first_true_case(x_val, want):
    def build(fluid, L):
        x = L.data(name="x", shape=[1], dtype="float32",
                   append_batch_size=False)
        out = L.fill_constant(shape=[1], dtype="float32", value=0.0)
        one = L.fill_constant(shape=[1], dtype="float32", value=1.0)
        two = L.fill_constant(shape=[1], dtype="float32", value=2.0)
        with L.Switch() as sw:
            with sw.case(L.less_than(x, one)):
                L.assign(L.fill_constant(shape=[1], dtype="float32",
                                         value=10.0), out)
            with sw.case(L.less_than(x, two)):
                L.assign(L.scale(x, scale=0.0, bias=20.0), out)
            with sw.default():
                L.assign(L.fill_constant(shape=[1], dtype="float32",
                                         value=30.0), out)
        return [out]

    o, = both(build, {"x": np.array([x_val], "float32")})
    assert float(np.squeeze(o)) == want


def test_static_rnn_cumsum():
    Bn, Tn, Dn = 2, 5, 3
    x_np = np.random.RandomState(0).rand(Bn, Tn, Dn).astype("float32")

    def build(fluid, L):
        x = L.data(name="x", shape=[-1, Tn, Dn], dtype="float32",
                   append_batch_size=False)
        h0 = L.fill_constant(shape=[Bn, Dn], dtype="float32", value=0.0)
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h = rnn.memory(init=h0)
            nh = L.elementwise_add(h, x_t)
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        return list(rnn())

    o, = both(build, {"x": x_np})
    np.testing.assert_allclose(o, np.cumsum(x_np, axis=1), rtol=1e-5)


def _rnn_with_fc(dynamic, Bn=4, Tn=6, Dn=3, Hn=8):
    def b(pkg, fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[Bn, Tn, Dn], dtype="float32",
                   append_batch_size=False, lod_level=1 if dynamic else 0)
        y = L.data(name="y", shape=[Bn, Hn], dtype="float32",
                   append_batch_size=False)
        h0 = L.fill_constant(shape=[Bn, Hn], dtype="float32", value=0.0)
        rnn = L.DynamicRNN() if dynamic else L.StaticRNN()
        with (rnn.block() if dynamic else rnn.step()):
            x_t = rnn.step_input(x)
            h = rnn.memory(init=h0)
            nh = L.fc(input=L.concat([x_t, h], axis=1), size=Hn,
                      act="tanh")
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        seq, = rnn()
        last = L.squeeze(L.slice(seq, axes=[1], starts=[Tn - 1], ends=[Tn]),
                         axes=[1])
        pooled = L.reduce_sum(seq, dim=1)
        loss = L.mean(L.square_error_cost(L.elementwise_add(last, pooled),
                                          y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [loss, seq]
    return b


@pytest.mark.parametrize("dynamic", [False, True])
def test_rnn_with_fc_trains_like_the_jax_package(dynamic):
    rng = np.random.RandomState(1)
    feed = {"x": rng.rand(4, 6, 3).astype("float32"),
            "y": rng.rand(4, 8).astype("float32")}
    if dynamic:
        feed["x@LEN"] = np.array([6, 2, 4, 1], np.int32)
    r = train_both(_rnn_with_fc(dynamic), feed, 3)
    for j, t in zip(r["j_out"], r["t_out"]):
        for a, b in zip(t, j):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    for n in r["state"]:
        np.testing.assert_allclose(r["t_state"][n], r["j_state"][n],
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    if dynamic:   # outputs past each length are 0
        seq = r["t_out"][-1][1]
        assert np.abs(seq[1, 2:]).max() == 0 and np.abs(seq[3, 1:]).max() == 0


def test_static_rnn_trains():
    """test_control_flow.py's oracle: an fc step trained 30 SGD steps
    halves the loss."""
    rng = np.random.RandomState(1)
    feed = {"x": rng.rand(4, 6, 3).astype("float32"),
            "y": rng.rand(4, 8).astype("float32")}
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        loss, _ = _rnn_with_fc(False)("torch", tfluid)
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(30)]
    assert losses[-1] < losses[0] * 0.5, losses


def test_dynamic_rnn_masks_past_length():
    Bn, Tn, Dn = 3, 4, 2

    def build(fluid, L):
        x = L.data(name="x", shape=[-1, Tn, Dn], dtype="float32",
                   append_batch_size=False, lod_level=1)
        h0 = L.fill_constant(shape=[Bn, Dn], dtype="float32", value=0.0)
        rnn = L.DynamicRNN()
        with rnn.block():
            x_t = rnn.step_input(x)
            h = rnn.memory(init=h0)
            nh = L.elementwise_add(h, x_t)
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        return list(rnn())

    o, = both(build, {"x": np.ones((Bn, Tn, Dn), "float32"),
                      "x@LEN": np.array([4, 2, 3], "int64")})
    np.testing.assert_allclose(o[:, :, 0], [[1, 2, 3, 4], [1, 2, 0, 0],
                                            [1, 2, 3, 0]])


@pytest.mark.parametrize("name", ["less_than", "less_equal", "greater_than",
                                  "greater_equal", "equal", "not_equal",
                                  "logical_and", "logical_or"])
def test_comparison_ops(name):
    rng = np.random.RandomState(2)
    logical = name.startswith("logical")
    feed = ({"a": rng.rand(4, 3) > 0.5, "b": rng.rand(4, 3) > 0.5}
            if logical else
            {"a": rng.randint(0, 3, (4, 3)).astype("float32"),
             "b": rng.randint(0, 3, (4, 3)).astype("float32")})
    dt = "bool" if logical else "float32"

    def build(fluid, L):
        a = L.data(name="a", shape=[4, 3], dtype=dt, append_batch_size=False)
        b = L.data(name="b", shape=[4, 3], dtype=dt, append_batch_size=False)
        out = getattr(L, name)(a, b)
        return [out, L.logical_not(out)]

    both(build, feed)


def test_array_write_read_length():
    def build(fluid, L):
        x = L.data(name="x", shape=[-1, 3], dtype="float32",
                   append_batch_size=False)
        i0 = L.fill_constant(shape=(), dtype="int32", value=0)
        i1 = L.fill_constant(shape=(), dtype="int32", value=1)
        arr = L.array_write(x, i0)
        L.array_write(L.scale(x=x, scale=2.0), i1, array=arr)
        return [L.array_read(arr, i0), L.array_read(arr, i1),
                L.array_length(arr)]

    xv = np.arange(6, dtype="f").reshape(2, 3)
    r0, r1, n = both(build, {"x": xv})
    np.testing.assert_allclose(r1, 2 * xv)
    assert int(n) == 2


def test_array_overflow_writes_nan_into_the_last_slot():
    def build(fluid, L):
        x = L.data(name="x", shape=[2], dtype="float32",
                   append_batch_size=False)
        arr = L.create_array("float32", max_len=2)
        L.array_write(x, L.fill_constant(shape=(), dtype="int32", value=0),
                      array=arr)
        L.array_write(x, L.fill_constant(shape=(), dtype="int32", value=5),
                      array=arr)
        return [L.array_read(arr, L.fill_constant(shape=(), dtype="int32",
                                                  value=1)),
                L.array_length(arr)]

    t = run("torch", build, {"x": np.ones(2, "f")})
    assert np.isnan(t[0]).all() and int(t[1]) == 6


def test_array_inside_while_loop():
    def build(fluid, L):
        x = L.data(name="x", shape=[-1, 2], dtype="float32",
                   append_batch_size=False)
        i = L.fill_constant(shape=(), dtype="int32", value=0)
        limit = L.fill_constant(shape=(), dtype="int32", value=4)
        arr = L.array_write(x, i)
        cond = L.less_than(i, limit)
        with L.While(cond).block():
            i2 = L.increment(i, value=1, in_place=True)
            L.array_write(L.scale(x=x, scale=2.0), i2, array=arr)
            L.less_than(i2, limit, cond=cond)
        return [L.array_length(arr), L.array_read(arr, i)]

    n, last = both(build, {"x": np.ones((1, 2), "f")})
    assert int(n) == 5
    np.testing.assert_allclose(last, 2 * np.ones((1, 2)))


def test_rank_table_reorder_roundtrip():
    def build(fluid, L):
        x = L.data(name="x", shape=[-1, 4, 2], dtype="float32",
                   append_batch_size=False, lod_level=1)
        table = L.lod_rank_table(x)
        arr = L.lod_tensor_to_array(x, table)
        i = L.fill_constant(shape=(), dtype="int32", value=1)
        return [L.max_sequence_len(table),
                L.reorder_lod_tensor_by_rank(x, table),
                L.array_to_lod_tensor(arr, table), L.array_read(arr, i),
                L.shrink_memory(x, i, table)]

    xv = np.random.RandomState(0).randn(3, 4, 2).astype("f")
    mx, xo, back, step1, shrunk = both(
        build, {"x": xv, "x@LEN": np.array([2, 4, 3], "int32")})
    assert int(mx) == 4
    np.testing.assert_allclose(xo, xv[[1, 2, 0]])
    np.testing.assert_allclose(back, xv)
    np.testing.assert_allclose(step1, xv[[1, 2, 0], 1])
    np.testing.assert_allclose(shrunk, xv)


def test_split_merge_lod_tensor():
    def build(fluid, L):
        x = L.data(name="x", shape=[-1, 2], dtype="float32",
                   append_batch_size=False)
        m = L.data(name="m", shape=[-1, 1], dtype="bool",
                   append_batch_size=False)
        t, f = L.split_lod_tensor(x, m)
        return [t, f, L.merge_lod_tensor(t, f, x, m)]

    xv = np.arange(10, dtype="f").reshape(5, 2)
    mv = np.array([[True], [False], [True], [False], [False]])
    t, f, merged = both(build, {"x": xv, "m": mv})
    np.testing.assert_allclose(t[:2], xv[[0, 2]])
    np.testing.assert_allclose(f[:3], xv[[1, 3, 4]])
    np.testing.assert_allclose(merged, xv)


def test_ifelse_rowwise_merge():
    def build(fluid, L):
        x = L.data(name="x", shape=[-1, 1], dtype="float32",
                   append_batch_size=False)
        cond = L.less_than(x, L.fill_constant(shape=(), dtype="float32",
                                              value=0.0))
        ie = L.IfElse(cond)
        with ie.true_block():
            ie.output(L.scale(x=ie.input(x), scale=-1.0))
        with ie.false_block():
            ie.output(L.scale(x=x, scale=1.0))
        return ie()

    xv = np.array([[-2.0], [3.0], [-0.5]], "f")
    out, = both(build, {"x": xv})
    np.testing.assert_allclose(out, np.abs(xv))


@pytest.mark.parametrize("flag", [True, False])
def test_conditional_block(flag):
    def build(fluid, L):
        x = L.data(name="x", shape=[-1, 2], dtype="float32",
                   append_batch_size=False)
        f = L.data(name="flag", shape=(), dtype="bool",
                   append_batch_size=False)
        acc = L.fill_constant(shape=(1, 2), dtype="float32", value=0.0)
        with L.ConditionalBlock([f]).block():
            L.assign(L.scale(x=x, scale=3.0), acc)
        return [acc]

    xv = np.ones((1, 2), "f")
    out, = both(build, {"x": xv, "flag": np.asarray(flag)})
    np.testing.assert_allclose(out, 3 * xv if flag else 0 * xv)


def test_is_empty_print_and_parallel_do(capfd):
    def build(fluid, L):
        x = L.data(name="x", shape=[-1, 2], dtype="float32",
                   append_batch_size=False)
        pd = L.ParallelDo()
        with pd.do():
            pd.write_output(L.scale(pd.read_input(x), scale=2.0))
        doubled, = pd()
        p = L.Print(doubled, message="dbg")
        return [L.is_empty(x), L.mean(p)]

    e, s = run("torch", build, {"x": np.ones((2, 2), "f")})
    assert not bool(e) and float(s) == 2.0
    out = capfd.readouterr()
    assert "dbg" in out.out


# --------------------------------------------- CUDA graph capture


def _program(build):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        fetch = build(tfluid, tfluid.layers)
    return main, startup, fetch


def _cond_block(fluid, L):
    x = L.data(name="x", shape=[-1, 2], dtype="float32",
               append_batch_size=False)
    f = L.data(name="flag", shape=(), dtype="bool", append_batch_size=False)
    acc = L.fill_constant(shape=(1, 2), dtype="float32", value=0.0)
    with L.ConditionalBlock([f]).block():
        L.assign(L.scale(x=x, scale=3.0), acc)
    return [acc]


def _printing(fluid, L):
    x = L.data(name="x", shape=[-1, 2], dtype="float32",
               append_batch_size=False)
    return [L.mean(L.Print(x, message="p"))]


def _printing_in_a_step(fluid, L):
    """A Print inside a StaticRNN's step block (a sub-block's op)."""
    x = L.data(name="x", shape=[2, 3, 2], dtype="float32",
               append_batch_size=False)
    rnn = L.StaticRNN()
    with rnn.step():
        rnn.step_output(L.Print(rnn.step_input(x), message="step"))
    return rnn()


@pytest.mark.parametrize("build,op", [(_while_sum, "while"),
                                      (_cond_block, "conditional_block"),
                                      (_printing, "print"),
                                      (_printing_in_a_step, "print")])
def test_host_sync_ops_refuse_capture_by_name(build, op):
    main, _, _ = _program(build)
    with pytest.raises(tfluid.GraphCaptureError, match=repr(op)):
        check_capturable(main)
    assert issubclass(tfluid.GraphCaptureError, tfluid.EnforceError)


def test_static_shape_control_flow_is_capturable():
    for build in (_rnn_with_fc(False), _rnn_with_fc(True)):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
            build("torch", tfluid)
        check_capturable(main)   # raises nothing


def test_run_steps_over_a_while_program_on_the_cpu_is_runs():
    """On the CPU run_steps is a loop of run, which runs the loop each
    step: the counter is state (a persistable), so each step adds 10."""
    def build(fluid, L):
        total = L.create_global_var(shape=[1], value=0.0, dtype="float32",
                                    persistable=True, name="total")
        i = L.fill_constant(shape=[1], dtype="float32", value=0.0)
        limit = L.fill_constant(shape=[1], dtype="float32", value=10.0)
        cond = L.less_than(i, limit)
        with L.While(cond).block():
            L.increment(i, value=1.0)
            L.assign(L.elementwise_add(total, L.fill_constant(
                shape=[1], dtype="float32", value=1.0)), total)
            L.less_than(i, limit, cond=cond)
        return [total]

    main, startup, fetch = _program(build)
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    out, = exe.run_steps(main, steps=3, fetch_list=fetch, scope=scope)
    np.testing.assert_array_equal(np.asarray(out).reshape(-1),
                                  [10.0, 20.0, 30.0])
