"""paddle_tpu_torch's ModelAverage held to paddle_tpu's (mirrors
tests/test_fused_state.py:291).

``ModelAverage.apply_to`` appends its ``model_average_accum`` ops after
``minimize``, so they read the updated parameters: under
``fuse_optimizer_state`` the views the group op's second unpack slices,
and the averages are bit-equal to the per-parameter layout's. Both
packages start from the JAX package's state; the port's sums, counts
and averages are within rtol 1e-5 / atol 1e-7 of the JAX package's
(XLA contracts ``a*b + c`` into a fused multiply-add in Adam's update,
ROADMAP Queue C 2). The program holds the JAX package's ops and symbol
table.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid

from _torch_port import _flags, package, symbol_table

torch.set_num_threads(1)

CPU = tfluid.CPUPlace()
STEPS = 3


def _feed():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(4, 8).astype("float32"),
            "y": rng.randn(4, 1).astype("float32")}


def _build(pkg, fuse):
    fluid, guard = package(pkg)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 3
    with _flags(pkg, {"fuse_optimizer_state": fuse}), guard(), \
            fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, size=16, act="relu")
        h2 = fluid.layers.fc(h, size=16, act="tanh")
        pred = fluid.layers.fc(h2, size=1)
        loss = fluid.layers.reduce_mean(fluid.layers.square(
            fluid.layers.elementwise_sub(pred, y)))
        fluid.optimizer.Adam(1e-2).minimize(loss)
        ma = fluid.optimizer.ModelAverage(0.15)
        ma.apply_to(main)
    return main, startup, loss, ma


def _averages(pkg, fuse, state=None):
    """({param: averaged value}, {accumulator: value}, program, start
    state) after STEPS steps."""
    main, startup, loss, ma = _build(pkg, fuse)
    feed = _feed()
    accs = [v.name for v in main.list_vars()
            if "_sum_" in v.name or "_num_accum_" in v.name]
    if pkg == "jax":
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            exe = jfluid.Executor(jfluid.CPUPlace())
            exe.run(startup)
            state = {v.name: np.asarray(scope.find_var(v.name))
                     for v in main.list_vars() if v.persistable}
            for _ in range(STEPS):
                exe.run(main, feed=feed, fetch_list=[loss.name])
            avg = {p.name: np.asarray(ma.averaged_value(scope, p))
                   for p in ma.params}
            vals = {n: np.asarray(scope.get(n)) for n in accs}
        return avg, vals, main, state
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    ours = {v.name for v in main.list_vars() if v.persistable}
    tfluid.state_from_numpy({n: a for n, a in state.items() if n in ours},
                            scope, CPU, program=main)
    for _ in range(STEPS):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    avg = {p.name: ma.averaged_value(scope, p).numpy() for p in ma.params}
    vals = {n: tfluid.fetch_var(n, scope) for n in accs}
    return avg, vals, main, state


def test_fused_averages_are_bit_equal_to_per_param():
    _, _, _, state = _averages("jax", False)
    _, _, _, flat_state = _averages("jax", True)
    for n, a in state.items():  # one start, in two layouts
        if n in flat_state:
            np.testing.assert_array_equal(flat_state[n], a, err_msg=n)
    per_param, _, _, _ = _averages("torch", False, state)
    fused, _, main, _ = _averages("torch", True, flat_state)
    assert "adam_fused" in [op.type for op in main.global_block().ops]
    assert per_param.keys() == fused.keys() and len(fused) == 6
    for n, v in per_param.items():
        np.testing.assert_array_equal(fused[n], v, err_msg=n)


@pytest.mark.parametrize("fuse", [False, True], ids=["per_param", "fused"])
def test_averages_match_the_jax_package(fuse):
    j_avg, j_vals, j_main, state = _averages("jax", fuse)
    t_avg, t_vals, t_main, _ = _averages("torch", fuse, state)
    assert [op.type for op in t_main.global_block().ops] == \
        [op.type for op in j_main.global_block().ops]
    assert symbol_table(t_main) == symbol_table(j_main)
    assert t_vals.keys() == j_vals.keys() and len(t_vals) == 12
    for n, v in j_vals.items():
        np.testing.assert_allclose(t_vals[n], v, rtol=1e-5,
                                   atol=1e-7 * max(1.0, np.abs(v).max()),
                                   err_msg=n)
        if "_num_accum_" in n:
            assert float(t_vals[n]) == STEPS
    for n, v in j_avg.items():
        np.testing.assert_allclose(t_avg[n], v, rtol=1e-5, atol=1e-7,
                                   err_msg=n)
