"""paddle_tpu_torch.layers.learning_rate_scheduler held to paddle_tpu's.

* Each of the eight schedules (and the staircase / cycle variants) in a
  program of its own: the learning rate of 10 consecutive runs equals
  the JAX package's within rtol 1e-6 (float32 transcendentals of two
  libraries), and the persistable ``@LR_DECAY_COUNTER@`` reads 10.
* ``append_LARS`` on the same parameters and gradients: rtol 1e-5.
* A schedule drives ``Momentum`` through ``Executor.run_steps`` (a loop
  of runs on the CPU) from the JAX package's start state: the losses of
  six steps and the parameters after them match the JAX package's
  ``run_steps`` within rtol 1e-5 / 1e-6 of their max, with the
  per-parameter and the flat (``fuse_optimizer_state``) update.
* A JAX state saved mid-schedule (counter 4) resumes in the port
  through ``state_from_numpy``: the next rates are the JAX package's.
"""

import math

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique_name

from _torch_port import _flags

torch.set_num_threads(1)

COUNTER = "@LR_DECAY_COUNTER@"
SCHEDULES = {
    "noam": lambda L: L.noam_decay(64, 4),
    "exponential": lambda L: L.exponential_decay(0.1, 3, 0.5),
    "exponential_staircase": lambda L: L.exponential_decay(
        0.1, 3, 0.5, staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.1, 4, 0.3),
    "natural_exp_staircase": lambda L: L.natural_exp_decay(
        0.1, 4, 0.3, staircase=True),
    "inverse_time": lambda L: L.inverse_time_decay(0.1, 2, 0.7),
    "inverse_time_staircase": lambda L: L.inverse_time_decay(
        0.1, 2, 0.7, staircase=True),
    "polynomial": lambda L: L.polynomial_decay(0.1, 6, 0.01, power=2.0),
    "polynomial_cycle": lambda L: L.polynomial_decay(0.1, 4, 0.01,
                                                     power=0.5, cycle=True),
    "piecewise": lambda L: L.piecewise_decay([3, 5, 8], [0.1, 0.05, 0.02,
                                                         0.005]),
    "cosine": lambda L: L.cosine_decay(0.1, 2, 6),
}


def _package(pkg):
    return ((jfluid, j_unique_name.guard) if pkg == "jax"
            else (tfluid, tfluid.unique_name.guard))


def _schedule_program(pkg, schedule):
    fluid, guard = _package(pkg)
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        lr = SCHEDULES[schedule](fluid.layers)
    return main, startup, lr


def _jax_rates(schedule, runs=10):
    main, startup, lr = _schedule_program("jax", schedule)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        rates = [float(np.asarray(exe.run(main, fetch_list=[lr])[0]))
                 for _ in range(runs)]
        return rates, float(np.asarray(scope.find_var(COUNTER)))


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_schedule_rates_match_the_jax_package(schedule):
    want, counter = _jax_rates(schedule)
    main, startup, lr = _schedule_program("torch", schedule)
    assert [op.type for op in main.global_block().ops][0] == "increment"
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    got = [float(exe.run(main, fetch_list=[lr], scope=scope)[0])
           for _ in range(10)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert float(tfluid.fetch_var(COUNTER, scope)) == counter == 10.0


def test_append_lars_matches_the_jax_package():
    rng = np.random.RandomState(0)
    p = rng.randn(5, 3).astype(np.float32)
    g = (0.1 * rng.randn(5, 3)).astype(np.float32)
    outs = {}
    for pkg in ("jax", "torch"):
        fluid, guard = _package(pkg)
        main, startup = fluid.Program(), fluid.Program()
        with guard(), fluid.program_guard(main, startup):
            pv = fluid.layers.data(name="p", shape=[5, 3], dtype="float32",
                                   append_batch_size=False)
            gv = fluid.layers.data(name="g", shape=[5, 3], dtype="float32",
                                   append_batch_size=False)
            lr = fluid.layers.exponential_decay(0.1, 2, 0.5)
            lars, = fluid.layers.append_LARS([(pv, gv)], lr, 0.01)
        if pkg == "jax":
            scope = jfluid.Scope()
            with jfluid.scope_guard(scope):
                exe = jfluid.Executor(jfluid.CPUPlace())
                exe.run(startup)
                out = exe.run(main, feed={"p": p, "g": g},
                              fetch_list=[lars])[0]
        else:
            scope = tfluid.Scope()
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup, scope=scope)
            out = exe.run(main, feed={"p": p, "g": g}, fetch_list=[lars],
                          scope=scope)[0]
        outs[pkg] = float(np.asarray(out))
    want = 0.1 * 0.5 ** 0.5 * np.linalg.norm(p) / (
        np.linalg.norm(g) + 0.01 * np.linalg.norm(p) + 1e-12)
    np.testing.assert_allclose(outs["torch"], outs["jax"], rtol=1e-5)
    np.testing.assert_allclose(outs["torch"], want, rtol=1e-5)


def _momentum_program(pkg):
    """x[4] -> fc 8 relu -> fc 1, mean squared error, Momentum(0.9) at a
    piecewise learning rate."""
    fluid, guard = _package(pkg)
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, size=8, act="relu")
        pred = fluid.layers.fc(h, size=1)
        cost = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        lr = fluid.layers.piecewise_decay([2, 4], [0.05, 0.02, 0.01])
        fluid.optimizer.Momentum(learning_rate=lr,
                                 momentum=0.9).minimize(cost)
    return main, startup, cost


@pytest.mark.parametrize("fuse", [False, True], ids=["per_param", "fused"])
def test_schedule_drives_momentum_through_run_steps(fuse):
    rng = np.random.RandomState(1)
    steps = 6
    feed = {"x": rng.randn(steps, 8, 4).astype(np.float32),
            "y": rng.randn(steps, 8, 1).astype(np.float32)}
    values = {"fuse_optimizer_state": fuse}
    with _flags("jax", dict(values, pallas_fused_update=fuse)):
        main, startup, cost = _momentum_program("jax")
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            exe = jfluid.Executor(jfluid.CPUPlace())
            exe.run(startup)
            state = {v.name: np.asarray(scope.find_var(v.name))
                     for v in main.list_vars() if v.persistable}
            j_losses, = exe.run_steps(main, feed=feed, steps=steps,
                                      fetch_list=[cost])
            j_params = {p.name: np.asarray(scope.find_var(p.name))
                        for p in main.all_parameters()}
            assert float(np.asarray(scope.find_var(COUNTER))) == steps
    with _flags("torch", values):
        main, startup, cost = _momentum_program("torch")
    assert any(op.type == "momentum_fused" for op in
               main.global_block().ops) == fuse
    scope, place = tfluid.Scope(), tfluid.CPUPlace()
    exe = tfluid.Executor(place)
    exe.run(startup, scope=scope)
    tfluid.state_from_numpy(state, scope, place, program=main)
    losses, = exe.run_steps(main, feed=feed, steps=steps,
                            fetch_list=[cost], scope=scope)
    assert losses.shape == (steps,)
    np.testing.assert_allclose(losses, np.asarray(j_losses), rtol=1e-5)
    for name, want in j_params.items():
        np.testing.assert_allclose(tfluid.fetch_var(name, scope), want,
                                   rtol=0, atol=1e-6 * np.abs(want).max(),
                                   err_msg=name)
    assert float(tfluid.fetch_var(COUNTER, scope)) == steps


def test_a_jax_state_resumes_mid_schedule():
    main, startup, lr = _schedule_program("jax", "cosine")
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        for _ in range(4):
            exe.run(main, fetch_list=[lr])
        state = {v.name: np.asarray(scope.find_var(v.name))
                 for v in main.list_vars() if v.persistable}
        want = [float(np.asarray(exe.run(main, fetch_list=[lr])[0]))
                for _ in range(4)]
    assert state[COUNTER] == 4.0
    t_main, _, t_lr = _schedule_program("torch", "cosine")
    scope = tfluid.Scope()
    tfluid.state_from_numpy(state, scope, tfluid.CPUPlace(), program=t_main)
    exe = tfluid.Executor(tfluid.CPUPlace())
    got = [float(exe.run(t_main, fetch_list=[t_lr], scope=scope)[0])
           for _ in range(4)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # cosine_decay(0.1, 2, 6) at steps 5..8
    np.testing.assert_allclose(
        got, [0.05 * (math.cos(math.floor(s / 2) * math.pi / 6) + 1)
              for s in range(5, 9)], rtol=1e-6)
