"""The ``check_nan_inf`` flag of paddle_tpu_torch held to paddle_tpu's:
after a run, one reduction over the fetched values and the written
state and one bool read; a NaN or Inf raises ``EnforceError`` naming
the first variable that holds one (the fetches first, then the state),
with the JAX package's message. Off, a NaN runs through silently; a
finite run passes with the flag on."""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import flags as j_flags

from _torch_port import _flags, package

torch.set_num_threads(1)

CPU = tfluid.CPUPlace()


def _program(pkg):
    fluid, guard = package(pkg)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 2
    with guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(x, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss, pred


def _feed(bad=None):
    rng = np.random.RandomState(0)
    x = rng.rand(3, 4).astype("float32")
    if bad is not None:
        x[1, 2] = bad
    return {"x": x, "y": rng.rand(3, 1).astype("float32")}


def _errors(pkg, feed, fetch):
    """The message a run with the flag on raises, or None."""
    main, startup, loss, pred = _program(pkg)
    names = [{"loss": loss, "pred": pred}[f].name for f in fetch]
    with _flags(pkg, {"check_nan_inf": True}):
        try:
            if pkg == "jax":
                scope = jfluid.Scope()
                with jfluid.scope_guard(scope):
                    exe = jfluid.Executor(jfluid.CPUPlace())
                    exe.run(startup)
                    exe.run(main, feed=feed, fetch_list=names)
            else:
                scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
                exe.run(startup, scope=scope)
                exe.run(main, feed=feed, fetch_list=names, scope=scope)
        except Exception as e:  # noqa: BLE001 - compared below
            return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("bad", [np.nan, np.inf])
@pytest.mark.parametrize("fetch", [["loss"], ["pred", "loss"], []])
def test_a_nan_feed_raises_naming_the_variable(bad, fetch):
    got = _errors("torch", _feed(bad), fetch)
    want = _errors("jax", _feed(bad), fetch)
    assert got is not None and got[0] == "EnforceError"
    assert "NaN/Inf detected in variable" in got[1]
    assert got == want
    name = got[1].split("'")[1]
    if fetch:
        main, _, loss, pred = _program("torch")
        assert name == {"loss": loss, "pred": pred}[fetch[0]].name


def test_clean_runs_pass_and_the_flag_is_off_by_default():
    assert _errors("torch", _feed(), ["loss"]) is None
    assert tfluid.get_flag("check_nan_inf") is False
    assert j_flags.get_flag("check_nan_inf") is False
    main, startup, loss, _ = _program("torch")
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    out, = exe.run(main, feed=_feed(np.nan), fetch_list=[loss], scope=scope)
    assert np.isnan(out).all()


def test_run_steps_checks_after_its_steps():
    main, startup, loss, _ = _program("torch")
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    feeds = [_feed(), _feed(np.inf), _feed()]
    with _flags("torch", {"check_nan_inf": True}):
        with pytest.raises(tfluid.EnforceError, match=loss.name):
            exe.run_steps(main, feed_list=feeds, fetch_list=[loss],
                          scope=scope)
        fresh = tfluid.Scope()
        exe.run(startup, scope=fresh)
        out, = exe.run_steps(main, feed_list=[_feed(), _feed()],
                             fetch_list=[loss], scope=fresh)
    assert np.isfinite(out).all()
