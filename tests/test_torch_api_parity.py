"""The public names this slice adds to the port, held to the JAX
package's runs (the counterparts of tests/test_api_parity_extra.py's
``get_var``, memory-knob, ``WeightNormParamAttr``, ``ErrorClipByValue``
and ``force_cpu`` tests), plus ``calc_gradient`` against the JAX
package's and the top-level ``save_params``/``load_params``.

Each program is built with the same calls in both packages; the JAX
package's start state is carried into the port (``_torch_port
.train_both``), so forward values and gradients compare at rtol 1e-6.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from _torch_port import _flags, package, train_both

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-6, atol=1e-7)


def test_get_var():
    """``fluid.get_var`` finds a program's variable by name, as the JAX
    package's does, and refuses what is not a name or a Program."""
    got = {}
    for pkg in ("jax", "torch"):
        fluid, guard = package(pkg)
        main, startup = fluid.Program(), fluid.Program()
        with guard(), fluid.program_guard(main, startup):
            fluid.layers.create_parameter(shape=[2], dtype="float32",
                                          name="gv")
            v = fluid.get_var("gv", main)
            assert fluid.get_var("gv").name == "gv"
        got[pkg] = (v.name, tuple(v.shape), str(np.dtype(v.dtype))
                    if pkg == "jax" else tfluid.core.dtype_utils.name(
                        v.dtype))
        with pytest.raises(Exception):
            fluid.get_var(3, main)
        with pytest.raises(Exception):
            fluid.get_var("gv", "not a program")
    assert got["jax"] == got["torch"]


def test_memory_knobs_and_stats():
    """The memory knobs of both packages on the host: a fraction out of
    (0, 1] raises, and ``memory_usage()`` is a well-formed snapshot with
    the same fields."""
    from paddle_tpu.core import memory as jmemory
    from paddle_tpu_torch.core import memory as tmemory

    for memory, kw in ((jmemory, {}), (tmemory, {"device": "cpu"})):
        with pytest.raises(Exception):
            memory.set_memory_fraction(1.5)
        stats = memory.memory_usage(**kw)
        assert stats.bytes_in_use >= 0
        assert stats.fraction_in_use is None or stats.fraction_in_use >= 0
    tstats = tmemory.memory_usage(device="cpu")
    for field in ("bytes_in_use", "bytes_limit", "fraction_in_use"):
        assert hasattr(tstats, field) and hasattr(jmemory.memory_usage(),
                                                  field)
    tmemory.preallocate(False, device="cpu")  # nothing to reserve


def _wn_build(dim, name):
    def build(pkg, fluid):
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        y = fluid.layers.fc(
            input=x, size=4, bias_attr=False,
            param_attr=fluid.WeightNormParamAttr(dim=dim, name=name))
        loss = fluid.layers.mean(y)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [y, loss, name + ".w_v@GRAD", name + ".w_g@GRAD"]
    return build


def test_weight_norm_param_attr():
    """w = g * v/||v||: g starts at the per-column norm of v (so the
    first w is v), the forward and both gradients equal the JAX
    package's at rtol 1e-6, and training moves g and v alike in both."""
    xv = np.random.RandomState(0).rand(2, 6).astype("float32")
    r = train_both(_wn_build(1, "wn"), {"x": xv}, steps=3)
    v0, g0 = r["state"]["wn.w_v"], r["state"]["wn.w_g"]
    np.testing.assert_allclose(g0, np.linalg.norm(v0, axis=0), rtol=1e-6)
    np.testing.assert_allclose(r["t_out"][0][0], xv @ v0, rtol=1e-5)
    for j, t in zip(r["j_out"], r["t_out"]):
        for a, b in zip(j, t):
            np.testing.assert_allclose(b, a, **TOL)
    for n in ("wn.w_v", "wn.w_g"):
        np.testing.assert_allclose(r["t_state"][n], r["j_state"][n], **TOL)
        assert np.abs(r["t_state"][n] - r["state"][n]).max() > 1e-6


def test_weight_norm_negative_dim_and_bf16_master():
    """``dim=-1`` gives one scale per output column, and under the bf16
    activation stream g and v stay f32 master weights, as in the JAX
    package; the step's loss agrees within bf16 rounding."""
    xv = np.random.RandomState(1).rand(2, 6).astype("float32")
    bf16 = {"use_bfloat16": True, "bf16_activations": True}
    with _flags("jax", bf16), _flags("torch", bf16):
        r = train_both(_wn_build(-1, "wnn"), {"x": xv}, steps=1)
    for state in (r["j_state"], r["t_state"]):
        assert state["wnn.w_g"].shape == (4,)
        assert state["wnn.w_g"].dtype == np.float32
        assert state["wnn.w_v"].dtype == np.float32
    np.testing.assert_allclose(r["t_out"][0][1], r["j_out"][0][1],
                               rtol=2e-2)
    for n in ("wnn.w_v", "wnn.w_g"):
        np.testing.assert_allclose(r["t_state"][n], r["j_state"][n],
                                   rtol=2e-2, atol=1e-3)


def test_error_clip_by_value():
    """``var.error_clip`` clips the cotangent through that variable:
    dL/dw = clip(5, max=0.1) * x in both packages."""
    xv = np.array([2.0, 3.0, 4.0], "float32")

    def build(pkg, fluid):
        x = fluid.layers.data(name="x", shape=[3], dtype="float32",
                              append_batch_size=False)
        w = fluid.layers.create_parameter(shape=[3], dtype="float32",
                                          name="wec")
        y = fluid.layers.elementwise_mul(x, w)
        y.error_clip = fluid.ErrorClipByValue(max=0.1)
        loss = fluid.layers.reduce_sum(fluid.layers.scale(y, scale=5.0))
        fluid.optimizer.SGD(learning_rate=0.0).minimize(loss)
        return ["wec@GRAD"]

    r = train_both(build, {"x": xv}, steps=1)
    np.testing.assert_allclose(r["t_out"][0][0], 0.1 * xv, rtol=1e-6)
    np.testing.assert_allclose(r["t_out"][0][0], r["j_out"][0][0], **TOL)


def test_force_cpu_pins_process(tmp_path):
    """``fluid.force_cpu()`` makes the CPU the process's default place:
    an Executor with no place runs on the host, card or not."""
    script = tmp_path / "fc.py"
    script.write_text(
        "import numpy as np\n"
        "import paddle_tpu_torch as fluid\n"
        "fluid.force_cpu(4)\n"
        "assert fluid.default_place() == fluid.CPUPlace()\n"
        "exe = fluid.Executor()\n"
        "assert exe.device.type == 'cpu', exe.device\n"
        "main, startup = fluid.Program(), fluid.Program()\n"
        "with fluid.program_guard(main, startup):\n"
        "    x = fluid.layers.data(name='x', shape=[2], dtype='float32')\n"
        "    y = fluid.layers.scale(x, scale=2.0)\n"
        "out, = exe.run(main, feed={'x': np.ones((1, 2), 'float32')},\n"
        "               fetch_list=[y])\n"
        "assert out.tolist() == [[2.0, 2.0]]\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, str(script)], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-800:]
    assert "ok" in proc.stdout


def test_calc_gradient_matches_the_jax_package():
    """Gradients of a target with respect to a parameter AND an
    intermediate (pinned at its value), against the JAX package's."""
    xv = np.array([[0.5, -1.0, 2.0]], "float32")
    wv = np.array([0.3, 0.7, -0.2], "float32")
    got = {}
    for pkg in ("jax", "torch"):
        fluid, guard = package(pkg)
        main, startup = fluid.Program(), fluid.Program()
        with guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[3], dtype="float32")
            w = fluid.layers.create_parameter(shape=[3], dtype="float32",
                                              name="wcg")
            h = fluid.layers.elementwise_mul(x, w)
            z = fluid.layers.reduce_sum(fluid.layers.tanh(h))
            grads = fluid.calc_gradient(z, [w, h])
        assert [g.name for g in grads] == ["wcg@GRAD", h.name + "@GRAD"]
        if pkg == "jax":
            scope = jfluid.Scope()
            with jfluid.scope_guard(scope):
                exe = jfluid.Executor(jfluid.CPUPlace())
                exe.run(startup)
                import jax.numpy as jnp

                scope.set_var("wcg", jnp.asarray(wv))
                got[pkg] = [np.asarray(a) for a in exe.run(
                    main, feed={"x": xv}, fetch_list=grads)]
        else:
            scope, place = tfluid.Scope(), tfluid.CPUPlace()
            exe = tfluid.Executor(place)
            exe.run(startup, scope=scope)
            tfluid.params_from_numpy({"wcg": wv}, scope, place,
                                     program=main)
            got[pkg] = exe.run(main, feed={"x": xv}, fetch_list=grads,
                               scope=scope)
    # h is pinned at its value: z depends on w only through h, so the
    # gradient with respect to w is zero and the one with respect to h
    # is tanh's derivative
    h = xv * wv
    np.testing.assert_array_equal(got["torch"][0], np.zeros(3, "float32"))
    np.testing.assert_allclose(got["torch"][1], 1 - np.tanh(h) ** 2,
                               rtol=1e-6)
    for a, b in zip(got["jax"], got["torch"]):
        np.testing.assert_allclose(b, a, **TOL)


def test_calc_gradient_target_gradients_and_no_grad_set():
    """``target_gradients`` weights a target element by element (the
    cotangent), and a variable in ``no_grad_set`` is held constant: the
    gradient stops there."""
    fluid = tfluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[3], dtype="float32",
                              append_batch_size=False)
        c = fluid.layers.data(name="c", shape=[3], dtype="float32",
                              append_batch_size=False)
        w = fluid.layers.create_parameter(shape=[3], dtype="float32",
                                          name="wtg")
        h = fluid.layers.elementwise_mul(x, w)
        y = fluid.layers.scale(h, scale=3.0)
        gw, = fluid.calc_gradient(y, [w], target_gradients=[c])
        gx, = fluid.calc_gradient(y, [x], no_grad_set={h.name})
    scope, place = fluid.Scope(), fluid.CPUPlace()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    wv = np.array([1.0, -2.0, 0.5], "float32")
    fluid.params_from_numpy({"wtg": wv}, scope, place, program=main)
    xv = np.array([2.0, 3.0, 4.0], "float32")
    cv = np.array([1.0, 0.0, -1.0], "float32")
    a, b = exe.run(main, feed={"x": xv, "c": cv}, fetch_list=[gw, gx],
                   scope=scope)
    np.testing.assert_allclose(a, 3.0 * xv * cv, rtol=1e-6)
    np.testing.assert_array_equal(b, np.zeros(3, "float32"))


def test_save_params_load_params_round_trip(tmp_path):
    """``fluid.save_params``/``fluid.load_params`` at the top level
    round-trip a scope's parameters."""
    fluid = tfluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        fluid.layers.fc(input=x, size=3)
    place = fluid.CPUPlace()
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    want = {p.name: fluid.fetch_var(p.name, scope)
            for p in main.all_parameters()}
    d = str(tmp_path / "params")
    fluid.save_params(exe, d, main_program=main, scope=scope)
    other = fluid.Scope()
    exe.run(startup, scope=other)
    fluid.load_params(exe, d, main_program=main, scope=other)
    for n, a in want.items():
        np.testing.assert_array_equal(fluid.fetch_var(n, other), a)
