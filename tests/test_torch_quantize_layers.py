"""paddle_tpu_torch.layers.quantize held to paddle_tpu.layers.quantize:
``fake_quantize_abs_max``, ``fake_quantize_range_abs_max`` (its window
buffer and step count persistable state, across training runs and in a
``clone(for_test=True)``) and ``fake_dequantize_max_abs`` — outputs,
scales, state and every gradient (the rounding's straight-through
gradient, the clip's half gradient at the bound, the scale's own
gradient) — and the tests of tests/test_parity_ops.py and
tests/test_review_fixes.py that use these layers.

Quantized values and states equal; scales, dequantized values and
gradients within 1e-5 of the array's largest magnitude.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid

from _torch_port import package, symbol_table

torch.set_num_threads(1)

TOL = 1e-5
# each layer of the module -> the tests here that hold it to the JAX
# package ("test[case]": one case of the file's parametrised table)
PARITY = {
    "fake_quantize_abs_max": (
        "test_abs_max_quant_dequant_matches_the_jax_package",),
    "fake_quantize_range_abs_max": (
        "test_range_abs_max_window_across_runs",
        "test_range_abs_max_is_test_reads_the_window"),
    "fake_dequantize_max_abs": (
        "test_abs_max_quant_dequant_matches_the_jax_package",
        "test_range_abs_max_window_across_runs"),
}


def _program(pkg, body):
    fluid, guard = package(pkg)
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[-1, 6], dtype="float32",
                              append_batch_size=False)
        h = fluid.layers.fc(x, size=6)
        outs = body(fluid.layers, h)
        r = fluid.layers.data(name="r", shape=[-1, 6], dtype="float32",
                              append_batch_size=False)
        loss = fluid.layers.mean(fluid.layers.elementwise_mul(outs[0], r))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, outs, loss


def run_both(body, feeds, for_test=False):
    """Per run: the outputs of ``body``, the loss, every @GRAD and every
    persistable after the run, in both packages (the port from the JAX
    package's start state); ``for_test`` adds a run of the program's
    ``clone(for_test=True)`` on the last feed."""
    out = {}
    for pkg in ("jax", "torch"):
        main, startup, outs, loss = _program(pkg, body)
        fetch = ([o.name for o in outs] + [loss.name]
                 + [p.name + "@GRAD" for p in main.all_parameters()])
        persist = sorted(v.name for v in main.list_vars() if v.persistable)
        runs = []
        if pkg == "jax":
            j_main = main
            scope = jfluid.Scope()
            with jfluid.scope_guard(scope):
                exe = jfluid.Executor(jfluid.CPUPlace())
                exe.run(startup)
                state = {n: np.asarray(scope.find_var(n)) for n in persist}
                for feed in feeds:
                    got = exe.run(main, feed=feed, fetch_list=fetch)
                    runs.append([np.asarray(g) for g in got]
                                + [np.asarray(scope.find_var(n))
                                   for n in persist])
                if for_test:
                    runs.append([np.asarray(g) for g in exe.run(
                        main.clone(for_test=True), feed=feeds[-1],
                        fetch_list=[o.name for o in outs])])
        else:
            assert symbol_table(main) == symbol_table(j_main)
            place, scope = tfluid.CPUPlace(), tfluid.Scope()
            tfluid.state_from_numpy(state, scope, place, program=main)
            exe = tfluid.Executor(place)
            for feed in feeds:
                got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
                runs.append(list(got) + [tfluid.fetch_var(n, scope)
                                         for n in persist])
            if for_test:
                runs.append(exe.run(main.clone(for_test=True),
                                    feed=feeds[-1],
                                    fetch_list=[o.name for o in outs],
                                    scope=scope))
        out[pkg] = runs
    names = fetch + persist
    for i, (got, want) in enumerate(zip(out["torch"], out["jax"])):
        for name, g, w in zip(names, got, want):
            g, w = np.asarray(g), np.asarray(w)
            assert g.shape == w.shape and g.dtype == w.dtype, (i, name)
            np.testing.assert_allclose(
                g, w, rtol=TOL, atol=TOL * float(np.abs(w).max(initial=0)),
                err_msg="run %d %s" % (i, name))
    return out["torch"]


def _feeds(n, seed=0, scales=None):
    r = np.random.RandomState(seed)
    return [{"x": (r.randn(4, 6) * (scales[i] if scales else 1.0)).astype(
        np.float32), "r": r.randn(4, 6).astype(np.float32)}
        for i in range(n)]


@pytest.mark.parametrize("bits", [8, 4])
def test_abs_max_quant_dequant_matches_the_jax_package(bits):
    bound = float(2 ** (bits - 1) - 1)

    def body(L, h):
        q, s = L.fake_quantize_abs_max(h, bit_length=bits)
        return [L.fake_dequantize_max_abs(q, s, max_range=bound), q, s]

    runs = run_both(body, _feeds(3))
    for run in runs:
        q = run[1]
        np.testing.assert_array_equal(q, np.round(q))
        assert np.abs(q).max() == bound     # the max element at the bound


def test_range_abs_max_window_across_runs():
    """A window of 3 over five training runs whose activations shrink,
    then a ``clone(for_test=True)``: the scale holds the window's max,
    so it drops once the large runs leave it."""
    def body(L, h):
        q, s = L.fake_quantize_range_abs_max(h, bit_length=8,
                                             window_size=3)
        return [L.fake_dequantize_max_abs(q, s, max_range=127.0), q, s]

    runs = run_both(body, _feeds(5, scales=[4.0, 3.0, 1.0, 0.5, 0.4]),
                    for_test=True)
    scales = [float(r[2]) for r in runs[:5]]
    assert scales[0] == scales[1] == scales[2] > scales[3] > scales[4]


def test_range_abs_max_is_test_reads_the_window():
    def body(L, h):
        q, s = L.fake_quantize_range_abs_max(h, window_size=4,
                                             is_test=True)
        return [q, s]

    runs = run_both(body, _feeds(2))
    assert runs[0][1] == np.float32(1e-8)  # an empty window: the floor


def _run_port(build, feed):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        outs = build(tfluid.layers)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    return exe, main, scope, outs


def test_fake_quantize_abs_max():
    """tests/test_parity_ops.py's cases in the port."""
    x = np.array([[0.5, -1.0], [0.25, 0.8]], "float32")
    exe, main, scope, outs = _run_port(lambda L: L.fake_quantize_abs_max(
        L.data(name="x", shape=[-1, 2], dtype="float32",
               append_batch_size=False), bit_length=8), {"x": x})
    got, scale = exe.run(main, feed={"x": x}, fetch_list=list(outs),
                         scope=scope)
    assert scale == pytest.approx(1.0)
    np.testing.assert_allclose(got, np.round(x / 1.0 * 127))
    x = np.random.RandomState(0).randn(4, 8).astype("float32")

    def build(L):
        q, s = L.fake_quantize_abs_max(
            L.data(name="x", shape=[-1, 8], dtype="float32",
                   append_batch_size=False), bit_length=8)
        return [L.fake_dequantize_max_abs(q, s, max_range=127.0)]

    exe, main, scope, outs = _run_port(build, {"x": x})
    deq, = exe.run(main, feed={"x": x}, fetch_list=outs, scope=scope)
    np.testing.assert_allclose(deq, x, atol=np.abs(x).max() / 127 + 1e-6)


def test_range_quant_window_shrinks_and_returns_scale():
    """tests/test_review_fixes.py's case in the port."""
    exe, main, scope, outs = _run_port(
        lambda L: L.fake_quantize_range_abs_max(
            L.data(name="x", shape=[-1, 4], dtype="float32",
                   append_batch_size=False), bit_length=8, window_size=2),
        None)

    def step(mag):
        arr = np.full((1, 4), mag, "float32")
        return float(exe.run(main, feed={"x": arr}, fetch_list=[outs[1]],
                             scope=scope)[0])

    assert step(10.0) == 10.0
    assert step(1.0) == 10.0
    assert step(1.0) == 1.0
