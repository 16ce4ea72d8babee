"""paddle_tpu_torch.layers.conv (``conv2d``, ``pool2d``, ``batch_norm``)
held to paddle_tpu.layers.conv.

Each case builds the same small program in both packages — a 1x1 conv
in front where the op under test has no parameter of its own, so its
input gradient reaches one — with the loss ``mean(out * r)`` for a
seeded random ``r``, and ``SGD(0)`` to bind every ``@GRAD``. The JAX
package's parameters are carried over with ``params_from_numpy``. The
output and every parameter's gradient agree within ``tol`` of the
array's largest magnitude (and rtol ``tol``): f32 1e-5, and under
``use_bfloat16`` + ``bf16_activations`` 2e-2 (bf16 rounds at other
places in the two frameworks: XLA rounds a fusion's result once, torch
each op's).

* ``conv2d``: stride, padding, groups, dilation, bias with an
  activation.
* ``pool2d``: max and average (exclusive and not), global, a padding
  wider than half the window (explicitly padded), and ``ceil_mode``
  with a ragged last window, where torch's own ``ceil_mode`` would
  divide by another count; a window that starts in the right padding,
  which torch's ``ceil_mode`` drops and the JAX package keeps (-inf for
  max pooling), is held in the forward.
* ``batch_norm``: training (population variance, the JAX package's
  momentum convention) over three runs — outputs, gradients and the
  running statistics after them — and ``is_test``, built so and through
  ``Program.clone(for_test=True)``.
* ResNet's head: ``fc`` over a pooled ``[B, C, 1, 1]`` map (flattened at
  ``num_flatten_dims=1``) with a softmax, ``cross_entropy`` of those
  probabilities and ``mean``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique_name

from _torch_port import _flags, symbol_table

torch.set_num_threads(1)

BF16 = {"use_bfloat16": True, "bf16_activations": True}
TOL = {"f32": 1e-5, "bf16": 2e-2}


def _package(pkg):
    return ((jfluid, j_unique_name.guard) if pkg == "jax"
            else (tfluid, tfluid.unique_name.guard))


def _program(pkg, shape, body, front_conv, out_shape):
    """(main, startup, out, loss): data x of ``shape`` (through a 1x1
    conv with ``front_conv``), ``body(layers, x)``, loss mean(out * r)
    with r a second data input, SGD(0) for the gradients."""
    fluid, guard = _package(pkg)
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=list(shape), dtype="float32",
                              append_batch_size=False)
        if front_conv:
            x = fluid.layers.conv2d(input=x, num_filters=shape[1],
                                    filter_size=1, bias_attr=False)
        out = body(fluid.layers, x)
        r = fluid.layers.data(name="r", shape=list(out_shape),
                              dtype="float32", append_batch_size=False)
        loss = fluid.layers.mean(fluid.layers.elementwise_mul(out, r))
        fluid.optimizer.SGD(learning_rate=0.0).minimize(loss)
    return main, startup, out, loss


def _run_both(shape, out_shape, body, dtype, front_conv=True, runs=1,
              extra=(), seed=0, feed_extra=None):
    """{pkg: (fetches of the last run: out, loss, every @GRAD; the
    persistables after the runs)} for both packages, the port from the
    JAX package's parameters."""
    rng = np.random.RandomState(seed)
    feed = {"x": rng.randn(*shape).astype(np.float32),
            "r": rng.randn(*out_shape).astype(np.float32),
            **(feed_extra or {})}
    values = BF16 if dtype == "bf16" else {}
    res = {}
    with _flags("jax", values):
        main, startup, out, loss = _program("jax", shape, body, front_conv,
                                            out_shape)
        params = [p.name for p in main.all_parameters()]
        fetch = [out.name, loss.name] + [p + "@GRAD" for p in params]
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            exe = jfluid.Executor(jfluid.CPUPlace())
            exe.run(startup)
            weights = {p: np.asarray(scope.find_var(p)) for p in params}
            for _ in range(runs):
                got = exe.run(main, feed=feed, fetch_list=fetch)
            res["jax"] = ([np.asarray(g).astype(np.float32) for g in got],
                          {n: np.asarray(scope.find_var(n))
                           for n in extra})
            j_main = main
    with _flags("torch", values):
        main, startup, out, loss = _program("torch", shape, body,
                                            front_conv, out_shape)
    assert symbol_table(main) == symbol_table(j_main)
    scope, place = tfluid.Scope(), tfluid.CPUPlace()
    exe = tfluid.Executor(place)
    exe.run(startup, scope=scope)
    tfluid.params_from_numpy(weights, scope, place, program=main)
    for _ in range(runs):
        got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    res["torch"] = (got, {n: tfluid.fetch_var(n, scope) for n in extra})
    return res, fetch, main, scope, feed


def _close(got, want, tol, name):
    assert got.shape == want.shape, (name, got.shape, want.shape)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite, err_msg=name)
    np.testing.assert_array_equal(got[~finite], want[~finite], err_msg=name)
    scale = float(np.abs(want[finite]).max()) if finite.any() else 0.0
    np.testing.assert_allclose(got[finite], want[finite], rtol=tol,
                               atol=tol * scale, err_msg=name)


def _check(res, fetch, dtype):
    for name, got, want in zip(fetch, res["torch"][0], res["jax"][0]):
        _close(got, want, TOL[dtype], name)


CONV_CASES = {
    "plain": dict(num_filters=6, filter_size=3, padding=1),
    "stride_padding": dict(num_filters=6, filter_size=3, stride=2,
                           padding=1),
    "groups": dict(num_filters=6, filter_size=3, padding=1, groups=2),
    "dilation": dict(num_filters=6, filter_size=3, padding=2, dilation=2),
    "bias_relu": dict(num_filters=6, filter_size=1, act="relu"),
}
CONV_OUT = {"plain": (2, 6, 8, 8), "stride_padding": (2, 6, 4, 4),
            "groups": (2, 6, 8, 8), "dilation": (2, 6, 8, 8),
            "bias_relu": (2, 6, 8, 8)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_matches_the_jax_package(case, dtype):
    kw = dict(CONV_CASES[case])
    bias = kw.pop("act", None) is not None
    act = CONV_CASES[case].get("act")

    def body(L, x):
        return L.conv2d(input=x, act=act,
                        bias_attr=None if bias else False, **kw)

    res, fetch, *_ = _run_both((2, 4, 8, 8), CONV_OUT[case], body, dtype,
                               front_conv=False)
    assert len(fetch) == 2 + (2 if bias else 1)
    _check(res, fetch, dtype)


# name -> (input shape, output shape, pool2d kwargs)
POOL_CASES = {
    "max": ((2, 4, 8, 8), (2, 4, 4, 4),
            dict(pool_size=3, pool_type="max", pool_stride=2,
                 pool_padding=1)),
    "avg_exclusive": ((2, 4, 8, 8), (2, 4, 4, 4),
                      dict(pool_size=3, pool_type="avg", pool_stride=2,
                           pool_padding=1)),
    "avg_inclusive": ((2, 4, 8, 8), (2, 4, 4, 4),
                      dict(pool_size=3, pool_type="avg", pool_stride=2,
                           pool_padding=1, exclusive=False)),
    "avg_unpadded": ((2, 4, 8, 8), (2, 4, 4, 4),
                     dict(pool_size=2, pool_type="avg", pool_stride=2)),
    "max_wide_padding": ((2, 4, 8, 8), (2, 4, 10, 10),
                         dict(pool_size=3, pool_type="max", pool_stride=1,
                              pool_padding=2)),
    "global_max": ((2, 4, 8, 8), (2, 4, 1, 1),
                   dict(pool_type="max", global_pooling=True)),
    "global_avg": ((2, 4, 8, 8), (2, 4, 1, 1),
                   dict(pool_size=8, pool_type="avg", global_pooling=True)),
    "ceil_max": ((2, 4, 6, 6), (2, 4, 3, 3),
                 dict(pool_size=3, pool_type="max", pool_stride=2,
                      ceil_mode=True)),
    "ceil_avg_exclusive": ((2, 4, 6, 6), (2, 4, 3, 3),
                           dict(pool_size=3, pool_type="avg", pool_stride=2,
                                ceil_mode=True)),
    "ceil_avg_inclusive": ((2, 4, 6, 6), (2, 4, 3, 3),
                           dict(pool_size=3, pool_type="avg", pool_stride=2,
                                ceil_mode=True, exclusive=False)),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool2d_matches_the_jax_package(case, dtype):
    shape, out_shape, kw = POOL_CASES[case]
    res, fetch, *_ = _run_both(shape, out_shape,
                               lambda L, x: L.pool2d(input=x, **kw), dtype)
    _check(res, fetch, dtype)


def test_pool2d_ceil_mode_keeps_a_window_in_the_padding():
    """Size 5, window 2, stride 2, padding 1: the JAX package's
    ``ceil_mode`` counts four windows, the last wholly in the right
    padding (max pooling gives -inf there); torch's ``ceil_mode`` would
    count three."""
    x = np.random.RandomState(3).randn(1, 2, 5, 5).astype(np.float32)
    outs = {}
    for pkg in ("jax", "torch"):
        fluid, guard = _package(pkg)
        main, startup = fluid.Program(), fluid.Program()
        with guard(), fluid.program_guard(main, startup):
            xv = fluid.layers.data(name="x", shape=[1, 2, 5, 5],
                                   dtype="float32", append_batch_size=False)
            out = fluid.layers.pool2d(input=xv, pool_size=2, pool_stride=2,
                                      pool_padding=1, ceil_mode=True)
        exe = (jfluid.Executor(jfluid.CPUPlace()) if pkg == "jax"
               else tfluid.Executor(tfluid.CPUPlace()))
        outs[pkg] = np.asarray(exe.run(main, feed={"x": x},
                                       fetch_list=[out])[0])
    assert outs["torch"].shape == outs["jax"].shape == (1, 2, 4, 4)
    assert np.all(np.isneginf(outs["torch"][..., -1, :]))
    np.testing.assert_array_equal(outs["torch"], outs["jax"])
    native = torch.nn.functional.max_pool2d(torch.from_numpy(x), 2, 2, 1,
                                            ceil_mode=True)
    assert native.shape == (1, 2, 3, 3)


def _bn_body(is_test):
    return lambda L, x: L.batch_norm(input=x, is_test=is_test, act="relu")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("is_test", [False, True], ids=["train", "test"])
def test_batch_norm_matches_the_jax_package(is_test, dtype):
    stats = ["batch_norm.moving_mean_0", "batch_norm.moving_var_0"]
    res, fetch, main, scope, feed = _run_both(
        (4, 3, 6, 6), (4, 3, 6, 6), _bn_body(is_test), dtype, runs=3,
        extra=stats)
    _check(res, fetch, dtype)
    for name in stats:
        got, want = res["torch"][1][name], res["jax"][1][name]
        assert got.dtype == want.dtype == np.float32, name
        # f32 state; under bf16 the statistics of bf16 conv outputs,
        # which round at other places in the two frameworks
        _close(got, want, TOL[dtype], name)
    if is_test:
        np.testing.assert_array_equal(res["torch"][1][stats[0]], 0.0)
        np.testing.assert_array_equal(res["torch"][1][stats[1]], 1.0)
    else:
        # the statistics are detached state: nothing of the step's
        # autograd graph stays in the scope
        assert not any(getattr(scope.find_var(n), "requires_grad", False)
                       or getattr(scope.find_var(n), "grad_fn", None)
                       for n in stats)


def test_batch_norm_clone_for_test_uses_the_running_statistics():
    """A program cloned ``for_test`` normalizes by the running
    statistics the training runs left, as the JAX package's clone."""
    rng = np.random.RandomState(5)
    x = rng.randn(4, 3, 6, 6).astype(np.float32)
    outs = {}
    for pkg in ("jax", "torch"):
        fluid, guard = _package(pkg)
        main, startup = fluid.Program(), fluid.Program()
        with guard(), fluid.program_guard(main, startup):
            xv = fluid.layers.data(name="x", shape=[4, 3, 6, 6],
                                   dtype="float32", append_batch_size=False)
            out = fluid.layers.batch_norm(input=xv)
        test_prog = main.clone(for_test=True)
        op, = [o for o in test_prog.global_block().ops
               if o.type == "batch_norm"]
        assert op.attrs["is_test"] is True
        if pkg == "jax":
            scope = jfluid.Scope()
            with jfluid.scope_guard(scope):
                exe = jfluid.Executor(jfluid.CPUPlace())
                exe.run(startup)
                for _ in range(3):
                    exe.run(main, feed={"x": x + 1.0})
                outs[pkg] = np.asarray(exe.run(test_prog, feed={"x": x},
                                               fetch_list=[out])[0])
        else:
            scope = tfluid.Scope()
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup, scope=scope)
            for _ in range(3):
                exe.run(main, feed={"x": x + 1.0}, scope=scope)
            outs[pkg] = exe.run(test_prog, feed={"x": x}, fetch_list=[out],
                                scope=scope)[0]
    np.testing.assert_allclose(outs["torch"], outs["jax"], rtol=1e-5,
                               atol=1e-5 * np.abs(outs["jax"]).max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_resnet_head_matches_the_jax_package(dtype):
    """pool2d(global) -> fc(softmax) -> cross_entropy -> mean, as
    resnet_imagenet ends; ``out`` is the per-example loss."""
    rng = np.random.RandomState(9)
    lbl = rng.randint(0, 5, (3, 1)).astype(np.int64)

    def body(L, x):
        pooled = L.pool2d(input=x, pool_size=4, pool_type="avg",
                          global_pooling=True)
        predict = L.fc(input=pooled, size=5, act="softmax")
        label = L.data(name="lbl", shape=[3, 1], dtype="int64",
                       append_batch_size=False)
        return L.cross_entropy(input=predict, label=label)

    res, fetch, main, *_ = _run_both((3, 8, 4, 4), (3, 1), body, dtype,
                                     feed_extra={"lbl": lbl})
    w = [v for v in main.all_parameters() if v.name.startswith("fc.w_")]
    assert [tuple(v.shape) for v in w] == [(8, 5)]
    _check(res, fetch, dtype)
