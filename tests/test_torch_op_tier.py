"""The rest of the conv tier and the image layers of paddle_tpu_torch
held to paddle_tpu: ``conv3d``, ``conv2d_transpose``,
``conv3d_transpose``, ``pool3d``, ``layer_norm``, ``lrn``, ``im2sequence``,
``batch_norm(data_layout="NHWC")``, ``image_resize`` (both methods, both
directions), ``image_resize_short``, ``resize_bilinear`` and
``roi_pool``, and the cases of tests/test_op_gap.py that use them.

Each case builds the same small program in both packages — a 1x1 conv
in front (``conv2d``, or ``conv3d`` for 5-D input), so the op's input
gradient reaches a parameter — with the loss ``mean(out * r)`` for a
seeded random ``r`` and ``SGD(0)`` to bind every ``@GRAD``; the JAX
package's parameters are carried over with ``params_from_numpy``. The
output and every gradient agree within 1e-5 of the array's largest
magnitude (and rtol 1e-5).
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
    "conv3d": ("test_op_matches_the_jax_package[conv3d]",),
    "conv2d_transpose": (
        "test_op_matches_the_jax_package[conv2d_transpose]",),
    "conv3d_transpose": (
        "test_op_matches_the_jax_package[conv3d_transpose]",),
    "pool3d": ("test_op_matches_the_jax_package[pool3d_max]",),
    "layer_norm": ("test_op_matches_the_jax_package[layer_norm]",),
    "lrn": ("test_op_matches_the_jax_package[lrn]",),
    "im2sequence": ("test_op_matches_the_jax_package[im2sequence]",),
    "batch_norm": ("test_batch_norm_nhwc_matches_the_jax_package",),
    "resize_bilinear": (
        "test_op_matches_the_jax_package[resize_bilinear_up]",),
    "image_resize": (
        "test_op_matches_the_jax_package[resize_bilinear_down]",
        "test_op_matches_the_jax_package[resize_nearest_up]"),
    "image_resize_short": ("test_op_matches_the_jax_package[resize_short]",),
    "roi_pool": ("test_roi_pool_matches_the_jax_package",),
}


def _program(pkg, shape, body, out_shape, front):
    fluid, guard = package(pkg)
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=list(shape), dtype="float32",
                              append_batch_size=False)
        if front:
            conv = (fluid.layers.conv3d if len(shape) == 5
                    else fluid.layers.conv2d)
            x = conv(input=x, num_filters=shape[1], filter_size=1,
                     bias_attr=False)
        out = body(fluid.layers, x)
        r = fluid.layers.data(name="r", shape=list(out_shape),
                              dtype="float32", append_batch_size=False)
        loss = fluid.layers.mean(fluid.layers.elementwise_mul(out, r))
        fluid.optimizer.SGD(learning_rate=0.0).minimize(loss)
    return main, startup, out, loss


def run_both(shape, out_shape, body, front=True, runs=1, extra=(), seed=0,
             feed_extra=None, for_test=False):
    """{pkg: (the last run's out, loss and every @GRAD; the persistables
    ``extra`` after the runs)}, the port from the JAX package's start
    state; ``for_test`` runs a ``clone(for_test=True)`` of the program
    after the training runs and returns its ``out`` third."""
    rng = np.random.RandomState(seed)
    feed = {"x": rng.randn(*shape).astype(np.float32),
            "r": rng.randn(*out_shape).astype(np.float32),
            **(feed_extra or {})}
    main, startup, out, loss = _program("jax", shape, body, out_shape, front)
    j_main = main
    fetch = [out.name, loss.name] + [p.name + "@GRAD"
                                     for p in main.all_parameters()]
    res = {}
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        state = {v.name: np.asarray(scope.find_var(v.name))
                 for v in main.list_vars() if v.persistable}
        for _ in range(runs):
            got = exe.run(main, feed=feed, fetch_list=fetch)
        tested = (np.asarray(exe.run(main.clone(for_test=True), feed=feed,
                                     fetch_list=[out.name])[0])
                  if for_test else None)
        res["jax"] = ([np.asarray(g) for g in got],
                      {n: np.asarray(scope.find_var(n)) for n in extra},
                      tested)
    main, startup, out, loss = _program("torch", shape, body, out_shape,
                                        front)
    assert symbol_table(main) == symbol_table(j_main)
    scope, place = tfluid.Scope(), tfluid.CPUPlace()
    exe = tfluid.Executor(place)
    tfluid.state_from_numpy(state, scope, place, program=main)
    for _ in range(runs):
        got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    tested = (exe.run(main.clone(for_test=True), feed=feed,
                      fetch_list=[out.name], scope=scope)[0]
              if for_test else None)
    res["torch"] = (got, {n: tfluid.fetch_var(n, scope) for n in extra},
                    tested)
    return res, fetch


def close(got, want, name, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=name)


def check(res, fetch):
    for name, got, want in zip(fetch, res["torch"][0], res["jax"][0]):
        close(got, want, name)


# name -> (input shape, output shape, body)
CASES = {
    "conv3d": ((2, 4, 5, 6, 6), (2, 6, 5, 6, 6), lambda L, x: L.conv3d(
        x, num_filters=6, filter_size=3, padding=1)),
    "conv3d_stride_groups_relu": (
        (2, 4, 5, 6, 6), (2, 6, 3, 4, 3), lambda L, x: L.conv3d(
            x, num_filters=6, filter_size=(3, 2, 3), stride=2, padding=1,
            groups=2, act="relu")),
    "conv3d_dilation_nobias": (
        (2, 4, 6, 6, 6), (2, 4, 6, 6, 6), lambda L, x: L.conv3d(
            x, num_filters=4, filter_size=3, padding=2, dilation=2,
            bias_attr=False)),
    "conv2d_transpose": ((2, 4, 5, 5), (2, 6, 9, 9), lambda L, x:
                         L.conv2d_transpose(x, num_filters=6, filter_size=3,
                                            stride=2, padding=1)),
    "conv2d_transpose_asymmetric": (
        (2, 4, 5, 6), (2, 3, 10, 13), lambda L, x: L.conv2d_transpose(
            x, num_filters=3, filter_size=(4, 3), stride=2, padding=(1, 0),
            act="relu")),
    "conv2d_transpose_groups": (
        (2, 4, 5, 5), (2, 6, 11, 11), lambda L, x: L.conv2d_transpose(
            x, num_filters=6, filter_size=3, stride=2, groups=2)),
    "conv2d_transpose_dilation": (
        (2, 4, 5, 5), (2, 2, 9, 9), lambda L, x: L.conv2d_transpose(
            x, num_filters=2, filter_size=3, dilation=2, bias_attr=False)),
    "conv2d_transpose_output_size": (
        (2, 4, 5, 5), (2, 3, 12, 12), lambda L, x: L.conv2d_transpose(
            x, num_filters=3, output_size=12, stride=2, padding=1)),
    "conv3d_transpose": ((1, 2, 3, 3, 3), (1, 4, 6, 6, 6), lambda L, x:
                         L.conv3d_transpose(x, num_filters=4, filter_size=2,
                                            stride=2)),
    "conv3d_transpose_groups_output_size": (
        (1, 4, 3, 4, 3), (1, 6, 7, 9, 7), lambda L, x: L.conv3d_transpose(
            x, num_filters=6, output_size=(7, 9, 7), stride=2, padding=1,
            groups=2)),
    "pool3d_max": ((2, 3, 6, 6, 6), (2, 3, 3, 3, 3), lambda L, x: L.pool3d(
        x, pool_size=2, pool_stride=2)),
    "pool3d_avg_padded": ((2, 3, 5, 6, 6), (2, 3, 5, 6, 6),
                          lambda L, x: L.pool3d(x, pool_size=3,
                                                pool_type="avg",
                                                pool_padding=1)),
    "pool3d_max_wide_padding": ((1, 2, 4, 4, 4), (1, 2, 6, 6, 6),
                                lambda L, x: L.pool3d(x, pool_size=3,
                                                      pool_padding=2)),
    "pool3d_avg_wide_padding": ((1, 2, 4, 4, 4), (1, 2, 6, 6, 6),
                                lambda L, x: L.pool3d(x, pool_size=3,
                                                      pool_type="avg",
                                                      pool_padding=2)),
    "pool3d_global_max": ((2, 3, 4, 5, 6), (2, 3, 1, 1, 1),
                          lambda L, x: L.pool3d(x, global_pooling=True)),
    "pool3d_global_avg": ((2, 3, 4, 5, 6), (2, 3, 1, 1, 1),
                          lambda L, x: L.pool3d(x, pool_type="avg",
                                                global_pooling=True)),
    "layer_norm": ((2, 3, 4, 5), (2, 3, 4, 5), lambda L, x: L.layer_norm(
        x, begin_norm_axis=1, act="relu")),
    "layer_norm_tail_no_scale": ((2, 3, 4, 5), (2, 3, 4, 5),
                                 lambda L, x: L.layer_norm(
                                     x, begin_norm_axis=2, scale=False)),
    "lrn": ((2, 7, 4, 4), (2, 7, 4, 4), lambda L, x: L.lrn(x)),
    "lrn_even_window": ((2, 6, 3, 5), (2, 6, 3, 5), lambda L, x: L.lrn(
        x, n=4, k=2.0, alpha=1e-2, beta=0.5)),
    "im2sequence": ((2, 3, 4, 5), (2 * 3 * 4, 3 * 2 * 2), lambda L, x:
                    L.im2sequence(x, filter_size=2)),
    "im2sequence_stride_padding": (
        (2, 3, 5, 5), (2 * 3 * 3, 3 * 3 * 3), lambda L, x: L.im2sequence(
            x, filter_size=3, stride=2, padding=1)),
    "resize_bilinear_up": ((2, 3, 4, 5), (2, 3, 8, 7), lambda L, x:
                           L.resize_bilinear(x, out_shape=[8, 7])),
    "resize_bilinear_down": ((2, 3, 9, 8), (2, 3, 4, 5), lambda L, x:
                             L.image_resize(x, out_shape=[4, 5])),
    "resize_bilinear_scale": ((1, 2, 6, 6), (1, 2, 9, 9), lambda L, x:
                              L.image_resize(x, scale=1.5)),
    "resize_nearest_up": ((2, 3, 4, 5), (2, 3, 9, 7), lambda L, x:
                          L.image_resize(x, out_shape=[9, 7],
                                         resample="NEAREST")),
    "resize_nearest_down": ((2, 3, 9, 8), (2, 3, 4, 3), lambda L, x:
                            L.image_resize(x, out_shape=[4, 3],
                                           resample="NEAREST")),
    "resize_short": ((1, 2, 6, 9), (1, 2, 4, 6), lambda L, x:
                     L.image_resize_short(x, out_short_len=4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_the_jax_package(case):
    shape, out_shape, body = CASES[case]
    res, fetch = run_both(shape, out_shape, body)
    check(res, fetch)


def _roi_body(spatial_scale, with_idx):
    def body(L, x):
        rois = L.data(name="rois", shape=[5, 4], dtype="float32",
                      append_batch_size=False)
        idx = (L.data(name="bidx", shape=[5], dtype="int32",
                      append_batch_size=False) if with_idx else None)
        return L.roi_pool(x, rois, pooled_height=3, pooled_width=2,
                          spatial_scale=spatial_scale, rois_batch_idx=idx)
    return body


@pytest.mark.parametrize("spatial_scale,with_idx", [(1.0, False),
                                                    (0.5, True)])
def test_roi_pool_matches_the_jax_package(spatial_scale, with_idx):
    rois = np.array([[0, 0, 7, 5], [1, 2, 4, 6], [3.4, 0.6, 3.6, 1.4],
                     [2, 1, 9, 9], [5, 5, 5, 5]], np.float32) / (
                         spatial_scale)
    feed = {"rois": rois, "bidx": np.array([0, 1, 1, 0, 1], np.int32)}
    res, fetch = run_both((2, 3, 8, 7), (5, 3, 3, 2),
                          _roi_body(spatial_scale, with_idx),
                          feed_extra=feed)
    check(res, fetch)


@pytest.mark.parametrize("is_test", [False, True], ids=["train", "test"])
def test_batch_norm_nhwc_matches_the_jax_package(is_test):
    """Channels-last batch norm over three training runs (outputs,
    gradients, running statistics) or built ``is_test``, and a
    ``clone(for_test=True)`` after the runs; the port's NHWC result
    equals its own NCHW result transposed."""
    stats = ["batch_norm.moving_mean_0", "batch_norm.moving_var_0"]

    def body(L, x):
        x = L.transpose(x, perm=[0, 2, 3, 1])
        return L.batch_norm(input=x, is_test=is_test, act="relu",
                            data_layout="NHWC")

    res, fetch = run_both((4, 3, 6, 5), (4, 6, 5, 3), body, runs=3,
                          extra=stats, for_test=True)
    check(res, fetch)
    for name in stats:
        got, want = res["torch"][1][name], res["jax"][1][name]
        assert got.dtype == want.dtype == np.float32
        close(got, want, name)
    close(res["torch"][2], res["jax"][2], "clone(for_test)")

    def nchw(L, x):
        y = L.batch_norm(input=x, is_test=is_test, act="relu")
        return L.transpose(y, perm=[0, 2, 3, 1])

    res2, _ = run_both((4, 3, 6, 5), (4, 6, 5, 3), nchw, runs=3,
                       extra=stats)
    for got, want in zip(res["torch"][0], res2["torch"][0]):
        close(got, want, "nhwc vs nchw")


def _run_port(build, feed, fetch_n=1):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        outs = build(tfluid.layers)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    return exe.run(main, feed=feed, fetch_list=list(outs[:fetch_n]),
                   scope=scope)


def _data(L, name, shape, dtype="float32"):
    return L.data(name=name, shape=shape, dtype=dtype,
                  append_batch_size=False)


def test_op_gap_image_resize_bilinear():
    """tests/test_op_gap.py::test_image_resize_bilinear in the port."""
    rng = np.random.RandomState(7)
    x = rng.rand(1, 2, 4, 4).astype("f")
    out, = _run_port(lambda L: [L.resize_bilinear(
        _data(L, "x", [-1, 2, 4, 4]), out_shape=[8, 8])], {"x": x})
    assert out.shape == (1, 2, 8, 8)
    np.testing.assert_allclose(out.mean(), x.mean(), rtol=0.05)
    out, = _run_port(lambda L: [L.image_resize_short(
        _data(L, "x", [-1, 2, 4, 8]), out_short_len=2)],
        {"x": rng.rand(1, 2, 4, 8).astype("f")})
    assert out.shape == (1, 2, 2, 4)


def test_op_gap_roi_pool():
    """tests/test_op_gap.py::test_roi_pool in the port."""
    x = np.arange(16, dtype="f").reshape(1, 1, 4, 4)
    rois = np.array([[0, 0, 3, 3], [1, 1, 2, 2]], "float32")
    out, = _run_port(lambda L: [L.roi_pool(
        _data(L, "x", [-1, 1, 4, 4]), _data(L, "r", [-1, 4]),
        pooled_height=2, pooled_width=2)], {"x": x, "r": rois})
    np.testing.assert_allclose(out[0, 0], [[5, 7], [13, 15]])
    np.testing.assert_allclose(out[1, 0], [[5, 6], [9, 10]])


def test_op_gap_conv3d_transpose_shape():
    """tests/test_op_gap.py::test_conv3d_transpose_shape_and_identity in
    the port."""
    x = np.random.RandomState(7).randn(1, 1, 3, 3, 3).astype("f")
    out, = _run_port(lambda L: [L.conv3d_transpose(
        _data(L, "x", [-1, 1, 3, 3, 3]), num_filters=2, filter_size=2,
        stride=2, bias_attr=False)], {"x": x})
    assert out.shape == (1, 2, 6, 6, 6)


def test_transposed_filters_carry_the_reference_layout():
    """The transposed convs' filters are ``(in, out / groups, k...)`` in
    both packages, so ``params_from_numpy`` carries them as they are."""
    for pkg in ("jax", "torch"):
        fluid, guard = package(pkg)
        main = fluid.Program()
        with guard(), fluid.program_guard(main, fluid.Program()):
            x = fluid.layers.data(name="x", shape=[2, 4, 5, 5],
                                  dtype="float32", append_batch_size=False)
            fluid.layers.conv2d_transpose(x, num_filters=6, filter_size=3,
                                          groups=2, bias_attr=False)
            v = fluid.layers.data(name="v", shape=[2, 4, 3, 5, 5],
                                  dtype="float32", append_batch_size=False)
            fluid.layers.conv3d_transpose(v, num_filters=2,
                                          filter_size=(2, 3, 1),
                                          bias_attr=False)
        assert [tuple(p.shape) for p in main.all_parameters()] == [
            (4, 3, 3, 3), (4, 2, 2, 3, 1)]


def test_roi_pool_bins_at_every_height():
    """Rois 1-60 rows high (and wide) pooled to 7x7: the bins' integer
    bounds equal the JAX package's (its compiled ``rh / 7`` is ``rh *
    f32(1 / 7)``, whose ``ceil`` ends some last bins a row later than a
    true quotient's)."""
    x = np.random.RandomState(2).randn(1, 2, 64, 64).astype(np.float32)
    sizes = np.arange(1, 61)
    rois = np.stack([np.zeros(60), np.zeros(60), sizes - 1, sizes - 1],
                    1).astype(np.float32)
    out = {}
    for pkg in ("jax", "torch"):
        fluid, guard = package(pkg)
        main = fluid.Program()
        with guard(), fluid.program_guard(main, fluid.Program()):
            L = fluid.layers
            xv = L.data(name="x", shape=[1, 2, 64, 64], dtype="float32",
                        append_batch_size=False)
            rv = L.data(name="r", shape=[60, 4], dtype="float32",
                        append_batch_size=False)
            y = L.roi_pool(xv, rv, pooled_height=7, pooled_width=7)
        exe = fluid.Executor(fluid.CPUPlace())
        if pkg == "jax":
            with jfluid.scope_guard(jfluid.Scope()):
                out[pkg] = np.asarray(exe.run(main, feed={"x": x, "r": rois},
                                              fetch_list=[y])[0])
        else:
            out[pkg] = exe.run(main, feed={"x": x, "r": rois},
                               fetch_list=[y])[0]
    np.testing.assert_array_equal(out["torch"], out["jax"])


def test_nearest_resize_indices_at_every_size():
    """Nearest resizes from 2, 6 and 7 pixels to each of 35-64
    (where a true quotient's floor parts from the folded ratio's, as at
    6 to 37, 2 to 41): the gathered source indices equal
    ``jax.image.resize``'s compiled ones."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu_torch.layers.image import _nearest_index

    for m in (2, 6, 7):
        src = jnp.arange(m, dtype=jnp.float32)[None, :]
        for n in range(35, 65):
            want = np.asarray(jax.image.resize(src, (1, n), "nearest"))[0]
            got = torch.clamp(_nearest_index(m, n, "cpu"), max=m - 1)
            np.testing.assert_array_equal(got.numpy(), want.astype(np.int64),
                                          err_msg="%d -> %d" % (m, n))
