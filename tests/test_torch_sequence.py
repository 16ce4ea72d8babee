"""The port's sequence feeds and sequence ops against the JAX package:
``layers.data(lod_level=1|2)`` and its ``@LEN``/``@LEN0`` companions,
the length propagation, ``lod_tensor.py``, the ``DataFeeder``'s
bucketed padding, every function of ``layers/sequence.py``, and the
host metrics and in-graph evaluators of ``metrics.py``/``evaluator.py``
(the oracles of tests/test_nested_lod.py and test_evaluator_debug.py).

Each op runs in both packages over the same numpy inputs (seeded); a
float input is a data var times a parameter, so the parameter's
gradient (of the sum of squares of the output) is compared too.
Tolerances: f32 values and gradients at rtol 1e-5 (atol 1e-6 of the
largest magnitude); integer outputs (lengths, ids, counts) exact.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu import lod_tensor as j_lod
from paddle_tpu_torch import lod_tensor as t_lod

from _torch_port import package, train_both

torch.set_num_threads(1)

B, T, D = 3, 6, 4
LENS = np.array([6, 2, 4], np.int32)
RTOL, ATOL = 1e-5, 1e-6


def _f(*shape, seed=0, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def assert_same(t, j, msg=""):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape, msg
    if j.dtype.kind in "biu":
        np.testing.assert_array_equal(t.astype(np.int64), j.astype(np.int64),
                                      msg)
    else:
        np.testing.assert_allclose(
            t, j, rtol=RTOL,
            atol=ATOL * max(float(np.abs(j).max(initial=0)), 1.0),
            err_msg=msg)


def seq_case(build, shape=(B, T, D), lens=LENS, extra=None, grad=True):
    """``build(L, x, v)`` over ``x`` = a 1-level sequence data var
    ``d`` times the parameter ``w`` (both ``shape``); ``extra`` adds
    data vars (name -> array, declared with their own shapes). Returns
    train_both's result; fetches are the outputs, then ``w@GRAD``."""
    feed = {"d": _f(*shape, seed=1), "d@LEN": lens}
    feed.update(extra or {})
    w = _f(*shape, seed=2, lo=0.5, hi=1.5)

    def b(pkg, fluid):
        L = fluid.layers
        d = L.data(name="d", shape=list(shape), dtype="float32",
                   append_batch_size=False, lod_level=1)
        wv = L.create_parameter(list(shape), "float32", name="w")
        v = {n: L.data(name=n, shape=list(a.shape), dtype=str(a.dtype),
                       append_batch_size=False)
             for n, a in (extra or {}).items()}
        outs = build(L, L.elementwise_mul(d, wv), v)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        fetch = list(outs)
        if grad:
            loss = L.reduce_sum(L.square(outs[0]))
            fluid.append_backward(loss)
            fetch.append("w@GRAD")
        return fetch

    return train_both(b, feed, 1, params={"w": w})


def check(r):
    for k, (t, j) in enumerate(zip(r["t_out"][0], r["j_out"][0])):
        assert_same(t, j, "fetch %d" % k)


POOLS = ["average", "sum", "sqrt", "max", "last", "first"]


@pytest.mark.parametrize("pool", POOLS)
def test_sequence_pool(pool):
    check(seq_case(lambda L, x, v: L.sequence_pool(x, pool)))


@pytest.mark.parametrize("which", ["first", "last"])
def test_sequence_first_last_step(which):
    fn = "sequence_%s_step" % which
    check(seq_case(lambda L, x, v: getattr(L, fn)(x)))


def test_sequence_pool_max_ties_split_the_gradient():
    """Tied maxima share the gradient (jnp.max's rule, torch.amax's)."""
    feed_d = np.ones((B, T, D), np.float32)

    def b(pkg, fluid):
        L = fluid.layers
        d = L.data(name="d", shape=[B, T, D], dtype="float32",
                   append_batch_size=False, lod_level=1)
        wv = L.create_parameter([B, T, D], "float32", name="w")
        out = L.sequence_pool(L.elementwise_mul(d, wv), "max")
        fluid.append_backward(L.reduce_sum(out))
        return [out, "w@GRAD"]

    r = train_both(b, {"d": feed_d, "d@LEN": LENS}, 1,
                   params={"w": np.ones((B, T, D), np.float32)})
    check(r)
    assert r["t_out"][0][1][1, 0, 0] == 0.5  # two tied valid steps


def test_sequence_softmax():
    check(seq_case(lambda L, x, v: L.sequence_softmax(x), shape=(B, T)))


@pytest.mark.parametrize("filter_size,act", [(3, "tanh"), (4, None),
                                             (1, "sigmoid")])
def test_sequence_conv(filter_size, act):
    check(seq_case(lambda L, x, v: L.sequence_conv(
        x, num_filters=5, filter_size=filter_size, act=act)))


def test_sequence_conv_window_wider_than_the_sequence():
    check(seq_case(lambda L, x, v: L.sequence_conv(
        x, num_filters=3, filter_size=9, bias_attr=False)))


def test_sequence_expand():
    extra = {"row": _f(B, D, seed=5)}
    check(seq_case(lambda L, x, v: L.sequence_expand(
        L.elementwise_mul(v["row"], L.sequence_pool(x, "sum")), x),
        extra=extra))


def test_sequence_expand_same_rank():
    check(seq_case(lambda L, x, v: L.sequence_expand(x, x)))


def test_sequence_reverse():
    check(seq_case(lambda L, x, v: L.sequence_reverse(x)))


def test_sequence_pad():
    check(seq_case(lambda L, x, v: L.sequence_pad(x, pad_value=-3.5)[0]))


def test_sequence_reshape():
    r = seq_case(lambda L, x, v: [L.sequence_reshape(x, new_dim=2)])
    check(r)
    r = seq_case(lambda L, x, v: [L.sequence_reshape(x, new_dim=8)])
    check(r)


def test_sequence_reshape_lengths_scale():
    def b(L, x, v):
        out = L.sequence_reshape(x, new_dim=2)
        return [out, L.length_var_of(out)]

    r = seq_case(b, grad=False)
    check(r)
    np.testing.assert_array_equal(r["t_out"][0][1], LENS * D // 2)


def test_sequence_slice():
    extra = {"off": np.array([1, 0, 2], np.int64),
             "n": np.array([3, 2, 1], np.int64)}

    def b(L, x, v):
        out = L.sequence_slice(x, v["off"], v["n"])
        return [out, L.length_var_of(out)]

    check(seq_case(b, extra=extra))


def test_sequence_concat():
    extra = {"e": _f(B, 3, D, seed=7), "e@LEN": np.array([1, 3, 0],
                                                          np.int32)}

    def b(L, x, v):
        e = L.data(name="e", shape=[B, 3, D], dtype="float32",
                   append_batch_size=False, lod_level=1)
        out = L.sequence_concat([x, e])
        return [out, L.length_var_of(out)]

    check(_concat_case(b, extra))


def _concat_case(build, extra_feed):
    feed = {"d": _f(B, T, D, seed=1), "d@LEN": LENS}
    feed.update(extra_feed)

    def b(pkg, fluid):
        L = fluid.layers
        d = L.data(name="d", shape=[B, T, D], dtype="float32",
                   append_batch_size=False, lod_level=1)
        wv = L.create_parameter([B, T, D], "float32", name="w")
        outs = build(L, L.elementwise_mul(d, wv), {})
        fluid.append_backward(L.reduce_sum(L.square(outs[0])))
        return outs + ["w@GRAD"]

    return train_both(b, feed, 1,
                      params={"w": _f(B, T, D, seed=2, lo=0.5, hi=1.5)})


@pytest.mark.parametrize("mode", ["maxlen", "like"])
def test_sequence_mask(mode):
    def b(L, x, v):
        lv = L.length_var_of(x)
        if mode == "maxlen":
            return [L.sequence_mask(lv, maxlen=T + 2, dtype="float32")]
        return [L.sequence_mask(lv, like=x, dtype="int32")]

    check(seq_case(b, grad=False))


def test_sequence_erase():
    ids = np.array([[3, 1, 4, 1, 5, 9], [2, 6, 5, 3, 5, 8],
                    [1, 1, 1, 7, 1, 1]], np.int64)
    lens = np.array([6, 4, 5], np.int32)
    out, new_len = _int_case(
        lambda L, s: list(L.sequence_erase(s, tokens=[1, 5])), ids, lens)
    np.testing.assert_array_equal(new_len, [3, 3, 1])
    np.testing.assert_array_equal(out[0, :3], [3, 4, 9])


def _int_case(build, ids, lens):
    outs = {}
    for pkg in ("jax", "torch"):
        fluid, guard = package(pkg)
        main, startup = fluid.Program(), fluid.Program()
        with guard(), fluid.program_guard(main, startup):
            s = fluid.layers.data(name="s", shape=list(ids.shape),
                                  dtype="int64", append_batch_size=False,
                                  lod_level=1)
            fetch = build(fluid.layers, s)
        kw = {} if pkg == "jax" else {"scope": tfluid.Scope()}
        exe = fluid.Executor(fluid.CPUPlace())
        outs[pkg] = exe.run(main, feed={"s": ids, "s@LEN": lens},
                            fetch_list=fetch, **kw)
    for t, j in zip(outs["torch"], outs["jax"]):
        assert_same(t, j)
    return outs["torch"]


def test_lod_reset_with_target_lod_and_with_y():
    def b(L, x, v):
        a = L.lod_reset(x, target_lod=[2, 5, 1])
        bb = L.lod_reset(x, y=v["ny"])
        return [L.sequence_pool(a, "sum"), L.sequence_pool(bb, "average")]

    check(seq_case(b, extra={"ny": np.array([1, 1, 6], np.int32)}))


def test_sub_nested_seq_two_levels():
    S, K, T2 = 4, 3, 5
    x = _f(B, S, T2, D, seed=3)
    l1 = np.array([[5, 2, 1, 0], [2, 2, 3, 1], [4, 0, 0, 0]], np.int32)
    l0 = np.array([3, 4, 1], np.int32)
    idx = np.array([[2, 0, 3], [3, 1, 1], [0, 2, -1]], np.int32)
    cnt = np.array([2, 3, 3], np.int32)

    def b(pkg, fluid):
        L = fluid.layers
        d = L.data(name="x", shape=[B, S, T2, D], dtype="float32",
                   append_batch_size=False, lod_level=2)
        wv = L.create_parameter([B, S, T2, D], "float32", name="w")
        sel = L.data(name="sel", shape=[B, K], dtype="int32",
                     append_batch_size=False)
        c = L.data(name="cnt", shape=[B], dtype="int32",
                   append_batch_size=False)
        xw = L.elementwise_mul(d, wv)
        assert xw.seq_outer_length_name == "x@LEN0"
        out = L.sub_nested_seq(xw, sel, selected_counts=c)
        blk = out.block
        fluid.append_backward(L.reduce_sum(L.square(out)))
        return [out, blk.var(out.seq_length_name),
                blk.var(out.seq_outer_length_name), "w@GRAD"]

    r = train_both(b, {"x": x, "x@LEN": l1, "x@LEN0": l0, "sel": idx,
                       "cnt": cnt}, 1,
                   params={"w": _f(B, S, T2, D, seed=4, lo=0.5, hi=1.5)})
    check(r)
    assert int(r["t_out"][0][2][2]) == 1   # counts clipped to @LEN0


def test_data_companions_and_propagation_match():
    """``@LEN``/``@LEN0`` declarations, their shapes, and the length
    names every op's outputs inherit are the JAX package's."""
    def table(pkg):
        fluid, guard = package(pkg)
        main = fluid.Program()
        with guard(), fluid.program_guard(main, fluid.Program()):
            L = fluid.layers
            a = L.data(name="a", shape=[1], dtype="int64", lod_level=1)
            n = L.data(name="n", shape=[3], dtype="float32", lod_level=2)
            e = L.embedding(a, size=[10, 4])
            f = L.fc(e, size=4, num_flatten_dims=2, act="tanh")
            L.sequence_pool(f, "max")
            L.scale(n, scale=2.0)
        return sorted((v.name, tuple(v.shape), v.lod_level,
                       v.seq_length_name, v.seq_outer_length_name)
                      for v in main.list_vars())

    assert table("torch") == table("jax")


def test_data_refuses_three_levels():
    for pkg in ("jax", "torch"):
        fluid, guard = package(pkg)
        with guard(), fluid.program_guard(fluid.Program(), fluid.Program()):
            with pytest.raises(Exception, match="lod_level=3"):
                fluid.layers.data(name="x", shape=[1], lod_level=3)


def test_sequence_op_without_lengths_names_the_input():
    with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
        x = tfluid.layers.data(name="plain", shape=[3, 4], dtype="float32")
        with pytest.raises(tfluid.EnforceError, match="plain@LEN"):
            tfluid.layers.sequence_pool(x, "sum")


# ------------------------------------------------------------- feeding


def _feeders(declare, rows):
    """Both packages' DataFeeder over ``rows`` (or ``rows(lod_module)``
    for rows holding a package's own LoDTensors), equal to the byte."""
    out = {}
    for pkg in ("jax", "torch"):
        fluid, guard = package(pkg)
        with guard(), fluid.program_guard(fluid.Program(), fluid.Program()):
            feeder = fluid.DataFeeder(feed_list=declare(fluid.layers),
                                      place=fluid.CPUPlace())
            out[pkg] = feeder.feed(rows(j_lod if pkg == "jax" else t_lod)
                                   if callable(rows) else rows)
    assert sorted(out["torch"]) == sorted(out["jax"])
    for n in out["jax"]:
        assert out["torch"][n].dtype == out["jax"][n].dtype, n
        np.testing.assert_array_equal(out["torch"][n], out["jax"][n])
    return out["torch"]


def test_data_feeder_pads_to_the_bucket():
    rng = np.random.RandomState(0)
    rows = [(rng.randint(0, 9, n).tolist(), [k % 2])
            for k, n in enumerate([3, 17, 1, 9])]
    feed = _feeders(lambda L: [
        L.data(name="w", shape=[-1, -1, 1], dtype="int64", lod_level=1,
               append_batch_size=False),
        L.data(name="y", shape=[1], dtype="int64")], rows)
    assert feed["w"].shape == (4, 32, 1)        # 17 rounds up to 32
    np.testing.assert_array_equal(feed["w@LEN"], [3, 17, 1, 9])


def test_data_feeder_float_sequences():
    rng = np.random.RandomState(1)
    rows = [(rng.rand(n, 3).astype("float32"),) for n in (2, 5)]
    feed = _feeders(lambda L: [L.data(name="f", shape=[3], dtype="float32",
                                      lod_level=1)], rows)
    assert feed["f"].shape == (2, 16, 3)


def test_data_feeder_two_levels():
    rows = [([[1, 2], [3]],), ([[4, 5, 6]],), ([[7], [8], [9], [1], [2]],)]
    feed = _feeders(lambda L: [L.data(name="x", shape=[1], dtype="int64",
                                      lod_level=2)], rows)
    assert feed["x"].shape[:3] == (3, 8, 16)   # S to 4s, T to 16s
    np.testing.assert_array_equal(feed["x@LEN0"], [2, 1, 5])


def test_data_feeder_two_level_lod_tensor_rows():
    def rows(lod):
        return [(lod.create_lod_tensor(
            [[np.arange(k + 2), np.arange(3)]], [[2], [k + 2, 3]], None),)
            for k in range(2)]

    feed = _feeders(lambda L: [L.data(name="x", shape=[1], dtype="int64",
                                      lod_level=2)], rows)
    np.testing.assert_array_equal(feed["x@LEN"][:, :2], [[2, 3], [3, 3]])


# ---------------------------------------------------------- lod_tensor


NESTED = [[np.array([1, 2]), np.array([3, 4, 5])], [np.array([6])]]
DEPTH3 = [[[np.array([1, 2]), np.array([3])], [np.array([4, 5, 6])]],
          [[np.array([7]), np.array([8, 9])]]]


@pytest.mark.parametrize("data,rsl", [
    (NESTED, [[2, 1], [2, 3, 1]]),
    (np.arange(6) + 1, [[2, 1], [2, 3, 1]]),
    (DEPTH3, [[2, 1], [2, 1, 2], [2, 1, 3, 1, 2]]),
    (np.arange(9) + 1, [[2, 1], [2, 1, 2], [2, 1, 3, 1, 2]]),
    ([np.array([1, 2, 3]), np.array([4])], [[3, 1]]),
    (np.arange(4.0), [[3, 1]]),
])
def test_create_lod_tensor_matches(data, rsl):
    t = t_lod.create_lod_tensor(data, rsl, None)
    j = j_lod.create_lod_tensor(data, rsl, None)
    np.testing.assert_array_equal(t.data, j.data)
    assert t.lod() == j.lod()
    assert t.recursive_sequence_lengths() == j.recursive_sequence_lengths()
    assert t.lod_level == j.lod_level and t.shape() == j.shape()
    for a, b in zip(t.level_lengths, j.level_lengths):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rsl", [[[3, 1, 2]], [[2, 1], [2, 3, 1]]])
def test_create_random_int_lodtensor_matches(rsl):
    t = t_lod.create_random_int_lodtensor(rsl, [1], None, 0, 9)
    j = j_lod.create_random_int_lodtensor(rsl, [1], None, 0, 9)
    np.testing.assert_array_equal(t.data, j.data)
    assert t.lod() == j.lod()


def test_pad_nested_groups_and_any_match():
    groups = [[np.arange(2), np.arange(3)], [np.arange(1)]]
    for a, b in zip(t_lod.pad_nested_groups(groups, s_max=4, t_max=8),
                    j_lod.pad_nested_groups(groups, s_max=4, t_max=8)):
        np.testing.assert_array_equal(a, b)
    ta, tl = t_lod.pad_nested_any(DEPTH3, 3)
    ja, jl = j_lod.pad_nested_any(DEPTH3, 3)
    np.testing.assert_array_equal(ta, ja)
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a, b)


def test_two_level_lod_tensor_feeds_the_executor():
    """A whole-batch 2-level LoDTensor feeds ``x``, ``x@LEN`` and
    ``x@LEN0`` through ``np.asarray`` (test_nested_lod.py's carrier);
    sub_nested_seq reads both companions."""
    t = t_lod.create_lod_tensor(NESTED, [[2, 1], [2, 3, 1]], None)
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        L = tfluid.layers
        x = L.data(name="x", shape=[2, 2, 3], dtype="int64",
                   append_batch_size=False, lod_level=2)
        sel = L.assign(np.array([[1, 0], [0, 1]], np.int32))
        out = L.sub_nested_seq(x, sel)
        lens = main.global_block().var(out.seq_length_name)
    got, got_len = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed={"x": np.asarray(t), "x@LEN": t.lengths,
                    "x@LEN0": t.outer_lengths}, fetch_list=[out, lens],
        scope=tfluid.Scope())
    np.testing.assert_array_equal(got[0], t.data[0, ::-1])
    np.testing.assert_array_equal(got[1], [t.data[1, 0], [0, 0, 0]])
    np.testing.assert_array_equal(got_len, [[3, 2], [1, 0]])


# --------------------------------------------- host metrics, evaluators


def _metric_pair(name, *args, **kw):
    from paddle_tpu import metrics as jm

    return getattr(tfluid.metrics, name)(*args, **kw), \
        getattr(jm, name)(*args, **kw)


@pytest.mark.parametrize("name,batches", [
    ("Precision", [([0.2, 0.8, 0.9, 0.4], [0, 1, 0, 1]),
                   ([0.7, 0.1], [1, 1])]),
    ("Recall", [([0.2, 0.8, 0.9, 0.4], [0, 1, 0, 1]),
                ([0.7, 0.1], [1, 1])]),
    ("Accuracy", [(0.5, 4), (0.25, 8)]),
    ("ChunkEvaluator", [(5, 4, 3), (2, 3, 2)]),
    ("EditDistance", [([0.0, 1.0, 2.0], 3), ([0.0, 0.5], 2)]),
    ("Auc", [(np.array([[0.9, 0.1], [0.3, 0.7], [0.4, 0.6]]), [0, 1, 1]),
             (np.array([[0.2, 0.8], [0.6, 0.4]]), [1, 0])]),
])
def test_host_metrics_match(name, batches):
    t, j = _metric_pair(name)
    for args in batches:
        t.update(*args)
        j.update(*args)
    np.testing.assert_array_equal(np.asarray(t.eval()), np.asarray(j.eval()))
    tc, jc = t.get_config(), j.get_config()
    assert sorted(tc) == sorted(jc)
    for k in tc:
        np.testing.assert_array_equal(tc[k], jc[k])
    t.reset()
    j.reset()
    np.testing.assert_array_equal(np.asarray(t.eval()), np.asarray(j.eval()))


def test_composite_metric_and_detection_map_refusal():
    t = tfluid.metrics.CompositeMetric()
    t.add_metric(tfluid.metrics.Precision())
    t.add_metric(tfluid.metrics.Recall())
    t.update(np.array([1, 0, 1]), np.array([1, 1, 0]))
    assert t.eval() == [0.5, 0.5]
    with pytest.raises(NotImplementedError, match="Queue A 7"):
        tfluid.metrics.DetectionMAP()
    with pytest.raises(NotImplementedError, match="Queue A 7"):
        tfluid.evaluator.DetectionMAP(None, None, None)


def _evaluate(pkg, declare, batches):
    """An evaluator over ``batches`` of feeds, reset once in between:
    its eval() after the first two batches and after the last."""
    fluid, guard = package(pkg)
    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    evals = []
    with fluid.scope_guard(scope), guard(), \
            fluid.program_guard(main, startup):
        ev = declare(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        ev.reset(exe)
        for k, feed in enumerate(batches):
            exe.run(main, feed=feed, fetch_list=[ev.metrics[0]])
            if k == 1:
                evals.append(ev.eval(exe))
                ev.reset(exe)
        evals.append(ev.eval(exe))
    return evals


@pytest.mark.parametrize("kind", ["accuracy", "chunk", "edit_distance"])
def test_evaluators_match(kind):
    rng = np.random.RandomState(3)
    if kind == "accuracy":
        def declare(fluid):
            p = fluid.layers.data(name="p", shape=[5], dtype="float32")
            lab = fluid.layers.data(name="l", shape=[1], dtype="int64")
            return fluid.evaluator.Accuracy(input=p, label=lab, k=2)

        batches = [{"p": rng.rand(6, 5).astype("f"),
                    "l": rng.randint(0, 5, (6, 1)).astype("int64")}
                   for _ in range(3)]
    elif kind == "chunk":
        def declare(fluid):
            L = fluid.layers
            inf = L.data(name="inf", shape=[-1, -1], dtype="int64",
                         append_batch_size=False, lod_level=1)
            lab = L.data(name="lab", shape=[-1, -1], dtype="int64",
                         append_batch_size=False, lod_level=1)
            return fluid.evaluator.ChunkEvaluator(
                input=inf, label=lab, chunk_scheme="IOB", num_chunk_types=2)

        batches = [{"inf": rng.randint(0, 5, (3, 7)).astype("int64"),
                    "inf@LEN": np.array([7, 4, 5], np.int32),
                    "lab": rng.randint(0, 5, (3, 7)).astype("int64"),
                    "lab@LEN": np.array([7, 4, 5], np.int32)}
                   for _ in range(3)]
    else:
        def declare(fluid):
            L = fluid.layers
            hyp = L.data(name="hyp", shape=[-1, -1], dtype="int64",
                         append_batch_size=False, lod_level=1)
            ref = L.data(name="ref", shape=[-1, -1], dtype="int64",
                         append_batch_size=False, lod_level=1)
            return fluid.evaluator.EditDistance(input=hyp, label=ref,
                                                normalized=False)

        batches = [{"hyp": rng.randint(1, 4, (2, 4)).astype("int64"),
                    "hyp@LEN": np.array([4, 2], np.int32),
                    "ref": rng.randint(1, 4, (2, 3)).astype("int64"),
                    "ref@LEN": np.array([3, 3], np.int32)}
                   for _ in range(3)]
    got = _evaluate("torch", declare, batches)
    want = _evaluate("jax", declare, batches)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, dtype=np.float64),
                                   np.asarray(w, dtype=np.float64),
                                   rtol=1e-6)


def test_evaluator_oracles():
    """test_evaluator_debug.py's accuracy, chunk and edit-distance
    evaluators, on the port."""
    acc = _evaluate("torch", lambda f: f.evaluator.Accuracy(
        input=f.layers.data(name="p", shape=[3], dtype="float32"),
        label=f.layers.data(name="l", shape=[1], dtype="int64")),
        [{"p": np.eye(3, dtype="f")[[0, 1]], "l": np.array([[0], [1]])},
         {"p": np.eye(3, dtype="f")[[2, 2]], "l": np.array([[0], [1]])},
         {"p": np.eye(3, dtype="f")[[0, 1]], "l": np.array([[0], [1]])}])
    np.testing.assert_allclose(acc, [0.5, 1.0])
    seq = np.array([[0, 1, 4, 2]], "int64")
    lens = np.array([4], "i")

    def chunk(f):
        L = f.layers
        return f.evaluator.ChunkEvaluator(
            input=L.data(name="inf", shape=[-1, -1], dtype="int64",
                         append_batch_size=False, lod_level=1),
            label=L.data(name="lab", shape=[-1, -1], dtype="int64",
                         append_batch_size=False, lod_level=1),
            chunk_scheme="IOB", num_chunk_types=2)

    feeds = {"inf": seq, "inf@LEN": lens, "lab": seq, "lab@LEN": lens}
    got = _evaluate("torch", chunk, [feeds] * 3)
    np.testing.assert_allclose(np.asarray(got[0], float), [1.0, 1.0, 1.0])

    def edit(f):
        L = f.layers
        return f.evaluator.EditDistance(
            input=L.data(name="hyp", shape=[-1, -1], dtype="int64",
                         append_batch_size=False, lod_level=1),
            label=L.data(name="ref", shape=[-1, -1], dtype="int64",
                         append_batch_size=False, lod_level=1),
            normalized=False)

    h = np.array([[1, 2, 3], [1, 2, 3]], "int64")
    r = np.array([[1, 2, 3], [1, 9, 3]], "int64")
    feeds = {"hyp": h, "hyp@LEN": np.array([3, 3], "i"), "ref": r,
             "ref@LEN": np.array([3, 3], "i")}
    got = _evaluate("torch", edit, [feeds] * 3)
    np.testing.assert_allclose(np.asarray(got[0], float), [0.5, 0.5])
