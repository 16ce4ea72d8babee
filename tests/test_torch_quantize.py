"""paddle_tpu_torch int8 quantization (passes/quantize.py) against the JAX
package: post-training int8 for serving (``calibrate_program``,
``QuantizePass``/``ptq_int8``, ``quantize_for_serving``), the QAT
transpile and freeze (``QuantizeTranspiler``, ``quantize_inference``),
the int8 op fns, serving and export of an int8 program.

Models: fit-a-line and the conv classifier of tests/test_quantize_ptq.py
and a two-layer BERT sentence-pair classifier, built with the same calls
in both packages, the JAX package's initialized weights carried into the
port's scope.

Tolerances, stated once:
  * the rewrite, given the JAX package's calibration: op lists, attrs
    (``rescale_digest`` included), ``@INT8`` weights and the
    ``_passes_stamp`` are EQUAL;
  * each int8 op is BIT-equal to the JAX package's jitted op on equal
    inputs (``quantize_act``: the f32 activations; the products: equal
    int8 codes);
  * program outputs within 1e-4 of the largest value; activation codes
    that differ (an ulp of an f32 activation across a rounding tie) are
    reported and held below one in a thousand;
  * the two calibrations within rtol 1e-6.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu import passes as jpasses
from paddle_tpu.core import unique_name as j_unique_name
from paddle_tpu.passes import quantize as jq
from paddle_tpu_torch import analysis, passes
from paddle_tpu_torch.inference import NativeConfig, create_paddle_predictor
from paddle_tpu_torch.passes import quantize as tq

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = fluid.CPUPlace()
OUT_TOL = 1e-4      # of the largest output value
CODE_SHARE = 1e-3   # activation codes allowed to differ across packages
CALIB_RTOL = 1e-6
BERT = dict(vocab_size=64, n_layer=2, n_head=2, d_model=32, d_inner=64,
            max_pos=32, dropout=0.0, is_test=True, attn_impl="fused")
BERT_T = 16


# ----------------------------------------------------------------- models


def _fit_a_line(pkg):
    x = pkg.layers.data(name="x", shape=[13], dtype="float32")
    h = pkg.layers.fc(input=x, size=16, act="relu")
    return ["x"], pkg.layers.fc(input=h, size=1)


def _conv(pkg):
    img = pkg.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
    c = pkg.layers.conv2d(img, num_filters=8, filter_size=3, padding=1,
                          act="relu")
    p = pkg.layers.pool2d(c, pool_size=2, pool_type="max", pool_stride=2)
    return ["img"], pkg.layers.softmax(pkg.layers.fc(p, size=10))


def _bert(pkg):
    if pkg is jfluid:
        from paddle_tpu.models.bert import bert_encoder
    else:
        from paddle_tpu_torch.models.bert import bert_encoder
    feeds = [pkg.layers.data(name=n, shape=[-1, BERT_T], dtype=dt,
                             append_batch_size=False)
             for n, dt in (("src_ids", "int64"), ("sent_ids", "int64"),
                           ("pos_ids", "int64"),
                           ("input_mask", "float32"))]
    enc = bert_encoder(*feeds, **BERT)
    cls = pkg.layers.squeeze(pkg.layers.slice(enc, axes=[1], starts=[0],
                                              ends=[1]), axes=[1])
    pooled = pkg.layers.fc(input=cls, size=BERT["d_model"], act="tanh")
    return ([v.name for v in feeds],
            pkg.layers.softmax(pkg.layers.fc(input=pooled, size=2)))


MODELS = {"fit_a_line": _fit_a_line, "conv": _conv, "bert": _bert}


def _feeds(model, n, seed):
    rng = np.random.RandomState(seed)
    if model == "fit_a_line":
        return {"x": rng.rand(n, 13).astype("float32")}
    if model == "conv":
        return {"img": rng.rand(n, 3, 8, 8).astype("float32")}
    lens = rng.randint(4, BERT_T + 1, size=n)
    cols = np.arange(BERT_T)[None, :]
    mask = cols < lens[:, None]
    return {"src_ids": np.where(mask, rng.randint(1, BERT["vocab_size"],
                                                  (n, BERT_T)), 0),
            "sent_ids": (mask & (cols > lens[:, None] // 2)).astype(
                np.int64),
            "pos_ids": np.broadcast_to(cols, (n, BERT_T)).astype(np.int64),
            "input_mask": mask.astype(np.float32)}


def _jax_model(model, seed=3):
    main, startup = jfluid.Program(), jfluid.Program()
    main.random_seed = seed
    with j_unique_name.guard(), jfluid.program_guard(main, startup):
        feeds, out = MODELS[model](jfluid)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    return main, scope, feeds, out.name


def _torch_model(model, j_main, j_scope):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feeds, out = MODELS[model](fluid)
    scope = fluid.Scope()
    fluid.params_from_numpy(
        {p.name: np.asarray(j_scope.find_var(p.name))
         for p in j_main.all_parameters()}, scope, CPU, program=main)
    return main, scope, feeds, out.name


def _calibration(model):
    return [_feeds(model, 16, 1), _feeds(model, 16, 2)]


def _both(model):
    """(jax int8 program, jax scope, port int8 program, port scope,
    fetch): the JAX package quantizes through quantize_for_serving, the
    port rewrites through its checked, stamped manager with the JAX
    package's calibration."""
    jm, js, _, out = _jax_model(model)
    tm, ts, _, _ = _torch_model(model, jm, js)
    with jfluid.scope_guard(js):
        jprog = jpasses.quantize_for_serving(jm, js, _calibration(model))
    jc = jprog._ptq_calibration
    calib = passes.CalibrationResult(jc.scales, jc.method, jc.bit_length)
    tprog = passes.PassManager([passes.QuantizePass(calib)]).apply(
        tm, scope=ts)
    return jprog, js, tprog, ts, out


# attrs the port's backward op carries and the JAX package's does not
# (ROADMAP Queue C 2, the compile cache)
_PORT_ONLY_ATTRS = ("_error_clips", "_sparse_sites")


def _ops(program):
    return [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()),
             sorted((k, json.dumps(v, default=list))
                    for k, v in op.attrs.items()
                    if k not in _PORT_ONLY_ATTRS))
            for op in program.global_block().ops]


# ------------------------------------------------------------ the rewrite


@pytest.mark.parametrize("model", sorted(MODELS))
def test_rewrite_matches_the_jax_package(model):
    jprog, js, tprog, ts, _ = _both(model)
    assert _ops(tprog) == _ops(jprog)
    assert tprog._passes_stamp == jprog._passes_stamp
    assert tprog._passes_stamp.startswith("ptq_int8=int8/b8/per_channel")
    assert (tprog._int8_quantized, tprog._int8_skipped) == \
        (jprog._int8_quantized, jprog._int8_skipped)
    assert tprog._int8_quantized > 0
    w8 = sorted(n for n in js.local_var_names() if n.endswith("@INT8"))
    assert w8 == sorted(n for n in ts.local_var_names()
                        if n.endswith("@INT8"))
    for n in w8:
        t = ts.find_var(n)
        assert t.dtype == torch.int8
        assert t.numpy().tobytes() == np.asarray(js.find_var(n)).tobytes()
    # clones carry the stamp; the program self-lints to zero diagnostics
    assert tprog.clone()._passes_stamp == tprog._passes_stamp
    report = analysis.check_program(tprog)
    assert report.ok and not report.diagnostics, str(report)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_outputs_and_codes_match_the_jax_package(model):
    jprog, js, tprog, ts, out = _both(model)
    feed = _feeds(model, 8, 9)
    codes = [op.output("Out")[0] for op in tprog.global_block().ops
             if op.type == "quantize_act"]
    with jfluid.scope_guard(js):
        jvals = jfluid.Executor(jfluid.CPUPlace()).run(
            jprog, feed=feed, fetch_list=[out] + codes)
    tvals = fluid.Executor(CPU).run(tprog, feed=feed,
                                    fetch_list=[out] + codes, scope=ts)
    scale = max(float(np.abs(jvals[0]).max()), 1e-30)
    assert np.abs(tvals[0] - jvals[0]).max() <= OUT_TOL * scale
    differ = {n: int((t != j).sum())
              for n, t, j in zip(codes, tvals[1:], jvals[1:])}
    total = sum(t.size for t in tvals[1:])
    print("activation codes that differ:", differ, "of", total)
    assert sum(differ.values()) <= CODE_SHARE * total, differ


@pytest.mark.parametrize("model", sorted(MODELS))
def test_calibrations_agree(model):
    jm, js, _, _ = _jax_model(model)
    tm, ts, _, _ = _torch_model(model, jm, js)
    with jfluid.scope_guard(js):
        jc = jpasses.calibrate_program(jm, _calibration(model), scope=js)
    tc = passes.calibrate_program(tm, _calibration(model), scope=ts,
                                  place=CPU)
    assert list(tc.scales) == list(jc.scales)
    np.testing.assert_allclose([tc.scales[n] for n in tc.scales],
                               [jc.scales[n] for n in tc.scales],
                               rtol=CALIB_RTOL)
    assert passes.quantizable_activations(tm, scope=ts) == \
        jpasses.quantizable_activations(jm, scope=js)


# ----------------------------------------------------------- the int8 ops


def _act_values(scale, seed):
    """Normals around the scale, plus the exact ties k + 1/2 of the code
    grid and their neighbours one f32 ulp up."""
    rng = np.random.RandomState(seed)
    s = np.float32(scale)
    ties = ((rng.randint(-126, 126, 2000).astype(np.float32) + 0.5)
            * s / np.float32(127.0)).astype(np.float32)
    return np.concatenate([
        (rng.randn(4000) * s).astype(np.float32), ties,
        np.nextafter(ties, np.float32(np.inf)),
        np.array([0.0, -0.0, 2 * s, -2 * s], np.float32)])


@pytest.mark.parametrize("scale", [0.37, 1.0, 3.14159, 1e-3, 1e-8])
def test_quantize_act_is_the_jax_packages_compiled_op(scale):
    x = _act_values(scale, 7)
    want = np.asarray(jax.jit(jq._quant_act_fn(scale, 127.0))(
        jnp.asarray(x)))
    got = tq._quant_act_fn(scale, 127.0)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int8
    assert np.array_equal(got, want), int((got != want).sum())


# (x shape, K, N): M = 1 and N = 2 (a pooler and a classifier head), K =
# 147 (ResNet's stem), leading dims flattened
MUL_CASES = [((1, 16), 16, 2), ((5, 147), 147, 64), ((3, 4, 24), 24, 8),
             ((40, 64), 64, 24)]


@pytest.mark.parametrize("case", MUL_CASES, ids=str)
@pytest.mark.parametrize("per_channel", [True, False])
def test_int8_mul_is_bit_equal(case, per_channel):
    xshape, K, N = case
    rng = np.random.RandomState(K + N)
    xq = rng.randint(-127, 128, xshape).astype(np.int8)
    wq = rng.randint(-127, 128, (K, N)).astype(np.int8)
    r = (rng.rand(N).astype(np.float32) * 1e-4 if per_channel
         else np.float32(3.3e-5))
    want = np.asarray(jax.jit(jq._int8_mul_fn(r))(xq, wq))
    got = tq._int8_mul_fn(r)(torch.from_numpy(xq),
                             torch.from_numpy(wq)).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


# (N, C, H, W), (O, kh, kw), strides, paddings, dilations
CONV_CASES = [((2, 3, 9, 9), (8, 3, 3), (1, 1), (1, 1), (1, 1)),
              ((1, 3, 20, 20), (16, 7, 7), (2, 2), (3, 3), (1, 1)),
              ((2, 8, 7, 7), (4, 1, 1), (2, 2), (0, 0), (1, 1)),
              ((1, 4, 11, 10), (6, 3, 3), (1, 2), (2, 1), (2, 2))]


@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_int8_conv_is_bit_equal(case):
    xshape, (O, kh, kw), st, pd, dl = case
    rng = np.random.RandomState(O * kh)
    xq = rng.randint(-127, 128, xshape).astype(np.int8)
    wq = rng.randint(-127, 128, (O, xshape[1], kh, kw)).astype(np.int8)
    r = rng.rand(O).astype(np.float32) * 1e-4
    want = np.asarray(jax.jit(jq._int8_conv_fn(r, st, pd, dl, 1))(xq, wq))
    got = tq._int8_conv_fn(r, st, pd, dl, 1)(
        torch.from_numpy(xq), torch.from_numpy(wq)).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


def test_int8_conv_sums_past_f32s_integers_exactly():
    """A 3x3x512 sum of +-127 products reaches 7.4e7, past 2^24: the
    int32 route keeps every unit."""
    xq = torch.full((1, 512, 3, 3), 127, dtype=torch.int8)
    wq = torch.full((2, 512, 3, 3), 127, dtype=torch.int8)
    wq[1, 0, 0, 0] = 126
    y = tq.int8_conv2d(xq, wq, (1, 1), (0, 0), (1, 1))
    assert y.dtype == torch.int32
    assert y[0, :, 0, 0].tolist() == [4608 * 127 * 127,
                                      4608 * 127 * 127 - 127]


# ------------------------------------------------------------------- QAT


def _qat(pkg, un, steps, window=64):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = 5
    with un.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[8], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        h = pkg.layers.fc(x, size=16, act="relu")
        pred = pkg.layers.fc(h, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        qt = pkg.QuantizeTranspiler(bit_length=8, window_size=window)
        qt.training_transpile(main, startup)
        pkg.optimizer.SGD(learning_rate=0.2).minimize(loss)
    return main, startup, pred.name, loss.name, qt


def _qat_data(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 8).astype("float32")
    return {"x": x, "y": (x @ rng.rand(8, 1).astype("float32"))
            .astype("float32")}


def test_qat_trains_and_freezes_to_int8():
    """tests/test_quantize_inference.py's first test, in the port."""
    main, startup, pred, loss, qt = _qat(fluid, fluid.unique_name, 30)
    types = [op.type for op in main.global_block().ops]
    assert types.count("fake_quantize_range_abs_max") == 2
    assert types.count("fake_quantize_abs_max") == 2
    assert types.count("fake_dequantize_qat") == 2
    feed = _qat_data()
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(30)]
    assert losses[-1] < losses[0] * 0.2, losses
    # the QAT forward at the weights the freeze reads (a run of the
    # training program would fetch the prediction from before its
    # update, and the port's initial weights, drawn by torch, leave its
    # steps at lr 0.2 larger than the JAX package's at step 30)
    qat_pred, = exe.run(main.prune([pred]).clone(for_test=True),
                        feed=feed, fetch_list=[pred], scope=scope)
    frozen = qt.freeze_program(main, scope=scope)
    ftypes = [op.type for op in frozen.global_block().ops]
    assert ftypes.count("int8_mul_dequant") == 2
    assert ftypes.count("quantize_act") == 2
    assert "fake_dequantize_qat" not in ftypes
    w8 = [n for n in scope.local_var_names() if n.endswith("@INT8")]
    assert len(w8) == 2
    assert all(scope.find_var(n).dtype == torch.int8 for n in w8)
    int8_pred, = exe.run(frozen, feed=feed, fetch_list=[pred], scope=scope)
    scale = max(np.abs(qat_pred).max(), 1e-3)
    assert np.max(np.abs(int8_pred - qat_pred)) / scale < 0.05


def test_qat_freeze_matches_the_jax_package():
    """The JAX package trains its QAT program; its whole state (weights,
    range windows, step counts) goes into the port's transpiled program,
    and both freeze: the same ops, attrs and int8 weights, and outputs
    bit for bit. The QAT step itself is held at 1e-5 of its loss."""
    feed = _qat_data()
    jm, js_, jpred, jloss, jqt = _qat(jfluid, j_unique_name, 3)
    tm, ts_, tpred, tloss, tqt = _qat(fluid, fluid.unique_name, 3)
    assert (tpred, tloss) == (jpred, jloss)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(js_)
        for _ in range(3):
            exe.run(jm, feed=feed, fetch_list=[jloss])
        state = {v.name: np.array(jscope.find_var(v.name))
                 for v in tm.list_vars() if v.persistable}
        jloss_v, = exe.run(jm, feed=feed, fetch_list=[jloss])
    scope = fluid.Scope()
    fluid.state_from_numpy(state, scope, CPU, program=tm)
    tloss_v, = fluid.Executor(CPU).run(tm, feed=feed, fetch_list=[tloss],
                                       scope=scope)
    np.testing.assert_allclose(tloss_v, jloss_v, rtol=1e-5)
    # the state again, as the JAX package's run left it (the port's QAT
    # step above advanced the windows)
    fluid.state_from_numpy(
        {v.name: np.asarray(jscope.find_var(v.name))
         for v in tm.list_vars() if v.persistable}, scope, CPU, program=tm)
    with jfluid.scope_guard(jscope), j_unique_name.guard():
        jf = jpasses.apply_passes([jpasses.QuantizeInferencePass()], jm,
                                  scope=jscope, check=False)
    with fluid.unique_name.guard():
        tf = passes.apply_passes([passes.QuantizeInferencePass()], tm,
                                 scope=scope, check=False)
    assert _ops(tf) == _ops(jf)
    assert tf._passes_stamp == jf._passes_stamp
    for n in ("fc.w_0@INT8", "fc.w_1@INT8"):
        assert scope.find_var(n).numpy().tobytes() == \
            np.asarray(jscope.find_var(n)).tobytes()
    with jfluid.scope_guard(jscope):
        want, = jfluid.Executor(jfluid.CPUPlace()).run(
            jf, feed=feed, fetch_list=[jpred])
    got, = fluid.Executor(CPU).run(tf, feed=feed, fetch_list=[tpred],
                                   scope=scope)
    assert np.array_equal(got, want)


def test_quantize_inference_pass_and_the_shims():
    from paddle_tpu_torch.core.passes import apply_passes, list_passes
    from paddle_tpu_torch.quantize_transpiler import QuantizeTranspiler

    assert QuantizeTranspiler is passes.QuantizeTranspiler
    assert "quantize_inference" in list_passes()
    main, startup, pred, loss, _ = _qat(fluid, fluid.unique_name, 5, 16)
    feed = _qat_data(seed=2)
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    for _ in range(5):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    frozen = apply_passes(["quantize_inference"], main, scope=scope)
    assert getattr(frozen, "_passes_stamp", None) is None  # legacy mode
    out, = exe.run(frozen, feed=feed, fetch_list=[pred], scope=scope)
    assert np.all(np.isfinite(out))


def test_freeze_without_training_state_fails_loudly():
    main, startup, _, _, qt = _qat(fluid, fluid.unique_name, 0)
    with pytest.raises(fluid.EnforceError, match="QAT"):
        qt.freeze_program(main, scope=fluid.Scope())


def test_non_param_muls_untouched():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        a = fluid.layers.data(name="a", shape=[4, 4], dtype="float32")
        b = fluid.layers.data(name="b", shape=[4, 4], dtype="float32")
        c = fluid.layers.matmul(a, b)
        fluid.layers.fc(c, size=8, num_flatten_dims=2)
    fluid.QuantizeTranspiler().training_transpile(main, startup)
    types = [op.type for op in main.global_block().ops]
    assert types.count("fake_quantize_abs_max") == 1


# ------------------------------------------------------------- PTQ seams


def _ptq(model, seed=3):
    jm, js, feeds, out = _jax_model(model, seed)
    tm, ts, _, _ = _torch_model(model, jm, js)
    return tm, ts, out


def test_policy_deny_and_uncalibrated_ops_stay_f32():
    from paddle_tpu_torch.amp.policy import AmpPolicy

    main, scope, _ = _ptq("conv", 13)
    feed = [_feeds("conv", 8, 5)]
    q = passes.quantize_for_serving(main, scope, feed, place=CPU,
                                    policy=AmpPolicy(extra_deny=["conv2d"]))
    types = [op.type for op in q.global_block().ops]
    assert "conv2d" in types and "int8_conv_dequant" not in types
    assert "int8_mul_dequant" in types
    calib = passes.calibrate_program(main, feed, scope=scope, place=CPU)
    partial = passes.CalibrationResult(
        {n: s for n, s in calib.scales.items() if n != "img"},
        method=calib.method)
    q2 = passes.PassManager([passes.QuantizePass(partial)]).apply(
        main, scope=scope)
    assert q2._int8_skipped >= 1
    t2 = [op.type for op in q2.global_block().ops]
    assert "conv2d" in t2 and "int8_mul_dequant" in t2


def test_redefined_activation_gets_fresh_int8_codes():
    rng = np.random.RandomState(3)
    main = fluid.Program()
    gb = main.global_block()
    gb.create_var(name="x", shape=[-1, 4], dtype="float32")
    for wn in ("W1", "W2", "W3"):
        gb.create_var(name=wn, shape=[4, 4], dtype="float32",
                      persistable=True)

    def mul(xn, wn, on):
        if gb.vars.get(on) is None:
            gb.create_var(name=on, shape=[-1, 4], dtype="float32")
        gb.append_op(type="mul", inputs={"X": [xn], "Y": [wn]},
                     outputs={"Out": [on]}, fn=lambda a, b: a @ b)

    mul("x", "W1", "y")
    mul("y", "W2", "x")   # redefines the quantized feed "x"
    mul("x", "W3", "z")   # must consume the NEW x's codes
    scope = fluid.Scope()
    for wn in ("W1", "W2", "W3"):
        scope.set_var(wn, torch.from_numpy(
            rng.rand(4, 4).astype("float32") - 0.5))
    xb = rng.rand(8, 4).astype("float32")
    exe = fluid.Executor(CPU)
    ref, = exe.run(main, feed={"x": xb}, fetch_list=["z"], scope=scope)
    with pytest.raises(passes.PassError):
        passes.quantize_for_serving(main, scope, [{"x": xb}], place=CPU)
    calib = passes.calibrate_program(main, [{"x": xb}], scope=scope,
                                     place=CPU)
    q = passes.QuantizePass(calib).apply(main, scope=scope)
    ops = q.global_block().ops
    assert [op.type for op in ops].count("quantize_act") == 3
    muls = [k for k, op in enumerate(ops) if op.type == "int8_mul_dequant"]
    last_x8 = ops[muls[-1]].input("X")[0]
    producer = next(k for k, op in enumerate(ops)
                    if last_x8 in op.output_arg_names)
    assert ops[producer].type == "quantize_act" and producer > muls[-2]
    got, = exe.run(q, feed={"x": xb}, fetch_list=["z"], scope=scope)
    assert np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-3) < 1.0


def test_calibration_methods_and_fingerprint_sensitivity():
    main, scope, _ = _ptq("fit_a_line")
    xb = _feeds("fit_a_line", 32, 4)["x"]
    absmax = passes.calibrate_program(main, [{"x": xb}], scope=scope,
                                      place=CPU)
    ema = passes.calibrate_program(main, [{"x": xb}], scope=scope,
                                   place=CPU, method="moving_average",
                                   momentum=0.5)
    other = passes.calibrate_program(main, [{"x": xb * 3.0}], scope=scope,
                                     place=CPU)
    assert set(absmax.scales) == set(ema.scales)
    assert absmax.digest() != other.digest()
    fps = {passes.QuantizePass(absmax).fingerprint(),
           passes.QuantizePass(other).fingerprint(),
           passes.QuantizePass(absmax, per_channel=False).fingerprint(),
           passes.QuantizePass(absmax, bit_length=4).fingerprint()}
    assert len(fps) == 4
    jc = jpasses.CalibrationResult(absmax.scales, absmax.method)
    assert absmax.digest() == jc.digest()
    assert passes.QuantizePass(absmax).fingerprint() == \
        jpasses.QuantizePass(jc).fingerprint()
    with pytest.raises(fluid.EnforceError):
        passes.calibrate_program(main, [{"x": xb}], scope=scope,
                                 place=CPU, method="median")
    with pytest.raises(fluid.EnforceError, match="INFERENCE"):
        m, s, loss = _train_program()
        passes.QuantizePass(absmax).apply(m, scope=s)


def _train_program():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.fc(input=x, size=1))
        fluid.SGD(learning_rate=0.1).minimize(loss)
    scope = fluid.Scope()
    fluid.Executor(CPU).run(startup, scope=scope)
    return main, scope, loss


def test_int8_serving_engine_replies_equal_executor_run():
    from paddle_tpu_torch.serving import BucketedEngine, ServingConfig

    main, scope, out = _ptq("bert")
    q = passes.quantize_for_serving(main, scope, _calibration("bert"),
                                    place=CPU)
    eng = BucketedEngine.from_program(
        q, [n for n in _feeds("bert", 1, 0)], [out], scope=scope,
        config=ServingConfig(buckets=[1, 4, 8]), place=CPU)
    eng.warm_up()
    for n in (1, 3, 8, 11):
        feed = _feeds("bert", n, 20 + n)
        got, = eng.run(feed)
        want, = fluid.Executor(CPU).run(q, feed=feed, fetch_list=[out],
                                        scope=scope)
        assert np.array_equal(got, want), n


# ----------------------------------------------------------------- export

_BUILD = r'''
def build_int8(fluid, passes, np):
    """fit-a-line with seeded weights, quantized on two seeded batches."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        h = fluid.layers.fc(input=x, size=16, act="relu")
        pred = fluid.layers.fc(input=h, size=1)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    fluid.params_from_numpy(
        {p.name: rng.randn(*p.shape).astype("float32")
         for p in main.all_parameters()}, scope, fluid.CPUPlace(),
        program=main)
    feeds = [{"x": rng.rand(32, 13).astype("float32")} for _ in range(2)]
    q = passes.quantize_for_serving(main, scope, feeds,
                                    place=fluid.CPUPlace())
    return q, pred, scope, exe
'''
exec(_BUILD)

_CHILD = _BUILD + r'''
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
import paddle_tpu_torch as fluid
from paddle_tpu_torch import passes
from paddle_tpu_torch.compile_cache import cache_metrics
fluid.set_flags({"compile_cache_dir": sys.argv[1]})
q, pred, scope, exe = build_int8(fluid, passes, np)
fluid.io.save_inference_model(sys.argv[2], ["x"], [pred], exe,
                              main_program=q, scope=scope,
                              export_batch_sizes=[1, 4])
print(json.dumps({"metrics": cache_metrics(), "stamp": q._passes_stamp}))
'''


def _shas(d):
    import hashlib

    return {f: hashlib.sha256(open(os.path.join(d, f), "rb").read())
            .hexdigest() for f in sorted(os.listdir(d)) if f.endswith(".pt2")}


def test_int8_export_serves_and_a_second_process_warm_starts(tmp_path):
    """``save_inference_model`` of a PTQ program writes the int8 weights
    (and not the f32 ones they replace) and the int8 ops' export; the
    predictor reproduces ``Executor.run`` bit for bit; a second process
    quantizing the same model exports from the compile cache with only
    hits, its files byte-equal, because the ``_passes_stamp`` keys the
    entries (held to the store layout and keys, as
    tests/test_torch_compile_cache.py holds f32 exports)."""
    from paddle_tpu_torch.compile_cache import (CacheStore, cache_metrics,
                                                reset_cache_metrics)
    from paddle_tpu_torch.core import flags

    cache = str(tmp_path / "cc")
    cold = str(tmp_path / "cold")
    q, pred, scope, exe = build_int8(fluid, passes, np)
    reset_cache_metrics()
    flags.set_flags({"compile_cache_dir": cache})
    try:
        fluid.io.save_inference_model(cold, ["x"], [pred], exe,
                                      main_program=q, scope=scope,
                                      export_batch_sizes=[1, 4])
    finally:
        flags.set_flags({"compile_cache_dir": ""})
    m = cache_metrics()
    assert (m["miss"], m["publish"], m["hit"]) == (2, 2, 0)
    metas = [e for e in CacheStore(cache).entries()]
    assert len(metas) == 2 and all(e["kind"] == "export" for e in metas)
    with open(os.path.join(cold, "__model__.json")) as f:
        man = json.load(f)
    assert man["torch_export_buckets"] == {"1": "__model__.pt2",
                                           "4": "__model__.b4.pt2"}
    params = np.load(os.path.join(cold, "__params__.npz"))
    w8 = [n for n in params.files if n.endswith("@INT8")]
    assert len(w8) == 2 and all(params[n].dtype == np.int8 for n in w8)
    assert not any(n.endswith(".w_0") for n in params.files)
    xb = np.random.RandomState(5).rand(4, 13).astype("float32")
    ref, = exe.run(q, feed={"x": xb}, fetch_list=[pred], scope=scope)
    p = create_paddle_predictor(NativeConfig(model_dir=cold, use_gpu=False))
    out = p.run({"x": xb})
    assert np.array_equal(np.asarray(out[0].data), ref)

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, cache, str(tmp_path / "warm")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    assert child["stamp"] == q._passes_stamp
    cm = child["metrics"]
    assert (cm["hit"], cm["miss"], cm["publish"], cm["bad_entry"]) == \
        (2, 0, 0, 0)
    assert _shas(str(tmp_path / "warm")) == _shas(cold)
