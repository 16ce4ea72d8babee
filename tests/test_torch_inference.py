"""paddle_tpu_torch.inference and the inference transforms, held to
paddle_tpu's on the CPU (mirrors tests/test_inference.py).

* **Predictor.** The same MLP is built in both packages and the JAX
  package's initialized parameters are carried into the port. Each
  package writes its artifact with ``save_inference_model``; the port's
  ``NativePredictor`` (``use_gpu=False``) equals the port's
  ``Executor.run`` bit for bit at an exported batch and the JAX
  package's ``NativePredictor`` within rtol 1e-5; a batch of 4 over a
  batch-1 artifact runs sliced; ``PaddleTensor`` input and ``clone``.
* **Transforms.** ``InferenceTranspiler`` (``conv_bn_fold``) folds an
  is_test batch norm into its conv, with and without a conv bias: the
  folded parameters equal the JAX transform's bit for bit, the folded
  program's output the unfolded one's (rtol 1e-4, atol 1e-5, the JAX
  test's bound: a reassociated product) and the JAX folded output
  (rtol 1e-5). ``transpile_to_bfloat16`` casts the same parameters to
  the same bfloat16 bits, and the cast program's output equals the
  JAX package's within rtol 1e-5 and its artifact's bit for bit.
* **Refusal.** A directory the JAX package wrote (``stablehlo``, no
  ``torch_export``) is refused, naming the key it lacks.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique_name
from paddle_tpu.inference import NativeConfig as JNativeConfig
from paddle_tpu.inference import \
    create_paddle_predictor as j_create_predictor
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.inference import (NativeConfig, PaddleTensor,
                                        create_paddle_predictor)

torch.set_num_threads(1)

CPU = tfluid.CPUPlace()
TOL = dict(rtol=1e-5, atol=1e-6)


def _build(pkg, body):
    guard = (j_unique_name.guard if pkg is jfluid
             else tfluid.unique_name.guard)
    main, startup = pkg.Program(), pkg.Program()
    with guard(), pkg.program_guard(main, startup):
        out = body(pkg)
    return main, startup, out


def _mlp(pkg):
    x = pkg.layers.data(name="x", shape=[8], dtype="float32")
    h = pkg.layers.fc(input=x, size=16, act="relu")
    return pkg.layers.fc(input=h, size=4, act="softmax")


def _both(body, carry=None):
    """(jax (main, scope, out), torch (main, scope, out, exe)): the JAX
    package initializes; ``carry(j_main, j_scope)`` (default: every
    persistable) is carried into the port."""
    j_main, j_startup, j_out = _build(jfluid, body)
    j_scope = jfluid.Scope()
    with jfluid.scope_guard(j_scope):
        jfluid.Executor(jfluid.CPUPlace()).run(j_startup)
    if carry is not None:
        carry(j_main, j_scope)
    t_main, t_startup, t_out = _build(tfluid, body)
    t_scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    exe.run(t_startup, scope=t_scope)
    tfluid.state_from_numpy(
        {v.name: np.asarray(j_scope.find_var(v.name))
         for v in j_main.list_vars() if v.persistable
         and j_scope.find_var(v.name) is not None},
        t_scope, CPU, program=t_main)
    return (j_main, j_scope, j_out), (t_main, t_scope, t_out, exe)


def test_native_predictor_matches_executor_and_the_jax_predictor(tmp_path):
    (j_main, j_scope, j_out), (t_main, t_scope, t_out, exe) = _both(_mlp)
    with jfluid.scope_guard(j_scope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jfluid.io.save_inference_model(str(tmp_path / "jax"), ["x"],
                                       [j_out], jexe, main_program=j_main)
    tdir = str(tmp_path / "torch")
    tfluid.io.save_inference_model(tdir, ["x"], [t_out], exe,
                                   main_program=t_main, scope=t_scope)
    ones = np.ones((1, 8), "float32")
    ref, = exe.run(t_main, feed={"x": ones}, fetch_list=[t_out],
                   scope=t_scope)

    pred = create_paddle_predictor(NativeConfig(model_dir=tdir,
                                                use_gpu=False))
    jpred = j_create_predictor(JNativeConfig(model_dir=str(tmp_path /
                                                           "jax")))
    assert pred.available_batch_sizes() == [1]
    assert (pred.compile_count, pred.cache_hits) == (0, 0)  # CPU: eager
    outs = pred.run({"x": ones})
    assert len(outs) == 1 and outs[0].name == t_out.name
    np.testing.assert_array_equal(outs[0].data, ref)
    np.testing.assert_allclose(outs[0].data, jpred.run({"x": ones})[0].data,
                               **TOL)

    # a larger batch runs in exported-batch slices
    x4 = np.random.RandomState(3).randn(4, 8).astype("float32")
    outs4 = pred.run({"x": x4})
    assert outs4[0].shape == (4, 4)
    np.testing.assert_allclose(outs4[0].data, jpred.run({"x": x4})[0].data,
                               **TOL)
    np.testing.assert_allclose(
        pred.run({"x": np.ones((4, 8), "float32")})[0].data[2], ref[0],
        **TOL)

    # PaddleTensor list input + clone
    outs_t = pred.clone().run([PaddleTensor(ones)])
    np.testing.assert_array_equal(outs_t[0].data, ref)

    # the default asks for the card, which this host has not
    if not torch.cuda.is_available():
        with pytest.raises(EnforceError, match="use_gpu=False"):
            create_paddle_predictor(NativeConfig(model_dir=tdir))


def test_a_jax_written_directory_is_refused(tmp_path):
    j_main, j_startup, j_out = _build(jfluid, _mlp)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(j_startup)
        jfluid.io.save_inference_model(str(tmp_path), ["x"], [j_out], exe,
                                       main_program=j_main)
    with pytest.raises(EnforceError, match="torch_export.*stablehlo"):
        create_paddle_predictor(NativeConfig(model_dir=str(tmp_path),
                                             use_gpu=False))


def _conv_bn(with_bias):
    def body(pkg):
        x = pkg.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
        conv = pkg.layers.conv2d(input=x, num_filters=4, filter_size=3,
                                 padding=1,
                                 bias_attr=None if with_bias else False)
        return pkg.layers.batch_norm(input=conv, is_test=True)
    return body


def _bn_stats(j_main, j_scope):
    """Non-trivial batch-norm statistics, so folding changes weights."""
    bn = [op for op in j_main.global_block().ops
          if op.type == "batch_norm"][0]
    rng = np.random.RandomState(0)
    for slot, val in (("Mean", rng.rand(4) * 0.5),
                      ("Variance", rng.rand(4) + 0.5),
                      ("Scale", rng.rand(4) + 0.5),
                      ("Bias", rng.rand(4))):
        j_scope.set_var(bn.input(slot)[0], val.astype("float32"))


@pytest.mark.parametrize("with_bias", [True, False])
def test_inference_transpiler_folds_bn_as_the_jax_package(with_bias):
    (j_main, j_scope, j_out), (t_main, t_scope, t_out, exe) = _both(
        _conv_bn(with_bias), carry=_bn_stats)
    img = np.random.RandomState(1).rand(2, 3, 8, 8).astype("float32")
    ref, = exe.run(t_main, feed={"img": img}, fetch_list=[t_out],
                   scope=t_scope)
    folded = tfluid.InferenceTranspiler().transpile(t_main, scope=t_scope)
    assert not any(op.type == "batch_norm"
                   for op in folded.global_block().ops)
    got, = exe.run(folded, feed={"img": img}, fetch_list=[t_out.name],
                   scope=t_scope)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)

    j_folded = jfluid.InferenceTranspiler().transpile(j_main, scope=j_scope)
    assert [op.type for op in folded.global_block().ops] == \
        [op.type for op in j_folded.global_block().ops]
    for p in t_main.all_parameters():
        np.testing.assert_array_equal(
            tfluid.fetch_var(p.name, t_scope),
            np.asarray(j_scope.find_var(p.name)), err_msg=p.name)
    with jfluid.scope_guard(j_scope):
        want, = jfluid.Executor(jfluid.CPUPlace()).run(
            j_folded, feed={"img": img}, fetch_list=[j_out.name])
    np.testing.assert_allclose(got, want, **TOL)


def test_bfloat16_transpile_as_the_jax_package(tmp_path):
    def body(pkg):
        x = pkg.layers.data(name="x", shape=[8], dtype="float32")
        return pkg.layers.fc(input=x, size=4)

    (j_main, j_scope, j_out), (t_main, t_scope, t_out, exe) = _both(body)
    tfluid.transpile_to_bfloat16(t_main, scope=t_scope)
    jfluid.transpile_to_bfloat16(j_main, scope=j_scope)
    for p in t_main.all_parameters():
        got = t_scope.find_var(p.name)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy(),
            np.asarray(j_scope.find_var(p.name)).view(np.int16))
    x = np.random.RandomState(2).randn(2, 8).astype("float32")
    got, = exe.run(t_main, feed={"x": x}, fetch_list=[t_out], scope=t_scope)
    with jfluid.scope_guard(j_scope):
        want, = jfluid.Executor(jfluid.CPUPlace()).run(
            j_main, feed={"x": x}, fetch_list=[j_out])
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **TOL)
    # the cast parameters ship in their stored dtype and the artifact
    # serves what the program gives
    d = str(tmp_path / "bf16")
    tfluid.io.save_inference_model(d, ["x"], [t_out], exe,
                                   main_program=t_main, scope=t_scope,
                                   export_batch_sizes=[2])
    pred = create_paddle_predictor(NativeConfig(model_dir=d, use_gpu=False))
    np.testing.assert_array_equal(pred.run({"x": x})[0].data, got)
