"""The smallest slice end to end in paddle_tpu_torch: fit_a_line (book
chapter 01), held to paddle_tpu's.

* ``models.fit_a_line.build_train`` builds the JAX package's symbol
  table and ops.
* The book tests of tests/test_fit_a_line.py run on the port: 200 SGD
  steps converge (last loss < 5 % of the first and < 0.1) and, from the
  JAX package's initial weights, every step's loss is within rtol 1e-5
  / atol 1e-7 of the JAX package's (the fit is exact: late losses reach
  ~1e-9, the f32 noise floor) and the final weights within rtol 1e-5 /
  atol 1e-6; a fetched intermediate and ``w@GRAD`` equal their closed forms
  (rtol 1e-5 / 1e-4, the book's); ``clone(for_test=True)`` + ``prune``
  keep the ``mul`` and drop the ``mean``.
* Trainer → ``save_params`` → ``Inferencer.infer``, and Trainer →
  ``save_inference_model`` → ``load_inference_model(program=)`` →
  ``Executor.run``: both equal ``Executor.run`` on the trained scope
  bit for bit, and the JAX package's ``Inferencer`` over the port's
  saved parameters predicts the same within rtol 1e-6.
"""

import numpy as np
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique_name
from paddle_tpu.models import fit_a_line as j_fit
from paddle_tpu_torch.models import fit_a_line as t_fit

from _torch_port import symbol_table

torch.set_num_threads(1)

CPU = tfluid.CPUPlace()
STEPS = 200


def _build(pkg, fit):
    guard = j_unique_name.guard if pkg is jfluid else \
        tfluid.unique_name.guard
    main, startup = pkg.Program(), pkg.Program()
    with guard(), pkg.program_guard(main, startup):
        x, y, avg_cost, pred = fit.build_train()
        pkg.optimizer.SGD(learning_rate=0.05).minimize(avg_cost)
    return main, startup, avg_cost, pred


def _batches():
    rng = np.random.RandomState(0)
    true_w = rng.randn(13, 1).astype("float32")
    for _ in range(STEPS):
        xb = rng.randn(32, 13).astype("float32")
        yield {"x": xb, "y": xb @ true_w + 0.5}


def test_build_train_is_the_jax_program():
    j, t = _build(jfluid, j_fit), _build(tfluid, t_fit)
    assert symbol_table(t[0]) == symbol_table(j[0])
    assert [(op.type, op.inputs, op.outputs)
            for op in t[0].global_block().ops] == \
        [(op.type, op.inputs, op.outputs) for op in j[0].global_block().ops]


def test_fit_a_line_converges_as_the_jax_package():
    j_main, j_startup, j_cost, _ = _build(jfluid, j_fit)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(j_startup)
        p0 = {p.name: np.asarray(jscope.find_var(p.name))
              for p in j_main.all_parameters()}
        j_losses = [float(jexe.run(j_main, feed=f,
                                   fetch_list=[j_cost.name])[0])
                    for f in _batches()]
    t_main, t_startup, t_cost, _ = _build(tfluid, t_fit)
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    exe.run(t_startup, scope=scope)
    tfluid.params_from_numpy(p0, scope, CPU, program=t_main)
    t_losses = [float(exe.run(t_main, feed=f, fetch_list=[t_cost],
                              scope=scope)[0]) for f in _batches()]
    # the book's bar
    assert t_losses[-1] < t_losses[0] * 0.05, (t_losses[0], t_losses[-1])
    assert t_losses[-1] < 0.1
    # the fit is exact: late losses reach ~1e-9, the f32 noise floor
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5, atol=1e-7)
    for name in p0:
        np.testing.assert_allclose(scope.find_var(name).numpy(),
                                   np.asarray(jscope.find_var(name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_fetch_intermediate_and_grad():
    main, startup = tfluid.Program(), tfluid.Program()
    scope = tfluid.Scope()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        y = tfluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = tfluid.layers.fc(input=x, size=1, bias_attr=False,
                                param_attr=tfluid.ParamAttr(name="w"))
        loss = tfluid.layers.mean(tfluid.layers.square_error_cost(pred, y))
        tfluid.append_backward(loss)
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    xb = np.ones((3, 4), dtype="float32")
    yb = np.zeros((3, 1), dtype="float32")
    pred_v, grad_v = exe.run(main, feed={"x": xb, "y": yb},
                             fetch_list=[pred, "w@GRAD"], scope=scope)
    w = scope.find_var("w").numpy()
    np.testing.assert_allclose(pred_v, xb @ w, rtol=1e-5)
    np.testing.assert_allclose(grad_v, 2.0 / 3.0 * xb.T @ (xb @ w),
                               rtol=1e-4)


def test_program_clone_and_prune():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        h = tfluid.layers.fc(input=x, size=8, act="relu")
        out = tfluid.layers.fc(input=h, size=2)
        tfluid.layers.mean(out)
    pruned = main.clone(for_test=True).prune([out.name])
    assert any(op.type == "mul" for op in pruned.global_block().ops)
    assert all(op.type != "mean" for op in pruned.global_block().ops)


def _train_func():
    _, _, avg_cost, _ = t_fit.build_train()
    return avg_cost


def _infer_func(pkg):
    def infer():
        x = pkg.layers.data(name="x", shape=[13], dtype="float32")
        return pkg.layers.fc(input=x, size=1, act=None)
    return infer


def _reader():
    batches = list(_batches())[:20]

    def reader():
        for f in batches:
            yield [(f["x"][i], f["y"][i]) for i in range(32)]
    return reader


def test_trainer_saves_and_both_inference_paths_serve_it(tmp_path):
    trainer = tfluid.Trainer(
        _train_func, lambda: tfluid.optimizer.SGD(learning_rate=0.05),
        place=CPU)
    trainer.train(1, reader=_reader(), feed_order=["x", "y"],
                  steps_per_loop=5)
    x = np.random.RandomState(7).randn(6, 13).astype(np.float32)
    pred_name = [op for op in trainer.train_program.global_block().ops
                 if op.type == "elementwise_add"][0].output_arg_names[0]
    want, = trainer.exe.run(
        trainer.test_program.prune([pred_name]), feed={"x": x},
        fetch_list=[pred_name], scope=trainer.scope)

    trainer.save_params(str(tmp_path / "params"))
    inferencer = tfluid.Inferencer(_infer_func(tfluid),
                                   str(tmp_path / "params"), place=CPU)
    got, = inferencer.infer({"x": x})
    np.testing.assert_array_equal(got, want)

    trainer.train_func_outputs.append(
        trainer.train_program.global_block().var(pred_name))
    trainer.save_inference_model(str(tmp_path / "model"), ["x"], [1])
    scope = tfluid.Scope()
    prog, feeds, fetches = tfluid.io.load_inference_model(
        str(tmp_path / "model"), tfluid.Executor(CPU), scope=scope,
        program=trainer.test_program)
    assert (feeds, fetches) == (["x"], [pred_name])
    got, = tfluid.Executor(CPU).run(prog, feed={"x": x},
                                    fetch_list=fetches, scope=scope)
    np.testing.assert_array_equal(got, want)

    # the JAX package's Inferencer reads the port's saved parameters
    j_inf = jfluid.Inferencer(_infer_func(jfluid), str(tmp_path / "params"),
                              place=jfluid.CPUPlace())
    j_got, = j_inf.infer({"x": x})
    np.testing.assert_allclose(np.asarray(j_got), want, rtol=1e-6)
