"""The port's small model zoo held to the JAX package's on the CPU:
``se_resnext50``, ``mnist_cnn``/``mnist_mlp`` (``mnist.build_train``,
with ``accuracy``) and ``word2vec.build_train``, each built with the
same calls in both packages, the JAX package's start state carried into
the port with ``state_from_numpy``, and one optimizer step on the same
seeded numpy batch.

* The symbol tables are equal.
* The loss within rtol 1e-5 (and ``accuracy`` equal, the predictions
  within rtol 1e-5).
* After the step, every parameter within 1e-5 of the largest parameter
  magnitude (``se_resnext50``: 1e-4, the bound tests/test_torch_resnet.py
  holds for a deep conv stack, its sums over 3x3x(C/32) windows and
  batch norms running in another order).

``se_resnext50`` runs in test mode (batch norm on its running
statistics, dropout scaling by 0.8) at 32x32, B=2, 10 classes: in
training mode a batch norm over a 1x1 map of B=2 normalizes two numbers
to about +-1, which is chaotic in both packages (see
tests/test_torch_resnet.py).
"""

import numpy as np
import pytest
import torch

from _torch_port import symbol_table, train_both

torch.set_num_threads(1)


def _models(pkg):
    from importlib import import_module

    root = "paddle_tpu" if pkg == "jax" else "paddle_tpu_torch"
    return import_module(root + ".models")


def _se_resnext(pkg, fluid):
    img = fluid.layers.data(name="img", shape=[-1, 3, 32, 32],
                            dtype="float32", append_batch_size=False)
    lbl = fluid.layers.data(name="lbl", shape=[-1, 1], dtype="int64",
                            append_batch_size=False)
    predict = _models(pkg).se_resnext50(img, class_dim=10, is_test=True)
    cost = fluid.layers.mean(fluid.layers.cross_entropy(input=predict,
                                                        label=lbl))
    fluid.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(cost)
    return [cost, predict]


def _mnist(model):
    def build(pkg, fluid):
        _, _, avg_cost, acc, predict = _models(pkg).mnist.build_train(model)
        fluid.optimizer.Momentum(learning_rate=0.1,
                                 momentum=0.9).minimize(avg_cost)
        return [avg_cost, predict, acc]

    return build


def _word2vec(is_sparse):
    def build(pkg, fluid):
        _, avg_cost, predict = _models(pkg).word2vec.build_train(
            DICT, embed_size=8, hidden_size=16, is_sparse=is_sparse)
        fluid.optimizer.SGD(learning_rate=0.5).minimize(avg_cost)
        return [avg_cost, predict]

    return build


DICT = 50


def _feed(name, seed=0):
    rng = np.random.RandomState(seed)
    if name == "se_resnext50":
        return {"img": rng.rand(2, 3, 32, 32).astype(np.float32),
                "lbl": rng.randint(0, 10, (2, 1)).astype(np.int64)}
    if name.startswith("mnist"):
        shape = (4, 1, 28, 28) if name == "mnist_cnn" else (4, 784)
        return {"pixel": rng.rand(*shape).astype(np.float32),
                "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
    return {n: rng.randint(0, DICT, (6, 1)).astype(np.int64)
            for n in ("firstw", "secondw", "thirdw", "forthw", "nextw")}


CASES = {"se_resnext50": (_se_resnext, 1e-4),
         "mnist_cnn": (_mnist("cnn"), 1e-5),
         "mnist_mlp": (_mnist("mlp"), 1e-5),
         "word2vec": (_word2vec(False), 1e-5),
         "word2vec_sparse": (_word2vec(True), 1e-5)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_model_matches_the_jax_package(name):
    build, param_tol = CASES[name]
    run = train_both(build, _feed(name), steps=1)
    assert symbol_table(run["t_main"]) == symbol_table(run["j_main"])
    j_out, t_out = run["j_out"][0], run["t_out"][0]
    np.testing.assert_allclose(t_out[0], j_out[0], rtol=1e-5)
    np.testing.assert_allclose(t_out[1], j_out[1], rtol=1e-5, atol=1e-7)
    if name.startswith("mnist"):
        assert float(t_out[2]) == float(j_out[2])
    params = [p.name for p in run["t_main"].all_parameters()]
    scale = max(float(np.abs(run["j_state"][n]).max()) for n in params)
    for n in params:
        assert not np.array_equal(run["j_state"][n], run["state"][n]) \
            or "moving" in n or name == "word2vec_sparse", n
        np.testing.assert_allclose(run["t_state"][n], run["j_state"][n],
                                   rtol=0, atol=param_tol * scale,
                                   err_msg=n)
