"""paddle_tpu_torch.models.vgg held to paddle_tpu.models.vgg on the CPU.

VGG-16 with batch norm at 32x32, ``class_dim=10``, B=4, built with the
same calls in both packages and trained with ``bench_resnet.py``'s
optimizer (``Momentum(0.1, 0.9)``); the JAX package's start state is
carried into the port with ``state_from_numpy`` and the same seeded
numpy batch goes through both.

* The symbol tables are equal: every parameter's name, shape and dtype,
  the running statistics, velocities and the dropout counter; and the
  two builds drew the same number of seeds.
* One step in each of three modes: the loss within rtol 1e-5, the class
  probabilities within rtol 1e-5 (``train``: 1e-4 of their largest,
  the fc batch norm normalizing 4 values a channel), every parameter
  and running statistic within 1e-4 of the largest parameter magnitude
  (the bound tests/test_torch_resnet.py holds), and the dropout counter.
  - ``test``: ``is_test=True`` (running statistics, dropout scaling by
    0.5);
  - ``train_bn_running``: the training program with its two dropout
    sites drawing their masks (bit-equal in the two packages), every
    batch norm switched to its running statistics;
  - ``train``: the training program as built. Batch statistics over a
    32x32 batch of 4 make the first blocks' gradients chaotic in f32:
    with this seed the JAX package meets a batch-norm output that is
    exactly 0 (its ``jnp.maximum`` ReLU passes half a gradient there,
    torch's value is an ulp off 0 and passes all or none), and ReLU and
    max-pool near-ties that one rounding flips part the gradients of
    blocks 1-3 by up to 4.4e-3 of the largest parameter (measured),
    while the last conv block and the head, where the dropout sites
    are, agree within 2e-5. So this mode holds the loss and the
    probabilities, and the last conv block's and the head's state.
"""

import re

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique_name
from paddle_tpu.models.vgg import vgg16 as j_vgg16
from paddle_tpu_torch.models.vgg import vgg16 as t_vgg16

from _torch_port import symbol_table

torch.set_num_threads(1)

HW, CLASSES, BATCH = 32, 10, 4
# the last conv block (convs 10-12 and their batch norms), the three fc
# layers and the fc batch norm, with their running statistics
_HEAD = re.compile(r"(conv2d\.[wb]_1[0-2]|batch_norm\.[wb]_1[0-3]|fc\.|"
                   r"batch_norm\.moving_\w+_1[0-3])(\b|_)")


def _build(pkg, mode):
    """(main, startup, avg_cost, predict) of VGG-16 + Momentum in one
    package. ``mode``: "test" (``is_test=True``), "train", or
    "train_bn_running" (training, then every batch norm switched to its
    running statistics by its ``is_test`` attribute: dropout still
    trains)."""
    fluid, guard, vgg = ((jfluid, j_unique_name.guard, j_vgg16)
                         if pkg == "jax" else
                         (tfluid, tfluid.unique_name.guard, t_vgg16))
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[-1, 3, HW, HW],
                                dtype="float32", append_batch_size=False)
        lbl = fluid.layers.data(name="lbl", shape=[-1, 1], dtype="int64",
                                append_batch_size=False)
        predict = vgg(img, class_dim=CLASSES, is_test=mode == "test")
        cost = fluid.layers.cross_entropy(input=predict, label=lbl)
        avg_cost = fluid.layers.mean(cost)
        fluid.optimizer.Momentum(learning_rate=0.1,
                                 momentum=0.9).minimize(avg_cost)
    if mode == "train_bn_running":
        for op in main.global_block().ops:
            if op.type == "batch_norm":
                op.attrs["is_test"] = True
    return main, startup, avg_cost, predict


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(BATCH, 3, HW, HW).astype(np.float32),
            "lbl": rng.randint(0, CLASSES, (BATCH, 1)).astype(np.int64)}


def _both(mode):
    """One step of each package from the JAX package's start state:
    ((jax cost, predict), (torch cost, predict), jax state, torch state,
    parameter names)."""
    jm, js, jcost, jpred = _build("jax", mode)
    tm, ts, tcost, tpred = _build("torch", mode)
    assert symbol_table(tm) == symbol_table(jm)
    assert tm._seed_counter == jm._seed_counter
    feed = _batch()
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(js)
        state = {v.name: np.asarray(scope.find_var(v.name))
                 for v in jm.list_vars() if v.persistable}
        jout = [np.asarray(o) for o in exe.run(
            jm, feed=feed, fetch_list=[jcost.name, jpred.name])]
        jstate = {n: np.asarray(scope.find_var(n)) for n in state}
    tscope, place = tfluid.Scope(), tfluid.CPUPlace()
    tfluid.state_from_numpy(state, tscope, place, program=tm)
    tout = tfluid.Executor(place).run(tm, feed=feed,
                                      fetch_list=[tcost, tpred],
                                      scope=tscope)
    tstate = {n: tfluid.fetch_var(n, tscope) for n in state}
    return jout, tout, jstate, tstate, [p.name for p in tm.all_parameters()]


@pytest.mark.parametrize("mode", ["test", "train_bn_running", "train"])
def test_vgg16_matches_the_jax_package(mode):
    jout, tout, jstate, tstate, params = _both(mode)
    # a weight and a bias each: 13 convs, 14 batch norms, 3 fc
    assert len(params) == 2 * (13 + 14 + 3)
    (jcost, jpred), (tcost, tpred) = jout, tout
    assert tpred.shape == (BATCH, CLASSES)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-5)
    if mode == "train":
        np.testing.assert_allclose(tpred, jpred, rtol=0,
                                   atol=1e-4 * np.abs(jpred).max())
    else:
        np.testing.assert_allclose(tpred, jpred, rtol=1e-5, atol=1e-7)
    scale = max(float(np.abs(jstate[n]).max()) for n in params)
    # in full training mode the blocks before the fourth pool are
    # compared through the loss alone (see the module docstring)
    held = params + [n for n in jstate if "moving" in n]
    if mode == "train":
        held = [n for n in held if _HEAD.match(n)]
    for n in held:
        np.testing.assert_allclose(tstate[n], jstate[n], rtol=0,
                                   atol=1e-4 * scale, err_msg=n)
    assert int(tstate["_dropout_rng_counter"]) == \
        int(jstate["_dropout_rng_counter"]) == (0 if mode == "test" else 2)
