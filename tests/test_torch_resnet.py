"""paddle_tpu_torch.models.resnet held to paddle_tpu.models.resnet.

The same builder calls in both packages give the same symbol table; the
JAX package's start state (parameters, batch norm's running statistics,
velocities, learning rate) is carried into the port with
``state_from_numpy``, and the same seeded numpy batches go through both.

* ``resnet_cifar10`` depth 8 at 32x32, B=4, three ``Momentum(0.1,
  0.9)`` steps: losses within rtol 1e-5; every parameter and running
  statistic within 1e-4 of the largest parameter magnitude. (Not of
  each tensor's own: a ReLU kink makes a per-tensor bound depend on
  ties. With this seed the JAX package meets one batch-norm output that
  is exactly 0 — x equal to the batch mean in its f32 rounding, not in
  the port's — and ``jnp.maximum(x, 0)`` sends that element half its
  gradient where the port's nonzero value takes all or none: the first
  bias's gradient then differs by that one element's share, about 1e-3
  of the bias's own small magnitude.)
* ``resnet_imagenet`` depth 50 at 32x32, B=2, 10 classes, with
  ``is_test=True``: the forward (class probabilities) and one Momentum
  step. At 32x32 the last stage is 1x1, so a training-mode batch norm
  there normalizes two numbers per channel to about +-1: a sign that one
  rounding of a near-tie flips, in either package. With the running
  statistics the whole 161-parameter net is well conditioned, and the
  comparison holds every conv, pooling, batch-norm (test mode), fc and
  update op at ResNet-50's topology to 1e-5. The training-mode step runs
  in the port alone: a finite loss, and the stem's running statistics
  moved by the JAX package's rule (0.9 running + 0.1 batch, population
  variance) from the stem conv's output.
* the space-to-depth stem against the plain 7x7/s2 conv in the port
  (the JAX package's ``test_s2d_stem_exact_equivalence``): the same
  output shape, output within 1e-5, the canonical weight's gradient
  within 1e-4.
"""

import numpy as np
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique_name
from paddle_tpu.models.resnet import resnet_cifar10 as j_cifar
from paddle_tpu.models.resnet import resnet_imagenet as j_imagenet
from paddle_tpu_torch.models.resnet import _s2d_stem_conv
from paddle_tpu_torch.models.resnet import resnet_cifar10 as t_cifar
from paddle_tpu_torch.models.resnet import resnet_imagenet as t_imagenet

from _torch_port import symbol_table

torch.set_num_threads(1)

HW, CLASSES = 32, 10
MODELS = {"jax": {"cifar": j_cifar, "imagenet": j_imagenet},
          "torch": {"cifar": t_cifar, "imagenet": t_imagenet}}


def _build(pkg, model, **kw):
    """(main, startup, avg_cost, predict) of bench_resnet.py's program
    at 32x32 in one package."""
    fluid, guard = ((jfluid, j_unique_name.guard) if pkg == "jax"
                    else (tfluid, tfluid.unique_name.guard))
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[-1, 3, HW, HW],
                                dtype="float32", append_batch_size=False)
        lbl = fluid.layers.data(name="lbl", shape=[-1, 1], dtype="int64",
                                append_batch_size=False)
        predict = MODELS[pkg][model](img, class_dim=CLASSES, **kw)
        cost = fluid.layers.cross_entropy(input=predict, label=lbl)
        avg_cost = fluid.layers.mean(cost)
        fluid.optimizer.Momentum(learning_rate=0.1,
                                 momentum=0.9).minimize(avg_cost)
    return main, startup, avg_cost, predict


def _batches(b, n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"img": rng.rand(b, 3, HW, HW).astype(np.float32),
             "lbl": rng.randint(0, CLASSES, (b, 1)).astype(np.int64)}
            for _ in range(n)]


def _both(model, feeds, fetch, **kw):
    """Run ``feeds`` (one step each) through both packages from the JAX
    package's start state: ({"jax"|"torch": [fetches per step]},
    {"jax"|"torch": {persistable: array after the steps}})."""
    jm, js, jcost, jpred = _build("jax", model, **kw)
    tm, ts, tcost, tpred = _build("torch", model, **kw)
    assert symbol_table(tm) == symbol_table(jm)
    names = {"cost": (jcost.name, tcost.name),
             "predict": (jpred.name, tpred.name)}
    jnames = [names[f][0] for f in fetch]
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(js)
        state = {v.name: np.asarray(scope.find_var(v.name))
                 for v in jm.list_vars() if v.persistable}
        jout = [[np.asarray(o) for o in exe.run(jm, feed=f,
                                                fetch_list=jnames)]
                for f in feeds]
        jstate = {n: np.asarray(scope.find_var(n)) for n in state}
    tscope = tfluid.Scope()
    place = tfluid.CPUPlace()
    tfluid.state_from_numpy(state, tscope, place, program=tm)
    exe = tfluid.Executor(place)
    tout = [exe.run(tm, feed=f, fetch_list=[names[x][1] for x in fetch],
                    scope=tscope) for f in feeds]
    tstate = {n: tfluid.fetch_var(n, tscope) for n in state}
    params = [p.name for p in tm.all_parameters()]
    return ({"jax": jout, "torch": tout},
            {"jax": jstate, "torch": tstate}, params)


def test_cifar_depth8_trains_as_the_jax_package():
    outs, states, params = _both("cifar", _batches(4, 3), ["cost"], depth=8)
    jl = [float(o[0]) for o in outs["jax"]]
    tl = [float(o[0]) for o in outs["torch"]]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    scale = max(float(np.abs(states["jax"][n]).max()) for n in params)
    moved = [n for n in states["jax"] if "moving" in n]
    for n in params + moved:
        np.testing.assert_allclose(states["torch"][n], states["jax"][n],
                                   rtol=0, atol=1e-4 * scale, err_msg=n)


def test_resnet50_forward_and_step_match_the_jax_package():
    outs, states, params = _both("imagenet", _batches(2, 1),
                                 ["cost", "predict"], depth=50,
                                 is_test=True)
    assert len(params) == 161
    (jcost, jpred), = outs["jax"]
    (tcost, tpred), = outs["torch"]
    assert tpred.shape == (2, CLASSES)
    np.testing.assert_allclose(tpred, jpred, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-5)
    for n in params:
        want = states["jax"][n]
        np.testing.assert_allclose(states["torch"][n], want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=n)


def test_resnet50_training_step_updates_stem_statistics():
    tm, ts, cost, _ = _build("torch", "imagenet", depth=50)
    scope, place = tfluid.Scope(), tfluid.CPUPlace()
    exe = tfluid.Executor(place)
    exe.run(ts, scope=scope)
    stem = next(op for op in tm.global_block().ops
                if op.type == "batch_norm")
    conv_out = stem.input("X")[0]
    mean_name, var_name = stem.input("Mean")[0], stem.input("Variance")[0]
    feed, = _batches(2, 1, seed=3)
    loss, x = exe.run(tm, feed=feed, fetch_list=[cost, conv_out],
                      scope=scope)
    assert np.isfinite(loss)
    x = x.astype(np.float64)
    np.testing.assert_allclose(tfluid.fetch_var(mean_name, scope),
                               0.1 * x.mean(axis=(0, 2, 3)), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(tfluid.fetch_var(var_name, scope),
                               0.9 + 0.1 * x.var(axis=(0, 2, 3)), rtol=1e-5)


def test_s2d_stem_equals_the_plain_stem():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 3, HW, HW).astype(np.float32)
    w = (rng.randn(64, 3, 7, 7) * 0.05).astype(np.float32)
    outs, grads = {}, {}
    for mode in ("plain", "s2d"):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.unique_name.guard(), \
                tfluid.program_guard(main, startup):
            img = tfluid.layers.data(name="img", shape=[-1, 3, HW, HW],
                                     dtype="float32",
                                     append_batch_size=False)
            if mode == "plain":
                conv = tfluid.layers.conv2d(input=img, num_filters=64,
                                            filter_size=7, stride=2,
                                            padding=3, bias_attr=False)
            else:
                conv = _s2d_stem_conv(img)
            loss = tfluid.layers.mean(
                tfluid.layers.elementwise_mul(conv, conv))
            tfluid.optimizer.SGD(learning_rate=0.0).minimize(loss)
        wname, = [p.name for p in main.all_parameters()]
        assert main.global_block().var(wname).shape == (64, 3, 7, 7)
        scope, place = tfluid.Scope(), tfluid.CPUPlace()
        exe = tfluid.Executor(place)
        exe.run(startup, scope=scope)
        tfluid.params_from_numpy({wname: w}, scope, place, program=main)
        outs[mode], grads[mode] = exe.run(
            main, feed={"img": x}, fetch_list=[conv, wname + "@GRAD"],
            scope=scope)
    assert outs["plain"].shape == outs["s2d"].shape == (2, 64, 16, 16)
    np.testing.assert_allclose(outs["s2d"], outs["plain"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(grads["s2d"], grads["plain"], rtol=1e-4,
                               atol=1e-6)
