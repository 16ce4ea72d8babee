"""MobileNet-SSD (PaddlePaddle/models, fluid/object_detection/
mobilenet_ssd.py and train.py) built through each package's layers by
``chip_smoke.build_ssd`` at a small size — widths scaled by 0.125,
96x96 images, B=2, 4 padded ground-truth rows — and held to the JAX
package: the symbol tables, the loss and every gradient of step 0, the
losses and every persistable (parameters, RMSProp's moments in their
two fused groups, the schedule's counter) after two steps, the
``detection_output`` rows of the trained model's ``clone(for_test=True)``
(labels exactly), and the mAP of ``evaluator.DetectionMAP`` (equal, and
equal to the numpy evaluator over the fetched rows).

The network's batch norms run on their running statistics here (as
tests/test_torch_vgg.py trains VGG-16): in training mode a batch norm
over the few values of B=2 at 1x1 to 3x3 maps magnifies the two
frameworks' f32 rounding, from 4e-7 of the first block's output to 6e-5
of the heads' and 4e-4 at the 1x1 maps, though both are right; the
training-mode network is held by its step-0 loss. Floats within 1e-5 of
the array's largest magnitude; after the steps, every persistable
within that or 1e-3 of ``lr``, whichever is larger: RMSProp's update
``lr * g / sqrt(ms + eps)`` (its ``momentum`` accumulator, and the
whole of a parameter that starts at 0) is steepest in ``g`` near
``sqrt(eps / (1 - rho))``, where it magnifies a gradient's last bits.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid

import chip_smoke as cs
from _torch_port import _flags, symbol_table

torch.set_num_threads(1)

TOL = 1e-5
SMALL = dict(scale=0.125, hw=96, G=4)
B = 2
LR = cs.SSD_LR[1][0]


def _close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=TOL, atol=TOL * float(np.abs(want).max(initial=0)),
        err_msg=name)


@pytest.fixture(scope="module")
def runs():
    """Both packages: step 0's loss and gradients, two steps' losses,
    the persistables after them, and the test clone's detections and the
    evaluator's mAPs over two test batches."""
    batches = cs.ssd_batches(4, B=B, hw=SMALL["hw"], G=SMALL["G"], seed=5)
    out = {}
    for pkg, fluid in (("jax", jfluid), ("torch", tfluid)):
        with _flags(pkg, cs.SSD_FLAGS):
            (main, startup, test_prog, eval_prog, loss, nmsed,
             maps) = cs.build_ssd(fluid, bn_is_test=True, **SMALL)
        grads = [p.name + "@GRAD" for p in main.all_parameters()]
        persist = sorted(v.name for v in main.list_vars() if v.persistable)
        r = {"table": symbol_table(main), "grads": grads}
        if pkg == "jax":
            scope = jfluid.Scope()
            with jfluid.scope_guard(scope):
                exe = jfluid.Executor(jfluid.CPUPlace())
                exe.run(startup)
                state = {n: np.asarray(scope.find_var(n)) for n in persist}
                r["step0"] = [np.asarray(a) for a in exe.run(
                    main, feed=batches[0], fetch_list=[loss.name] + grads)]
                r["loss1"] = float(np.asarray(exe.run(
                    main, feed=batches[1], fetch_list=[loss.name])[0]))
                r["state"] = {n: np.asarray(scope.find_var(n))
                              for n in persist}
                r["det"] = [np.asarray(exe.run(
                    test_prog, feed=b, fetch_list=[nmsed.name])[0])
                    for b in batches[2:]]
                r["maps"] = [[float(np.asarray(m)) for m in exe.run(
                    eval_prog, feed=b, fetch_list=[m.name for m in maps])]
                    for b in batches[2:]]
        else:
            place, scope = tfluid.CPUPlace(), tfluid.Scope()
            tfluid.state_from_numpy(state, scope, place, program=main)
            exe = tfluid.Executor(place)
            r["step0"] = exe.run(main, feed=batches[0],
                                 fetch_list=[loss.name] + grads, scope=scope)
            r["loss1"] = float(exe.run(main, feed=batches[1],
                                       fetch_list=[loss.name],
                                       scope=scope)[0])
            r["state"] = {n: tfluid.fetch_var(n, scope) for n in persist}
            r["det"] = [exe.run(test_prog, feed=b, fetch_list=[nmsed.name],
                                scope=scope)[0] for b in batches[2:]]
            r["maps"] = [[float(m) for m in exe.run(
                eval_prog, feed=b, fetch_list=[m.name for m in maps],
                scope=scope)] for b in batches[2:]]
            r["groups"] = sum(op.type == "rmsprop_fused"
                              for op in main.global_block().ops)
        out[pkg] = r
    out["batches"] = batches
    return out


def test_programs_and_priors(runs):
    assert runs["torch"]["table"] == runs["jax"]["table"]
    # 6x6 x 3 + (3x3 + 2x2 + 1 + 1 + 1) x 6 priors at 96x96
    assert runs["torch"]["step0"][1:] and runs["torch"]["det"][0].shape == (
        B, 200, 6)
    # the convs (learning rate 0.1) and the rest: two flat groups
    assert runs["torch"]["groups"] == 2


def test_step0_loss_and_gradients(runs):
    names = ["loss"] + runs["torch"]["grads"]
    for name, got, want in zip(names, runs["torch"]["step0"],
                               runs["jax"]["step0"]):
        _close(got, want, name)


def test_two_rmsprop_steps(runs):
    t, j = runs["torch"], runs["jax"]
    np.testing.assert_allclose(t["loss1"], j["loss1"], rtol=TOL)
    assert t["state"].keys() == j["state"].keys()
    for name in sorted(j["state"]):
        got, want = t["state"][name], j["state"][name]
        scale = float(np.abs(want).max(initial=0))
        np.testing.assert_allclose(got, want, rtol=TOL,
                                   atol=max(TOL * scale, 1e-3 * LR),
                                   err_msg=name)


def test_training_mode_step0_loss():
    """The network as train.py builds it (batch norms on batch
    statistics): the same program, and step 0's loss."""
    batch = cs.ssd_batches(1, B=B, hw=SMALL["hw"], G=SMALL["G"], seed=6)[0]
    losses, tables = {}, {}
    for pkg, fluid in (("jax", jfluid), ("torch", tfluid)):
        with _flags(pkg, cs.SSD_FLAGS):
            main, startup, test_prog, _, loss, _, _ = cs.build_ssd(
                fluid, **SMALL)
        tables[pkg] = symbol_table(main)
        persist = sorted(v.name for v in main.list_vars() if v.persistable)
        if pkg == "jax":
            scope = jfluid.Scope()
            with jfluid.scope_guard(scope):
                exe = jfluid.Executor(jfluid.CPUPlace())
                exe.run(startup)
                state = {n: np.asarray(scope.find_var(n)) for n in persist}
                losses[pkg] = float(np.asarray(exe.run(
                    main, feed=batch, fetch_list=[loss.name])[0]))
        else:
            place, scope = tfluid.CPUPlace(), tfluid.Scope()
            tfluid.state_from_numpy(state, scope, place, program=main)
            losses[pkg] = float(tfluid.Executor(place).run(
                main, feed=batch, fetch_list=[loss.name], scope=scope)[0])
    assert tables["torch"] == tables["jax"]
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=TOL)


def test_detection_rows_and_map(runs):
    t, j = runs["torch"], runs["jax"]
    for got, want in zip(t["det"], j["det"]):
        np.testing.assert_array_equal(got[..., 0], want[..., 0])
        _close(got, want, "detections")
        assert (got[..., 0] >= 0).sum() > 0
    # cur_map and accum_map of each test batch: the JAX package's, and
    # the numpy evaluator's over the fetched rows
    assert t["maps"] == j["maps"]
    batches = runs["batches"][2:]
    assert t["maps"][0][0] == np.float32(cs.numpy_map(t["det"][:1],
                                                      batches[:1]))
    assert t["maps"][1][1] == np.float32(cs.numpy_map(t["det"], batches))


def test_cost_report_equals_the_jax_package():
    """``obs.cost.report`` of the training program at B=2: the same ops,
    families, totals and unknown op types in both packages (the new
    layers have no cost rule in either, and the convs count as
    convs)."""
    feed_shapes = {"image": (B, 3, 96, 96), "gt_box": (B, 4, 4),
                   "gt_box@LEN": (B,), "gt_label": (B, 4, 1),
                   "gt_difficult": (B, 4, 1)}
    reps = {}
    for pkg, fluid in (("jax", jfluid), ("torch", tfluid)):
        with _flags(pkg, cs.SSD_FLAGS):
            main = cs.build_ssd(fluid, **SMALL)[0]
        reps[pkg] = fluid.obs.cost.report(main, feed_shapes=feed_shapes)
    j, t = reps["jax"], reps["torch"]
    assert [(o.op_type, o.family, o.flops, o.bytes) for o in t.ops] == [
        (o.op_type, o.family, o.flops, o.bytes) for o in j.ops]
    assert (t.total_flops, t.total_bytes) == (j.total_flops, j.total_bytes)
    assert t.unknown_op_types() == j.unknown_op_types()
    assert {"ssd_loss", "prior_box"} <= set(t.unknown_op_types())
    assert t.by_family()["conv"]["unknown"] == 0
