"""paddle_tpu_torch.layers.switch_moe held to paddle_tpu's: the first two
tests of tests/test_moe.py (the numpy oracle of routing and capacity,
and the capacity drop) in the port, the layer's output, aux loss and
every gradient over three Adam steps against the JAX package, the
expert weights' ``ep`` annotation, and the build-time check of a mesh
whose ``ep`` axis does not split the experts (tests/test_moe.py's third
test, expert parallelism over ranks, is
tests/test_torch_expert_parallel.py's).
"""

import math

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
    "switch_moe": ("test_trains_like_the_jax_package",),
}


def _numpy_moe(x, wr, w1, b1, w2, b2, cap):
    B, T, D = x.shape
    S = B * T
    E = wr.shape[1]
    C = max(1, math.ceil(cap * S / E))
    xs = x.reshape(S, D)
    logits = xs @ wr
    e = np.exp(logits - logits.max(-1, keepdims=True))
    probs = e / e.sum(-1, keepdims=True)
    expert = probs.argmax(-1)
    counts = {}
    ys = np.zeros_like(xs)
    for s in range(S):
        k = int(expert[s])
        pos = counts.get(k, 0)
        counts[k] = pos + 1
        if pos >= C:
            continue  # dropped token
        h = np.maximum(xs[s] @ w1[k] + b1[k], 0)
        ys[s] = (h @ w2[k] + b2[k]) * probs[s, k]
    return ys.reshape(B, T, D)


def _build(E=4, D=8, F=16, cap=1.25):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[-1, -1, D], dtype="float32",
                               append_batch_size=False)
        out, aux = tfluid.layers.switch_moe(x, num_experts=E, d_inner=F,
                                            capacity_factor=cap)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    return main, scope, exe, out, aux


def test_matches_numpy_oracle():
    main, scope, exe, out, aux = _build()
    xv = np.random.RandomState(0).randn(2, 6, 8).astype("float32")
    got, aux_v = exe.run(main, feed={"x": xv}, fetch_list=[out, aux],
                         scope=scope)
    p = {v.name: tfluid.fetch_var(v.name, scope)
         for v in main.all_parameters()}
    wr = next(v for v in p.values() if v.shape == (8, 4))
    w1 = next(v for v in p.values() if v.shape == (4, 8, 16))
    b1 = next(v for v in p.values() if v.shape == (4, 16))
    w2 = next(v for v in p.values() if v.shape == (4, 16, 8))
    b2 = next(v for v in p.values() if v.shape == (4, 8))
    want = _numpy_moe(xv, wr, w1, b1, w2, b2, 1.25)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert 0.5 < float(aux_v) < 4.0


def test_capacity_drops_tokens():
    main, scope, exe, out, aux = _build(E=2, cap=0.26)
    xv = np.ones((1, 8, 8), "float32")
    got, = exe.run(main, feed={"x": xv}, fetch_list=[out], scope=scope)
    # identical tokens all pick one expert; capacity = ceil(.26*8/2)=2
    nonzero_rows = np.abs(got[0]).sum(-1) > 1e-12
    assert nonzero_rows.sum() == 2


def _train(pkg, cap):
    fluid, guard = package(pkg)
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[-1, -1, 8], dtype="float32",
                              append_batch_size=False)
        out, aux = fluid.layers.switch_moe(x, 4, 16, capacity_factor=cap)
        r = fluid.layers.data(name="r", shape=[-1, -1, 8], dtype="float32",
                              append_batch_size=False)
        loss = fluid.layers.elementwise_add(
            x=fluid.layers.mean(fluid.layers.elementwise_mul(out, r)),
            y=fluid.layers.scale(aux, scale=0.01))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, [out.name, aux.name, loss.name] + [
        p.name + "@GRAD" for p in main.all_parameters()]


@pytest.mark.parametrize("cap", [1.25, 0.5])
def test_trains_like_the_jax_package(cap):
    """Output, aux loss, loss and every gradient of three Adam steps
    (0.5: tokens dropped)."""
    r = np.random.RandomState(3)
    feed = {"x": r.randn(3, 5, 8).astype(np.float32),
            "r": r.randn(3, 5, 8).astype(np.float32)}
    j_main, j_startup, fetch = _train("jax", cap)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(j_startup)
        state = {v.name: np.asarray(scope.find_var(v.name))
                 for v in j_main.list_vars() if v.persistable}
        want = [[np.asarray(a) for a in exe.run(j_main, feed=feed,
                                                fetch_list=fetch)]
                for _ in range(3)]
    t_main, _, t_fetch = _train("torch", cap)
    assert t_fetch == fetch
    assert symbol_table(t_main) == symbol_table(j_main)
    place, t_scope = tfluid.CPUPlace(), tfluid.Scope()
    tfluid.state_from_numpy(state, t_scope, place, program=t_main)
    exe = tfluid.Executor(place)
    for step, w in enumerate(want):
        got = exe.run(t_main, feed=feed, fetch_list=fetch, scope=t_scope)
        for name, g, ww in zip(fetch, got, w):
            np.testing.assert_allclose(
                g, ww, rtol=TOL, atol=TOL * float(np.abs(ww).max()),
                err_msg="step %d %s" % (step, name))


def test_expert_weights_carry_the_ep_annotation_and_a_mesh_is_refused():
    main = tfluid.Program()
    with tfluid.unique_name.guard(), \
            tfluid.program_guard(main, tfluid.Program()):
        x = tfluid.layers.data(name="x", shape=[-1, -1, 8], dtype="float32",
                               append_batch_size=False)
        tfluid.layers.switch_moe(x, 4, 16, mesh={"ep": 1, "dp": 8})
        # expert parallelism, once refused here, is ported (ranks:
        # tests/test_torch_expert_parallel.py); a mesh whose ep axis does
        # not split the experts is refused while building
        tfluid.layers.switch_moe(x, 4, 16, mesh={"ep": 4, "dp": 2})
        with pytest.raises(tfluid.EnforceError, match="ep=8"):
            tfluid.layers.switch_moe(x, 4, 16, mesh={"ep": 8})
    specs = {tuple(p.shape): getattr(p, "sharding_spec", None)
             for p in main.all_parameters()}
    assert specs == {(8, 4): None, (4, 8, 16): ("ep", None, None),
                     (4, 16): ("ep", None), (4, 16, 8): ("ep", None, None),
                     (4, 8): ("ep", None)}
