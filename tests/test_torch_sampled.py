"""paddle_tpu_torch.layers.sampled held to paddle_tpu.layers.sampled:
``hsigmoid``, ``nce`` (uniform and log-uniform samplers) and
``sampled_softmax_with_cross_entropy`` — the cost and every gradient
over three training runs (the dropout counter advancing, so each run
draws new negatives), the negatives themselves bit-equal to the JAX
package's draws, and the tests of tests/test_parity_ops.py that use
these layers.

Costs and gradients within 1e-5 of the array's largest magnitude.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import prng

from _torch_port import package, symbol_table

torch.set_num_threads(1)

TOL = 1e-5
# each layer of the module -> the tests here that hold it to the JAX
# package ("test[case]": one case of the file's parametrised table)
PARITY = {
    "hsigmoid": ("test_layer_trains_like_the_jax_package[hsigmoid]",
                 "test_layer_trains_like_the_jax_package"
                 "[hsigmoid_power_of_two]"),
    "nce": ("test_layer_trains_like_the_jax_package[nce_uniform]",
            "test_layer_trains_like_the_jax_package[nce_log_uniform]",
            "test_nce_negatives_are_the_jax_draws"),
    "sampled_softmax_with_cross_entropy": (
        "test_layer_trains_like_the_jax_package[sampled_softmax]",),
}
B, D = 6, 5


def _program(pkg, layer, C, lr):
    fluid, guard = package(pkg)
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[-1, D], dtype="float32",
                              append_batch_size=False)
        y = fluid.layers.data(name="y", shape=[-1, 1], dtype="int64",
                              append_batch_size=False)
        h = fluid.layers.fc(x, size=D, act="tanh")
        cost = layer(fluid.layers, h, y, C)
        loss = fluid.layers.mean(cost)
        fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    return main, startup, cost, loss


def train_both(layer, C, runs=3, lr=0.3, seed=0):
    """The cost, loss and every @GRAD of each of ``runs`` SGD steps in
    both packages, the port from the JAX package's start state."""
    r = np.random.RandomState(seed)
    feed = {"x": r.randn(B, D).astype(np.float32),
            "y": r.randint(0, C, (B, 1)).astype(np.int64)}
    out = {}
    for pkg in ("jax", "torch"):
        main, startup, cost, loss = _program(pkg, layer, C, lr)
        fetch = [cost.name, loss.name] + [p.name + "@GRAD"
                                          for p in main.all_parameters()]
        if pkg == "jax":
            j_main = main
            scope = jfluid.Scope()
            with jfluid.scope_guard(scope):
                exe = jfluid.Executor(jfluid.CPUPlace())
                exe.run(startup)
                state = {v.name: np.asarray(scope.find_var(v.name))
                         for v in main.list_vars() if v.persistable}
                out[pkg] = [[np.asarray(a) for a in exe.run(
                    main, feed=feed, fetch_list=fetch)] for _ in range(runs)]
        else:
            assert symbol_table(main) == symbol_table(j_main)
            place, scope = tfluid.CPUPlace(), tfluid.Scope()
            tfluid.state_from_numpy(state, scope, place, program=main)
            exe = tfluid.Executor(place)
            out[pkg] = [exe.run(main, feed=feed, fetch_list=fetch,
                                scope=scope) for _ in range(runs)]
    for step, (got, want) in enumerate(zip(out["torch"], out["jax"])):
        for name, g, w in zip(fetch, got, want):
            assert g.shape == w.shape, (step, name)
            np.testing.assert_allclose(
                g, w, rtol=TOL, atol=TOL * float(np.abs(w).max()),
                err_msg="step %d %s" % (step, name))
    return out["torch"]


LAYERS = {
    "hsigmoid": (lambda L, h, y, C: L.hsigmoid(h, y, num_classes=C), 11),
    "hsigmoid_power_of_two": (
        lambda L, h, y, C: L.hsigmoid(h, y, num_classes=C), 16),
    "nce_uniform": (lambda L, h, y, C: L.nce(
        h, y, num_total_classes=C, num_neg_samples=4, seed=3), 40),
    "nce_log_uniform": (lambda L, h, y, C: L.nce(
        h, y, num_total_classes=C, num_neg_samples=7, seed=5,
        sampler="log_uniform"), 300),
    "sampled_softmax": (lambda L, h, y, C:
                        L.sampled_softmax_with_cross_entropy(
                            h, y, num_total_classes=C, num_samples=9,
                            seed=2), 50),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layer_trains_like_the_jax_package(case):
    layer, C = LAYERS[case]
    steps = train_both(layer, C)
    if case.startswith(("nce", "sampled")):
        # fresh negatives each run: the gradients move with the draws
        assert not np.array_equal(steps[0][0], steps[1][0])


@pytest.mark.parametrize("sampler", ["uniform", "log_uniform"])
def test_nce_negatives_are_the_jax_draws(sampler):
    """The port's draws under ``fold_in(PRNGKey(seed), counter)`` equal
    ``jax.random``'s, element for element, at several counters."""
    C, k, seed = 1000, 12, 7
    for c in (0, 1, 5, 123):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), np.uint32(c))
        tkey = prng.fold_in(prng.prng_key(torch.tensor(seed)),
                            torch.tensor(c))
        if sampler == "uniform":
            want = np.asarray(jax.random.randint(key, (B, k), 0, C))
            got = prng.randint(tkey, B * k, 0, C).reshape(B, k).numpy()
        else:
            import jax.numpy as jnp

            u = jax.random.uniform(key, (B, k))
            want = np.asarray(jnp.clip((jnp.exp(u * jnp.log(C + 1.0))
                                        - 1.0).astype(jnp.int32), 0, C - 1))
            tu = prng.uniform(tkey, B * k).reshape(B, k)
            log_span = float(np.log(np.float32(C + 1.0)))
            got = torch.clamp((torch.exp(tu * log_span) - 1.0).to(
                torch.int32), 0, C - 1).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("span", [7, 50, 2 ** 16 + 3, 10 ** 6, 2 ** 30])
def test_randint_is_jax_randint(span):
    for seed, c in ((0, 0), (3, 9), (42, 77)):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), np.uint32(c))
        tkey = prng.fold_in(prng.prng_key(torch.tensor(seed)),
                            torch.tensor(c))
        want = np.asarray(jax.random.randint(key, (37,), -3, span - 3))
        got = prng.randint(tkey, 37, -3, span - 3).numpy()
        np.testing.assert_array_equal(got, want)


def _run_port(build, feed, fetch_n=1):
    main, startup = tfluid.Program(), tfluid.Program()
    scope = tfluid.Scope()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        outs = build(tfluid.layers)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    return exe.run(main, feed=feed, fetch_list=list(outs[:fetch_n]),
                   scope=scope)


def test_hsigmoid_probabilities_sum_to_one():
    """tests/test_parity_ops.py's case in the port."""
    C = 7
    x = np.random.RandomState(1).randn(4, 6).astype("float32")
    costs = []
    for c in range(C):
        cost, = _run_port(lambda L: [L.hsigmoid(
            L.data(name="x", shape=[-1, 6], dtype="float32",
                   append_batch_size=False),
            L.data(name="y", shape=[-1, 1], dtype="int64",
                   append_batch_size=False), num_classes=C)],
            {"x": x, "y": np.full((4, 1), c, "int64")})
        costs.append(cost[:, 0])
    probs = np.exp(-np.stack(costs, 1))
    np.testing.assert_allclose(probs.sum(1), np.ones(4), rtol=1e-5)


def test_nce_runs_and_trains():
    """tests/test_parity_ops.py's case in the port."""
    Bn, Dn, C = 8, 4, 50
    r = np.random.RandomState(2)
    x = r.randn(Bn, Dn).astype("float32")
    y = r.randint(0, C, (Bn, 1)).astype("int64")
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        L = tfluid.layers
        xv = L.data(name="x", shape=[-1, Dn], dtype="float32",
                    append_batch_size=False)
        yv = L.data(name="y", shape=[-1, 1], dtype="int64",
                    append_batch_size=False)
        cost = L.mean(L.nce(xv, yv, num_total_classes=C,
                            num_neg_samples=5, seed=3))
        tfluid.optimizer.SGD(learning_rate=0.5).minimize(cost)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed={"x": x, "y": y}, fetch_list=[cost],
                            scope=scope)[0]) for _ in range(20)]
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0]
