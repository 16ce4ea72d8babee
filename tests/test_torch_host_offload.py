"""paddle_tpu_torch's ``host_offload`` pass and the executor's staging
(passes/schedule.py, executor.py) against the JAX package
(tests/test_schedule.py:366,392,452).

The pass marks the same names as the JAX package's on the same programs,
with the same schedule stamp. Offloaded state round-trips with no cast,
so the losses and the final state with the pass are BIT-identical to
those without it (``.tolist()`` equality, as the JAX tests hold). On
the CPU the staging is a host copy and a clone; the card's leg (pinned
host memory between steps, the allocated bytes' drop) is
tests/test_torch_static_card.py, which imports no JAX.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu import passes as jpasses
from paddle_tpu.core import unique_name as j_unique_name
from paddle_tpu_torch import analysis, passes
from paddle_tpu_torch.compile_cache.runtime import _program_stamps

torch.set_num_threads(1)

CPU = fluid.CPUPlace()
STEPS = 8

OPTIMIZERS = {
    "sgd": (lambda pkg: pkg.optimizer.SGD(learning_rate=0.1), False),
    "adam": (lambda pkg: pkg.optimizer.Adam(learning_rate=1e-2), True),
    "adagrad": (lambda pkg: pkg.optimizer.Adagrad(learning_rate=0.1), True),
}


def _mlp_train(pkg, un, opt, fuse=False, offload=False, hidden=32):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = 5
    with un.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[-1, 16], dtype="float32",
                            append_batch_size=False)
        y = pkg.layers.data(name="y", shape=[-1, 1], dtype="float32",
                            append_batch_size=False)
        h = pkg.layers.fc(x, size=hidden, act="relu")
        pred = pkg.layers.fc(h, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        flags = pkg.core.flags
        flags.set_flags({"fuse_optimizer_state": fuse})
        try:
            OPTIMIZERS[opt][0](pkg).minimize(loss)
        finally:
            flags.set_flags({"fuse_optimizer_state": False})
    if offload:
        mod = jpasses if pkg is jfluid else passes
        mod.apply_passes([mod.HostOffloadPass()], main)
    return main, startup, loss.name


def _feeds(n=STEPS):
    rng = np.random.RandomState(11)
    out = []
    for _ in range(n):
        xb = rng.rand(8, 16).astype("float32")
        out.append({"x": xb, "y": xb.sum(1, keepdims=True)})
    return out


def _train(main, startup, loss, feeds=None, between=None):
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    losses = []
    for i, feed in enumerate(feeds or _feeds()):
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        losses.append(float(out))
        if between is not None:
            between(i, scope, exe)
    state = {n: fluid.fetch_var(n, scope) for n in sorted(
        v.name for v in main.list_vars() if v.persistable)}
    exe.close()
    return losses, state


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_marks_the_jax_packages_names(opt):
    jm, _, _ = _mlp_train(jfluid, j_unique_name, opt, offload=True)
    tm, _, _ = _mlp_train(fluid, fluid.unique_name, opt, offload=True)
    assert getattr(tm, "_host_offload_state", None) == \
        getattr(jm, "_host_offload_state", None)
    assert getattr(tm, "_schedule_stamp", None) == \
        getattr(jm, "_schedule_stamp", None)
    if OPTIMIZERS[opt][1]:
        assert tm._host_offload_state
        assert "host_offload=" in tm._schedule_stamp
    else:
        # SGD carries no accumulators: a no-op, no stamp
        assert getattr(tm, "_host_offload_state", None) is None
        assert getattr(tm, "_schedule_stamp", None) is None


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_losses_and_state_bit_identical(opt):
    base = _train(*_mlp_train(fluid, fluid.unique_name, opt))
    off = _train(*_mlp_train(fluid, fluid.unique_name, opt, offload=True))
    assert off[0] == base[0]
    for n, v in base[1].items():
        assert np.array_equal(off[1][n], v), n


def test_liveness_drops_the_offloaded_bytes():
    bm, _, _ = _mlp_train(fluid, fluid.unique_name, "adam")
    om, _, _ = _mlp_train(fluid, fluid.unique_name, "adam", offload=True)
    rep_b = analysis.analyze_liveness(bm, assume_batch=8)
    rep_o = analysis.analyze_liveness(om, assume_batch=8)
    moments = sum(int(np.prod(om.global_block().var(n).shape)) * 4
                  for n in om._host_offload_state)
    assert rep_o.persistable_device_bytes == \
        rep_b.persistable_device_bytes - moments


def test_fused_flat_state_offloads_the_storage_not_the_views():
    jm, _, _ = _mlp_train(jfluid, j_unique_name, "adam", fuse=True,
                          offload=True)
    om, os_, ol = _mlp_train(fluid, fluid.unique_name, "adam", fuse=True,
                             offload=True)
    assert om._host_offload_state == jm._host_offload_state
    offloaded = set(om._host_offload_state)
    views = set(om._flat_state_views)
    assert any(n.startswith("fused_") for n in offloaded)
    assert views and not (offloaded & views)
    base = _train(*_mlp_train(fluid, fluid.unique_name, "adam", fuse=True))
    off = _train(om, os_, ol)
    assert off[0] == base[0]
    for n, v in base[1].items():
        assert np.array_equal(off[1][n], v), n


def test_the_scope_holds_the_host_copies_between_steps():
    main, startup, loss = _mlp_train(fluid, fluid.unique_name, "adam",
                                     offload=True)
    seen = []

    def between(i, scope, exe):
        entry = exe._offload_stage[(id(main), main._host_offload_state)]
        seen.append(all(scope.find_var(n) is entry["src"][n]
                        for n in main._host_offload_state))

    _train(main, startup, loss, between=between)
    assert seen == [True] * STEPS


def test_a_write_between_steps_makes_the_stage_stale():
    """A set_var between steps (a checkpoint restore) wins over the
    staged copy: the next step reads the written value, as a twin
    without offload does."""
    def poke(i, scope, exe):
        if i == 3:
            name = sorted(n for n in scope.local_var_names()
                          if "moment1" in n)[0]
            scope.set_var(name, torch.from_numpy(
                fluid.fetch_var(name, scope) * 0.5))

    base = _train(*_mlp_train(fluid, fluid.unique_name, "adam"),
                  between=poke)
    off = _train(*_mlp_train(fluid, fluid.unique_name, "adam",
                             offload=True), between=poke)
    assert off[0] == base[0]
    assert all(np.array_equal(off[1][n], v) for n, v in base[1].items())


def test_run_steps_equals_the_steps_run_one_by_one():
    feeds = _feeds(4)
    main, startup, loss = _mlp_train(fluid, fluid.unique_name, "adam",
                                     offload=True)
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    got, = exe.run_steps(main, feed_list=feeds, fetch_list=[loss],
                         scope=scope)
    want = _train(*_mlp_train(fluid, fluid.unique_name, "adam"),
                  feeds=feeds)[0]
    assert np.asarray(got).ravel().tolist() == want


def test_schedule_stamp_keys_the_fingerprint_both_ways():
    """Never running the pass leaves no schedule key (twins agree); the
    pass adds the stamp, as the JAX package's ``_schedule_config``."""
    a, _, _ = _mlp_train(fluid, fluid.unique_name, "adam")
    assert "schedule" not in _program_stamps(a)
    passes.apply_passes([passes.HostOffloadPass()], a)
    assert _program_stamps(a)["schedule"] == a._schedule_stamp
    jm, _, _ = _mlp_train(jfluid, j_unique_name, "adam", offload=True)
    assert a._schedule_stamp == jm._schedule_stamp


def test_the_pass_applies_once():
    main, _, _ = _mlp_train(fluid, fluid.unique_name, "adam", offload=True)
    stamp, v = main._schedule_stamp, main._version
    passes.HostOffloadPass().apply(main)
    assert (main._schedule_stamp, main._version) == (stamp, v)
    assert passes.HostOffloadPass(include_moments=False).fingerprint() == \
        jpasses.HostOffloadPass(include_moments=False).fingerprint()
