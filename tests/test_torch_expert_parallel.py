"""Expert parallelism (``ep``) in paddle_tpu_torch against paddle_tpu.

On a world of four gloo ranks on the CPU (``tests/_torch_ranks.py``),
from the JAX package's start states:

* ``switch_moe`` at ep=2 x dp=2 (tests/test_moe.py:87), at capacity
  factors 1.25 and 0.5: each rank holds two of the four experts; three
  Adam steps' losses at rtol 1e-4 (the JAX test's bar) against the JAX
  package's run on the same mesh and against one device; then a fourth
  step's output and aux loss — the capacity drops (output rows exactly
  zero) equal, token for token, and the aux loss at rtol 1e-5;
* ``embedding(is_distributed=True)`` at dp=2 x ep=2
  (tests/test_distributed_embedding.py:41): each rank holds 16 of the 32
  rows, four SGD steps at rtol 1e-4 against the dense one-device run;
* ``transformer_base(distributed_embedding=True)`` at dp=2 x ep=2
  (tests/test_distributed_embedding.py:73, without its mp axis): three
  Adam steps at rtol 1e-4 against the JAX package's dense one-device
  run.

In one process: the layer's build-time mesh check.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique_name

import _torch_ranks as R

torch.set_num_threads(1)

RTOL = 1e-4  # tests/test_moe.py:129, tests/test_distributed_embedding.py:70


def _devices(n):
    import jax

    if len(jax.devices()) < n:
        pytest.skip("needs %d virtual devices" % n)
    return jax.devices()[:n]


def _save_state(path, main, startup):
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    np.savez(path, **{v.name: np.asarray(scope.find_var(v.name))
                      for v in main.list_vars()
                      if v.persistable and scope.find_var(v.name)
                      is not None})


def _jax_scope(startup, state):
    import jax.numpy as jnp

    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        with np.load(state) as z:
            for n in z.files:
                scope.set_var(n, jnp.asarray(z[n]))
    return scope


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from paddle_tpu.models.transformer import transformer_base as jtb

    out = tmp_path_factory.mktemp("ep_ranks")
    builds = {"moe.npz": lambda: R.build_moe(jfluid)[:3],
              "dist_emb.npz": lambda: R.build_dist_emb(jfluid, True),
              "tb_emb.npz": lambda: R.build_tb(jfluid, jtb,
                                               distributed_embedding=True)}
    for name, build in builds.items():
        with j_unique_name.guard():
            main, startup, _ = build()
        _save_state(str(out / name), main, startup)
    return out, R.launch(4, ["ep"], str(out), timeout=300)["ep"]


@pytest.mark.parametrize("cap", [1.25, 0.5])
def test_switch_moe_ep2_dp2_matches_the_jax_mesh_run(ranks, cap):
    """At capacity factor 1.25 no token is dropped; at 0.5 an expert
    takes 4 of the 32 tokens, and which are dropped depends on the queue
    order over the whole batch (the two dp blocks' tokens in turn)."""
    out, res = ranks
    state = str(out / "moe.npz")
    xv = R.moe_feed()
    with j_unique_name.guard():
        main, startup, loss, o, aux = R.build_moe(jfluid, cap=cap)
    scope = _jax_scope(startup, state)
    with jfluid.scope_guard(scope):
        pe = jfluid.ParallelExecutor(
            loss_name=loss.name, main_program=main,
            mesh=jfluid.parallel.make_mesh({"ep": 2, "dp": 2},
                                           devices=_devices(4)))
        want = [float(np.asarray(pe.run(feed={"x": xv},
                                         fetch_list=[loss.name])[0]))
                for _ in range(3)]
        wo, wa = pe.run(feed={"x": xv}, fetch_list=[o.name, aux.name])
    wo = np.asarray(wo)
    main, startup, loss, _o, _a = R.build_moe(tfluid, cap=cap)
    exe, tscope = R._start(tfluid, main, startup, state)
    one = R._losses(exe, main, loss, [{"x": xv}] * 3, tscope)
    dropped = np.abs(wo).sum(-1) == 0
    if cap < 1:
        assert 0 < dropped.sum() < dropped.size
    else:
        assert dropped.sum() == 0
    for rank in res:
        got = rank["moe_%s" % cap]
        np.testing.assert_allclose(got["losses"], want, rtol=RTOL)
        np.testing.assert_allclose(got["losses"], one, rtol=RTOL)
        o_ = np.asarray(got["out"])
        np.testing.assert_array_equal(np.abs(o_).sum(-1) == 0, dropped)
        np.testing.assert_allclose(o_, wo, rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(got["aux"], float(np.asarray(wa)),
                                   rtol=1e-5)
        experts = [v for v in got["held"].values() if v[0][0] == 4]
        assert len(experts) == 4  # w1, b1, w2, b2 of the 4 experts
        for whole, mine in experts:
            assert mine == [2] + whole[1:]


def test_distributed_embedding_matches_dense(ranks):
    out, res = ranks
    state = str(out / "dist_emb.npz")
    with j_unique_name.guard():
        main, startup, loss = R.build_dist_emb(jfluid, False)
    scope = _jax_scope(startup, state)
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        want = [float(np.asarray(exe.run(main, feed=R.dist_emb_feed(),
                                          fetch_list=[loss.name])[0]))
                for _ in range(4)]
    for rank in res:
        np.testing.assert_allclose(rank["emb"], want, rtol=RTOL)
        assert rank["emb_held"] == [16, 8]


def test_transformer_distributed_embedding_matches_dense(ranks):
    from paddle_tpu.models.transformer import transformer_base as jtb

    out, res = ranks
    state = str(out / "tb_emb.npz")
    with j_unique_name.guard():
        main, startup, loss = R.build_tb(jfluid, jtb)
    scope = _jax_scope(startup, state)
    feed = R.tb_feeds(1)[0]
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        want = [float(np.asarray(exe.run(main, feed=feed,
                                          fetch_list=[loss.name])[0]))
                for _ in range(3)]
    for rank in res:
        np.testing.assert_allclose(rank["tb"], want, rtol=RTOL)


def test_switch_moe_mesh_check():
    """The mesh the program is built for must split the experts; an
    ``ep`` axis that does not is refused while building."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[-1, -1, 8],
                               dtype="float32", append_batch_size=False)
        tfluid.layers.switch_moe(x, 4, 16, mesh={"ep": 2, "dp": 2})
        with pytest.raises(tfluid.EnforceError, match="ep=3"):
            tfluid.layers.switch_moe(x, 4, 16, mesh={"ep": 3})
