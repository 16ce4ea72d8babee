"""paddle_tpu_torch.parallel.pipeline and the pipelined encoder against
paddle_tpu's.

On a world of four gloo ranks on the CPU (``tests/_torch_ranks.py``),
from the JAX package's start states and numpy-seeded inputs:

* ``gpipe`` on pp=4 (a layer a stage) and pp=2 x dp=2 (two layers a
  stage), forward and gradient, against the JAX package's ``gpipe`` on a
  mesh of the same shape (forward at 1e-6, gradients at 1e-4 of atol,
  tests/test_pipeline.py's bars);
* the pipelined Transformer (``pp_encoder=True``) on pp=2 x dp=2, four
  SGD steps at rtol 2e-5 against the JAX package's run on the same mesh
  and the port's one-process run (tests/test_pipeline.py:614), its
  stage weights held as each rank's block;
* pp=2 x mp=2 with ``tp=True``, and with dropout 0.2: the masks keyed
  as the JAX package's manual shard_map keys them (the mp fold at the
  FFN hidden site) give the JAX run's losses at rtol 2e-5, as do
  dp=2 x mp=2's (no pp: each rank's block of the whole masks);
  indivisible heads refused;
* pp=2 x dp=2 with dropout: deterministic, finite (the port microbatches
  each dp block, the JAX package splits each global microbatch over dp,
  so the masks fall on other rows: ROADMAP Queue C 2).

In one process: the stage's keyed dropout masks bit-equal to
``jax.random.bernoulli`` under the JAX package's fold chain; the
inference program's (1 - p) scaling; the ring refusal and the ring
composition; pallas against fused through the port's plain flash;
``local_batch_slice`` over the data axes only.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique_name

import _torch_ranks as R

torch.set_num_threads(1)

PP_RTOL = 2e-5  # tests/test_pipeline.py:653


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


def _jax_pp(build_kw, state, axes, steps, n_dev):
    from paddle_tpu.models.transformer import transformer_base as jtb

    import jax.numpy as jnp

    with j_unique_name.guard():
        main, startup, loss = R.build_pp_tb(jfluid, jtb, **build_kw)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        with np.load(state) as z:
            for n in z.files:
                scope.set_var(n, jnp.asarray(z[n]))
        if axes is None:
            run = lambda: exe.run(main, feed=R.pp_feed(),  # noqa: E731
                                  fetch_list=[loss.name])[0]
        else:
            pe = jfluid.ParallelExecutor(
                main_program=main, loss_name=loss.name,
                mesh=jfluid.parallel.make_mesh(axes,
                                               devices=_devices(n_dev)))
            run = lambda: pe.run(fetch_list=[loss.name],  # noqa: E731
                                 feed=R.pp_feed())[0]
        return [float(np.asarray(run())) for _ in range(steps)]


def _port_one(build_kw, state, steps):
    from paddle_tpu_torch.models.transformer import transformer_base

    main, startup, loss = R.build_pp_tb(tfluid, transformer_base,
                                        **build_kw)
    exe, scope = R._start(tfluid, main, startup, state)
    return R._losses(exe, main, loss, [R.pp_feed()] * steps, scope)


STATES = {"pp_tb.npz": {}, "pp_tb_tp.npz": {"tp": True},
          "pp_tb_drop.npz": {"tp": True, "dropout_rate": 0.2},
          "pp_tb_drop1.npz": {"dropout_rate": 0.3}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from paddle_tpu.models.transformer import transformer_base as jtb

    out = tmp_path_factory.mktemp("pipeline_ranks")
    for name, kw in STATES.items():
        with j_unique_name.guard():
            main, startup, _ = R.build_pp_tb(jfluid, jtb, **kw)
        _save_state(str(out / name), main, startup)
    res = R.launch(4, ["gpipe", "pp"], str(out), timeout=300)
    return out, res


def _jax_gpipe(axes, n_dev):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.parallel.pipeline import gpipe, microbatch, unmicrobatch

    W, b, x, mask = [jnp.asarray(a) for a in R.gpipe_inputs()]
    mesh = jfluid.parallel.make_mesh(axes, devices=_devices(n_dev))

    def stage(p, xb, mb):
        w, bb = p

        def one(c, pl):
            wl, bl = pl
            return jnp.tanh(c @ wl + bl) * mb[..., None] + c, None

        y, _ = jax.lax.scan(one, xb, (w, bb))
        return y

    xmb, mmb = microbatch(x, 4), microbatch(mask, 4)

    def loss(W, b):
        y = unmicrobatch(gpipe(stage, (W, b), xmb, mesh, side_mb=(mmb,)))
        return jnp.sum(y ** 2), y

    (_, y), g = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(W, b)
    return np.asarray(y), [np.asarray(t) for t in g]


@pytest.mark.parametrize("name,axes", [("pp4", {"pp": 4}),
                                       ("pp2dp2", {"pp": 2, "dp": 2})])
def test_gpipe_matches_the_jax_packages_forward_and_grad(ranks, name,
                                                         axes):
    """tests/test_pipeline.py:568,614: the schedule against the JAX
    package's ``gpipe`` on the same mesh; pp=2 stages hold two of the
    four layers each."""
    _out, res = ranks
    y, (gW, gb) = _jax_gpipe(axes, 4)
    for rank in res["gpipe"]:
        got = rank[name]
        np.testing.assert_allclose(got["y"], y, atol=1e-6)
        np.testing.assert_allclose(got["gW"], gW, atol=1e-4)
        np.testing.assert_allclose(got["gb"], gb, atol=1e-4)


def test_gpipe_sequential_fallback_is_the_same_math():
    """Off a pp mesh (or outside a world of ranks) ``gpipe`` is one
    sequential fold over the whole stack."""
    from paddle_tpu_torch.parallel.pipeline import (gpipe, microbatch,
                                                    unmicrobatch)

    W, b, x, mask = [torch.tensor(a) for a in R.gpipe_inputs()]

    def stage(p, xb, mb):
        w, bb = p
        for i in range(w.shape[0]):
            xb = torch.tanh(xb @ w[i] + bb[i]) * mb[..., None] + xb
        return xb

    mesh = tfluid.parallel.make_mesh({"pp": 4}, devices=range(4))
    y = unmicrobatch(gpipe(stage, (W, b), microbatch(x, 4), mesh,
                           side_mb=(microbatch(mask, 4),)))
    ref = x
    for s in range(4):
        ref = torch.tanh(ref @ W[s] + b[s]) * mask[..., None] + ref
    torch.testing.assert_close(y, ref, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        microbatch(x, 3)


def test_pp_transformer_matches_the_jax_mesh_run_and_one_device(ranks):
    """tests/test_pipeline.py:614 (pp=2 x dp=2, rtol 2e-5): each rank
    holds its stage's layer of every stacked weight."""
    out, res = ranks
    state = str(out / "pp_tb.npz")
    want = _jax_pp({}, state, {"pp": 2, "dp": 2}, 4, 4)
    one = _port_one({}, state, 4)
    jone = _jax_pp({}, state, None, 4, 1)
    np.testing.assert_allclose(one, jone, rtol=PP_RTOL)
    for rank in res["pp"]:
        np.testing.assert_allclose(rank["pp_dp"], want, rtol=PP_RTOL)
        np.testing.assert_allclose(rank["pp_dp"], one, rtol=PP_RTOL)
        assert rank["pp_dp"][-1] < rank["pp_dp"][0]
        for name, (whole, held) in rank["held"].items():
            assert held == [whole[0] // 2] + whole[1:], name
        assert len(rank["held"]) == 12


def test_pp_tp_matches_the_jax_mesh_run(ranks):
    """tests/test_pipeline_tp.py:72,83 (pp=2 x mp=2, no dp axis): each
    stage computes its local heads and sums over mp."""
    out, res = ranks
    state = str(out / "pp_tb_tp.npz")
    want = _jax_pp({"tp": True}, state, {"pp": 2, "mp": 2}, 4, 4)
    one = _port_one({"tp": True}, state, 4)
    for rank in res["pp"]:
        np.testing.assert_allclose(rank["pp_tp"], want, rtol=PP_RTOL)
        np.testing.assert_allclose(rank["pp_tp"], one, rtol=PP_RTOL)


def test_pp_tp_indivisible_heads_rejected(ranks):
    """tests/test_pipeline_tp.py:92: two heads over mp=4."""
    for rank in ranks[1]["pp"]:
        assert rank["indivisible"] and "divisible" in rank["indivisible"]


def test_pp_tp_dropout_masks_are_the_jax_packages(ranks):
    """tests/test_pipeline_tp.py:117: pp x mp with dropout. The port
    draws each site's mask under the JAX package's fold chain (the mp
    index folded in at the FFN hidden site, each rank drawing its local
    block), so the losses follow the JAX mesh run at the dropout-free
    bar; a mask off by one element moves them far past it."""
    out, res = ranks
    kw = {"tp": True, "dropout_rate": 0.2}
    want = _jax_pp(kw, str(out / "pp_tb_drop.npz"), {"pp": 2, "mp": 2},
                   3, 4)
    for rank in res["pp"]:
        np.testing.assert_allclose(rank["pp_tp_drop"], want, rtol=PP_RTOL)
        assert np.isfinite(rank["pp_tp_drop"]).all()


def test_tp_dropout_without_pp_draws_the_whole_masks_blocks(ranks):
    """dp=2 x mp=2 with no pp axis: the encoder runs as the sequential
    fold on each rank's batch rows and mp columns, each dropout site
    drawing its block of the whole tensor's mask (the JAX package's
    fold has no manual axis to key on); the losses follow the JAX
    package's run on the same mesh at the dropout-free bar."""
    out, res = ranks
    kw = {"tp": True, "dropout_rate": 0.2}
    want = _jax_pp(kw, str(out / "pp_tb_drop.npz"), {"dp": 2, "mp": 2},
                   3, 4)
    for rank in res["pp"]:
        np.testing.assert_allclose(rank["dp_mp_drop"], want, rtol=PP_RTOL)


def test_pp_dropout_trains_and_is_deterministic(ranks):
    """tests/test_pipeline_tp.py:100: pp=2 x dp=2 with dropout; two runs
    from one state replay alike, the masks move the loss each step."""
    for rank in ranks[1]["pp"]:
        a, b = rank["pp_dp_drop"]
        assert a == b and np.isfinite(a).all()
        assert len({round(x, 9) for x in a}) == 3


def test_stage_dropout_masks_bit_equal_to_jax():
    """The stage's keys, ``fold_in(fold_in(fold_in(PRNGKey(seed),
    seed_m), layer), site)`` then the dp and mp folds, through the
    port's ``core.prng`` and the dropout op's keyed plain version: the
    mask is ``jax.random.bernoulli``'s, bit for bit."""
    import jax

    from paddle_tpu_torch.core import prng
    from paddle_tpu_torch.ops.dropout import dropout_keyed

    shape = (4, 8, 32)
    x = torch.ones(shape)
    for seed_m, li, site, dp, mp in ((0, 0, 0, None, None),
                                     (3, 1, 2, 1, 1), (5, 3, 3, 0, None)):
        jk = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(17), np.uint32(seed_m)), li), site)
        tk = prng.fold_in(prng.fold_in(prng.fold_in(
            prng.prng_key(torch.tensor(17)), torch.tensor(seed_m)),
            torch.tensor(li)), torch.tensor(site))
        for f in (dp, mp):
            if f is not None:
                jk = jax.random.fold_in(jk, f)
                tk = prng.fold_in(tk, torch.tensor(f))
        want = np.asarray(jax.random.bernoulli(jk, 1.0 - 0.3, shape))
        got = dropout_keyed(x, tk, 0.3)
        np.testing.assert_array_equal(got.numpy() != 0, want)


def _eval_loss(fluid, guard, tb, dropout):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 21
    with guard(), fluid.program_guard(main, startup):
        _, avg_cost, _ = tb(
            src_vocab_size=64, trg_vocab_size=64, max_length=16,
            n_layer=2, n_head=2, d_model=16, d_inner_hid=32,
            dropout_rate=dropout, is_test=True, pp_encoder=True)
    return main, startup, avg_cost


def test_pp_dropout_infer_scaling():
    """tests/test_pipeline_tp.py:131: the eval program scales each site
    by (1 - p), as the JAX package's, from the same parameters."""
    from paddle_tpu.models.transformer import transformer_base as jtb
    from paddle_tpu_torch.models.transformer import transformer_base as ttb

    import jax.numpy as jnp

    for p in (0.0, 0.5):
        jm, js, jc = _eval_loss(jfluid, j_unique_name.guard, jtb, p)
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            exe = jfluid.Executor(jfluid.CPUPlace())
            exe.run(js)
            state = {n: np.asarray(scope.find_var(n))
                     for n in scope.local_var_names()
                     if scope.find_var(n) is not None}
            want = float(np.asarray(exe.run(jm, feed=R.pp_feed(),
                                            fetch_list=[jc.name])[0]))
        tm, ts, tc = _eval_loss(tfluid, tfluid.unique_name.guard, ttb, p)
        texe = tfluid.Executor(tfluid.CPUPlace())
        tscope = tfluid.Scope()
        texe.run(ts, scope=tscope)
        tfluid.state_from_numpy(state, tscope, tfluid.CPUPlace(),
                                program=tm)
        got = [float(texe.run(tm, feed=R.pp_feed(), fetch_list=[tc],
                              scope=tscope)[0]) for _ in range(2)]
        assert got[0] == got[1]
        np.testing.assert_allclose(got[0], want, rtol=1e-5)
        if p == 0.0:
            base = got[0]
    assert abs(got[0] - base) > 1e-6


def test_pp_ring_composition():
    """tests/test_pipeline_tp.py:156: ``pipelined_encoder`` refuses the
    ring; the whole model routes it to the decoder and builds the
    pipelined encoder with the dense attention."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.models.transformer import (pipelined_encoder,
                                                     transformer_base)

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[-1, 8, 16], dtype="float32",
                        append_batch_size=False)
        m = layers.data(name="m", shape=[-1, 8], dtype="float32",
                        append_batch_size=False)
        with pytest.raises(tfluid.EnforceError, match="ring"):
            pipelined_encoder(x, m, n_layer=2, n_head=2, d_key=8,
                              d_value=8, d_model=16, d_inner_hid=32,
                              attn_impl="ring")
    main, _s, loss = R.build_pp_tb(tfluid, transformer_base,
                                   attn_impl="ring")
    types = [op.type for op in main.global_block().ops]
    assert "pipelined_encoder" in types


def test_pp_pallas_matches_fused():
    """tests/test_pipeline_tp.py:177: ``attn_impl="pallas"`` through the
    pipelined encoder (the port's plain flash on the CPU) against the
    fused attention, from the same parameters."""
    from paddle_tpu_torch.models.transformer import transformer_base

    got = {}
    state = None
    for impl in ("fused", "pallas"):
        main, startup, loss = R.build_pp_tb(tfluid, transformer_base,
                                            attn_impl=impl)
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        if state is None:
            state = {n: tfluid.fetch_var(n, scope)
                     for n in scope.local_var_names()}
        else:
            tfluid.state_from_numpy(state, scope, tfluid.CPUPlace(),
                                    program=main)
        got[impl] = R._losses(exe, main, loss, [R.pp_feed()] * 2, scope)
    np.testing.assert_allclose(got["pallas"], got["fused"], rtol=1e-4)


def test_local_batch_slice_cuts_over_the_data_axes_only():
    """A rank's slice of a global batch: its block over the data axes,
    the same for the ranks of a pp (or sp, ep, tp) axis that share a
    data index; without data axes, its block over the processes."""
    lbs = tfluid.parallel.local_batch_slice
    pp_dp = tfluid.parallel.make_mesh({"pp": 2, "dp": 2}, devices=range(4))
    assert [lbs(8, pp_dp, r) for r in range(4)] == [
        slice(0, 4), slice(4, 8), slice(0, 4), slice(4, 8)]
    dp = tfluid.parallel.make_mesh({"dp": 4}, devices=range(4))
    assert [lbs(8, dp, r) for r in range(4)] == [
        slice(2 * r, 2 * r + 2) for r in range(4)]
    assert lbs(8, None) == slice(0, 8)
    with pytest.raises(ValueError, match="not divisible"):
        lbs(7, dp, 0)
