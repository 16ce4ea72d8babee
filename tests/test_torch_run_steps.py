"""paddle_tpu_torch's Executor.run_steps, held to N calls of its own
``run`` and to the JAX package's ``run_steps``.

* On the CPU, ``run_steps`` is bit-equal to N ``run`` calls: losses
  stacked on a leading ``steps`` axis and every parameter after them,
  for ``feed_list``, stacked, step-invariant and mixed feeds, with the
  JAX package's error paths (tests/test_run_steps.py, with Adam or SGD
  for its Momentum, which the port does not have yet).
* Against the JAX package's ``run_steps``: bench.py's recipe at the
  tiny Transformer-base of tests/_torch_port.py (``sparse_embedding``,
  ``fuse_optimizer_state``, the bf16 flags, Adam), from the same
  weights: the 3 stacked losses within rel 1e-2 and every parameter
  within 3e-2 of its max — the tolerance tests/test_torch_recipe.py
  states for the same program (bf16 rounds at other places in the two
  frameworks).
* The static-shape ``_merge_rows`` (no host sync, so a CUDA graph can
  capture it) against the JAX package's: the same unique rows (fill
  rows ``vocab`` last), the same sums, and the fill rows' writes dropped
  by ``_set_rows``; ids with duplicates, with the padding id, and all
  distinct.

Tests marked ``cuda`` need a card and skip here: the captured graph's
steps equal eager ``run`` steps (bit for bit on a dense f32 MLP; within
a tolerance with sparse tables, whose duplicate rows add with atomics
in a varying order), one capture per key, exactly N steps a call
(counted by the beta powers), a scope tensor replaced between calls
copied in before the replay, the launch counts of the replays, and a
first call (warm-up and capture) that makes no host sync under
``torch.cuda.set_sync_debug_mode("error")``. JAX is imported inside the
tests that use it, so the card tests run on a machine without JAX:

    python -m pytest tests/test_torch_run_steps.py -m cuda --noconftest -q
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.optimizer import Optimizer, _set_rows

torch.set_num_threads(1)


def _build_mlp(opt=None, seed=11):
    """x[-1, 8] -> fc 16 relu -> fc 1, squared error; ``opt`` makes the
    optimizer (default Adam)."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data(name="x", shape=[-1, 8], dtype="float32",
                   append_batch_size=False)
        y = L.data(name="y", shape=[-1, 1], dtype="float32",
                   append_batch_size=False)
        pred = L.fc(L.fc(x, size=16, act="relu"), size=1)
        d = L.elementwise_add(pred, L.scale(y, scale=-1.0))
        loss = L.scale(L.reduce_sum(L.elementwise_mul(d, d)), scale=0.25)
        (opt or (lambda: fluid.optimizer.Adam(learning_rate=0.05)))() \
            .minimize(loss)
    return main, startup, loss


def _feeds(n, batch=4, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rng.rand(batch, 8).astype("float32")
        out.append({"x": x, "y": (x.sum(1, keepdims=True)
                                  + 0.1 * rng.randn(batch, 1)).astype(
                                      "float32")})
    return out


def _params(main, scope):
    return {p.name: fluid.fetch_var(p.name, scope)
            for p in main.all_parameters()}


def _fresh(main, startup, place=None, p0=None):
    """(executor, scope) after the startup program; ``p0`` loads
    parameters over the initialization."""
    place = place or fluid.CPUPlace()
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    if p0 is not None:
        fluid.params_from_numpy(p0, scope, place, program=main)
    return exe, scope


def test_feed_list_matches_sequential_runs():
    feeds = _feeds(5)
    main, startup, loss = _build_mlp()
    exe, seq_scope = _fresh(main, startup)
    seq = [exe.run(main, feed=f, fetch_list=[loss], scope=seq_scope)[0]
           for f in feeds]
    exe, scan_scope = _fresh(main, startup)
    stacked, = exe.run_steps(main, feed_list=feeds, fetch_list=[loss.name],
                             scope=scan_scope)
    assert stacked.shape == (5,) + np.shape(seq[0])
    np.testing.assert_array_equal(stacked, np.stack(seq))
    want = _params(main, seq_scope)
    for n, v in _params(main, scan_scope).items():
        np.testing.assert_array_equal(v, want[n], err_msg=n)
    assert exe.num_compiled == 0  # nothing is captured on the CPU


def test_fetched_state_is_each_steps_value():
    """A fetched state tensor that an op updates in place (a flat
    group's buffer) comes back stacked with each step's value, as the
    card's graph writes it into its fetch buffer step by step."""
    feeds = _feeds(3)
    fluid.set_flags({"fuse_optimizer_state": True})
    try:
        main, startup, loss = _build_mlp()
    finally:
        fluid.set_flags({"fuse_optimizer_state": False})
    flat = "fused_param_storage_0"
    exe, seq_scope = _fresh(main, startup)
    seq = [exe.run(main, feed=f, fetch_list=[flat], scope=seq_scope)[0]
           for f in feeds]
    exe, scan_scope = _fresh(main, startup)
    stacked, = exe.run_steps(main, feed_list=feeds, fetch_list=[flat],
                             scope=scan_scope)
    np.testing.assert_array_equal(stacked, np.stack(seq))
    assert not np.array_equal(stacked[0], stacked[-1])


def test_stacked_feed_and_invariant_feed():
    feeds = _feeds(3, seed=7)
    main, startup, loss = _build_mlp()

    # dict-of-stacked-arrays form == feed_list form
    stacked_feed = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
    exe, s1 = _fresh(main, startup)
    a, = exe.run_steps(main, feed=stacked_feed, steps=3,
                       fetch_list=[loss], scope=s1)
    exe, s2 = _fresh(main, startup)
    b, = exe.run_steps(main, feed_list=feeds, fetch_list=[loss], scope=s2)
    np.testing.assert_array_equal(a, b)

    # step-invariant feed: the same batch every step
    exe, s3 = _fresh(main, startup)
    c, = exe.run_steps(main, feed=feeds[0], steps=3, fetch_list=[loss],
                       scope=s3)
    exe, s4 = _fresh(main, startup)
    d = [exe.run(main, feed=feeds[0], fetch_list=[loss], scope=s4)[0]
         for _ in range(3)]
    np.testing.assert_array_equal(c, np.stack(d))
    for n, v in _params(main, s4).items():
        np.testing.assert_array_equal(_params(main, s3)[n], v, err_msg=n)


def test_mixed_invariant_and_stacked_feed():
    """Per-name classification: stacked batches and a step-invariant
    feed in one call; a typo'd fetch target gets the accurate error."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data(name="x", shape=[-1, 4], dtype="float32",
                   append_batch_size=False)
        s = L.data(name="s", shape=[-1, 4], dtype="float32",
                   append_batch_size=False)
        loss = L.reduce_sum(L.fc(L.elementwise_mul(x, s), size=1))
        fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
    xs = np.random.RandomState(0).rand(3, 2, 4).astype("float32")
    sv = np.full((2, 4), 0.5, dtype="float32")
    exe, scope = _fresh(main, startup)
    out, = exe.run_steps(main, feed={"x": xs, "s": sv}, steps=3,
                         fetch_list=[loss], scope=scope)
    exe, ref = _fresh(main, startup)
    want = [exe.run(main, feed={"x": xs[i], "s": sv}, fetch_list=[loss],
                    scope=ref)[0] for i in range(3)]
    assert out.shape[0] == 3
    np.testing.assert_array_equal(out, np.stack(want))
    with pytest.raises(EnforceError, match="Fetch target"):
        exe.run_steps(main, feed={"x": xs, "s": sv}, steps=3,
                      fetch_list=["nope"], scope=scope)
    with pytest.raises(EnforceError, match="looks stacked"):
        exe.run_steps(main, feed={"x": xs, "s": sv}, steps=2,
                      fetch_list=[loss], scope=scope)


def test_run_steps_error_paths():
    main, startup, loss = _build_mlp()
    exe, scope = _fresh(main, startup)
    feeds = _feeds(2)
    with pytest.raises(EnforceError, match="steps is required"):
        exe.run_steps(main, feed=feeds[0], fetch_list=[loss], scope=scope)
    with pytest.raises(EnforceError, match="disagrees"):
        exe.run_steps(main, feed_list=feeds, steps=5, fetch_list=[loss],
                      scope=scope)
    with pytest.raises(EnforceError, match="same variables"):
        exe.run_steps(main, feed_list=[feeds[0], {"x": feeds[1]["x"]}],
                      fetch_list=[loss], scope=scope)
    with pytest.raises(EnforceError, match="program readers"):
        main._readers = (object(),)
        try:
            exe.run_steps(main, feed_list=feeds, fetch_list=[loss],
                          scope=scope)
        finally:
            del main._readers
    # state must exist (startup not run)
    with pytest.raises(EnforceError, match="neither fed nor present"):
        fluid.Executor(fluid.CPUPlace()).run_steps(
            main, feed_list=feeds, fetch_list=[loss], scope=fluid.Scope())


@pytest.mark.parametrize("unroll", [False, True, None])
def test_unroll_and_the_scan_unroll_flag(unroll):
    """``unroll`` (and the ``scan_unroll`` flag behind ``None``) picks
    the graph's form on a card; on the CPU every form is the loop of
    ``run`` — bit-equal to the sequential runs."""
    feeds = _feeds(4)
    main, startup, loss = _build_mlp()
    exe, ref = _fresh(main, startup)
    want = [exe.run(main, feed=f, fetch_list=[loss], scope=ref)[0]
            for f in feeds]
    fluid.set_flags({"scan_unroll": True})
    try:
        exe, scope = _fresh(main, startup)
        got, = exe.run_steps(main, feed_list=feeds, fetch_list=[loss],
                             scope=scope, unroll=unroll)
    finally:
        fluid.set_flags({"scan_unroll": False})
    np.testing.assert_array_equal(got, np.stack(want))


def test_return_numpy_false_and_async():
    feeds = _feeds(3)
    main, startup, loss = _build_mlp()
    exe, s1 = _fresh(main, startup)
    want, = exe.run_steps(main, feed_list=feeds, fetch_list=[loss],
                          scope=s1)
    exe, s2 = _fresh(main, startup)
    t, = exe.run_steps(main, feed_list=feeds, fetch_list=[loss], scope=s2,
                       return_numpy=False)
    assert isinstance(t, torch.Tensor) and t.shape[0] == 3
    np.testing.assert_array_equal(t.numpy(), want)
    exe, s3 = _fresh(main, startup)
    h, = exe.run_steps(main, feed_list=feeds, fetch_list=[loss], scope=s3,
                       return_numpy="async")
    assert isinstance(h, fluid.FetchHandle) and h.name == loss.name
    assert h.block_until_ready().is_ready()
    np.testing.assert_array_equal(np.asarray(h), want)


# ------------------------------------------------- the static merge


def _merge_cases():
    rng = np.random.RandomState(3)
    return {
        "duplicates": rng.randint(0, 12, size=20),
        "padding_id": np.array([0, 5, 0, 3, 5, 5, 0, 11, 3]),
        "distinct": rng.permutation(30)[:17],
    }


@pytest.mark.parametrize("case", sorted(_merge_cases()))
def test_static_merge_rows_matches_jax(case):
    import jax.numpy as jnp

    import paddle_tpu as jfluid

    vocab = 30
    rows = _merge_cases()[case]
    vals = np.random.RandomState(5).randn(rows.size, 4).astype(np.float32)
    ju, js = jfluid.optimizer.Optimizer._merge_rows(
        jnp.asarray(rows.astype(np.int32)), jnp.asarray(vals), vocab)
    tu, ts = Optimizer._merge_rows(torch.from_numpy(rows.astype(np.int32)),
                                   torch.from_numpy(vals), vocab)
    assert tu.shape == (rows.size,) and ts.shape == vals.shape
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-6)
    uniq = np.unique(rows)
    assert (tu.numpy()[:uniq.size] == uniq).all()
    assert (tu.numpy()[uniq.size:] == vocab).all()
    assert not ts.numpy()[uniq.size:].any()
    # the writes: fill rows dropped, every unique row written
    table = torch.from_numpy(np.arange(vocab * 4, dtype=np.float32)
                             .reshape(vocab, 4))
    want = table.numpy().copy()
    want[uniq] = ts.numpy()[:uniq.size]
    got = _set_rows(table, tu, ts, vocab)
    assert got is table
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", sorted(_merge_cases()))
def test_static_merge_rows_is_bit_equal_to_the_unique_merge(case):
    """The static merge against the data-dependent one it replaced
    (``torch.unique`` + ``index_add_``): the same unique rows and the
    same sums, bit for bit, on the CPU; then fill rows only."""
    rows = torch.from_numpy(_merge_cases()[case])
    vals = torch.from_numpy(np.random.RandomState(6).randn(
        rows.numel(), 5).astype(np.float32))
    u_old, inv = torch.unique(rows, sorted=True, return_inverse=True)
    s_old = torch.zeros((u_old.numel(), 5)).index_add_(0, inv, vals)
    u, s = Optimizer._merge_rows(rows, vals, 30)
    k = u_old.numel()
    assert torch.equal(u[:k], u_old) and (u[k:] == 30).all()
    assert torch.equal(s[:k], s_old) and not s[k:].any()


# ------------------------------------------- against the JAX package

RECIPE_FLAGS = {"use_bfloat16": True, "bf16_activations": True,
                "bf16_moments": True, "fuse_optimizer_state": True}


def test_run_steps_matches_jax_run_steps_on_the_recipe():
    import jax.numpy as jnp

    import paddle_tpu as jfluid
    from _torch_port import STEPS, _build, _feed, _flags

    feeds = [_feed(seed) for seed in range(STEPS)]
    with warnings.catch_warnings(), _flags("jax", RECIPE_FLAGS):
        warnings.filterwarnings("ignore")
        j_main, j_startup, j_cost, _ = _build("jax", "pallas",
                                              sparse_embedding=True)
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            exe = jfluid.Executor(jfluid.CPUPlace())
            exe.run(j_startup)
            rng = np.random.RandomState(11)
            p0 = {p.name: (np.asarray(jfluid.executor.fetch_var(
                p.name, scope)).astype(np.float32) + rng.normal(
                    0.0, 0.08, p.shape)).astype(np.float32)
                for p in j_main.all_parameters()}
            for name, a in p0.items():
                scope.set_var(name, jnp.asarray(a))
            j_loss, = exe.run_steps(j_main, feed_list=feeds,
                                    fetch_list=[j_cost.name])
            j_params = {n: np.asarray(jfluid.executor.fetch_var(n, scope))
                        .astype(np.float32) for n in p0}
    with _flags("torch", RECIPE_FLAGS):
        t_main, t_startup, t_cost, _ = _build("torch", "pallas",
                                              sparse_embedding=True)
    exe, scope = _fresh(t_main, t_startup, p0=p0)
    t_loss, = exe.run_steps(t_main, feed_list=feeds, fetch_list=[t_cost],
                            scope=scope)
    assert t_loss.shape == np.shape(j_loss) and t_loss.shape[0] == STEPS
    np.testing.assert_allclose(t_loss, np.asarray(j_loss), rtol=1e-2)
    for name, want in j_params.items():
        got = fluid.fetch_var(name, scope)
        assert got.shape == want.shape and np.isfinite(got).all(), name
        err = np.abs(got - want).max()
        assert err <= 3e-2 * np.abs(want).max(), (name, err)


# ------------------------------------------------------- on the card

# a recipe Transformer small enough for a test, with the head dim the
# flash kernels take (64)
CARD_TB = dict(src_vocab_size=64, trg_vocab_size=64, max_length=16,
               n_layer=1, n_head=2, d_model=128, d_inner_hid=256,
               dropout_rate=0.0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run_steps captures a CUDA graph "
                    "there, and the graph has no CPU mode")
    return fluid.CUDAPlace(0)


def _card_recipe():
    from paddle_tpu_torch.models.transformer import transformer_base

    saved = {n: fluid.get_flag(n) for n in RECIPE_FLAGS}
    fluid.set_flags(RECIPE_FLAGS)
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            _, cost, _ = transformer_base(**CARD_TB, sparse_embedding=True,
                                          attn_impl="pallas")
            fluid.optimizer.Adam(learning_rate=1e-3).minimize(cost)
    finally:
        fluid.set_flags(saved)
    return main, startup, cost


def _card_feeds(n, B=4, T=16, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = lambda: rng.randint(1, 64, (B, T)).astype(np.int64)  # noqa
        mask = lambda: (np.arange(T)[None] < rng.randint(  # noqa: E731
            T // 2, T + 1, (B, 1))).astype(np.float32)
        out.append({"src_word": ids(), "trg_word": ids(), "lbl_word": ids(),
                    "src_mask": mask(), "trg_mask": mask()})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("unroll", [False, True])
def test_cuda_graph_is_bit_equal_to_eager_runs(unroll):
    """A dense f32 MLP with Adam: the captured steps against eager runs
    from the same weights, bit for bit, over two calls; one capture."""
    place = _card()
    feeds = _feeds(5)
    main, startup, loss = _build_mlp()
    exe, ref = _fresh(main, startup, place)
    p0 = _params(main, ref)
    want = [exe.run(main, feed=f, fetch_list=[loss], scope=ref)[0]
            for f in feeds + feeds]
    exe, scope = _fresh(main, startup, place, p0)
    got = [exe.run_steps(main, feed_list=feeds, fetch_list=[loss],
                         scope=scope, unroll=unroll)[0] for _ in range(2)]
    assert exe.num_compiled == 1
    np.testing.assert_array_equal(np.concatenate(got), np.stack(want))
    for n, v in _params(main, ref).items():
        np.testing.assert_array_equal(fluid.fetch_var(n, scope), v,
                                      err_msg=n)


def _beta_pows(main, scope):
    names = sorted(v.name for v in main.list_vars()
                   if "beta1_pow_acc" in v.name or "beta2_pow_acc" in v.name)
    assert names
    return {n: fluid.fetch_var(n, scope) for n in names}


@pytest.mark.cuda
@pytest.mark.parametrize("unroll", [False, True])
def test_cuda_recipe_takes_exactly_n_steps_and_counts_replays(unroll):
    """The recipe (flash kernels, the fused update, lazy sparse Adam)
    in a graph: after each call the beta powers equal those of the same
    number of eager steps (the state advanced exactly ``steps``), losses
    agree with eager steps within rel 1e-4 (the tables' duplicate rows
    add with atomics), one capture, and the launch counts rise by what
    the replayed steps launched."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops.fused_optimizer import fused_flat_update

    place = _card()
    feeds = _card_feeds(4)
    main, startup, cost = _card_recipe()
    exe, ref = _fresh(main, startup, place)
    p0 = _params(main, ref)
    want = [exe.run(main, feed=f, fetch_list=[cost], scope=ref)[0]
            for f in feeds]
    ref_pows = _beta_pows(main, ref)
    exe, scope = _fresh(main, startup, place, p0)
    launchers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                 fused_flat_update)
    for fn in launchers:
        fn.launches = 0
    got, = exe.run_steps(main, feed_list=feeds, fetch_list=[cost],
                         scope=scope, unroll=unroll)
    torch.cuda.synchronize()
    groups = sum(op.type.endswith("_fused") for op in main.global_block().ops)
    per_step = {"flash_fwd": 3, "flash_bwd_dq": 3, "flash_bwd_dkv": 3,
                "fused_flat_update": groups}
    # unroll=True's warm-up step ran on copies of the state: real launches
    extra = 1 if unroll else 0
    assert {fn.__name__: fn.launches for fn in launchers} == {
        k: v * (len(feeds) + extra) for k, v in per_step.items()}
    for n, v in _beta_pows(main, scope).items():
        np.testing.assert_array_equal(v, ref_pows[n], err_msg=n)
    np.testing.assert_allclose(got.ravel(), np.ravel(want), rtol=1e-4)
    for fn in launchers:
        fn.launches = 0
    exe.run_steps(main, feed_list=feeds, fetch_list=[cost], scope=scope,
                  unroll=unroll)
    assert exe.num_compiled == 1
    assert {fn.__name__: fn.launches for fn in launchers} == {
        k: v * len(feeds) for k, v in per_step.items()}
    for f in feeds:
        exe.run(main, feed=f, fetch_list=[cost], scope=ref)
    for n, v in _beta_pows(main, ref).items():
        np.testing.assert_array_equal(fluid.fetch_var(n, scope), v,
                                      err_msg=n)


@pytest.mark.cuda
def test_cuda_replaced_scope_tensor_is_copied_in():
    """Between two calls, a parameter set through ``scope.set_var`` (a
    new tensor) and one loaded by ``params_from_numpy``: the second
    call's losses are those of eager steps from the new values."""
    place = _card()
    feeds = _feeds(3)
    main, startup, loss = _build_mlp()
    exe, scope = _fresh(main, startup, place)
    exe.run_steps(main, feed_list=feeds, fetch_list=[loss], scope=scope)
    names = sorted(_params(main, scope))
    rng = np.random.RandomState(9)
    new = {n: rng.randn(*fluid.fetch_var(n, scope).shape).astype(np.float32)
           for n in names}
    scope.set_var(names[0], torch.from_numpy(new[names[0]]).to("cuda"))
    fluid.params_from_numpy(new, scope, place, program=main)
    # the same state in a second scope, by value
    ref = fluid.Scope()
    for n in scope.local_var_names():
        v = scope.find_var(n)
        ref.set_var(n, v.clone() if isinstance(v, torch.Tensor) else v)
    ref_exe = fluid.Executor(place)
    want = [ref_exe.run(main, feed=f, fetch_list=[loss], scope=ref)[0]
            for f in feeds]
    got, = exe.run_steps(main, feed_list=feeds, fetch_list=[loss],
                         scope=scope)
    assert exe.num_compiled == 1
    np.testing.assert_array_equal(got, np.stack(want))


@pytest.mark.cuda
def test_cuda_two_scopes_keep_their_own_state():
    """One executor, one program, two scopes from different weights:
    a graph each, and each scope's steps are its eager steps."""
    place = _card()
    feeds = _feeds(3)
    main, startup, loss = _build_mlp()
    exe = fluid.Executor(place)
    scopes, wants = [], []
    for seed in (1, 2):
        rng = np.random.RandomState(seed)
        p0 = {p.name: rng.randn(*p.shape).astype(np.float32)
              for p in main.all_parameters()}
        ref_exe, ref = _fresh(main, startup, place, p0)
        wants.append([ref_exe.run(main, feed=f, fetch_list=[loss],
                                  scope=ref)[0] for f in feeds + feeds])
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        fluid.params_from_numpy(p0, scope, place, program=main)
        scopes.append(scope)
    got = [[], []]
    for _ in range(2):  # interleaved calls
        for k, scope in enumerate(scopes):
            got[k].append(exe.run_steps(main, feed_list=feeds,
                                        fetch_list=[loss], scope=scope)[0])
    assert exe.num_compiled == 2
    for k in range(2):
        np.testing.assert_array_equal(np.concatenate(got[k]),
                                      np.stack(wants[k]))


@pytest.mark.cuda
def test_cuda_capture_makes_no_host_sync():
    """The first call (eager warm-up step, capture, replays) of the
    recipe under ``set_sync_debug_mode("error")``: feeds and state
    already on the card, fetches returned as tensors."""
    place = _card()
    main, startup, cost = _card_recipe()
    exe, scope = _fresh(main, startup, place)
    feeds = [{n: torch.from_numpy(v).to("cuda") for n, v in f.items()}
             for f in _card_feeds(3)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, = exe.run_steps(main, feed_list=feeds, fetch_list=[cost],
                             scope=scope, return_numpy=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert exe.num_compiled == 1
    assert torch.isfinite(got).all() and got.shape[0] == 3
