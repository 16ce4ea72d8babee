"""bench.py's full training recipe in paddle_tpu_torch, held to paddle_tpu.

The recipe — ``transformer_base(sparse_embedding=True)`` with the flags
``use_bfloat16``, ``bf16_activations``, ``bf16_moments`` and
``fuse_optimizer_state`` and ``Adam`` — at the tiny ``TB`` size of
tests/test_torch_training.py (vocab 50, 2 layers, d_model 32; B=3 with
ragged masks), in both packages:

* the symbol tables, op sequences and flat-state view maps (flat buffer
  names, offsets, sizes, shapes, dtypes) of the main and startup
  programs are equal;
* losses and parameters after 3 steps agree within the bf16 tolerance:
  rel 1e-2 on the loss, 3e-2 of each parameter's max magnitude. Every
  weight starts from the JAX package's initialization plus seeded
  noise, so no parameter starts at zero and its max is its scale, not
  its last update (Adam moves every element by about lr per step, and
  bf16 rounding may flip the sign of a near-zero gradient).

In the port, the flat-group route is bit-equal to the per-parameter
route (SGD, Adagrad with bf16 moments, Adam, and the recipe), every
dense gradient included. Row-sparse tables (``@GRAD@ROWS`` /
``@GRAD@VALUES``) with lazy SGD, Adagrad and Adam match the JAX package
at f32, rtol 1e-5 (duplicate ids, ``padding_idx``, two lookups of one
table). The flat-state views of the scope, a fused state saved by the
JAX package, and the bf16 rules of the layers at op level are checked
too.
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique_name
from paddle_tpu_torch.core.enforce import EnforceError

from _torch_port import (GRAD_TOL, LR, STEPS, UPDATE_TOL, _build, _feed,
                         _flags, symbol_table)

torch.set_num_threads(1)

RECIPE_FLAGS = {"use_bfloat16": True, "bf16_activations": True,
                "bf16_moments": True, "fuse_optimizer_state": True}


def _jax_fetch(name, scope):
    return np.asarray(jfluid.executor.fetch_var(name, scope)).astype(
        np.float32)


class _Recipe:
    """The recipe at TB in both packages from the same weights (the JAX
    package's initialization plus N(0, 0.08) noise from a seed), 3
    steps each on one batch."""

    def __init__(self):
        import jax.numpy as jnp

        feed = _feed()
        with warnings.catch_warnings(), _flags("jax", RECIPE_FLAGS):
            warnings.filterwarnings("ignore")
            self.j = _build("jax", "pallas", sparse_embedding=True)
            j_main, j_startup, j_cost, _ = self.j
            scope = jfluid.Scope()
            with jfluid.scope_guard(scope):
                exe = jfluid.Executor(jfluid.CPUPlace())
                exe.run(j_startup)
                rng = np.random.RandomState(11)
                self.p0 = {p.name: (_jax_fetch(p.name, scope) + rng.normal(
                    0.0, 0.08, p.shape)).astype(np.float32)
                    for p in j_main.all_parameters()}
                for name, a in self.p0.items():
                    scope.set_var(name, jnp.asarray(a))
                self.j_loss = [float(exe.run(j_main, feed=feed,
                                             fetch_list=[j_cost.name])[0])
                               for _ in range(STEPS)]
                self.j_params = {n: _jax_fetch(n, scope) for n in self.p0}
        with _flags("torch", RECIPE_FLAGS):
            self.t = _build("torch", "pallas", sparse_embedding=True)
        t_main, t_startup, t_cost, _ = self.t
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(t_startup, scope=scope)
        tfluid.params_from_numpy(self.p0, scope, tfluid.CPUPlace(),
                                 program=t_main)
        self.t_loss = [float(exe.run(t_main, feed=feed, fetch_list=[t_cost],
                                     scope=scope)[0]) for _ in range(STEPS)]
        self.t_params = {n: tfluid.fetch_var(n, scope) for n in self.p0}


@pytest.fixture(scope="module")
def recipe():
    return _Recipe()


def test_recipe_builds_the_jax_programs(recipe):
    """Symbol tables (flat buffers, moment views, bf16 moments), op
    sequences and the flat-state view maps (names, offsets, sizes,
    shapes, dtypes) of the main and startup programs."""
    for j_prog, t_prog in ((recipe.j[0], recipe.t[0]),
                           (recipe.j[1], recipe.t[1])):
        assert symbol_table(t_prog) == symbol_table(j_prog)
        assert [op.type for op in t_prog.global_block().ops] == \
            [op.type for op in j_prog.global_block().ops]
        assert t_prog._flat_state_views == j_prog._flat_state_views
    ops = [op.type for op in recipe.t[0].global_block().ops]
    assert ops[0] == "unpack_flat_params" and ops[-1] == "unpack_flat_params"
    assert ops.count("adam_fused") == 1 and ops.count("adam_sparse") == 2
    table = {v[0]: v[2:] for v in symbol_table(recipe.t[0])}
    assert table["fused_param_storage_0"] == ("float32", True)
    assert table["fused_moment2_storage_0"] == ("bfloat16", True)
    assert [(p.name, g.name) for p, g in recipe.t[3]] == \
        [(p.name, g.name) for p, g in recipe.j[3]]
    assert {g.name for _, g in recipe.t[3]} >= {
        "src_word_emb_table@GRAD@VALUES", "trg_word_emb_table@GRAD@VALUES"}


def test_recipe_losses_and_params_after_three_steps_match_jax(recipe):
    np.testing.assert_allclose(recipe.t_loss, recipe.j_loss, rtol=1e-2)
    assert recipe.t_loss[-1] < recipe.t_loss[0]
    for name, want in recipe.j_params.items():
        got = recipe.t_params[name]
        assert got.shape == want.shape and np.isfinite(got).all(), name
        err = np.abs(got - want).max()
        assert err <= 3e-2 * np.abs(want).max(), (name, err)


def _train_port(opt, flag_values, fuse, p0=None, feed=None):
    """Build with ``flag_values`` (+ ``fuse_optimizer_state=fuse``),
    sparse embeddings, and run STEPS steps fetching the loss and every
    gradient; (main, params_grads, p0, outputs, params after)."""
    with _flags("torch", {**flag_values, "fuse_optimizer_state": fuse}):
        main, startup, cost, pg = _build("torch", "pallas", opt=opt,
                                         sparse_embedding=True)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    if p0 is None:
        p0 = {p.name: tfluid.fetch_var(p.name, scope)
              for p in main.all_parameters()}
    else:
        tfluid.params_from_numpy(p0, scope, tfluid.CPUPlace(), program=main)
    fetch = [cost.name] + [g.name for _, g in pg]
    outs = [exe.run(main, feed=feed or _feed(), fetch_list=fetch,
                    scope=scope) for _ in range(STEPS)]
    return main, pg, p0, outs, {n: tfluid.fetch_var(n, scope) for n in p0}


FUSE_CASES = {
    "sgd": (lambda f: f.optimizer.SGD(learning_rate=0.05), {}),
    "adagrad": (lambda f: f.optimizer.Adagrad(learning_rate=0.05),
                {"bf16_moments": True}),
    "adam": (lambda f: f.optimizer.Adam(learning_rate=LR), {}),
    "adam_recipe": (lambda f: f.optimizer.Adam(learning_rate=LR),
                    {k: v for k, v in RECIPE_FLAGS.items()
                     if k != "fuse_optimizer_state"}),
}


@pytest.mark.parametrize("case", sorted(FUSE_CASES))
def test_fused_route_is_bit_equal_to_per_param_route(case):
    """The flat groups (one ``<op>_fused`` op, the kernel's plain
    version here) against one update op per parameter, from the same
    weights: the loss, every dense ``@GRAD`` and sparse
    ``@GRAD@VALUES`` of every step, and every parameter after 3 steps,
    bit for bit. A dense gradient that came back zero (a leaf the
    forward did not read) would show here."""
    opt, flag_values = FUSE_CASES[case]
    _, pg, p0, per_out, per_params = _train_port(opt, flag_values, False)
    main, f_pg, _, f_out, f_params = _train_port(opt, flag_values, True,
                                                 p0=p0)
    kind = {"sgd": "sgd", "adagrad": "adagrad"}.get(case, "adam")
    ops = [op.type for op in main.global_block().ops]
    assert ops.count(kind + "_fused") == 1
    assert ops.count(kind + "_sparse") == 2
    names = [g.name for _, g in pg]
    assert names == [g.name for _, g in f_pg]
    for step, (a, b) in enumerate(zip(per_out, f_out)):
        for name, x, y in zip(["loss"] + names, a, b):
            np.testing.assert_array_equal(y, x, err_msg=f"{name} {step}")
    for name, x in zip(names, f_out[0][1:]):
        if name.endswith("@GRAD"):
            assert np.abs(x).max() > 0, name
    for name, x in per_params.items():
        np.testing.assert_array_equal(f_params[name], x, err_msg=name)


def test_fused_route_grads_match_jax():
    """The fused route's step-0 loss and gradients (f32) against the
    JAX package's fused route, from the same weights."""
    flags_on = {"fuse_optimizer_state": True}
    with warnings.catch_warnings(), _flags("jax", flags_on):
        warnings.filterwarnings("ignore")
        j_main, j_startup, j_cost, j_pg = _build("jax", "pallas",
                                                 sparse_embedding=True)
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            exe = jfluid.Executor(jfluid.CPUPlace())
            exe.run(j_startup)
            p0 = {p.name: _jax_fetch(p.name, scope)
                  for p in j_main.all_parameters()}
            want = exe.run(j_main, feed=_feed(),
                           fetch_list=[j_cost.name] + [g.name for _, g in j_pg])
    _, pg, _, outs, _ = _train_port(None, {}, True, p0=p0)
    assert [g.name for _, g in pg] == [g.name for _, g in j_pg]
    for name, got, w in zip(["loss"] + [g.name for _, g in pg], outs[0],
                            want):
        np.testing.assert_allclose(got, np.asarray(w), err_msg=name,
                                   **GRAD_TOL)


# ---------------------------------------------------- sparse tables, lazy rows

SPARSE_OPTS = {
    "sgd": lambda f: f.optimizer.SGD(learning_rate=0.05),
    "adagrad": lambda f: f.optimizer.Adagrad(learning_rate=0.05),
    "adam": lambda f: f.optimizer.Adam(learning_rate=0.01),
}


def _sparse_program(fluid, guard, opt, clip=None):
    """Two lookups of one sparse table (``padding_idx`` 0) feeding two fc
    heads; ``opt`` makes the optimizer, ``clip`` (if given) the gradient
    clip set on every parameter."""
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        a = L.data("a", [4, 5], dtype="int64", append_batch_size=False)
        b = L.data("b", [4, 1], dtype="int64", append_batch_size=False)
        ea = L.embedding(a, [20, 6], is_sparse=True, padding_idx=0,
                         param_attr=fluid.ParamAttr(name="emb"))
        eb = L.embedding(b, [20, 6], is_sparse=True, padding_idx=0,
                         param_attr=fluid.ParamAttr(name="emb"))
        h = L.fc(ea, 3, num_flatten_dims=2, act="relu")
        h2 = L.fc(eb, 3)
        loss = L.elementwise_add(L.reduce_sum(L.elementwise_mul(h, h)),
                                 L.reduce_sum(L.elementwise_mul(h2, h2)))
        if clip is not None:
            fluid.clip.set_gradient_clip(clip(fluid))
        _, pg = opt(fluid).minimize(loss)
    return main, startup, loss, pg


def _sparse_feed(step):
    rng = np.random.RandomState(20 + step)
    # ids from a small range: duplicates within and across the lookups,
    # and the padding id 0
    return {"a": rng.randint(0, 6, (4, 5)).astype(np.int64),
            "b": rng.randint(0, 6, (4, 1)).astype(np.int64)}


@pytest.mark.parametrize("kind", sorted(SPARSE_OPTS))
def test_sparse_table_rows_and_lazy_updates_match_jax(kind):
    """``@GRAD@ROWS`` / ``@GRAD@VALUES``, the loss and the dense grads of
    3 steps (new ids each step), and the table and weights after them,
    against the JAX package at f32. Rows no step touched keep their
    initial values in both."""
    opt = SPARSE_OPTS[kind]
    j_main, j_startup, j_loss, j_pg = _sparse_program(
        jfluid, j_unique_name.guard, opt)
    fetch = [j_loss.name] + [g.name for _, g in j_pg] + ["emb@GRAD@ROWS"]
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(j_startup)
        p0 = {p.name: _jax_fetch(p.name, scope)
              for p in j_main.all_parameters()}
        want = [exe.run(j_main, feed=_sparse_feed(s), fetch_list=fetch)
                for s in range(STEPS)]
        j_after = {n: _jax_fetch(n, scope) for n in p0}
    t_main, t_startup, t_loss, t_pg = _sparse_program(
        tfluid, tfluid.unique_name.guard, opt)
    assert symbol_table(t_main) == symbol_table(j_main)
    assert [op.type for op in t_main.global_block().ops] == \
        [op.type for op in j_main.global_block().ops]
    assert kind + "_sparse" in [op.type for op in t_main.global_block().ops]
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(t_startup, scope=scope)
    tfluid.params_from_numpy(p0, scope, tfluid.CPUPlace(), program=t_main)
    got = [exe.run(t_main, feed=_sparse_feed(s), fetch_list=fetch,
                   scope=scope) for s in range(STEPS)]
    for step in range(STEPS):
        feed = _sparse_feed(step)
        rows = got[step][-1]
        assert rows.dtype == np.int32
        np.testing.assert_array_equal(
            rows, np.concatenate([feed["a"].ravel(), feed["b"].ravel()]))
        vals = got[step][fetch.index("emb@GRAD@VALUES")]
        assert vals.shape == (24, 6) and not vals[rows == 0].any()
        for name, g, w in zip(fetch, got[step], want[step]):
            np.testing.assert_allclose(g, np.asarray(w), err_msg=name,
                                       **GRAD_TOL)
    touched = np.unique(np.concatenate(
        [np.concatenate([_sparse_feed(s)["a"].ravel(),
                         _sparse_feed(s)["b"].ravel()])
         for s in range(STEPS)]))
    t_after = {n: tfluid.fetch_var(n, scope) for n in p0}
    untouched = np.setdiff1d(np.arange(20), touched)
    np.testing.assert_array_equal(t_after["emb"][untouched],
                                  p0["emb"][untouched])
    lr = {"sgd": 0.05, "adagrad": 0.05, "adam": 0.01}[kind]
    for name in p0:
        np.testing.assert_allclose((t_after[name] - p0[name]) / lr,
                                   (j_after[name] - p0[name]) / lr, rtol=0,
                                   atol=UPDATE_TOL, err_msg=name)


def test_sparse_gradient_without_a_sparse_update_is_densified():
    """An optimizer that defines only a dense update gets the sparse
    table's gradient scattered into a dense one (with a warning), as in
    the JAX package; regularization and clipping pass a sparse gradient
    through, warning."""

    def plain_sgd(f):
        class PlainSGD(f.optimizer.Optimizer):
            _OP_TYPE = "plain_sgd"

            def _make_update_fn(self, scale, owns):
                return lambda pv, gv, lr: pv - (lr * scale) * gv

        return PlainSGD(learning_rate=0.05,
                        regularization=f.regularizer.L2Decay(0.01))

    results = []
    for fluid, guard in ((jfluid, j_unique_name.guard),
                         (tfluid, tfluid.unique_name.guard)):
        with pytest.warns(UserWarning) as caught:
            main, startup, loss, pg = _sparse_program(
                fluid, guard, plain_sgd,
                clip=lambda f: f.clip.GradientClipByGlobalNorm(clip_norm=1.0))
        text = " ".join(str(w.message) for w in caught)
        assert "densifying" in text and "regularization skipped" in text
        assert "gradient clip skipped" in text
        results.append((main, startup, loss))
    (j_main, j_startup, j_loss), (t_main, t_startup, t_loss) = results
    assert symbol_table(t_main) == symbol_table(j_main)
    assert "sparse_to_dense" in [op.type for op in t_main.global_block().ops]
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(j_startup)
        p0 = {p.name: _jax_fetch(p.name, scope)
              for p in j_main.all_parameters()}
        for s in range(STEPS):
            exe.run(j_main, feed=_sparse_feed(s), fetch_list=[j_loss.name])
        want = {n: _jax_fetch(n, scope) for n in p0}
    t_scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(t_startup, scope=t_scope)
    tfluid.params_from_numpy(p0, t_scope, tfluid.CPUPlace(), program=t_main)
    for s in range(STEPS):
        exe.run(t_main, feed=_sparse_feed(s), fetch_list=[t_loss],
                scope=t_scope)
    for name, w in want.items():
        np.testing.assert_allclose(tfluid.fetch_var(name, t_scope), w,
                                   err_msg=name, **GRAD_TOL)


# ------------------------------------------------------- flat-state views


def test_scope_views_of_a_fused_program():
    """fetch_var reads a fused parameter through its view of the flat
    buffer; a write goes through into the buffer; a parameter fetched
    in a step is its value after the update; a fed fused parameter
    raises; clones keep the view map."""
    with _flags("torch", {"fuse_optimizer_state": True}):
        main, startup, cost, _ = _build("torch", "fused")
    views = main._flat_state_views
    assert main.clone()._flat_state_views is views
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    name = "fc.w_0"
    flat_name, off, n, shape, dtype = views[name]
    assert flat_name == "fused_param_storage_0" and dtype == "float32"
    assert name not in list(scope.local_var_names())  # the view replaced it
    flat = scope.find_var(flat_name)
    view = scope.find_var(name)
    assert tuple(view.shape) == shape
    assert view.data_ptr() == flat[off:].data_ptr()  # shares the storage
    np.testing.assert_array_equal(tfluid.fetch_var(name, scope).ravel(),
                                  flat[off:off + n].numpy())
    new = np.full(shape, 0.25, np.float32)
    scope.set_var(name, torch.from_numpy(new))
    np.testing.assert_array_equal(
        scope.find_var(flat_name)[off:off + n].numpy(), new.ravel())
    got, = exe.run(main, feed=_feed(), fetch_list=[name], scope=scope)
    np.testing.assert_array_equal(got, tfluid.fetch_var(name, scope))
    assert not np.array_equal(got, new)
    moment = next(k for k, v in views.items()
                  if k.startswith(name + "_moment1_"))
    assert views[moment][0] == "fused_moment1_storage_0"
    assert tfluid.fetch_var(moment, scope).shape == shape
    assert np.abs(tfluid.fetch_var(moment, scope)).max() > 0
    with pytest.raises(EnforceError, match="Cannot feed fused parameter"):
        exe.run(main, feed={**_feed(), name: new}, fetch_list=[cost],
                scope=scope)
    with pytest.raises(EnforceError, match="Cannot find variable"):
        tfluid.fetch_var("no_such_var", scope)


def test_fused_state_from_jax_resumes():
    """Two steps of the JAX package's fused program with bf16 moments
    and sparse embeddings, then its whole state — flat buffers, their
    per-name views, bf16 moments, sparse tables, beta powers, the
    learning rate — carried into the port: the third step's loss and
    gradients match, and so do the updated parameters (in units of lr)
    and beta powers."""
    flag_values = {"fuse_optimizer_state": True, "bf16_moments": True}
    feed = _feed(seed=3)
    with warnings.catch_warnings(), _flags("jax", flag_values):
        warnings.filterwarnings("ignore")
        j_main, j_startup, j_cost, j_pg = _build("jax", "pallas",
                                                 sparse_embedding=True)
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            exe = jfluid.Executor(jfluid.CPUPlace())
            exe.run(j_startup)
            for _ in range(2):
                exe.run(j_main, feed=feed, fetch_list=[j_cost.name])
            names = [v.name for v in j_main.list_vars() if v.persistable]
            state = {n: np.asarray(scope.find_var(n)) for n in names}
            fetch = [j_cost.name] + [g.name for _, g in j_pg]
            j_out = exe.run(j_main, feed=feed, fetch_list=fetch)
            j_after = {n: _jax_fetch(n, scope) for n in names}
    assert state["fused_moment1_storage_0"].dtype.name == "bfloat16"
    with _flags("torch", flag_values):
        t_main, _, t_cost, t_pg = _build("torch", "pallas",
                                         sparse_embedding=True)
    t_scope = tfluid.Scope()
    tfluid.state_from_numpy(state, t_scope, tfluid.CPUPlace(),
                            program=t_main)
    t_out = tfluid.Executor(tfluid.CPUPlace()).run(
        t_main, feed=feed, fetch_list=[t_cost.name] + [g.name for _, g in t_pg],
        scope=t_scope)
    for t_v, j_v in zip(t_out, j_out):
        np.testing.assert_allclose(t_v, np.asarray(j_v), **GRAD_TOL)
    for name in names:
        got = tfluid.fetch_var(name, t_scope)
        if name.startswith("learning_rate") or "_pow_acc_" in name:
            np.testing.assert_allclose(got, j_after[name], rtol=1e-6,
                                       err_msg=name)
        elif "moment" not in name:
            base = state[name].astype(np.float32)
            np.testing.assert_allclose((got - base) / LR,
                                       (j_after[name] - base) / LR, rtol=0,
                                       atol=UPDATE_TOL, err_msg=name)


def test_a_fused_state_needs_its_flat_storage():
    """Per-name parameters of a fused program write through the views
    into flat buffers; without them (no startup run, none given) the
    load refuses and loads nothing."""
    with _flags("torch", {"fuse_optimizer_state": True}):
        t_main = _build("torch", "fused")[0]
    params = {p.name: np.zeros(p.shape, np.float32)
              for p in t_main.all_parameters()}
    scope = tfluid.Scope()
    with pytest.raises(EnforceError, match="run the startup program"):
        tfluid.params_from_numpy(params, scope, tfluid.CPUPlace(),
                                 program=t_main)
    assert list(scope.local_var_names()) == []


# ------------------------------------------------------ bf16 at op level


@pytest.mark.parametrize("layer", ["softmax", "cross_entropy_hard",
                                   "cross_entropy_soft",
                                   "cross_entropy_ignore"])
def test_bf16_stream_reductions_match_at_op_level(layer):
    """softmax and cross_entropy on a bf16 input reduce in f32 in both
    packages: equal symbol tables; softmax within one bf16 rounding, the
    f32 cross-entropy at rtol 1e-6."""
    rng = np.random.RandomState(4)
    xs = (2 * rng.standard_normal((3, 4, 7))).astype(np.float32)
    probs = np.exp(xs) / np.exp(xs).sum(-1, keepdims=True)
    soft = rng.uniform(0, 1, (3, 4, 7)).astype(np.float32)
    hard = rng.randint(0, 7, (3, 4, 1)).astype(np.int64)

    def build(fluid, guard):
        main = fluid.Program()
        with guard(), fluid.program_guard(main, fluid.Program()):
            L = fluid.layers
            x = L.cast(L.data("x", [3, 4, 7], append_batch_size=False),
                       "bfloat16")
            if layer == "softmax":
                return main, L.softmax(x)
            soft_label = layer == "cross_entropy_soft"
            y = L.data("y", [3, 4, 7] if soft_label else [3, 4, 1],
                       dtype="float32" if soft_label else "int64",
                       append_batch_size=False)
            return main, L.cross_entropy(
                x, y, soft_label=soft_label,
                ignore_index=3 if layer == "cross_entropy_ignore" else -100)

    feed = {"x": xs if layer == "softmax" else probs,
            "y": soft if layer == "cross_entropy_soft" else hard}
    if layer == "softmax":
        feed.pop("y")
    j_main, j_out = build(jfluid, j_unique_name.guard)
    t_main, t_out = build(tfluid, tfluid.unique_name.guard)
    assert symbol_table(t_main) == symbol_table(j_main)
    with jfluid.scope_guard(jfluid.Scope()):
        want, = jfluid.Executor(jfluid.CPUPlace()).run(
            j_main, feed=feed, fetch_list=[j_out.name])
    got, = tfluid.Executor(tfluid.CPUPlace()).run(
        t_main, feed=feed, fetch_list=[t_out.name], scope=tfluid.Scope())
    want = np.asarray(want).astype(np.float32)
    np.testing.assert_allclose(got, want,
                               rtol=2 ** -8 if layer == "softmax" else 1e-6)
    if layer == "cross_entropy_ignore":
        assert not got[hard == 3].any()


@pytest.mark.parametrize("rule", ["operands", "stream"])
def test_bf16_matmul_rule_matches_at_op_level(rule):
    """fc under ``use_bfloat16`` (bf16 operands, f32 result) and under
    the bf16 stream (bf16 result) in both packages: symbol tables (the
    weights stay f32), the loss and the gradients of one SGD step
    within the bf16 tolerance (rel 1e-2, grads 2e-2 of their max)."""
    flag_values = {"use_bfloat16": True, "bf16_activations": rule == "stream"}
    rng = np.random.RandomState(9)
    feed = {"x": rng.standard_normal((5, 8)).astype(np.float32)}

    def build(fluid, guard):
        main, startup = fluid.Program(), fluid.Program()
        with guard(), fluid.program_guard(main, startup):
            L = fluid.layers
            x = L.data("x", [5, 8], append_batch_size=False)
            h = L.fc(L.fc(x, 6, act="relu"), 4)
            loss = L.reduce_sum(L.elementwise_mul(h, h))
            _, pg = fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return main, startup, [loss.name] + [g.name for _, g in pg]

    with _flags("jax", flag_values):
        j_main, j_startup, fetch = build(jfluid, j_unique_name.guard)
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            exe = jfluid.Executor(jfluid.CPUPlace())
            exe.run(j_startup)
            p0 = {p.name: _jax_fetch(p.name, scope)
                  for p in j_main.all_parameters()}
            want = exe.run(j_main, feed=feed, fetch_list=fetch)
    with _flags("torch", flag_values):
        t_main, t_startup, t_fetch = build(tfluid, tfluid.unique_name.guard)
    assert t_fetch == fetch
    assert symbol_table(t_main) == symbol_table(j_main)
    assert all(p.dtype == np.dtype("float32") for p in t_main.all_parameters())
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(t_startup, scope=scope)
    tfluid.params_from_numpy(p0, scope, tfluid.CPUPlace(), program=t_main)
    got = exe.run(t_main, feed=feed, fetch_list=fetch, scope=scope)
    np.testing.assert_allclose(got[0], np.asarray(want[0], np.float32),
                               rtol=1e-2)
    for name, g, w in zip(fetch[1:], got[1:], want[1:]):
        w = np.asarray(w, np.float32)
        assert g.dtype == np.float32, name
        assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max(), name
