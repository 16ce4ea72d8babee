"""paddle_tpu_torch trains Transformer-base as paddle_tpu does.

The same tiny ``transformer_base`` (vocab 50, 2 layers, 2 heads,
d_model 32, FFN 64; B=3, T_src=9, T_trg=7 with ragged masks,
dropout 0) and ``Adam`` are built with the same calls in both packages;
the JAX package's initial weights are carried into the port with
``params_from_numpy``, and both run 3 steps on one seeded numpy batch.
Held to the JAX package:

* the symbol tables and op sequences are equal;
* loss and every ``<param>@GRAD`` agree at rtol 1e-5 / atol 1e-6 (the
  packages sum in different orders);
* after 3 Adam steps, the parameter updates agree within 0.02 in units
  of the learning rate, element by element — compared relative to lr
  because Adam's normalisation ``m / (sqrt(v) + eps)`` turns a
  near-zero gradient's last-bit difference into an update difference
  of order lr;

for ``attn_impl="fused"`` and ``"pallas"`` alike (on the CPU the JAX
package's ``"pallas"`` route runs its plain reference
``_xla_attention``; the port's runs the flash kernels' plain versions).
A state carried from the JAX package after 2 steps
(``state_from_numpy``) resumes for a 3rd that matches, and the options
the port does not have yet raise ``NotImplementedError``
(tests/test_torch_dropout.py trains with dropout,
tests/test_torch_fused_ce.py with the fused head).
tests/test_torch_recipe.py holds ``bench.py``'s full recipe (bf16
flags, flat optimizer state, sparse embeddings) to the JAX package.
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique_name
from paddle_tpu_torch.core.enforce import EnforceError

from _torch_port import (B, GRAD_TOL, LR, STEPS, T_TRG, UPDATE_TOL, _build,
                         _feed, symbol_table)

torch.set_num_threads(1)


def _quiet():
    """Silence the JAX package's off-TPU flash-attention fallback note."""
    ctx = warnings.catch_warnings()
    ctx.__enter__()
    warnings.filterwarnings("ignore", message="flash_attention: XLA fallback")
    return ctx


class _Run:
    """Both packages built, the JAX weights carried over, and STEPS
    steps run on each, fetching the loss and every gradient."""

    def __init__(self, attn_impl):
        ctx = _quiet()
        try:
            self.j = _build("jax", attn_impl)
            self.t = _build("torch", attn_impl)
            feed = _feed()
            j_main, j_startup, j_cost, j_pg = self.j
            self.j_scope = jfluid.Scope()
            with jfluid.scope_guard(self.j_scope):
                exe = jfluid.Executor(jfluid.CPUPlace())
                exe.run(j_startup)
                self.p0 = {p.name: np.asarray(self.j_scope.find_var(p.name))
                           for p in j_main.all_parameters()}
                fetch = [j_cost.name] + [g.name for _, g in j_pg]
                self.j_out = [exe.run(j_main, feed=feed, fetch_list=fetch)
                              for _ in range(STEPS)]
        finally:
            ctx.__exit__(None, None, None)
        t_main, t_startup, t_cost, t_pg = self.t
        self.t_scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(t_startup, scope=self.t_scope)
        tfluid.params_from_numpy(self.p0, self.t_scope, tfluid.CPUPlace(),
                                 program=t_main)
        fetch = [t_cost.name] + [g.name for _, g in t_pg]
        self.t_out = [exe.run(t_main, feed=feed, fetch_list=fetch,
                              scope=self.t_scope) for _ in range(STEPS)]


@pytest.fixture(scope="module", params=["fused", "pallas"])
def run(request):
    return _Run(request.param)


def test_symbol_tables_and_op_sequences_match(run):
    for (j_prog, t_prog) in ((run.j[0], run.t[0]), (run.j[1], run.t[1])):
        assert symbol_table(t_prog) == symbol_table(j_prog)
        assert [op.type for op in t_prog.global_block().ops] == \
            [op.type for op in j_prog.global_block().ops]
    assert [(p.name, g.name) for p, g in run.t[3]] == \
        [(p.name, g.name) for p, g in run.j[3]]
    bw = [op for op in run.t[0].global_block().ops if op.type == "backward"]
    assert len(bw) == 1 and bw[0].attrs["loss"] == run.t[2].name


def test_step0_loss_and_every_grad_match(run):
    j0, t0 = run.j_out[0], run.t_out[0]
    np.testing.assert_allclose(t0[0], j0[0], **GRAD_TOL)
    names = [g.name for _, g in run.t[3]]
    assert len(names) == len(run.p0) and all(n.endswith("@GRAD")
                                             for n in names)
    for name, t_g, j_g in zip(names, t0[1:], j0[1:]):
        assert t_g.shape == j_g.shape, name
        np.testing.assert_allclose(t_g, j_g, err_msg=name, **GRAD_TOL)


def test_losses_and_params_after_three_adam_steps_match(run):
    for j_o, t_o in zip(run.j_out, run.t_out):
        np.testing.assert_allclose(t_o[0], j_o[0], **GRAD_TOL)
    assert run.t_out[-1][0] < run.t_out[0][0]
    for name, p0 in run.p0.items():
        j_up = (np.asarray(run.j_scope.find_var(name)) - p0) / LR
        t_up = (run.t_scope.find_var(name).numpy() - p0) / LR
        np.testing.assert_allclose(t_up, j_up, rtol=0, atol=UPDATE_TOL,
                                   err_msg=name)


def _persistables(program, scope, jax_side):
    out = {}
    for v in program.list_vars():
        if v.persistable:
            val = scope.find_var(v.name)
            out[v.name] = np.asarray(val) if jax_side else val.numpy()
    return out


def test_state_from_jax_after_two_steps_resumes():
    """Two JAX steps, then every persistable (parameters, moments, beta
    powers, learning rate) carried into the port: the third step's loss,
    gradients and updated state match the JAX package's third step."""
    ctx = _quiet()
    try:
        j_main, j_startup, j_cost, j_pg = _build("jax", "pallas")
        feed = _feed(seed=3)
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            exe = jfluid.Executor(jfluid.CPUPlace())
            exe.run(j_startup)
            for _ in range(2):
                exe.run(j_main, feed=feed, fetch_list=[j_cost.name])
            state = _persistables(j_main, scope, True)
            fetch = [j_cost.name] + [g.name for _, g in j_pg]
            j_out = exe.run(j_main, feed=feed, fetch_list=fetch)
            j_after = _persistables(j_main, scope, True)
    finally:
        ctx.__exit__(None, None, None)
    t_main, _, t_cost, t_pg = _build("torch", "pallas")
    assert any(n.startswith("learning_rate") for n in state)
    assert any("_moment2_" in n for n in state)
    assert sum("_pow_acc_" in n for n in state) == 2  # shared beta powers
    t_scope = tfluid.Scope()
    tfluid.state_from_numpy(state, t_scope, tfluid.CPUPlace(),
                            program=t_main)
    t_out = tfluid.Executor(tfluid.CPUPlace()).run(
        t_main, feed=feed, fetch_list=[t_cost.name] + [g.name for _, g in t_pg],
        scope=t_scope)
    for t_v, j_v in zip(t_out, j_out):
        np.testing.assert_allclose(t_v, j_v, **GRAD_TOL)
    t_after = _persistables(t_main, t_scope, False)
    assert set(t_after) == set(j_after)
    for name in j_after:
        if name.startswith("learning_rate") or "_pow_acc_" in name:
            np.testing.assert_allclose(t_after[name], j_after[name],
                                       rtol=1e-6, err_msg=name)
        elif "_moment" not in name:
            np.testing.assert_allclose(
                (t_after[name] - state[name]) / LR,
                (j_after[name] - state[name]) / LR, rtol=0,
                atol=UPDATE_TOL, err_msg=name)


def test_state_from_numpy_refuses_a_partial_or_misshapen_state():
    t_main = _build("torch", "fused")[0]
    full = {v.name: np.zeros([max(s, 1) for s in v.shape] if v.shape else (),
                             np.float32)
            for v in t_main.list_vars() if v.persistable}
    lr = next(n for n in full if n.startswith("learning_rate"))
    partial = {n: a for n, a in full.items() if n != lr}
    scope = tfluid.Scope()
    with pytest.raises(EnforceError, match="missing persistables"):
        tfluid.state_from_numpy(partial, scope, tfluid.CPUPlace(),
                                program=t_main)
    bad = dict(full, **{lr: np.zeros((1,), np.float32)})
    with pytest.raises(EnforceError, match="shape"):
        tfluid.state_from_numpy(bad, scope, tfluid.CPUPlace(),
                                program=t_main)
    assert list(scope.local_var_names()) == []


# ---------------------------------------------------------------- op level


@pytest.mark.parametrize("eps,label_dims", [(0.1, 2), (0.0, 2), (0.1, 3)],
                         ids=["smooth", "hard", "label_trailing_1"])
def test_softmax_with_cross_entropy_matches_at_op_level(eps, label_dims):
    """Loss, softmax and the gradient w.r.t. the logits of the two
    packages' ops on the same numpy inputs (the port's backward is the
    analytic ``softmax - (1-eps)*onehot - eps/V``, as the JAX one)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(5)
    lg = (3 * rng.standard_normal((2, 6, 11))).astype(np.float32)
    lab = rng.randint(0, 11, (2, 6) + (1,) * (label_dims - 2)).astype(
        np.int64)
    dloss = rng.standard_normal((2, 6, 1)).astype(np.float32)

    def op_fn(fluid, guard):
        main = fluid.Program()
        with guard(), fluid.program_guard(main, fluid.Program()):
            x = fluid.layers.data("lg", [2, 6, 11], append_batch_size=False)
            y = fluid.layers.data("y", list(lab.shape), dtype="int64",
                                  append_batch_size=False)
            fluid.layers.softmax_with_cross_entropy(
                x, y, return_softmax=True, smooth_eps=eps)
        return main.global_block().ops[-1].fn

    j_fn = op_fn(jfluid, j_unique_name.guard)
    (j_loss, j_sm), vjp = jax.vjp(lambda a: j_fn(a, jnp.asarray(lab)),
                                  jnp.asarray(lg))
    j_grad, = vjp((jnp.asarray(dloss), jnp.zeros_like(j_sm)))
    t_fn = op_fn(tfluid, tfluid.unique_name.guard)
    x = torch.from_numpy(lg).requires_grad_()
    t_loss, t_sm = t_fn(x, torch.from_numpy(lab))
    t_sm = t_sm.resolve()
    t_grad, = torch.autograd.grad(t_loss, x, torch.from_numpy(dloss))
    np.testing.assert_allclose(t_loss.detach().numpy(), np.asarray(j_loss),
                               **GRAD_TOL)
    np.testing.assert_allclose(t_sm.detach().numpy(), np.asarray(j_sm),
                               **GRAD_TOL)
    np.testing.assert_allclose(t_grad.numpy(), np.asarray(j_grad),
                               **GRAD_TOL)


@pytest.mark.parametrize("layer", ["elementwise_mul", "elementwise_div",
                                   "reduce_sum", "reduce_sum_dim", "squeeze",
                                   "cast_int32", "cast_float32"])
def test_loss_layers_match_at_op_level(layer):
    """The layers the Transformer-base loss is built from, and the cast
    of its bf16 embedding path, on the same numpy inputs in both
    packages: equal symbol tables and equal values."""
    rng = np.random.RandomState(11)
    xs = (3 * rng.standard_normal((2, 3, 1))).astype(np.float32)
    ys = (rng.uniform(0.5, 2.0, (2, 3, 1))).astype(np.float32)
    ids = rng.randint(0, 9, (2, 3)).astype(np.int64)

    def build(fluid, guard):
        main = fluid.Program()
        with guard(), fluid.program_guard(main, fluid.Program()):
            x = fluid.layers.data("x", [2, 3, 1], append_batch_size=False)
            y = fluid.layers.data("y", [2, 3, 1], append_batch_size=False)
            i = fluid.layers.data("i", [2, 3], dtype="int64",
                                  append_batch_size=False)
            L = fluid.layers
            out = {"elementwise_mul": lambda: L.elementwise_mul(x, y),
                   "elementwise_div": lambda: L.elementwise_div(x, y),
                   "reduce_sum": lambda: L.reduce_sum(x),
                   "reduce_sum_dim": lambda: L.reduce_sum(x, dim=1,
                                                          keep_dim=True),
                   "squeeze": lambda: L.squeeze(x, axes=[-1]),
                   "cast_int32": lambda: L.cast(x, "int32"),
                   "cast_float32": lambda: L.cast(i, "float32")}[layer]()
        return main, out

    feed = {"x": xs, "y": ys, "i": ids}
    j_main, j_out = build(jfluid, j_unique_name.guard)
    t_main, t_out = build(tfluid, tfluid.unique_name.guard)
    assert symbol_table(t_main) == symbol_table(j_main)
    with jfluid.scope_guard(jfluid.Scope()):
        want, = jfluid.Executor(jfluid.CPUPlace()).run(
            j_main, feed=feed, fetch_list=[j_out.name])
    got, = tfluid.Executor(tfluid.CPUPlace()).run(
        t_main, feed=feed, fetch_list=[t_out.name], scope=tfluid.Scope())
    assert got.dtype == np.asarray(want).dtype
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)


def test_softmax_output_is_computed_only_when_read():
    """The CE op's [.., V] Softmax stays in the symbol table but is
    computed only for a reader: not in a training step that fetches the
    loss, yes when it is fetched."""
    t_main, t_startup, t_cost, _ = _build("torch", "fused")
    op = next(o for o in t_main.global_block().ops
              if o.type == "softmax_with_cross_entropy")
    sm_name = op.output("Softmax")[0]
    assert t_main.global_block().var(sm_name).shape == (-1, -1, 50)
    resolved = []
    orig = op.fn

    def spy(*args):
        loss, sm = orig(*args)
        inner = sm.fn
        sm.fn = lambda: resolved.append(1) or inner()
        return loss, sm

    op.fn = spy
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(t_startup, scope=scope)
    exe.run(t_main, feed=_feed(), fetch_list=[t_cost], scope=scope)
    assert resolved == []
    sm, = exe.run(t_main, feed=_feed(), fetch_list=[sm_name], scope=scope)
    assert resolved == [1]
    assert sm.shape == (B, T_TRG, 50)
    np.testing.assert_allclose(sm.sum(-1), 1.0, rtol=1e-5)


def test_sgd_with_clip_regularizer_and_error_clip_matches():
    """SGD through ``append_gradient_clip_ops`` (global norm),
    ``append_regularization_ops`` (L2 decay) and an error clip on an
    intermediate var, in both packages: loss, gradients and parameters
    after 3 steps."""
    rng = np.random.RandomState(7)
    xs = rng.standard_normal((16, 5)).astype(np.float32)
    ys = xs.sum(1, keepdims=True).astype(np.float32)

    def build(fluid, guard):
        main, startup = fluid.Program(), fluid.Program()
        with guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [16, 5], append_batch_size=False)
            y = fluid.layers.data("y", [16, 1], append_batch_size=False)
            h = fluid.layers.fc(x, 8, act="relu")
            h.error_clip = fluid.clip.ErrorClipByValue(max=0.05)
            pred = fluid.layers.fc(h, 1)
            diff = fluid.layers.elementwise_add(pred, fluid.layers.scale(
                y, scale=-1.0))
            loss = fluid.layers.reduce_sum(
                fluid.layers.elementwise_mul(diff, diff))
            fluid.clip.set_gradient_clip(
                fluid.clip.GradientClipByGlobalNorm(clip_norm=1.0))
            opt = fluid.optimizer.SGD(
                learning_rate=0.05,
                regularization=fluid.regularizer.L2Decay(0.01))
            _, pg = opt.minimize(loss)
        return main, startup, loss, pg

    j_main, j_startup, j_loss, j_pg = build(jfluid, j_unique_name.guard)
    t_main, t_startup, t_loss, t_pg = build(tfluid, tfluid.unique_name.guard)
    assert symbol_table(t_main) == symbol_table(j_main)
    feed = {"x": xs, "y": ys}
    j_scope = jfluid.Scope()
    with jfluid.scope_guard(j_scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(j_startup)
        p0 = {p.name: np.asarray(j_scope.find_var(p.name))
              for p in j_main.all_parameters()}
        fetch = [j_loss.name] + [g.name for _, g in j_pg]
        j_out = [exe.run(j_main, feed=feed, fetch_list=fetch)
                 for _ in range(3)]
    t_scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(t_startup, scope=t_scope)
    tfluid.params_from_numpy(p0, t_scope, tfluid.CPUPlace(), program=t_main)
    fetch = [t_loss.name] + [g.name for _, g in t_pg]
    t_out = [exe.run(t_main, feed=feed, fetch_list=fetch, scope=t_scope)
             for _ in range(3)]
    assert [g.name for _, g in t_pg][0].endswith("@GRAD@CLIP@REG")
    for j_o, t_o in zip(j_out, t_out):
        for t_v, j_v in zip(t_o, j_o):
            np.testing.assert_allclose(t_v, j_v, rtol=1e-5, atol=1e-6)
    for name in p0:
        np.testing.assert_allclose(t_scope.find_var(name).numpy(),
                                   np.asarray(j_scope.find_var(name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------- seams


def test_a_param_grad_can_be_fetched_by_name():
    t_main, t_startup, t_cost, t_pg = _build("torch", "pallas")
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(t_startup, scope=scope)
    g, = exe.run(t_main, feed=_feed(), scope=scope,
                 fetch_list=["src_word_emb_table@GRAD"])
    assert g.shape == (50, 32) and np.isfinite(g).all() and (g != 0).any()


def test_the_backward_op_refuses_to_run_outside_the_executor():
    from paddle_tpu_torch.executor import run_program_ops

    t_main = _build("torch", "fused")[0]
    bw = next(op for op in t_main.global_block().ops
              if op.type == "backward")
    env = {n: torch.zeros(1) for n in bw.input_arg_names}
    with pytest.raises(EnforceError, match="executed by Executor.run"):
        run_program_ops([bw], env)


@pytest.mark.parametrize("option", [
    "training_dropout", "fused_ce", "ring", "tp", "pp_encoder"])
def test_options_not_ported_yet_raise(option):
    """Each option not ported yet raises, naming the ROADMAP item that
    ports it. Every option once on this list is ported: training
    dropout, ``fused_ce`` and ``tp`` build with their dropout sites, the
    fused head, and the JAX package's tensor-parallel annotations
    (column-parallel QKV and FFN-in, row-parallel output projections
    over ``mp``); ``"ring"`` and ``pp_encoder`` build the JAX package's
    program — the same ops, and for the pipelined encoder the same
    stacked parameters, shapes and ``pp`` specs (their runs over ranks:
    tests/test_torch_ring_attention.py, tests/test_torch_pipeline.py)."""
    kw = {"training_dropout": {"dropout_rate": 0.1},
          "fused_ce": {"fused_ce": True}, "ring": {},
          "tp": {"tp": True}, "pp_encoder": {"pp_encoder": True}}[option]
    if option in ("training_dropout", "fused_ce"):
        main = _build("torch", "fused", **kw)[0]
        types = [op.type for op in main.global_block().ops]
        assert ("dropout" in types) == (option == "training_dropout")
        assert ("fused_linear_softmax_ce" in types) == (option == "fused_ce")
        return
    if option == "tp":
        t_main = _build("torch", "fused", **kw)[0]
        j_main = _build("jax", "fused", **kw)[0]
        specs = {pkg: {p.name: getattr(p, "sharding_spec", None)
                       for p in m.all_parameters()}
                 for pkg, m in (("torch", t_main), ("jax", j_main))}
        assert specs["torch"] == specs["jax"]
        assert sorted(set(map(str, specs["torch"].values()))) == \
            ["('mp', None)", "(None, 'mp')", "None"]
        return
    impl = "ring" if option == "ring" else "fused"
    mains = {pkg: _build(pkg, impl, **kw)[0] for pkg in ("torch", "jax")}
    types = {pkg: [op.type for op in m.global_block().ops
                   if op.type != "backward"]
             for pkg, m in mains.items()}
    assert types["torch"] == types["jax"]
    assert ("pipelined_encoder" in types["torch"]) == (option ==
                                                      "pp_encoder")
    params = {pkg: {p.name: (tuple(p.shape),
                             getattr(p, "sharding_spec", None))
                    for p in m.all_parameters()}
              for pkg, m in mains.items()}
    assert params["torch"] == params["jax"]
