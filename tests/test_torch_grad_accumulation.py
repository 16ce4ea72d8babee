"""paddle_tpu_torch's GradientAccumulation held to paddle_tpu's (mirrors
tests/test_grad_accumulation.py, each test against the JAX package).

k micro-batch steps equal one inner-optimizer step on the combined
batch: the loss is a batch mean, so the k-step mean gradient is the
concatenated batch's. Both packages start from the JAX package's
initialized state (``state_from_numpy``); the port's parameters are held
to the JAX package's within rtol 1e-5 / atol 1e-7 (XLA contracts
``a*b + c`` into a fused multiply-add where the port rounds op by op,
ROADMAP Queue C 2), and to its own combined batch within the same
tolerance, as the JAX test holds the JAX package. The micro-steps
before the k-th leave the parameters bit-unchanged (the inner update is
gated on the counter, ``optimizer.mask_update_op``). Under
``fuse_optimizer_state`` the flat group op takes the same gate, and its
parameters are bit-equal to the per-parameter layout's.
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid

from _torch_port import _flags, package
from paddle_tpu_torch.models.transformer import \
    transformer_base as t_transformer

torch.set_num_threads(1)

CPU = tfluid.CPUPlace()
TOL = dict(rtol=1e-5, atol=1e-7)

rng = np.random.RandomState(3)
MICRO = [(rng.rand(4, 3).astype("f"), rng.rand(4, 1).astype("f"))
         for _ in range(4)]
# combined pairs: micro-batches 0+1 and 2+3 concatenated
COMBINED = [(np.concatenate([MICRO[i][0], MICRO[i + 1][0]]),
             np.concatenate([MICRO[i][1], MICRO[i + 1][1]]))
            for i in (0, 2)]


def _net(fluid, clip=False):
    x = fluid.layers.data(name="x", shape=[3], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    if clip:
        pred = fluid.layers.fc(
            input=x, size=1, bias_attr=False,
            param_attr=fluid.ParamAttr(
                name="gw", gradient_clip=fluid.clip.GradientClipByValue(
                    0.01)))
    else:
        pred = fluid.layers.fc(input=x, size=1,
                               param_attr=fluid.ParamAttr(name="gw"),
                               bias_attr=fluid.ParamAttr(name="gb"))
    return fluid.layers.mean(fluid.layers.square_error_cost(pred, y))


def _run(pkg, make_opt, batches, clip=False, fuse=False, state=None):
    """(params after each batch as {name: array}, start state) of one
    package; ``make_opt(fluid)`` makes the optimizer; the port starts
    from ``state``."""
    fluid, guard = package(pkg)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 17
    with _flags(pkg, {"fuse_optimizer_state": fuse}), guard(), \
            fluid.program_guard(main, startup), warnings.catch_warnings():
        loss = _net(fluid, clip)
        make_opt(fluid).minimize(loss)
    names = sorted(p.name for p in main.all_parameters())
    trace = []
    if pkg == "jax":
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            exe = jfluid.Executor(jfluid.CPUPlace())
            exe.run(startup)
            state = {v.name: np.asarray(scope.find_var(v.name))
                     for v in main.list_vars() if v.persistable}
            for xb, yb in batches:
                exe.run(main, feed={"x": xb, "y": yb},
                        fetch_list=[loss.name])
                trace.append({n: np.asarray(jfluid.executor.fetch_var(
                    n, scope)) for n in names})
        return trace, state, main
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    # the start state of the names this program declares (a plain
    # optimizer's program has no accumulation buffers)
    ours = {v.name for v in main.list_vars() if v.persistable}
    tfluid.state_from_numpy({n: a for n, a in state.items() if n in ours},
                            scope, CPU, program=main)
    for xb, yb in batches:
        exe.run(main, feed={"x": xb, "y": yb}, fetch_list=[loss],
                scope=scope)
        trace.append({n: tfluid.fetch_var(n, scope) for n in names})
    return trace, state, main


def _close(got, want):
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **TOL)


INNER = {
    "sgd": lambda f: f.optimizer.SGD(learning_rate=0.1),
    "adam": lambda f: f.optimizer.Adam(learning_rate=0.1),
    "momentum": lambda f: f.optimizer.Momentum(learning_rate=0.1,
                                               momentum=0.9),
}


def _accum(inner, k):
    return lambda f: f.optimizer.GradientAccumulation(INNER[inner](f), k)


@pytest.mark.parametrize("inner", sorted(INNER))
def test_accumulation_matches_combined_batch(inner):
    j_trace, state, j_main = _run("jax", _accum(inner, 2), MICRO)
    t_trace, _, t_main = _run("torch", _accum(inner, 2), MICRO,
                              state=state)
    assert [op.type for op in t_main.global_block().ops] == \
        [op.type for op in j_main.global_block().ops]
    for got, want in zip(t_trace, j_trace):
        _close(got, want)
    combined, _, _ = _run("torch", INNER[inner], COMBINED, state=state)
    _close(t_trace[-1], combined[-1])
    _close(t_trace[1], combined[0])


def test_no_update_before_k_steps():
    make = _accum("sgd", 3)
    j_trace, state, _ = _run("jax", make, MICRO[:3])
    t_trace, _, _ = _run("torch", make, MICRO[:3], state=state)
    for step in (0, 1):
        for n, v in t_trace[step].items():
            np.testing.assert_array_equal(v, state[n], err_msg=n)
    assert np.abs(t_trace[2]["gw"] - state["gw"]).max() > 1e-6
    for got, want in zip(t_trace, j_trace):
        _close(got, want)


def test_sparse_grads_rejected():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        ids = tfluid.layers.data(name="ids", shape=[-1, 2], dtype="int64",
                                 append_batch_size=False)
        emb = tfluid.layers.embedding(ids, size=[10, 4], is_sparse=True)
        loss = tfluid.layers.reduce_mean(emb)
        with pytest.raises(tfluid.EnforceError, match="sparse"):
            tfluid.optimizer.GradientAccumulation(
                tfluid.optimizer.SGD(0.1), 2).minimize(loss)


def test_clip_applies_to_accumulated_mean():
    """clip(mean), matching the combined batch — not mean(clip(micro))."""
    make = lambda f: f.optimizer.GradientAccumulation(  # noqa: E731
        f.optimizer.SGD(learning_rate=1.0), 2)
    plain = lambda f: f.optimizer.SGD(learning_rate=1.0)  # noqa: E731
    j_trace, state, _ = _run("jax", make, MICRO, clip=True)
    t_trace, _, _ = _run("torch", make, MICRO, clip=True, state=state)
    combined, _, _ = _run("torch", plain, COMBINED, clip=True, state=state)
    _close(t_trace[-1], j_trace[-1])
    _close(t_trace[-1], combined[-1])


def test_wrapper_level_regularization_applies():
    def make(reg):
        return lambda f: f.optimizer.GradientAccumulation(
            f.optimizer.SGD(learning_rate=0.5), 2,
            regularization=None if reg is None else
            f.regularizer.L2Decay(reg))

    _, state, _ = _run("jax", make(None), MICRO[:2])
    plain, _, _ = _run("torch", make(None), MICRO[:2], state=state)
    j_reg, _, _ = _run("jax", make(0.5), MICRO[:2])
    t_reg, _, _ = _run("torch", make(0.5), MICRO[:2], state=state)
    assert np.abs(plain[-1]["gw"] - t_reg[-1]["gw"]).max() > 1e-5
    _close(t_reg[-1], j_reg[-1])


def test_minimize_outside_program_guard():
    """The counter and its init land on the resolved programs
    (loss.block.program, the passed startup), not the ambient
    defaults."""
    counts = {}
    for pkg in ("jax", "torch"):
        fluid, guard = package(pkg)
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = 17
        with guard():
            with fluid.program_guard(main, startup):
                loss = _net(fluid)
            opt = fluid.optimizer.GradientAccumulation(
                fluid.optimizer.SGD(learning_rate=0.1), 2)
            opt.minimize(loss, startup_program=startup)
        counters = [n for n in startup.global_block().vars
                    if "grad_accum_step" in n]
        assert counters, "counter init must be on the passed startup"
        if pkg == "jax":
            scope = jfluid.Scope()
            with jfluid.scope_guard(scope):
                exe = jfluid.Executor(jfluid.CPUPlace())
                exe.run(startup)
                for xb, yb in MICRO:
                    exe.run(main, feed={"x": xb, "y": yb},
                            fetch_list=[loss.name])
                counts[pkg] = int(np.asarray(scope.get(counters[0])))
        else:
            scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
            exe.run(startup, scope=scope)
            for xb, yb in MICRO:
                exe.run(main, feed={"x": xb, "y": yb}, fetch_list=[loss],
                        scope=scope)
            counts[pkg] = int(scope.get(counters[0]))
    assert counts == {"jax": len(MICRO), "torch": len(MICRO)}


@pytest.mark.parametrize("inner", ["sgd", "adam"])
def test_fused_state_layout(inner):
    """Under ``fuse_optimizer_state`` the inner group op takes the gate:
    bit-equal to the per-parameter layout, close to the JAX package's
    fused layout, unchanged before the k-th step."""
    make = _accum(inner, 2)
    j_trace, state, _ = _run("jax", make, MICRO, fuse=True)
    per_param, _, _ = _run("torch", make, MICRO, state=state)
    fused, _, t_main = _run("torch", make, MICRO, fuse=True, state=state)
    assert inner + "_fused" in [op.type for op in
                                t_main.global_block().ops]
    group = next(op for op in t_main.global_block().ops
                 if op.type == inner + "_fused")
    assert group.input("ApplyFlag")
    for n, v in fused[0].items():
        np.testing.assert_array_equal(v, state[n], err_msg=n)
    for got, want in zip(fused, per_param):
        for n in want:
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    for got, want in zip(fused, j_trace):
        _close(got, want)


# ------------------- the Transformer: what parts micro-steps from one step

TB = dict(src_vocab_size=500, trg_vocab_size=500, max_length=16, n_layer=2,
          n_head=2, d_model=64, d_inner_hid=128, dropout_rate=0.0)
TB_B, TB_T, TB_K = 8, 16, 4
# (mean gradient against the combined batch's: relative 2-norm, tensor
# by tensor; parameters after the applied step: max |difference| over
# the tensor's max |value|)
TB_TOL = {"float32": (1e-5, None), "float64": (1e-13, 1e-12)}


def _tb_feed():
    rng = np.random.RandomState(0)
    ids = lambda: rng.randint(1, 500, (TB_B, TB_T)).astype(  # noqa: E731
        "int64")
    return {"src_word": ids(), "trg_word": ids(), "lbl_word": ids(),
            "src_mask": np.ones((TB_B, TB_T), "float32"),
            "trg_mask": np.ones((TB_B, TB_T), "float32")}


def _as_float64(main, scope, feed):
    """Retype ``main``'s float32 variables and ``scope``'s float32
    tensors to float64; the feed too."""
    for blk in main.blocks:
        for v in blk.vars.values():
            if v.dtype == np.float32:
                v.dtype = np.dtype("float64")
    for name in list(scope.local_var_names()):
        t = scope.find_var(name)
        if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
            scope.set_var(name, t.double())
    return {n: v.astype("float64") if v.dtype == np.float32 else v
            for n, v in feed.items()}


def _tb_step(accumulate, dtype):
    """(parameters, the gradient the Adam ops applied) after
    ``GradientAccumulation(Adam, TB_K)`` over the batch's ``TB_K``
    micro-batches, or after one Adam step over the whole batch."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        _, cost, _ = t_transformer(**TB)
        opt = tfluid.optimizer.Adam(learning_rate=1e-4)
        if accumulate:
            opt = tfluid.optimizer.GradientAccumulation(opt, TB_K)
        opt.minimize(cost)
    adam = [op for op in main.global_block().ops if op.type == "adam"]
    grads = [op.input("Grad")[0] for op in adam]
    params = [op.input("Param")[0] for op in adam]
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    feed = _tb_feed()
    if dtype == "float64":
        feed = _as_float64(main, scope, feed)
    m = TB_B // TB_K
    batches = ([{n: v[k * m:(k + 1) * m] for n, v in feed.items()}
                for k in range(TB_K)] if accumulate else [feed])
    for b in batches:
        out = exe.run(main, feed=b, fetch_list=grads, scope=scope)
    return ({n: tfluid.fetch_var(n, scope) for n in params},
            dict(zip(params, out)))


@pytest.mark.parametrize("dtype", sorted(TB_TOL))
def test_transformer_accumulation_is_exact_up_to_rounding(dtype):
    """Four micro-steps of 2 rows against one Adam step of 8 rows on the
    same tokens. In float64 the mean gradient and the parameters after
    the applied step equal the combined batch's to float64 rounding: the
    accumulation adds nothing of its own. In float32 the mean gradient
    stays within 1e-5 of the combined batch's; what is left is the
    order in which float32 sums the rows."""
    torch.manual_seed(0)
    grad_tol, param_tol = TB_TOL[dtype]
    p_acc, g_acc = _tb_step(True, dtype)
    p_one, g_one = _tb_step(False, dtype)
    assert g_acc.keys() == g_one.keys() and len(g_one) > 20
    for n, want in g_one.items():
        assert g_acc[n].dtype == np.dtype(dtype)
        gap = np.linalg.norm(g_acc[n] - want) / max(
            np.linalg.norm(want), 1e-300)
        assert gap <= grad_tol, (n, gap)
    if param_tol is not None:
        for n, want in p_one.items():
            gap = np.abs(p_acc[n] - want).max() / np.abs(want).max()
            assert gap <= param_tol, (n, gap)
