"""paddle_tpu_torch's fused projection + softmax cross-entropy held to
paddle_tpu's, on the CPU.

* The op (``ops/fused_ce.py``) against the JAX package's
  ``fused_linear_softmax_ce_fn`` at the same explicit ``chunk_cap``, on
  the same seeded inputs and cotangent: several chunks of an exact
  divisor (V = 96, cap 32), a prime vocabulary with a padded tail (V =
  257, cap 64: 3 chunks of 128), label smoothing 0 and 0.1, with and
  without a bias. The loss and ``dx``, ``dW``, ``db`` within 1e-5 of
  each tensor's largest magnitude in f32. Under the ``use_bfloat16``
  rule (bf16 operands, f32 logits, the cotangent rounded to bf16 before
  both gradient matmuls) the loss within 1e-5 (the products of bf16
  operands are exact in f32; only the order of the f32 sums differs),
  and the gradients within 2**-8 of their largest magnitude: one bf16
  rounding of a cotangent element may land on the other side when its
  f32 value differs in the last bits.
* The layer builds the unfused head's parameter names and the JAX
  package's symbol table.
* ``transformer_base(fused_ce=True)`` at the tiny ``TB`` widths tracks
  the port's unfused build from the same weights: step 0's loss and
  every gradient within rtol 1e-5 / atol 1e-6, 3 Adam steps' losses
  likewise.
* With only the loss fetched the predict head's ``mul`` does not run (the
  executor's dead-op skip); fetching ``predict`` runs it and returns the
  unfused build's logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import flags as j_flags
from paddle_tpu.core import unique_name as j_unique_name
from paddle_tpu.ops.fused_ce import \
    fused_linear_softmax_ce_fn as j_fused_ce
from paddle_tpu_torch.executor import live_ops
from paddle_tpu_torch.ops.fused_ce import _chunking
from paddle_tpu_torch.ops.fused_ce import \
    fused_linear_softmax_ce_fn as t_fused_ce

from _torch_port import GRAD_TOL, STEPS, _build, _feed, symbol_table

torch.set_num_threads(1)

N, D = 24, 16
VOCABS = {"multi_chunk": (96, 32), "prime_padded": (257, 64)}
CASES = ([(v, eps, bias, False) for v in VOCABS for eps in (0.0, 0.1)
          for bias in (True, False)]
         + [(v, 0.1, True, True) for v in VOCABS])


def _inputs(V, seed=0):
    rng = np.random.RandomState(seed)
    return dict(x=rng.randn(N, D).astype(np.float32),
                W=(rng.randn(D, V) * 0.3).astype(np.float32),
                b=(rng.randn(V) * 0.1).astype(np.float32),
                y=rng.randint(0, V, (N, 1)).astype(np.int64),
                dloss=rng.rand(N, 1).astype(np.float32))


def test_chunking_pads_the_prime_vocabulary():
    assert _chunking(96, 32) == (32, 3, 96)
    assert _chunking(257, 64) == (128, 3, 384)
    assert _chunking(32000, 4096) == (4000, 8, 32000)


@pytest.mark.parametrize("vocab,eps,bias,bf16", CASES)
def test_op_matches_the_jax_op(vocab, eps, bias, bf16):
    V, cap = VOCABS[vocab]
    a = _inputs(V)

    def jfn(x, W, b):
        return j_fused_ce(x, W, b if bias else None, jnp.asarray(a["y"]),
                          smooth_eps=eps, chunk_cap=cap)

    saved = j_flags.get_flag("use_bfloat16")
    j_flags.set_flags({"use_bfloat16": bf16})
    try:
        jloss, vjp = jax.vjp(jfn, jnp.asarray(a["x"]), jnp.asarray(a["W"]),
                             jnp.asarray(a["b"]))
        jdx, jdW, jdb = vjp(jnp.asarray(a["dloss"]))
    finally:
        j_flags.set_flags({"use_bfloat16": saved})
    x, W, b = (torch.tensor(a[k], requires_grad=True) for k in "xWb")
    loss = t_fused_ce(x, W, b if bias else None, torch.tensor(a["y"]),
                      smooth_eps=eps, chunk_cap=cap, bf16=bf16)
    loss.backward(torch.tensor(a["dloss"]))
    assert loss.shape == (N, 1) and loss.dtype == torch.float32
    grad_tol = 2.0 ** -8 if bf16 else 1e-5
    pairs = [("loss", loss, jloss, 1e-5), ("dx", x.grad, jdx, grad_tol),
             ("dW", W.grad, jdW, grad_tol)]
    if bias:
        pairs.append(("db", b.grad, jdb, grad_tol))
    else:
        assert b.grad is None
    for name, got, want, tol in pairs:
        want = np.asarray(want)
        got = got.detach().numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * np.abs(want).max(),
                                   err_msg=name)


def _head(pkg, fused, bias_attr=None):
    """x [-1, 5, D] -> the vocab head (fused, or fc + softmax CE) in one
    package: (main, startup, loss, predict)."""
    fluid, guard = ((jfluid, j_unique_name.guard) if pkg == "jax"
                    else (tfluid, tfluid.unique_name.guard))
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        x = L.data(name="x", shape=[-1, 5, D], dtype="float32",
                   append_batch_size=False)
        y = L.data(name="y", shape=[-1, 5], dtype="int64",
                   append_batch_size=False)
        if fused:
            loss, predict = L.fused_linear_softmax_ce(
                x, y, size=97, smooth_eps=0.1, bias_attr=bias_attr)
        else:
            predict = L.fc(input=x, size=97, num_flatten_dims=2,
                           bias_attr=bias_attr)
            loss = L.softmax_with_cross_entropy(predict, y, smooth_eps=0.1)
    return main, startup, loss, predict


@pytest.mark.parametrize("bias_attr", [None, False])
def test_layer_builds_the_unfused_parameter_names(bias_attr):
    fused = _head("torch", True, bias_attr)[0]
    plain = _head("torch", False, bias_attr)[0]
    params = lambda m: [(p.name, tuple(p.shape))  # noqa: E731
                        for p in m.all_parameters()]
    assert params(fused) == params(plain)
    assert len(params(fused)) == (1 if bias_attr is False else 2)
    assert symbol_table(fused) == symbol_table(_head("jax", True,
                                                     bias_attr)[0])


def test_transformer_fused_ce_tracks_the_unfused_build():
    runs = {}
    p0 = None
    for fused in (False, True):
        main, startup, cost, pg = _build("torch", "fused", fused_ce=fused)
        scope, place = tfluid.Scope(), tfluid.CPUPlace()
        exe = tfluid.Executor(place)
        exe.run(startup, scope=scope)
        if p0 is None:
            p0 = {p.name: tfluid.fetch_var(p.name, scope)
                  for p in main.all_parameters()}
        tfluid.params_from_numpy(p0, scope, place, program=main)
        fetch = [cost.name] + [g.name for _, g in pg]
        runs[fused] = [exe.run(main, feed=_feed(), fetch_list=fetch,
                               scope=scope) for _ in range(STEPS)]
        assert sorted(p.name for p, _ in pg) == sorted(p0)
    plain, fused = runs[False], runs[True]
    for t_o, u_o in zip(fused, plain):
        np.testing.assert_allclose(t_o[0], u_o[0], **GRAD_TOL)
    for k, (t_g, u_g) in enumerate(zip(fused[0][1:], plain[0][1:])):
        np.testing.assert_allclose(t_g, u_g, err_msg=str(k), **GRAD_TOL)
    assert fused[-1][0] < fused[0][0]


def test_predict_head_runs_only_when_fetched():
    main, startup, cost, pg = _build("torch", "fused", fused_ce=True)
    gb = main.global_block()
    # the layer appends the fused op, then the head's mul and add
    at = next(i for i, op in enumerate(gb.ops)
              if op.type == "fused_linear_softmax_ce")
    mul, add = gb.ops[at + 1], gb.ops[at + 2]
    assert (mul.type, add.type) == ("mul", "elementwise_add")
    assert mul.output_arg_names == add.input("X")
    predict = add.output_arg_names[0]
    calls = []
    fn = mul.fn
    mul.fn = lambda *a: calls.append(1) or fn(*a)
    assert mul not in live_ops(main, [cost.name])
    assert mul in live_ops(main, [cost.name, predict])

    scope, place = tfluid.Scope(), tfluid.CPUPlace()
    exe = tfluid.Executor(place)
    exe.run(startup, scope=scope)
    params = {p.name: tfluid.fetch_var(p.name, scope)
              for p in main.all_parameters()}
    exe.run(main, feed=_feed(), fetch_list=[cost], scope=scope)
    assert calls == []
    # predict fetched: the head runs and gives the unfused logits (from
    # the same start state: this run trains a step too)
    tfluid.params_from_numpy(params, scope, place, program=main)
    logits, = exe.run(main, feed=_feed(), fetch_list=[predict],
                      scope=scope)
    assert calls == [1]
    u_main, u_startup, _, _ = _build("torch", "fused", fused_ce=False)
    u_scope = tfluid.Scope()
    exe.run(u_startup, scope=u_scope)
    tfluid.params_from_numpy(params, u_scope, place, program=u_main)
    u_pred = next(op for op in u_main.global_block().ops
                  if op.type == "softmax_with_cross_entropy").input(
                      "Logits")[0]
    want, = exe.run(u_main, feed=_feed(), fetch_list=[u_pred],
                    scope=u_scope)
    np.testing.assert_allclose(logits, want, rtol=1e-5, atol=1e-6)
