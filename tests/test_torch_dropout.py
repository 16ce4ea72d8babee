"""paddle_tpu_torch's training dropout held to paddle_tpu's, on the CPU.

The masks are the JAX package's bit for bit, so everything here is held
exactly except the training run's sums:

* ``prng.bernoulli`` equals ``jax.random.bernoulli`` for 1-, 2- and 3-D
  shapes and odd lengths, at several seeds, counters and probabilities.
* A program with three dropout sites (f32 and bf16, one with an explicit
  seed, a parameter created between sites) built with the same calls in
  both packages: each site's mask equals the JAX package's bit for bit
  at every one of 3 steps, and its output on random inputs equals the
  JAX package's (the sign of a dropped zero aside: XLA compiles the f32
  ``v * convert(mask)`` as a select), the counter equals the JAX counter
  after them, and the programs drew the same number of seeds
  (parameters and dropout sites interleave alike).
* The dropout op itself, called on the same tensors in both packages:
  bit-equal outputs, -0.0, +-inf and NaN inputs included (NaN at the
  same elements; torch rounds a bf16 NaN to the positive quiet NaN,
  XLA keeps the sign of the one the multiply made), and ``counter + 1``.
* ``is_test=True`` and ``Program.clone(for_test=True)`` scale by
  ``1 - p`` and leave the counter alone.
* The gradient is ``g * mask``, equal to ``jax.grad`` of the JAX op.
* Transformer-base at the tiny ``TB`` widths with ``dropout_rate=0.1``
  and ``Adam``: 3 steps' losses and every parameter update match the
  JAX package within the tolerances tests/test_torch_training.py holds
  for dropout 0 (loss rtol 1e-5 / atol 1e-6, updates within 0.02 of
  the learning rate); ``run_steps`` equals the eager loop bit for bit.

The kernel itself (``ops/dropout.py``) runs only on a card:
tests/test_torch_dropout_kernel.py holds it to ``plain_dropout`` there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique_name
from paddle_tpu_torch.core import prng
from paddle_tpu_torch.ops import dropout as dropout_ops

from _torch_port import (B, GRAD_TOL, LR, STEPS, UPDATE_TOL, _build, _feed,
                         symbol_table)

torch.set_num_threads(1)

COUNTER = "_dropout_rng_counter"


def _jax_key(seed, counter):
    return jax.random.fold_in(jax.random.PRNGKey(seed),
                              jnp.asarray(counter).astype(jnp.uint32))


@pytest.mark.parametrize("shape", [(1,), (37,), (4099,), (3, 7), (5, 129),
                                   (2, 5, 9), (3, 1, 17)])
@pytest.mark.parametrize("seed,counter,p", [(0, 0, 0.9), (11, 3, 0.5),
                                            (2 ** 31 - 1, 64, 0.1)])
def test_bernoulli_is_bit_equal_to_jax(shape, seed, counter, p):
    want = np.asarray(jax.random.bernoulli(_jax_key(seed, counter), p,
                                           shape))
    key = prng.fold_in(prng.prng_key(torch.tensor(seed)),
                       torch.tensor(counter))
    got = prng.bernoulli(key, p, shape)
    assert got.dtype == torch.bool and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


def _inputs(seed=0, rows=6, cols=33, edges=True):
    x = np.random.RandomState(seed).randn(rows, cols).astype(np.float32)
    if edges:
        x[0, :6] = [-0.0, np.inf, -np.inf, np.nan, -1.5, 0.0]
    return x


def _same_bits(got, want):
    """Equal bits where ``want`` is not NaN, NaN where it is."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = np.isnan(want.astype(np.float32))
    np.testing.assert_array_equal(np.isnan(got.astype(np.float32)), nan)
    bits = (np.uint16 if got.dtype.itemsize == 2 else np.uint32)
    np.testing.assert_array_equal(got.view(bits)[~nan], want.view(bits)[~nan])


def _site_program(pkg, dtype, is_test=False):
    """Three dropout sites with an fc built between the first two (its
    parameters draw seeds between theirs; nothing reads its output),
    built with the same calls in one package: (main, startup,
    [outputs])."""
    fluid, guard = ((jfluid, j_unique_name.guard) if pkg == "jax"
                    else (tfluid, tfluid.unique_name.guard))
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        x = L.data(name="x", shape=[-1, 33], dtype="float32",
                   append_batch_size=False)
        h = x if dtype == "float32" else L.cast(x, dtype)
        a = L.dropout(h, dropout_prob=0.5, is_test=is_test)
        L.fc(input=x, size=16)
        b = L.dropout(h, dropout_prob=0.1, is_test=is_test, seed=7)
        c = L.dropout(h, dropout_prob=0.9, is_test=is_test)
    return main, startup, [a, b, c]


def _run_both(dtype, x, steps=3, is_test=False, clone=False):
    """Both packages' site outputs at each step and their counters."""
    jm, js, jouts = _site_program("jax", dtype, is_test)
    tm, ts, touts = _site_program("torch", dtype, is_test)
    assert symbol_table(tm) == symbol_table(jm)
    assert tm._seed_counter == jm._seed_counter
    if clone:
        jm, tm = jm.clone(for_test=True), tm.clone(for_test=True)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(js)
        params = {p.name: np.asarray(scope.find_var(p.name))
                  for p in jm.all_parameters()}
        jres = [[np.asarray(v) for v in exe.run(
            jm, feed={"x": x}, fetch_list=[o.name for o in jouts])]
            for _ in range(steps)]
        jcount = int(np.asarray(scope.find_var(COUNTER)))
    tscope, place = tfluid.Scope(), tfluid.CPUPlace()
    texe = tfluid.Executor(place)
    texe.run(ts, scope=tscope)
    tfluid.params_from_numpy(params, tscope, place, program=tm)
    tres = [texe.run(tm, feed={"x": x}, fetch_list=[o.name for o in touts],
                     scope=tscope, return_numpy=False)
            for _ in range(steps)]
    tcount = int(tscope.find_var(COUNTER))
    return jres, tres, jcount, tcount


def _np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_sites_are_bit_equal_to_jax_over_three_steps(dtype):
    """Every site's mask (its output on ones) bit-equal at each step, and the values on random inputs equal (XLA
    rewrites the JAX package's compiled f32 ``v * convert(mask)`` as
    ``select(mask, v, 0)``, so a dropped negative element is +0.0 there
    and -0.0 in the multiply: the sign of a zero is left out)."""
    ones = np.ones((6, 33), np.float32)
    jres, tres, jcount, tcount = _run_both(dtype, ones)
    for j_step, t_step in zip(jres, tres):
        for jv, tv in zip(j_step, t_step):
            _same_bits(_np(tv), jv)
    # the steps drew fresh masks
    assert not np.array_equal(_np(tres[0][0]), _np(tres[1][0]))
    assert tcount == jcount == 9
    x = _inputs(edges=False)
    jres, tres, _, _ = _run_both(dtype, x, steps=2)
    for j_step, t_step in zip(jres, tres):
        for jv, tv in zip(j_step, t_step):
            np.testing.assert_array_equal(_np(tv).astype(np.float32),
                                          jv.astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_op_is_bit_equal_to_the_jax_op(dtype):
    """The two packages' dropout ops, called on the same tensors at the
    same counter: the outputs bit for bit, -0.0, +-inf and NaN inputs
    included (inf * 0 = NaN, -x * 0 = -0.0), and counter + 1."""
    jm, _, _ = _site_program("jax", dtype)
    tm, _, _ = _site_program("torch", dtype)
    jops = [op for op in jm.global_block().ops if op.type == "dropout"]
    tops = [op for op in tm.global_block().ops if op.type == "dropout"]
    x = _inputs()
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    for jop, top in zip(jops, tops):
        for c in (0, 5, 2 ** 31 - 1):
            jout, jc = jop.fn(jnp.asarray(x).astype(jdt), jnp.int32(c))
            tout, tc = top.fn(torch.tensor(x).to(tdt),
                              torch.tensor(c, dtype=torch.int32))
            _same_bits(_np(tout), np.asarray(jout))
            assert tc.dtype == torch.int32 and int(tc) == int(jc)


@pytest.mark.parametrize("how", ["is_test", "clone"])
def test_inference_scales_by_keep_probability(how):
    x = _inputs()
    jres, tres, jcount, tcount = _run_both(
        "float32", x, steps=2, is_test=how == "is_test",
        clone=how == "clone")
    for j_step, t_step in zip(jres, tres):
        for jv, tv in zip(j_step, t_step):
            _same_bits(_np(tv), jv)
        np.testing.assert_array_equal(_np(t_step[0]), x * (1.0 - 0.5))
        np.testing.assert_array_equal(_np(t_step[1]), x * (1.0 - 0.1))
        np.testing.assert_array_equal(_np(t_step[2]),
                                      x * np.float32(1.0 - 0.9))
    assert tcount == jcount == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gradient_is_g_times_the_mask(dtype):
    rng = np.random.RandomState(3)
    x = torch.tensor(rng.randn(5, 41).astype(np.float32)).to(dtype)
    g = torch.tensor(rng.randn(5, 41).astype(np.float32)).to(dtype)
    counter = torch.tensor(4, dtype=torch.int32)
    xt = x.clone().requires_grad_(True)
    out, nxt = dropout_ops.dropout(xt, 123, counter, 0.3)
    out.backward(g)
    assert int(nxt) == 5 and int(counter) == 4
    mask = dropout_ops.plain_dropout(torch.ones_like(x), 123, counter, 0.3)
    torch.testing.assert_close(xt.grad, g * mask, rtol=0, atol=0)
    # and jax.grad of the JAX op's training branch
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def jop(v):
        keep = jax.random.bernoulli(_jax_key(123, 4), 1.0 - 0.3, v.shape)
        return v * keep.astype(v.dtype)

    _, vjp = jax.vjp(jop, jnp.asarray(x.float().numpy()).astype(jdt))
    want, = vjp(jnp.asarray(g.float().numpy()).astype(jdt))
    _same_bits(_np(xt.grad), np.asarray(want))


# ------------------------------------------- Transformer-base training


class _DropoutRun:
    """TB with dropout 0.1 and Adam in both packages from the JAX
    package's weights; STEPS steps of the loss and every gradient."""

    def __init__(self):
        import warnings

        kw = dict(dropout_rate=0.1)
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="flash_attention")
            self.j = _build("jax", "fused", **kw)
            self.t = _build("torch", "fused", **kw)
            feed = self.feed = _feed()
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
                self.j_count = int(np.asarray(self.j_scope.find_var(
                    COUNTER)))
        t_main, t_startup, t_cost, t_pg = self.t
        self.t_scope = self.fresh()
        exe = tfluid.Executor(tfluid.CPUPlace())
        fetch = [t_cost.name] + [g.name for _, g in t_pg]
        self.t_out = [exe.run(t_main, feed=feed, fetch_list=fetch,
                              scope=self.t_scope) for _ in range(STEPS)]

    def fresh(self):
        t_main, t_startup = self.t[:2]
        scope = tfluid.Scope()
        tfluid.Executor(tfluid.CPUPlace()).run(t_startup, scope=scope)
        tfluid.params_from_numpy(self.p0, scope, tfluid.CPUPlace(),
                                 program=t_main)
        return scope


@pytest.fixture(scope="module")
def run():
    return _DropoutRun()


def test_transformer_with_dropout_builds_the_jax_program(run):
    j_main, t_main = run.j[0], run.t[0]
    assert symbol_table(t_main) == symbol_table(j_main)
    assert [op.type for op in t_main.global_block().ops] == \
        [op.type for op in j_main.global_block().ops]
    # 2 layers: 4 sites an encoder layer, 6 a decoder layer, 2 at the
    # embedding inputs
    n_sites = sum(op.type == "dropout" for op in t_main.global_block().ops)
    assert n_sites == 2 * 4 + 2 * 6 + 2
    assert t_main._seed_counter == j_main._seed_counter


def test_transformer_with_dropout_trains_as_the_jax_package(run):
    names = [g.name for _, g in run.t[3]]
    for j_o, t_o in zip(run.j_out, run.t_out):
        np.testing.assert_allclose(t_o[0], j_o[0], **GRAD_TOL)
    for name, t_g, j_g in zip(names, run.t_out[0][1:], run.j_out[0][1:]):
        np.testing.assert_allclose(t_g, j_g, err_msg=name, **GRAD_TOL)
    for name, p0 in run.p0.items():
        j_up = (np.asarray(run.j_scope.find_var(name)) - p0) / LR
        t_up = (run.t_scope.find_var(name).numpy() - p0) / LR
        np.testing.assert_allclose(t_up, j_up, rtol=0, atol=UPDATE_TOL,
                                   err_msg=name)
    n_sites = sum(op.type == "dropout" for op in run.t[0].global_block().ops)
    assert int(run.t_scope.find_var(COUNTER)) == run.j_count \
        == STEPS * n_sites


def test_run_steps_equals_the_eager_loop_with_dropout(run):
    t_main, _, t_cost, _ = run.t
    scope = run.fresh()
    exe = tfluid.Executor(tfluid.CPUPlace())
    losses, = exe.run_steps(t_main, feed_list=[run.feed] * STEPS,
                            fetch_list=[t_cost], scope=scope)
    np.testing.assert_array_equal(losses, [o[0] for o in run.t_out])
    for p in t_main.all_parameters():
        np.testing.assert_array_equal(scope.find_var(p.name).numpy(),
                                      run.t_scope.find_var(p.name).numpy(),
                                      err_msg=p.name)
    assert int(scope.find_var(COUNTER)) == int(run.t_scope.find_var(COUNTER))
