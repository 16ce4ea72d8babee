"""Shared builders for the tests that hold paddle_tpu_torch to paddle_tpu:
the same small causal LM and the same tiny Transformer-base (``TB``)
built with the same calls in both packages, the JAX package's
(perturbed) weights carried into the port's scope as numpy arrays, and
a guard that sets one package's flags."""

import contextlib

import numpy as np
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import flags as j_flags
from paddle_tpu.core import unique_name as j_unique_name
from paddle_tpu.models.causal_lm import causal_lm as j_causal_lm
from paddle_tpu.models.transformer import transformer_base as j_transformer
from paddle_tpu_torch.models.causal_lm import causal_lm as t_causal_lm
from paddle_tpu_torch.models.transformer import \
    transformer_base as t_transformer

VOCAB = 37
LM = dict(vocab_size=VOCAB, n_layer=2, n_head=2, d_model=32, d_inner_hid=64)
# the one-layer draft of tests/test_decoding_fleet.py (perturbed with
# seed 5 there and here)
DRAFT_LM = dict(vocab_size=VOCAB, n_layer=1, n_head=2, d_model=16,
                d_inner_hid=32)
CACHE = dict(num_blocks=24, block_size=8, max_blocks_per_seq=4)


def jax_lm(seed=11, lm=LM):
    """(program, scope, logits_var) of the JAX package, with every float
    parameter perturbed so greedy streams vary with the prompt (the
    recipe of tests/test_decoding.py)."""
    import jax.numpy as jnp

    main, startup = jfluid.Program(), jfluid.Program()
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope), j_unique_name.guard(), \
            jfluid.program_guard(main, startup):
        _, logits = j_causal_lm(**lm)
        jfluid.Executor().run(startup)
        rng = np.random.RandomState(seed)
        for name in list(scope.local_var_names()):
            v = np.asarray(scope.find_var(name))
            if v.dtype.kind == "f":
                scope.set_var(name, jnp.asarray(
                    (v + rng.normal(0.0, 0.08, v.shape)).astype(v.dtype)))
    return main, scope, logits


def torch_lm(lm=LM):
    """(program, startup, logits_var) of the port, same builder calls."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        _, logits = t_causal_lm(**lm)
    return main, startup, logits


def carried_scope(j_main, j_scope, t_main):
    """A port scope on the CPU holding the JAX package's parameters."""
    arrays = {p.name: np.asarray(j_scope.find_var(p.name))
              for p in j_main.all_parameters()}
    scope = tfluid.Scope()
    tfluid.params_from_numpy(arrays, scope, tfluid.CPUPlace(),
                             program=t_main)
    return scope


def symbol_table(program):
    def dt(d):
        return "bfloat16" if d is torch.bfloat16 else np.dtype(d).name

    return sorted((v.name, v.shape, dt(v.dtype), bool(v.persistable))
                  for v in program.list_vars())


# ------------------------------------------- the tiny Transformer-base

TB = dict(src_vocab_size=50, trg_vocab_size=50, max_length=16, n_layer=2,
          n_head=2, d_model=32, d_inner_hid=64, dropout_rate=0.0)
B, T_SRC, T_TRG = 3, 9, 7
LR = 1e-3
STEPS = 3
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
UPDATE_TOL = 0.02  # |update_port - update_jax| / lr, element by element


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    ids = lambda t: rng.randint(1, 50, (B, t)).astype(np.int64)  # noqa: E731
    src_len, trg_len = np.array([9, 5, 3]), np.array([7, 4, 6])
    return {"src_word": ids(T_SRC), "trg_word": ids(T_TRG),
            "lbl_word": ids(T_TRG),
            "src_mask": (np.arange(T_SRC)[None] < src_len[:, None]
                         ).astype(np.float32),
            "trg_mask": (np.arange(T_TRG)[None] < trg_len[:, None]
                         ).astype(np.float32)}


def _build(pkg, attn_impl, opt=None, **kw):
    """(main, startup, avg_cost, params_grads) of one package; ``opt``
    makes the optimizer from the package (default ``Adam(LR)``)."""
    fluid, build, guard = ((jfluid, j_transformer, j_unique_name.guard)
                           if pkg == "jax" else
                           (tfluid, t_transformer, tfluid.unique_name.guard))
    opt = opt or (lambda f: f.optimizer.Adam(learning_rate=LR))
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        _, avg_cost, _ = build(**{**TB, **kw}, attn_impl=attn_impl)
        _, params_grads = opt(fluid).minimize(avg_cost)
    return main, startup, avg_cost, params_grads


@contextlib.contextmanager
def _flags(pkg, values):
    """The flags ``values`` set in one package's registry, then
    restored. The JAX package reads the bf16 rule when it traces (the
    first run), so its runs stay inside; the port reads every flag when
    the program is built."""
    reg = j_flags if pkg == "jax" else tfluid
    saved = {n: reg.get_flag(n) for n in values}
    reg.set_flags(dict(values))
    try:
        yield
    finally:
        reg.set_flags(saved)
