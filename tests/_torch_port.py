"""Shared builders for the tests that hold paddle_tpu_torch to paddle_tpu:
the same small causal LM built with the same calls in both packages,
and the JAX package's (perturbed) weights carried into the port's scope
as numpy arrays."""

import numpy as np
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique_name
from paddle_tpu.models.causal_lm import causal_lm as j_causal_lm
from paddle_tpu_torch.models.causal_lm import causal_lm as t_causal_lm

VOCAB = 37
LM = dict(vocab_size=VOCAB, n_layer=2, n_head=2, d_model=32, d_inner_hid=64)
CACHE = dict(num_blocks=24, block_size=8, max_blocks_per_seq=4)


def jax_lm():
    """(program, scope, logits_var) of the JAX package, with every float
    parameter perturbed so greedy streams vary with the prompt (the
    recipe of tests/test_decoding.py)."""
    import jax.numpy as jnp

    main, startup = jfluid.Program(), jfluid.Program()
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope), j_unique_name.guard(), \
            jfluid.program_guard(main, startup):
        _, logits = j_causal_lm(**LM)
        jfluid.Executor().run(startup)
        rng = np.random.RandomState(11)
        for name in list(scope.local_var_names()):
            v = np.asarray(scope.find_var(name))
            if v.dtype.kind == "f":
                scope.set_var(name, jnp.asarray(
                    (v + rng.normal(0.0, 0.08, v.shape)).astype(v.dtype)))
    return main, scope, logits


def torch_lm():
    """(program, startup, logits_var) of the port, same builder calls."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        _, logits = t_causal_lm(**LM)
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
