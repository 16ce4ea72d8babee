"""paddle_tpu_torch's Program IR, layers, executor and weight carry-over,
held to paddle_tpu: the same builder calls give the same symbol table
and op sequence, and the JAX package's weights carried across give the
same forward logits (f32, rtol/atol 1e-5 — the two packages sum in
different orders)."""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique_name
from paddle_tpu_torch.core.enforce import EnforceError

from _torch_port import (LM, VOCAB, carried_scope, jax_lm, symbol_table,
                         torch_lm)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    j_main, j_scope, j_logits = jax_lm()
    t_main, t_startup, t_logits = torch_lm()
    scope = carried_scope(j_main, j_scope, t_main)
    return j_main, j_scope, j_logits, t_main, t_startup, t_logits, scope


def test_symbol_tables_and_op_sequences_match(pair):
    j_main, _, j_logits, t_main, _, t_logits, _ = pair
    assert symbol_table(t_main) == symbol_table(j_main)
    assert [op.type for op in t_main.global_block().ops] == \
        [op.type for op in j_main.global_block().ops]
    assert t_logits.name == j_logits.name
    assert t_logits.shape == j_logits.shape == (-1, -1, VOCAB)
    assert [p.name for p in t_main.all_parameters()] == \
        [p.name for p in j_main.all_parameters()]


def test_startup_programs_match(pair):
    """The startup program initializes every parameter (values differ:
    another generator), and running it fills a port scope with tensors
    of the declared shapes."""
    j_main, _, _, t_main, t_startup, _, _ = pair
    j_startup = jfluid.Program()
    with j_unique_name.guard(), jfluid.program_guard(jfluid.Program(),
                                                     j_startup):
        from paddle_tpu.models.causal_lm import causal_lm
        causal_lm(**LM)
    assert symbol_table(t_startup) == symbol_table(j_startup)
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(t_startup, scope=scope)
    for p in t_main.all_parameters():
        v = scope.find_var(p.name)
        assert isinstance(v, torch.Tensor) and tuple(v.shape) == p.shape


@pytest.mark.parametrize("prompts", [[[3, 1, 4, 1, 5, 9, 2]],
                                     [[7, 3], [2, 2], [36, 0]],
                                     [[0, 36, 5, 5], [11, 12, 13, 14]]],
                         ids=["one_row", "three_rows", "two_rows"])
def test_forward_logits_match(pair, prompts):
    j_main, j_scope, j_logits, t_main, _, t_logits, scope = pair
    tokens = np.asarray(prompts, np.int64)
    with jfluid.scope_guard(j_scope):
        ref = jfluid.Executor().run(j_main, feed={"tokens": tokens},
                                    fetch_list=[j_logits])[0]
    out = tfluid.Executor(tfluid.CPUPlace()).run(
        t_main, feed={"tokens": tokens}, fetch_list=[t_logits],
        scope=scope)[0]
    assert out.shape == np.asarray(ref).shape
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_executor_default_place_refuses_cpu_host():
    """The default place is CUDAPlace(0): on a host without a card,
    constructing it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default place is valid")
    with pytest.raises(EnforceError, match="CUDAPlace"):
        tfluid.Executor()
    with pytest.raises(EnforceError, match="CPUPlace"):
        tfluid.CUDAPlace(0)


def test_params_from_numpy_refuses_mismatches(pair):
    j_main, j_scope, _, t_main, _, _, _ = pair
    arrays = {p.name: np.asarray(j_scope.find_var(p.name))
              for p in j_main.all_parameters()}
    place = tfluid.CPUPlace()
    name = "lm_word_emb_table"
    cases = {
        "missing parameters": {k: v for k, v in arrays.items()
                               if k != name},
        "not parameters": dict(arrays, extra_w=np.zeros(3, np.float32)),
        "shape": dict(arrays, **{name: arrays[name][:-1]}),
        "dtype": dict(arrays, **{name: arrays[name].astype(np.float64)}),
    }
    for match, bad in cases.items():
        scope = tfluid.Scope()
        with pytest.raises(EnforceError, match=match):
            tfluid.params_from_numpy(bad, scope, place, program=t_main)
        assert list(scope.local_var_names()) == []  # nothing loaded


def test_executor_reports_missing_inputs(pair):
    _, _, _, t_main, _, t_logits, _ = pair
    exe = tfluid.Executor(tfluid.CPUPlace())
    with pytest.raises(EnforceError, match="startup program"):
        exe.run(t_main, feed={"tokens": np.zeros((1, 2), np.int64)},
                fetch_list=[t_logits], scope=tfluid.Scope())


def test_embedding_trailing_one_squeeze_matches():
    """``[B, 1]`` ids squeeze to ``[B, d]`` in both packages (the quirk
    the decode rewrite swaps out), at build time and at run time."""
    def build(fluid, unique_name):
        main = fluid.Program()
        with unique_name.guard(), fluid.program_guard(main, fluid.Program()):
            ids = fluid.layers.data(name="ids", shape=[-1, 1],
                                    dtype="int64", append_batch_size=False)
            emb = fluid.layers.embedding(input=ids, size=[10, 4])
        return main, emb

    (jm, je), (tm, te) = (build(jfluid, j_unique_name),
                          build(tfluid, tfluid.unique_name))
    assert te.shape == je.shape == (-1, 4)
    assert symbol_table(tm) == symbol_table(jm)
    scope = tfluid.Scope()
    scope.set_var("embedding.w_0", torch.arange(40.0).reshape(10, 4))
    out = tfluid.Executor(tfluid.CPUPlace()).run(
        tm, feed={"ids": np.asarray([[3], [7]], np.int64)},
        fetch_list=[te], scope=scope)[0]
    np.testing.assert_array_equal(out, np.arange(40.0).reshape(10, 4)[[3, 7]])


def test_unported_options_raise():
    from paddle_tpu_torch.models.transformer import multi_head_attention

    main = tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main,
                                                          tfluid.Program()):
        x = tfluid.layers.data(name="x", shape=[-1, 4, 8], dtype="float32",
                               append_batch_size=False)
        for impl in ("pallas", "ring"):
            with pytest.raises(NotImplementedError, match="not ported"):
                multi_head_attention(x, x, x, 4, 4, 8, n_head=2,
                                     attn_impl=impl)
        with pytest.raises(NotImplementedError, match="not ported"):
            tfluid.layers.dropout(x, dropout_prob=0.1, is_test=False)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_shape_inference_warn_raise_split_matches(package):
    """Build-time shape inference, in both packages: an incompatible
    static-shape op warns by default and raises under ``debug_fallback``;
    a symbolic batch (-1) meeting a concrete one stays silent, and a
    symbolic dim comes back as -1 in the inferred shape."""
    import warnings

    if package == "jax":
        fluid, set_flags = jfluid, jfluid.set_flags
        from paddle_tpu.core.enforce import EnforceError as Error
    else:
        from paddle_tpu_torch.core import flags

        fluid, set_flags, Error = tfluid, flags.set_flags, EnforceError

    def build(shape_a, shape_b):
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            a = fluid.layers.data(name="a", shape=shape_a, dtype="float32",
                                  append_batch_size=False)
            b = fluid.layers.data(name="b", shape=shape_b, dtype="float32",
                                  append_batch_size=False)
            return fluid.layers.elementwise_add(a, b)

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        build([3, 4], [5, 6])
    assert any("shape inference skipped" in str(x.message) for x in w)
    set_flags({"debug_fallback": True})
    try:
        with pytest.raises(Error, match="shape inference failed"):
            build([3, 4], [5, 6])
    finally:
        set_flags({"debug_fallback": False})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert build([-1, 4], [-1, 4]).shape == (-1, 4)
        build([-1, 4], [2, 4])
