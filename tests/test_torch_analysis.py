"""paddle_tpu_torch.analysis — the static program verifier and the
liveness report — held to paddle_tpu.analysis on the same programs.

* The seeded-defect corpus of tests/test_analysis.py (one defect per
  diagnostic class) is built in both packages, with torch fns in the
  port where the JAX package's fixtures use numpy ones, and gives the
  same diagnostics: codes, severities, blocks, op indices, op types,
  var names and messages (a message from abstract evaluation is the
  framework's own error text and is compared by code only).
* The clean suite (mlp, mnist_cnn, resnet_cifar10, resnet_imagenet at
  64x64, word2vec, deepfm, fit_a_line) gives zero diagnostics in both
  packages. The small Transformer-base and BERT give the same warnings
  in both (their feeds' free sequence axis: recompile-hazard; the
  dropout counter read by the snapshot op before its chain:
  donation-alias) and no error in the port. With dropout the JAX
  package also reports write-after-write on ``_dropout_rng_counter``,
  whose sites form a read-modify-write chain — a false positive of the
  JAX package that the port does not repeat (ROADMAP Queue C).
* Shape/dtype inference gives the JAX package's types on a training
  program, op outputs and all.
* ``Program.validate``, the Executor's ``check_program`` flag (it stops
  a defective program before any op runs) and the Queue A 9 refusals.
* ``analyze_liveness`` equals the JAX package's — per-op bytes, peaks,
  lifetimes, render text — on the hand fixtures (the three-op MLP, the
  training fixture under remat False / True / segments x donation on /
  off, assume_batch, a ``{name: shard_count}`` sharding) and on the
  small Transformer-base's training program; ``memory_optimize(
  print_log=True)`` prints the JAX package's text.
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu.analysis import diagnostics as j_diag
from paddle_tpu_torch.analysis import diagnostics as t_diag
from paddle_tpu_torch.core.enforce import EnforceError

from _torch_port import TB, package

torch.set_num_threads(1)

PKGS = ("jax", "torch")


def _fresh(pkg):
    fluid, _ = package(pkg)
    return fluid.Program(), fluid.Program()


def _np(pkg):
    """(matmul, mean, full, to_int32) of one package's array library."""
    if pkg == "jax":
        return (np.matmul, np.mean,
                lambda shape, v: np.full(shape, v, "float32"),
                lambda v: v.astype(np.int32))
    return (torch.matmul, torch.mean,
            lambda shape, v: torch.full(shape, v, dtype=torch.float32),
            lambda v: v.to(torch.int32))


def _key(d):
    """What must agree between the packages for one diagnostic."""
    msg = None if "abstract evaluation failed" in d.message else d.message
    return (d.severity, d.code, d.block_idx, d.op_idx, d.op_type, d.var,
            msg)


def _keys(report):
    return sorted(_key(d) for d in report.diagnostics)


# ---------------------------------------------------------------------------
# the negative corpus, one seeded defect per diagnostic class
# ---------------------------------------------------------------------------


def _undefined_var(pkg):
    main, _ = _fresh(pkg)
    gb = main.global_block()
    out = gb.create_var(name="o", shape=(4,), dtype="float32")
    gb.append_op(type="scale", inputs={"X": ["ghost_var"]},
                 outputs={"Out": [out.name]}, fn=lambda v: v)
    return main, {}


def _subblock_unresolved(pkg):
    main, _ = _fresh(pkg)
    gb = main.global_block()
    gb.create_var(name="x", shape=(4,), dtype="float32", is_data=True)
    sub = main._create_block()
    sub.append_op(type="scale", inputs={"X": ["ghost_sub_var"]},
                  outputs={"Out": ["sub_o"]}, fn=lambda v: v)
    main._rollback()
    return main, {}


def _use_before_def(pkg):
    main, _ = _fresh(pkg)
    gb = main.global_block()
    x = gb.create_var(name="x", shape=(4,), dtype="float32", is_data=True)
    b = gb.create_var(name="b", shape=(4,), dtype="float32")
    c = gb.create_var(name="c", shape=(4,), dtype="float32")
    gb.append_op(type="scale", inputs={"X": [b.name]},
                 outputs={"Out": [c.name]}, fn=lambda v: v * 2.0)
    gb.append_op(type="scale", inputs={"X": [x.name]},
                 outputs={"Out": [b.name]}, fn=lambda v: v + 1.0)
    return main, {}


def _write_after_write(pkg):
    full = _np(pkg)[2]
    main, _ = _fresh(pkg)
    gb = main.global_block()
    w = gb.create_var(name="w", shape=(4,), dtype="float32",
                      persistable=True)
    for value in (0.0, 1.0):
        gb.append_op(type="fill_constant", inputs={},
                     outputs={"Out": [w.name]},
                     attrs={"shape": (4,), "value": value},
                     fn=lambda _v=value: full((4,), _v))
    return main, {}


def _dangling_fetch(pkg):
    main, _ = _fresh(pkg)
    gb = main.global_block()
    x = gb.create_var(name="x", shape=(4,), dtype="float32", is_data=True)
    gb.append_op(type="scale", inputs={"X": [x.name]},
                 outputs={"Out": [gb.create_var(
                     name="y", shape=(4,), dtype="float32").name]},
                 fn=lambda v: v)
    return main, {"fetch_list": ["no_such_out"]}


def _donation_alias(pkg):
    full = _np(pkg)[2]
    main, _ = _fresh(pkg)
    gb = main.global_block()
    w = gb.create_var(name="w", shape=(4,), dtype="float32",
                      persistable=True)
    a = gb.create_var(name="a", shape=(4,), dtype="float32")
    b = gb.create_var(name="b", shape=(4,), dtype="float32")
    gb.append_op(type="scale", inputs={"X": [w.name]},
                 outputs={"Out": [a.name]}, fn=lambda v: v * 2.0)
    gb.append_op(type="fill_constant", inputs={},
                 outputs={"Out": [w.name]},
                 attrs={"shape": (4,), "value": 7.0},
                 fn=lambda: full((4,), 7.0))
    gb.append_op(type="scale", inputs={"X": [w.name]},
                 outputs={"Out": [b.name]}, fn=lambda v: v * 3.0)
    return main, {}


def _shape_mismatch_declared(pkg):
    main, _ = _fresh(pkg)
    gb = main.global_block()
    x = gb.create_var(name="x", shape=(4, 8), dtype="float32",
                      is_data=True)
    bad = gb.create_var(name="bad", shape=(3, 8), dtype="float32")
    gb.append_op(type="elementwise_add",
                 inputs={"X": [x.name], "Y": [x.name]},
                 outputs={"Out": [bad.name]}, fn=lambda p, q: p + q)
    return main, {}


def _shape_mismatch_contract(pkg):
    main, _ = _fresh(pkg)
    gb = main.global_block()
    x = gb.create_var(name="x", shape=(4, 8), dtype="float32",
                      is_data=True)
    y = gb.create_var(name="y", shape=(3, 8), dtype="float32",
                      is_data=True)
    out = gb.create_var(name="o", shape=(4, 8), dtype="float32")
    gb.append_op(type="elementwise_add",
                 inputs={"X": [x.name], "Y": [y.name]},
                 outputs={"Out": [out.name]}, fn=lambda p, q: p + q)
    return main, {}


def _shape_mismatch_abstract_eval(pkg):
    """An op with no rule whose fn itself rejects the shapes: found by
    abstract evaluation (meta tensors in the port, eval_shape in the
    JAX package, over jnp: numpy would need concrete values)."""
    import jax.numpy as jnp

    matmul = jnp.matmul if pkg == "jax" else torch.matmul
    main, _ = _fresh(pkg)
    gb = main.global_block()
    a = gb.create_var(name="a", shape=(4, 8), dtype="float32",
                      is_data=True)
    b = gb.create_var(name="b", shape=(7, 5), dtype="float32",
                      is_data=True)
    out = gb.create_var(name="o", shape=(4, 5), dtype="float32")
    gb.append_op(type="my_projection",
                 inputs={"X": [a.name], "Y": [b.name]},
                 outputs={"Out": [out.name]}, fn=lambda p, q: matmul(p, q))
    return main, {}


def _matmul_contraction(pkg):
    matmul = _np(pkg)[0]
    main, _ = _fresh(pkg)
    gb = main.global_block()
    a = gb.create_var(name="a", shape=(4, 8), dtype="float32",
                      is_data=True)
    b = gb.create_var(name="b", shape=(7, 5), dtype="float32",
                      is_data=True)
    out = gb.create_var(name="o", shape=(4, 5), dtype="float32")
    gb.append_op(type="matmul", inputs={"X": [a.name], "Y": [b.name]},
                 outputs={"Out": [out.name]}, fn=lambda p, q: matmul(p, q))
    return main, {}


def _dtype_mismatch(pkg):
    to_int32 = _np(pkg)[3]
    main, _ = _fresh(pkg)
    gb = main.global_block()
    x = gb.create_var(name="x", shape=(4,), dtype="float32", is_data=True)
    out = gb.create_var(name="o", shape=(4,), dtype="float32")
    gb.append_op(type="cast", inputs={"X": [x.name]},
                 outputs={"Out": [out.name]}, attrs={"dtype": "int32"},
                 fn=to_int32)
    return main, {}


def _maybe_uninitialized(pkg):
    main, _ = _fresh(pkg)
    gb = main.global_block()
    u = gb.create_var(name="u", shape=(4,), dtype="float32")
    gb.append_op(type="scale", inputs={"X": [u.name]},
                 outputs={"Out": [gb.create_var(
                     name="v", shape=(4,), dtype="float32").name]},
                 fn=lambda v: v)
    return main, {}


def _maybe_uninitialized_fed(pkg):
    main, kw = _maybe_uninitialized(pkg)
    return main, {"feed": ["u"]}


def _data_program(pkg, shape, dtype="float32", name="x"):
    fluid, guard = package(pkg)
    main, startup = _fresh(pkg)
    with guard(), fluid.program_guard(main, startup):
        fluid.layers.data(name=name, shape=shape, dtype=dtype)
    return main


def _strict_batch(pkg):
    return _data_program(pkg, [8]), {"strict_batch": True}


def _strict_batch_bucketed(pkg):
    return _data_program(pkg, [8]), {"strict_batch": True,
                                     "buckets": [1, 2, 4]}


def _dynamic_batch_default(pkg):
    return _data_program(pkg, [8]), {}


def _feed_without_shape(pkg):
    main, _ = _fresh(pkg)
    gb = main.global_block()
    ext = gb.create_var(name="ext", dtype="float32")  # shapeless
    gb.append_op(type="scale", inputs={"X": [ext.name]},
                 outputs={"Out": [gb.create_var(
                     name="o2", dtype="float32").name]}, fn=lambda v: v)
    return main, {"feed": ["ext"]}


def _free_sequence_axis(pkg):
    return _data_program(pkg, [-1, 1], "int64", "seq"), {}


def _unknown_ops(pkg):
    main, _ = _fresh(pkg)
    gb = main.global_block()
    x = gb.create_var(name="x", shape=(4, 8), dtype="float32",
                      is_data=True)
    mystery = gb.create_var(name="m", dtype="float32")  # shapeless
    gb.append_op(type="totally_unregistered_op",
                 inputs={"X": [x.name]}, outputs={"Out": [mystery.name]},
                 fn=None)
    out = gb.create_var(name="o", dtype="float32")
    gb.append_op(type="another_unknown_op",
                 inputs={"X": [mystery.name]},
                 outputs={"Out": [out.name]}, fn=None)
    return main, {}


# case -> (builder, the codes the JAX package's report holds)
NEGATIVE = {
    "undefined_var": (_undefined_var, ["undefined-var"]),
    "subblock_unresolved": (_subblock_unresolved, ["subblock-unresolved"]),
    "use_before_def": (_use_before_def, ["use-before-def"]),
    "write_after_write": (_write_after_write, ["write-after-write"]),
    "dangling_fetch": (_dangling_fetch, ["dangling-fetch"]),
    "donation_alias": (_donation_alias, ["donation-alias"]),
    "shape_mismatch_declared": (_shape_mismatch_declared,
                                ["shape-mismatch"]),
    "shape_mismatch_contract": (_shape_mismatch_contract,
                                ["shape-mismatch"]),
    "shape_mismatch_abstract_eval": (_shape_mismatch_abstract_eval,
                                     ["shape-mismatch"]),
    "matmul_contraction": (_matmul_contraction, ["shape-mismatch"]),
    "dtype_mismatch": (_dtype_mismatch, ["dtype-mismatch"]),
    "maybe_uninitialized": (_maybe_uninitialized,
                            ["maybe-uninitialized"]),
    "maybe_uninitialized_fed": (_maybe_uninitialized_fed, []),
    "strict_batch": (_strict_batch, ["recompile-hazard"]),
    "strict_batch_bucketed": (_strict_batch_bucketed, []),
    "dynamic_batch_default": (_dynamic_batch_default, []),
    "feed_without_shape": (_feed_without_shape, ["recompile-hazard"]),
    "free_sequence_axis": (_free_sequence_axis, ["recompile-hazard"]),
    "unknown_ops": (_unknown_ops, []),
}


@pytest.mark.parametrize("case", sorted(NEGATIVE))
def test_negative_corpus_gives_the_jax_diagnostics(case):
    build, codes = NEGATIVE[case]
    reports = {}
    for pkg in PKGS:
        main, kw = build(pkg)
        fluid, _ = package(pkg)
        reports[pkg] = fluid.analysis.check_program(main, **kw)
    assert sorted(d.code for d in reports["jax"].diagnostics) == codes, \
        str(reports["jax"])
    assert _keys(reports["torch"]) == _keys(reports["jax"]), \
        "jax:\n%s\ntorch:\n%s" % (reports["jax"], reports["torch"])
    if case == "unknown_ops":
        # an unknown op degrades to the unknown lattice value, no guess
        assert reports["torch"].inferred.type_of("m").shape is None


def test_diagnostic_codes_are_the_jax_package_codes():
    for name in ("UNDEFINED_VAR", "USE_BEFORE_DEF", "WRITE_AFTER_WRITE",
                 "DANGLING_FETCH", "SUBBLOCK_UNRESOLVED", "DONATION_ALIAS",
                 "SHAPE_MISMATCH", "DTYPE_MISMATCH", "MAYBE_UNINITIALIZED",
                 "RECOMPILE_HAZARD", "ERROR", "WARNING"):
        assert getattr(t_diag, name) == getattr(j_diag, name)


def test_serving_bucket_cross_check_matches():
    for pkg in PKGS:
        fluid, _ = package(pkg)
        main, _ = _fresh(pkg)
        main.global_block().create_var(name="pinned", shape=(3, 8),
                                       dtype="float32", is_data=True)
        found = fluid.analysis.check_serving_buckets(main, ["pinned"],
                                                     [1, 2, 4])
        assert [(d.code, d.var) for d in found] == [
            ("recompile-hazard", "pinned")]
        assert "pinned to 3" in found[0].message
        assert not fluid.analysis.check_serving_buckets(
            main, ["pinned"], [1, 2, 3, 4])


def test_write_after_write_still_fires_on_a_blind_second_write():
    """The port exempts a read-modify-write chain (each later write
    reads the value first); a blind write after a chained one is still
    an overwrite."""
    main, _ = _fresh("torch")
    gb = main.global_block()
    gb.create_var(name="c", shape=(), dtype="int32", persistable=True)
    for _ in range(2):
        gb.append_op(type="increment", inputs={"X": ["c"]},
                     outputs={"Out": ["c"]}, fn=lambda v: v + 1)
    assert tfluid.analysis.check_program(main).ok
    gb.append_op(type="fill_constant", inputs={}, outputs={"Out": ["c"]},
                 attrs={"shape": (), "value": 0, "dtype": "int32"},
                 fn=lambda: torch.zeros((), dtype=torch.int32))
    (d,) = tfluid.analysis.check_program(main).errors
    assert (d.code, d.var, d.op_idx) == ("write-after-write", "c", 2)


# ---------------------------------------------------------------------------
# models: the clean suite and the training programs
# ---------------------------------------------------------------------------


def _models(pkg, name):
    from importlib import import_module

    root = "paddle_tpu" if pkg == "jax" else "paddle_tpu_torch"
    return import_module(root + ".models." + name)


def _mlp(pkg, fluid):
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    h = fluid.layers.fc(input=x, size=16, act="relu")
    pred = fluid.layers.fc(input=h, size=1)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    fluid.SGD(learning_rate=0.1).minimize(loss)
    return ["x", "y"], [loss.name]


def _mnist_cnn(pkg, fluid):
    img = fluid.layers.data(name="img", shape=[1, 28, 28],
                            dtype="float32")
    lbl = fluid.layers.data(name="lbl", shape=[1], dtype="int64")
    pred = _models(pkg, "mnist").mnist_cnn(img)
    loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, lbl))
    fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return ["img", "lbl"], [loss.name]


def _resnet(cifar, depth, hw):
    def build(pkg, fluid):
        image, label, avg_cost, _ = _models(pkg, "resnet").build_train(
            class_dim=10, depth=depth, image_shape=(3, hw, hw),
            cifar=cifar)
        fluid.optimizer.Momentum(learning_rate=0.1,
                                 momentum=0.9).minimize(avg_cost)
        return [image.name, label.name], [avg_cost.name]
    return build


def _word2vec(pkg, fluid):
    _models(pkg, "word2vec").build_train(dict_size=100, embed_size=8,
                                         hidden_size=16)
    return [], []


def _deepfm(pkg, fluid):
    _models(pkg, "deepfm").deepfm(num_features=1000, num_fields=10,
                                  embed_dim=8, mlp_dims=(32, 16))
    return [], []


def _fit_a_line(pkg, fluid):
    x, y, avg_cost, _ = _models(pkg, "fit_a_line").build_train()
    fluid.optimizer.SGD(learning_rate=0.05).minimize(avg_cost)
    return [x.name, y.name], [avg_cost.name]


def _transformer(dropout):
    def build(pkg, fluid):
        _, avg_cost, _ = _models(pkg, "transformer").transformer_base(
            **dict(TB, dropout_rate=dropout), attn_impl="pallas")
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
        return (["src_word", "trg_word", "lbl_word", "src_mask",
                 "trg_mask"], [avg_cost.name])
    return build


BERT = dict(vocab_size=128, n_layer=2, n_head=2, d_model=32, d_inner=64,
            max_pos=16, max_predictions=4)


def _bert(dropout):
    def build(pkg, fluid):
        _, total, _ = _models(pkg, "bert").bert_pretrain(
            **BERT, dropout=dropout, attn_impl="pallas")
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(total)
        return [], [total.name]
    return build


CLEAN = {"mlp": _mlp, "mnist_cnn": _mnist_cnn,
         "resnet_cifar10": _resnet(True, 20, 32),
         "resnet_imagenet": _resnet(False, 50, 64),
         "word2vec": _word2vec, "deepfm": _deepfm,
         "fit_a_line": _fit_a_line}
TRAINING = {"transformer_p0": _transformer(0.0),
            "transformer_p01": _transformer(0.1),
            "bert_p0": _bert(0.0), "bert_p01": _bert(0.1)}


def _build(pkg, builder):
    fluid, guard = package(pkg)
    main, startup = fluid.Program(), fluid.Program()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="flash_attention")
        with guard(), fluid.program_guard(main, startup):
            feeds, fetches = builder(pkg, fluid)
    return main, startup, feeds, fetches


def _check_both(builder):
    out = {}
    for pkg in PKGS:
        fluid, _ = package(pkg)
        main, startup, feeds, fetches = _build(pkg, builder)
        out[pkg] = (fluid.analysis.check_program(main, feed=feeds,
                                                 fetch_list=fetches),
                    fluid.analysis.check_program(startup))
    return out


@pytest.mark.parametrize("name", sorted(CLEAN))
def test_clean_programs_give_zero_diagnostics_in_both(name):
    for pkg, (main_rep, startup_rep) in _check_both(CLEAN[name]).items():
        assert not main_rep.diagnostics, "%s %s main:\n%s" % (
            pkg, name, main_rep)
        assert not startup_rep.diagnostics, "%s %s startup:\n%s" % (
            pkg, name, startup_rep)


@pytest.mark.parametrize("name", sorted(TRAINING))
def test_training_programs_lint_as_the_jax_package(name):
    reports = _check_both(TRAINING[name])
    (j_main, j_start), (t_main, t_start) = reports["jax"], reports["torch"]
    assert not j_start.diagnostics and not t_start.diagnostics
    assert t_main.ok, str(t_main)
    warn = lambda r: sorted(_key(d) for d in r.warnings)  # noqa: E731
    assert warn(t_main) == warn(j_main)
    assert {d.code for d in t_main.warnings} == {"recompile-hazard"} | (
        {"donation-alias"} if name.endswith("p01") else set())
    # the JAX package's only error: the dropout counter's chain
    assert [(d.code, d.var) for d in j_main.errors] == (
        [("write-after-write", "_dropout_rng_counter")]
        if name.endswith("p01") else [])


def test_inferred_types_equal_the_jax_package_on_a_training_program():
    types = {}
    for pkg in PKGS:
        fluid, _ = package(pkg)
        main = _build(pkg, _transformer(0.1))[0]
        res = fluid.analysis.infer_program_types(main)
        types[pkg] = {k: (t.shape, None if t.dtype is None else
                          tfluid.core.dtype_utils.name(t.dtype)
                          if pkg == "torch" else np.dtype(t.dtype).name)
                      for k, t in res.types.items()}
    assert types["torch"] == types["jax"]
    assert all(s is not None for s, _ in types["torch"].values())


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_program_validate_raises_on_error():
    main, _ = _undefined_var("torch")
    with pytest.raises(EnforceError, match="undefined-var"):
        main.validate()
    report = main.validate(raise_on_error=False)
    assert not report.ok and report.by_code("undefined-var")
    clean = _build("torch", _mlp)
    assert clean[0].validate(feed=clean[2], fetch_list=clean[3]).ok


def test_executor_check_program_flag_stops_a_defect_before_any_op():
    fluid = tfluid
    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        pred = fluid.layers.fc(input=x, size=2)
    saved = fluid.get_flag("check_program")
    fluid.set_flags({"check_program": True})
    try:
        exe.run(startup, scope=scope)
        feed = {"x": np.ones((4, 8), "float32")}
        out, = exe.run(main, feed=feed, fetch_list=[pred], scope=scope)
        assert out.shape == (4, 2)
        ran = []  # the devices the probe op ran on (meta: the check)
        gb = main.global_block()
        z = gb.create_var(name="z", shape=(4, 2), dtype="float32")
        seen = gb.create_var(name="seen", shape=(-1, 8), dtype="float32")
        gb.prepend_op(type="probe", inputs={"X": ["x"]},
                      outputs={"Out": [seen.name]},
                      fn=lambda v: ran.append(v.device.type) or v)
        # operands that cannot broadcast: [-1, 2] + [-1, 8]
        gb.append_op(type="elementwise_add",
                     inputs={"X": [pred.name], "Y": [x.name]},
                     outputs={"Out": [z.name]}, fn=lambda a, b: a + b)
        fetch = [z, seen]
        for call in (lambda: exe.run(main, feed=feed, fetch_list=fetch,
                                     scope=scope),
                     lambda: exe.run_steps(main, feed=feed, steps=2,
                                           fetch_list=fetch,
                                           scope=scope)):
            with pytest.raises(EnforceError, match="check_program"):
                call()
        assert "cpu" not in ran  # the check ran before any op
        fluid.set_flags({"check_program": False})
        with pytest.raises(RuntimeError, match="size of tensor"):
            exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        assert "cpu" in ran  # unchecked, the run got as far as the probe
    finally:
        fluid.set_flags({"check_program": saved})


def test_comm_analysis_and_sharding_plans_raise_naming_queue_a9():
    """The communication analysis still raises, naming Queue A 9. A
    sharding plan, once refused too, is ported: the report divides by
    its shard counts (tests/test_torch_sharding.py holds the per-device
    bytes to the JAX package's)."""
    main = _build("torch", _mlp)[0]
    with pytest.raises(NotImplementedError, match="Queue A 9"):
        tfluid.analysis.check_program(main, with_comm=True)
    with pytest.raises(NotImplementedError, match="Queue A 9"):
        main.validate(with_comm=True)

    class Plan:
        def shard_counts(self, program):
            return {}

    rep = tfluid.analysis.analyze_liveness(main, sharding=Plan())
    assert rep.n_shards == 1 and \
        rep.peak_device_bytes == rep.peak_bytes


# ---------------------------------------------------------------------------
# liveness
# ---------------------------------------------------------------------------


def _three_op_mlp(pkg):
    """x[4,8] @ w1[8,16] -> h; h @ w2[16,1] -> p; mean(p) -> loss."""
    matmul, mean = _np(pkg)[:2]
    main, _ = _fresh(pkg)
    gb = main.global_block()
    gb.create_var(name="x", shape=(4, 8), dtype="float32", is_data=True)
    gb.create_var(name="w1", shape=(8, 16), dtype="float32",
                  persistable=True)
    gb.create_var(name="w2", shape=(16, 1), dtype="float32",
                  persistable=True)
    gb.create_var(name="h", shape=(4, 16), dtype="float32")
    gb.create_var(name="p", shape=(4, 1), dtype="float32")
    gb.create_var(name="loss", shape=(), dtype="float32")
    gb.append_op(type="matmul", inputs={"X": ["x"], "Y": ["w1"]},
                 outputs={"Out": ["h"]}, fn=matmul)
    gb.append_op(type="matmul", inputs={"X": ["h"], "Y": ["w2"]},
                 outputs={"Out": ["p"]}, fn=matmul)
    gb.append_op(type="mean", inputs={"X": ["p"]},
                 outputs={"Out": ["loss"]}, fn=mean)
    return main


def _remat_training_fixture(pkg):
    """The three ops in two remat segments, a ``backward`` op and one
    ``sgd`` per parameter (tests/test_analysis.py's training fixture)."""
    matmul, mean = _np(pkg)[:2]
    main, _ = _fresh(pkg)
    gb = main.global_block()
    for name, shape, kw in (("x", (4, 8), {"is_data": True}),
                            ("w1", (8, 16), {"persistable": True}),
                            ("w2", (16, 1), {"persistable": True}),
                            ("h", (4, 16), {}), ("p", (4, 1), {}),
                            ("loss", (), {}), ("w1@GRAD", (8, 16), {}),
                            ("w2@GRAD", (16, 1), {})):
        gb.create_var(name=name, shape=shape, dtype="float32", **kw)
    gb.append_op(type="matmul", inputs={"X": ["x"], "Y": ["w1"]},
                 outputs={"Out": ["h"]}, attrs={"_remat_segment": 0},
                 fn=matmul)
    gb.append_op(type="matmul", inputs={"X": ["h"], "Y": ["w2"]},
                 outputs={"Out": ["p"]}, attrs={"_remat_segment": 1},
                 fn=matmul)
    gb.append_op(type="mean", inputs={"X": ["p"]},
                 outputs={"Out": ["loss"]}, attrs={"_remat_segment": 1},
                 fn=mean)
    gb.append_op(type="backward",
                 inputs={"Params": ["w1", "w2"], "Inputs": ["x"]},
                 outputs={"Grads": ["w1@GRAD", "w2@GRAD"]},
                 attrs={"loss": "loss"})
    for w in ("w1", "w2"):
        gb.append_op(type="sgd",
                     inputs={"Param": [w], "Grad": [w + "@GRAD"]},
                     outputs={"ParamOut": [w]})
    return main


def _report(rep):
    """A MemoryReport as plain data, render text included."""
    return dict(
        per_op_bytes=list(rep.per_op_bytes),
        per_op_live=list(rep.per_op_live),
        per_op_device_bytes=list(rep.per_op_device_bytes),
        peak=(rep.peak_bytes, rep.peak_op_index, rep.peak_op_type),
        peak_device=(rep.peak_device_bytes, rep.peak_device_op_index),
        persistable=(rep.persistable_bytes, rep.persistable_device_bytes),
        unsized=sorted(rep.unsized_vars),
        lives={n: (t.bytes, t.device_bytes, t.first, t.last,
                   t.persistable, tuple(t.shape) if t.shape is not None
                   else None, t.dtype)
               for n, t in rep.lives.items()},
        render=rep.render())


def _both_liveness(build, **kw):
    out = {}
    for pkg in PKGS:
        fluid, _ = package(pkg)
        out[pkg] = _report(fluid.analysis.analyze_liveness(build(pkg),
                                                           **kw))
    return out


def test_three_op_mlp_peak_is_the_jax_package_and_the_hand_count():
    rep = _both_liveness(_three_op_mlp, fetch_list=["loss"])
    assert rep["torch"] == rep["jax"]
    assert rep["torch"]["per_op_bytes"] == [960, 848, 596]
    assert rep["torch"]["peak"] == (960, 0, "matmul")


@pytest.mark.parametrize("remat", [False, True, frozenset({1}),
                                   frozenset({0, 1})],
                         ids=["none", "all", "seg1", "seg01"])
@pytest.mark.parametrize("donation", [True, False], ids=["don", "nodon"])
def test_training_fixture_liveness_matches_under_remat_and_donation(
        remat, donation):
    rep = _both_liveness(_remat_training_fixture, remat=remat,
                         donation=donation)
    assert rep["torch"] == rep["jax"]
    hand = {(False, True): [960, 976, 980, 1556, 1152, 640],
            (frozenset({1}), True): [960, 976, 980, 1536, 1152, 640],
            (frozenset({1}), False): [960, 976, 980, 1536, 1664, 1216],
            (True, True): [960, 976, 724, 1280, 1152, 640]}
    if (remat, donation) in hand:
        assert rep["torch"]["per_op_bytes"] == hand[remat, donation]


def test_liveness_assume_batch_and_shard_counts_match():
    def dyn(pkg):
        main, _ = _fresh(pkg)
        gb = main.global_block()
        gb.create_var(name="x", shape=(-1, 8), dtype="float32",
                      is_data=True)
        gb.create_var(name="y", shape=(-1, 8), dtype="float32")
        gb.append_op(type="scale", inputs={"X": ["x"]},
                     outputs={"Out": ["y"]}, fn=lambda v: v)
        return main

    for b in (1, 64):
        rep = _both_liveness(dyn, fetch_list=["y"], assume_batch=b)
        assert rep["torch"] == rep["jax"]
        assert rep["torch"]["peak"][0] == 2 * b * 8 * 4
    shards = {"w1": 4, "w2": 2, "w1@GRAD": 4}
    rep = _both_liveness(_remat_training_fixture, sharding=shards,
                         remat=frozenset({1}), donation=True)
    assert rep["torch"] == rep["jax"]
    assert rep["torch"]["lives"]["w1"][1] == 128


@pytest.mark.parametrize("remat", [False, True, "policy"])
def test_transformer_liveness_matches(remat):
    """The small Transformer-base's training program (dropout, the
    snapshot op, Adam) under each remat model; "policy" annotates the
    forward slice in segments as the remat_policy pass does."""
    reports = {}
    for pkg in PKGS:
        fluid, _ = package(pkg)
        main = _build(pkg, _transformer(0.1))[0]
        kw = {"assume_batch": 3}
        if remat == "policy":
            sched = (__import__("paddle_tpu.passes.schedule").passes
                     .schedule if pkg == "jax" else
                     tfluid.passes.schedule)
            bw = next(op for op in main.global_block().ops
                      if op.type == "backward")
            fwd, _ = fluid.backward._forward_slice(main, bw.attrs["loss"])
            assert sched._annotate_segments(fwd) == 4
            kw["remat"] = frozenset({1, 3})
        else:
            kw["remat"] = remat
        reports[pkg] = _report(fluid.analysis.analyze_liveness(main, **kw))
    assert reports["torch"] == reports["jax"]


def test_memory_optimize_print_log_prints_the_jax_text(capsys):
    texts = {}
    for pkg in PKGS:
        fluid, _ = package(pkg)
        for level, build in ((0, _three_op_mlp),
                             (1, lambda p: _build(p, _mlp)[0])):
            fluid.memory_optimize(build(pkg), print_log=True, level=level,
                                  assume_batch=16)
            texts[pkg, level] = capsys.readouterr().out
    for level in (0, 1):
        assert texts["torch", level] == texts["jax", level]
    assert "960 B" in texts["torch", 0]
    assert "remat on" in texts["torch", 1]
