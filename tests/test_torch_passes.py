"""paddle_tpu_torch's Program.prune, def-use utilities and inference
passes, held to paddle_tpu's.

* ``Program.prune`` keeps the JAX package's ops (types, slots, order)
  and vars, on fit_a_line's and the tiny Transformer-base's (dropout
  0.1) train programs and their ``clone(for_test=True)``, pruned to the
  prediction and to the loss; the pruned clone keeps the flat-state
  view map and gets a version of its own.
* ``analysis.dataflow`` (consumer counts, producer index, def/use sets,
  the backward live-op sweep, live intervals) equals the JAX package's
  on the same op lists.
* The inference pipeline (transpose elimination, attention fusion,
  fc+act fusion, dead-code elimination; legacy manager) leaves the same
  op types in the same order as the JAX package's on the same program,
  and the fused program computes what the unfused one does, bit for bit
  (a fused op replays its chain's fns). Adjacent transposes compose or
  cancel, DCE keeps persistable writes and fetch targets, fusion never
  swallows a ``keep`` name.
* The registry (names, ``get_pass``, ``build_pipeline``, fingerprints
  equal to the JAX package's); the checked and stamped manager (the JAX
  package's op lists and ``_passes_stamp``, a pass introducing an error
  stopped) and ``Program.validate``; ``lint_comm`` raises naming ROADMAP
  Queue A 9.
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.analysis import dataflow as j_dataflow
from paddle_tpu.core import unique_name as j_unique_name
from paddle_tpu.models.transformer import transformer_base as j_transformer
from paddle_tpu_torch.analysis import dataflow as t_dataflow
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.models.transformer import \
    transformer_base as t_transformer
from paddle_tpu_torch.passes import (AttentionFusePass,
                                     DeadCodeEliminatePass, FcActFusePass,
                                     PassManager, TransposeEliminatePass,
                                     build_pipeline, get_pass, list_passes)
from paddle_tpu_torch.passes.manager import (apply_passes,
                                             inference_pass_pipeline)

from _torch_port import TB, _feed, _flags

torch.set_num_threads(1)


def _fit(pkg):
    guard = j_unique_name.guard if pkg is jfluid else \
        tfluid.unique_name.guard
    main, startup = pkg.Program(), pkg.Program()
    with guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[13], dtype="float32")
        h = pkg.layers.fc(input=x, size=16, act="relu")
        h = pkg.layers.fc(input=h, size=8, act="relu")
        pred = pkg.layers.fc(input=h, size=1)
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, pred.name, loss.name


def _tb(pkg, fuse=False):
    guard, build = ((j_unique_name.guard, j_transformer) if pkg is jfluid
                    else (tfluid.unique_name.guard, t_transformer))
    main, startup = pkg.Program(), pkg.Program()
    with warnings.catch_warnings(), _flags(
            "jax" if pkg is jfluid else "torch",
            {"fuse_optimizer_state": fuse}), \
            guard(), pkg.program_guard(main, startup):
        warnings.filterwarnings("ignore")
        _, cost, predict = build(**{**TB, "dropout_rate": 0.1},
                                 attn_impl="fused")
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(cost)
    return main, startup, predict.name, cost.name


BUILDS = {"fit": _fit, "transformer": _tb}


def _ops(program):
    return [(op.type, op.inputs, op.outputs)
            for op in program.global_block().ops]


@pytest.mark.parametrize("for_test", [False, True])
@pytest.mark.parametrize("target", ["predict", "loss"])
@pytest.mark.parametrize("model", list(BUILDS))
def test_prune_keeps_the_jax_packages_ops(model, target, for_test):
    j = BUILDS[model](jfluid)
    t = BUILDS[model](tfluid)
    name = j[2] if target == "predict" else j[3]
    assert name == (t[2] if target == "predict" else t[3])
    jp, tp = j[0], t[0]
    if for_test:
        jp, tp = jp.clone(for_test=True), tp.clone(for_test=True)
    jpr, tpr = jp.prune([name]), tp.prune([name])
    assert _ops(tpr) == _ops(jpr)
    assert sorted(tpr.global_block().vars) == \
        sorted(jpr.global_block().vars)
    assert len(tpr.global_block().ops) < len(tp.global_block().ops)
    # the source program is untouched
    assert _ops(tp) == _ops(jp)


def test_prune_keeps_flat_views_and_gets_its_own_version():
    main, _, predict, _ = _tb(tfluid, fuse=True)
    assert main._flat_state_views
    pruned = main.prune([predict])
    assert pruned._flat_state_views is main._flat_state_views
    assert pruned is not main and pruned._version > 0
    v0 = pruned._version
    pruned.prune([predict])
    assert pruned._version == v0


@pytest.mark.parametrize("model", list(BUILDS))
def test_dataflow_equals_the_jax_packages(model):
    jops = BUILDS[model](jfluid)[0].global_block().ops
    tops = BUILDS[model](tfluid)[0].global_block().ops
    assert t_dataflow.consumer_counts(tops) == \
        j_dataflow.consumer_counts(jops)
    assert t_dataflow.producer_index(tops) == \
        j_dataflow.producer_index(jops)
    jd, td = j_dataflow.DefUse(jops), t_dataflow.DefUse(tops)
    assert (td.defs, td.uses, td.names()) == (jd.defs, jd.uses, jd.names())
    roots = {tops[-1].output_arg_names[0]}
    eff = lambda op: op.fn is None  # noqa: E731
    assert t_dataflow.backward_live_ops(tops, roots, eff) == \
        j_dataflow.backward_live_ops(jops, roots, eff)
    assert t_dataflow.live_intervals(tops, ["x"], roots) == \
        j_dataflow.live_intervals(jops, ["x"], roots)


@pytest.mark.parametrize("model", list(BUILDS))
def test_inference_pipeline_rewrites_as_the_jax_package(model):
    j, t = BUILDS[model](jfluid), BUILDS[model](tfluid)
    keep = [t[2]]
    jp = j[0].clone(for_test=True).prune(keep)
    tp = t[0].clone(for_test=True).prune(keep)
    from paddle_tpu.core.passes import \
        inference_pass_pipeline as j_pipeline

    jout = j_pipeline(keep).apply(jp)
    tout = inference_pass_pipeline(keep).apply(tp)
    assert [op.type for op in tout.global_block().ops] == \
        [op.type for op in jout.global_block().ops]
    assert any(op.type == "fc_act_fused" for op in tout.global_block().ops)
    assert [(op.inputs, op.outputs) for op in tout.global_block().ops] == \
        [(op.inputs, op.outputs) for op in jout.global_block().ops]


@pytest.mark.parametrize("model", list(BUILDS))
def test_fused_program_computes_the_unfused_result(model):
    main, startup, predict, _ = BUILDS[model](tfluid)
    scope, place = tfluid.Scope(), tfluid.CPUPlace()
    exe = tfluid.Executor(place)
    exe.run(startup, scope=scope)
    plain = main.clone(for_test=True).prune([predict])
    fused = inference_pass_pipeline([predict]).apply(
        main.clone(for_test=True).prune([predict]))
    assert len(fused.global_block().ops) < len(plain.global_block().ops)
    if model == "fit":
        feed = {"x": np.random.RandomState(0).randn(5, 13).astype(
            np.float32)}
    else:
        feed = {k: v for k, v in _feed().items()
                if k in ("src_word", "trg_word", "src_mask", "trg_mask")}
    want, = exe.run(plain, feed=feed, fetch_list=[predict], scope=scope)
    got, = exe.run(fused, feed=feed, fetch_list=[predict], scope=scope)
    np.testing.assert_array_equal(got, want)


def _chain_program(pkg, perms, keep_mid=False):
    """x -> transpose(p) for p in perms -> relu, built by hand."""
    import jax.numpy as jnp

    main = pkg.Program()
    gb = main.global_block()
    gb.create_var(name="x", shape=(2, 3, 4), dtype="float32", is_data=True)
    cur = "x"
    for i, p in enumerate(perms):
        out = "t%d" % i
        gb.create_var(name=out, shape=None, dtype="float32")
        fn = ((lambda v, _p=tuple(p): v.permute(_p)) if pkg is tfluid else
              (lambda v, _p=tuple(p): jnp.transpose(v, _p)))
        gb.append_op(type="transpose", inputs={"X": [cur]},
                     outputs={"Out": [out]}, attrs={"perm": list(p)}, fn=fn)
        cur = out
    gb.create_var(name="y", shape=None, dtype="float32")
    relu = (torch.relu if pkg is tfluid else (lambda v: jnp.maximum(v, 0)))
    gb.append_op(type="relu", inputs={"X": [cur]}, outputs={"Out": ["y"]},
                 fn=relu)
    return main


@pytest.mark.parametrize("perms,left", [
    ([(1, 0, 2), (1, 0, 2)], ["identity", "relu"]),
    ([(2, 0, 1), (1, 0, 2)], ["transpose", "relu"]),
    ([(1, 2, 0), (1, 2, 0), (1, 2, 0)], ["identity", "relu"]),
])
def test_transposes_compose_or_cancel_as_in_the_jax_package(perms, left):
    x = np.random.RandomState(1).randn(2, 3, 4).astype(np.float32)
    tp = _chain_program(tfluid, perms)
    exe = tfluid.Executor(tfluid.CPUPlace())
    want, = exe.run(tp, feed={"x": x}, fetch_list=["y"],
                    scope=tfluid.Scope())
    out = TransposeEliminatePass(keep=["y"]).apply(tp)
    from paddle_tpu.passes.fusion import \
        TransposeEliminatePass as JTranspose

    jout = JTranspose(keep=["y"]).apply(_chain_program(jfluid, perms))
    assert [op.type for op in out.global_block().ops] == left == \
        [op.type for op in jout.global_block().ops]
    got, = exe.run(out, feed={"x": x}, fetch_list=["y"],
                   scope=tfluid.Scope())
    np.testing.assert_array_equal(got, want)


def test_keep_names_are_barriers():
    # the middle transpose's output is a declared target: nothing fuses
    tp = _chain_program(tfluid, [(1, 0, 2), (1, 0, 2)])
    out = TransposeEliminatePass(keep=["t0"]).apply(tp)
    assert [op.type for op in out.global_block().ops] == \
        ["transpose", "transpose", "relu"]
    main, _, predict, _ = _fit(tfluid)
    hidden = [op for op in main.global_block().ops
              if op.type == "relu"][0].output_arg_names[0]
    p = main.clone(for_test=True).prune([predict])
    p = FcActFusePass(keep=[predict, hidden]).apply(p)
    assert hidden in {n for op in p.global_block().ops
                      for n in op.output_arg_names}


def test_dce_keeps_targets_and_persistable_writes():
    main, _, predict, loss = _fit(tfluid)
    gb = main.global_block()
    n_before = len(gb.ops)
    # a dead op: reads x, writes a var nothing reads
    gb.create_var(name="dead", shape=None, dtype="float32")
    gb.append_op(type="scale", inputs={"X": ["x"]},
                 outputs={"Out": ["dead"]}, attrs={"scale": 2.0},
                 fn=lambda v: v * 2.0)
    out = DeadCodeEliminatePass(keep=[loss]).apply(main)
    types = [op.type for op in out.global_block().ops]
    assert len(types) == n_before and "sgd" in types


def test_registry_and_fingerprints_match_the_jax_package():
    from paddle_tpu.passes import fusion as j_fusion

    from paddle_tpu.passes import transforms as j_transforms

    from paddle_tpu_torch.passes import transforms as t_transforms

    assert list_passes() == ["amp_bf16", "attention_fuse",
                             "cast_params_bf16",
                             "comm_overlap", "conv_bn_fold", "dce",
                             "fc_act_fuse", "host_offload",
                             "memory_optimize", "ptq_int8",
                             "quantize_inference", "remat_policy",
                             "sharding", "transpose_eliminate"]
    for name in ("ConvBNFoldPass", "CastParamsBF16Pass", "AmpRewritePass",
                 "ShardingPass"):
        tcls, jcls = getattr(t_transforms, name), getattr(j_transforms, name)
        assert (tcls.name, tcls.reads, tcls.writes, tcls.mutates_scope,
                tcls.stamp_attr) == (jcls.name, jcls.reads, jcls.writes,
                                     jcls.mutates_scope, jcls.stamp_attr)
        assert tcls().fingerprint() == jcls().fingerprint()
    for tcls, jcls in ((FcActFusePass, j_fusion.FcActFusePass),
                       (AttentionFusePass, j_fusion.AttentionFusePass),
                       (TransposeEliminatePass,
                        j_fusion.TransposeEliminatePass),
                       (DeadCodeEliminatePass,
                        j_fusion.DeadCodeEliminatePass)):
        assert tcls.name == jcls.name
        assert tcls(keep=["a", "b"]).fingerprint() == \
            jcls(keep=["b", "a"]).fingerprint()
        assert tcls.writes == jcls.writes and tcls.reads == jcls.reads
    assert isinstance(get_pass("dce"), DeadCodeEliminatePass)
    built = build_pipeline(["dce", "fc_act_fuse"], keep=["p"])
    assert [p.keep for p in built] == [{"p"}, {"p"}]
    with pytest.raises(EnforceError, match="unknown pass"):
        get_pass("nope")


def test_legacy_manager_applies_in_order_and_checked_one_is_refused():
    """The legacy manager applies in order and stamps nothing. The
    checked and stamped manager and ``Program.validate``, once refused
    (ROADMAP Queue A 8), are ported: the manager re-infers, composes
    ``_passes_stamp`` as the JAX package's does and stops a pass that
    introduces an error; ``validate`` returns the report. ``lint_comm``
    raises, naming Queue A 9."""
    from paddle_tpu.passes.fusion import FcActFusePass as JFcActFusePass
    from paddle_tpu.passes.manager import PassManager as JPassManager

    main, _, predict, _ = _fit(tfluid)
    p = main.clone(for_test=True).prune([predict])
    out = apply_passes([FcActFusePass(keep=[predict]),
                        DeadCodeEliminatePass(keep=[predict])], p,
                       check=False, stamp=False)
    assert [op.type for op in out.global_block().ops].count(
        "fc_act_fused") == 2
    assert not hasattr(out, "_passes_stamp")
    j_main, _, j_predict, _ = _fit(jfluid)
    for kw in ({}, {"check": True, "stamp": False},
               {"check": False, "stamp": True}):
        progs = {}
        for pkg, fit, pred, Manager, Fuse in (
                ("torch", main, predict, PassManager, FcActFusePass),
                ("jax", j_main, j_predict, JPassManager, JFcActFusePass)):
            prog = fit.clone(for_test=True).prune([pred])
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                progs[pkg] = Manager([Fuse(keep=[pred]), "dce"],
                                     **kw).apply(prog)
        assert [op.type for op in progs["torch"].global_block().ops] == \
            [op.type for op in progs["jax"].global_block().ops]
        assert getattr(progs["torch"], "_passes_stamp", None) == \
            getattr(progs["jax"], "_passes_stamp", None)
    with pytest.raises(NotImplementedError, match="Queue A 9"):
        PassManager(["dce"], check=False, stamp=False, lint_comm=True)

    class Breaks(tfluid.passes.Pass):
        name = "breaks"

        def apply(self, program, scope=None):
            gb = program.global_block()
            gb.append_op(type="scale", inputs={"X": ["ghost"]},
                         outputs={"Out": [predict]}, fn=lambda v: v)
            return program

    with pytest.raises(tfluid.passes.PassError,
                       match="introduced-diagnostics"):
        PassManager([Breaks()]).apply(main.clone())
    report = main.validate()
    assert report.ok and not report.errors
