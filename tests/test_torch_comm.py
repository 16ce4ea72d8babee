"""paddle_tpu_torch.analysis's communication analysis against
paddle_tpu.analysis's (tests/test_comm.py's corpus and cases).

On the CPU, in one process: a plan's mesh is a shape, so the port
analyzes a program sharded over ``training_mesh(data=2, fsdp=2, tp=2)``
with no world of ranks. The same builders run in both packages, and the
port's ``analyze_comm`` must give the JAX package's counts, total bytes,
events (kind, reason, block, op, var, axes, bytes), unknowns and
diagnostics; on the four corpora its volume counts also equal
``count_collectives`` of the StableHLO the JAX package compiles for the
program on its forced 8-device CPU mesh. The suggestion fixpoint, its
rewrite and the ``comm_overlap`` pass give the JAX package's program;
the lints, the pass manager's ``lint_comm``, the roofline join and the
CLI (``--shard``/``--comm``) are held to the JAX package's or to its
test's assertions. (The ranks' side, the prediction against the port's
own collectives: tests/test_torch_parallel.py.)
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import analysis as janalysis
from paddle_tpu import sharding as jsharding
from paddle_tpu.core import unique_name as j_unique_name
from paddle_tpu_torch import analysis, passes, sharding
from paddle_tpu_torch.core.enforce import EnforceError

from conftest import lower_last_compiled

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_VOLUME = ("all-gather", "all-reduce", "reduce-scatter")

# tests/test_comm.py's rule sets
BASE_RULES = [(r"fc\.w_\d+", ("fsdp", "tp")), (r"fc\.b_\d+", (None,)),
              (r".*", ())]
REPL_RULES = [(r".*", ())]
MEGATRON_RULES = [(r"fc\.w_0", (None, "tp")), (r"fc\.w_1", ("tp", None)),
                  (r"fc\.b_\d+", (None,)), (r".*", ())]
CHURN_RULES = [(r"fc\.tmp_\d+$", (("data", "fsdp"),))] + BASE_RULES

CORPUS = [("replicated", REPL_RULES, 2),
          ("dp_fsdp_tp_default", BASE_RULES, 2),
          ("megatron_pair", MEGATRON_RULES, 2),
          ("zero_3layer", BASE_RULES, 3)]


def _mesh(pkg, jmesh):
    if pkg is jfluid:
        return jmesh
    return sharding.training_mesh(data=2, fsdp=2, tp=2, devices=range(8))


def _guard(pkg):
    return j_unique_name.guard() if pkg is jfluid \
        else tfluid.unique_name.guard()


def _mlp_fwd(pkg, layers=3):
    x = pkg.layers.data(name="x", shape=[-1, 16], dtype="float32",
                        append_batch_size=False)
    y = pkg.layers.data(name="y", shape=[-1, 1], dtype="float32",
                        append_batch_size=False)
    h = x
    for _ in range(layers - 1):
        h = pkg.layers.fc(h, size=32, act="relu")
    pred = pkg.layers.fc(h, size=1)
    return pkg.layers.mean(pkg.layers.square_error_cost(pred, y))


def _build(pkg, mesh, rules=None, layers=3, seed=5, builder=None,
           train=False):
    """(main, startup, loss): tests/test_comm.py's MLP (or ``builder``),
    sharded over ``mesh`` before ``minimize`` when ``train``."""
    shard = jsharding if pkg is jfluid else sharding
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = seed
    with _guard(pkg), pkg.program_guard(main, startup):
        loss = builder(pkg) if builder is not None \
            else _mlp_fwd(pkg, layers)
        if mesh is not None:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                shard.shard_program(main, mesh, rules=rules)
        if train:
            pkg.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def _events(rep):
    return [(e.kind, e.reason, e.block_idx, e.op_idx, e.op_type, e.var,
             tuple(e.axes), e.bytes) for e in rep.events]


def _diags(diags):
    return [(d.severity, d.code, d.block_idx, d.op_idx, d.op_type, d.var,
             d.message) for d in diags]


def _analyze(pkg, main, loss, **kw):
    mod = janalysis if pkg is jfluid else analysis
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return mod.analyze_comm(main, fetch_list=[loss.name], **kw)


def _assert_same_report(t, j):
    assert t.counts() == j.counts()
    assert t.total_bytes == j.total_bytes
    assert _events(t) == _events(j)
    assert t.unknowns == j.unknowns
    assert t.complete == j.complete
    assert _diags(t.diagnostics) == _diags(j.diagnostics)
    assert t.render() == j.render()


def _tb(pkg):
    """tests/test_comm.py:477-485's Transformer-base."""
    from importlib import import_module

    mod = import_module(pkg.__name__ + ".models.transformer")
    _, avg_cost, _ = mod.transformer_base(
        src_vocab_size=512, trg_vocab_size=512, max_length=16,
        n_layer=1, n_head=2, d_model=64, d_inner_hid=128,
        dropout_rate=0.0)
    return avg_cost


# ---------------------------------------------------------------------------
# the prediction: the JAX package's, event for event
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,rules,layers", CORPUS + [
    ("churn", CHURN_RULES, 3)], ids=lambda v: v if isinstance(v, str)
    else None)
def test_analysis_matches_jax(cpu_mesh8, name, rules, layers):
    reps = {}
    for pkg in (jfluid, tfluid):
        main, _, loss = _build(pkg, _mesh(pkg, cpu_mesh8), rules=rules,
                               layers=layers)
        reps[pkg] = _analyze(pkg, main, loss, batch_size=8)
    _assert_same_report(reps[tfluid], reps[jfluid])
    assert reps[tfluid].complete, reps[tfluid].unknowns


@pytest.mark.parametrize("train", [False, True])
def test_transformer_analysis_matches_jax(cpu_mesh8, train):
    """The Transformer-base of tests/test_comm.py under the default plan:
    the same events and the same unknown op types (``pos_encoding`` has
    no comm signature in either package, so its layout and everything
    after it stay unknown)."""
    reps = {}
    for pkg in (jfluid, tfluid):
        main, _, loss = _build(pkg, _mesh(pkg, cpu_mesh8), seed=3,
                               builder=_tb, train=train)
        reps[pkg] = _analyze(pkg, main, loss)
    _assert_same_report(reps[tfluid], reps[jfluid])
    assert "pos_encoding" in reps[tfluid].unknowns


def _compiled_counts(main, startup, loss):
    """tests/test_comm.py's per-step leg: the collectives in the
    StableHLO the JAX package's Executor compiles for the program."""
    rng = np.random.RandomState(11)
    feed = {"x": rng.rand(8, 16).astype("float32"),
            "y": rng.rand(8, 1).astype("float32")}
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor()
        exe.run(startup)
        exe.run(main, feed=feed, fetch_list=[loss.name])
        _, compiled = lower_last_compiled(exe, scope, feed)
        text = compiled.as_text()
    return text


@pytest.mark.parametrize("name,rules,layers", CORPUS,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_predicted_matches_jax_compiled(cpu_mesh8, name, rules, layers):
    """The port's volume counts equal the collectives of the JAX
    package's compiled program, counted by both packages'
    ``count_collectives`` (the same text function)."""
    jmain, jstart, jloss = _build(jfluid, cpu_mesh8, rules=rules,
                                  layers=layers)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        text = _compiled_counts(jmain, jstart, jloss)
    compiled = analysis.count_collectives(text)
    assert compiled == janalysis.count_collectives(text)
    tmain, _, tloss = _build(tfluid, _mesh(tfluid, cpu_mesh8), rules=rules,
                             layers=layers)
    rep = _analyze(tfluid, tmain, tloss, batch_size=8)
    assert rep.complete
    vol = {k: v for k, v in rep.counts().items() if k in _VOLUME}
    assert vol == {k: v for k, v in compiled.items() if k in _VOLUME}, \
        (name, rep.render(), compiled)
    assert rep.counts().get("reshard", 0) == \
        compiled.get("collective-permute", 0)


# ---------------------------------------------------------------------------
# suggestions and the comm_overlap pass
# ---------------------------------------------------------------------------


def _suggestions(sugs):
    return [(s.var, tuple(s.spec), s.block_idx, s.op_idx, s.reason)
            for s in sugs]


def _constraints(main):
    return [(op.type, list(op.input_arg_names), list(op.output_arg_names),
             op.attrs.get("spec")) for op in main.global_block().ops]


def test_suggestions_reduce_gathers_like_jax(cpu_mesh8):
    """The fixpoint's suggestions and their rewrite: the JAX package's
    (every churn constraint widened to ``(("data", "fsdp"), "tp")``, the
    predicted all-gathers 4 -> 3). The port's constraint op is the
    identity, so the rewrite changes no value a run computes
    (tests/test_torch_parallel.py runs both on ranks)."""
    got = {}
    for pkg, mod in ((jfluid, janalysis), (tfluid, analysis)):
        main, _, loss = _build(pkg, _mesh(pkg, cpu_mesh8),
                               rules=CHURN_RULES)
        before = _analyze(pkg, main, loss, batch_size=8)
        sugs = mod.suggest_constraints(main, batch_size=8)
        n = mod.apply_suggestions(main, sugs)
        after = _analyze(pkg, main, loss, batch_size=8)
        got[pkg] = (before.counts(), _suggestions(sugs), n, after.counts(),
                    after.total_bytes, _constraints(main))
    assert got[tfluid] == got[jfluid]
    before, sugs, n, after = got[tfluid][:4]
    assert before["all-gather"] == 4 and after["all-gather"] == 3
    assert n == len(sugs) and all(s[1] == (("data", "fsdp"), "tp")
                                  for s in sugs)


def test_apply_suggestions_refuses_training_program(cpu_mesh8):
    main, _, _ = _build(tfluid, _mesh(tfluid, cpu_mesh8), rules=CHURN_RULES,
                        train=True)
    sugs = analysis.suggest_constraints(main, batch_size=8)
    assert sugs  # the analysis half still works on training programs
    v0 = main._version
    with pytest.raises(EnforceError, match="backward"):
        analysis.apply_suggestions(main, sugs)
    assert main._version == v0  # refused before any mutation
    assert analysis.apply_suggestions(main, sugs,
                                      allow_training=True) == len(sugs)


def _unit_desc(main, loss, pkg):
    """The compile-cache unit's desc without op fns (the fns differ by
    package; tests/test_torch_compile_cache.py's comparison)."""
    if pkg is jfluid:
        from paddle_tpu.compile_cache import CompilationUnit
    else:
        from paddle_tpu_torch.compile_cache import CompilationUnit
    d = json.loads(json.dumps(CompilationUnit(main, ("x", "y"),
                                              (loss.name,)).desc))
    for block in d["blocks"]:
        for op in block:
            op.pop("fn")
    return d


@pytest.mark.parametrize("rules", [CHURN_RULES, BASE_RULES],
                         ids=["churn", "default"])
def test_comm_overlap_matches_jax(cpu_mesh8, rules):
    """``comm_overlap`` between ``sharding`` and ``minimize``: the same
    program out (op types, order, constraint specs, the compile-cache
    unit's desc), the same ``_schedule_stamp`` and fingerprint, the same
    drop in predicted counts; without constraints to pin it is a no-op
    that stamps nothing."""
    from paddle_tpu.passes.schedule import CommOverlapPass as JPass
    from paddle_tpu_torch.passes.schedule import CommOverlapPass as TPass

    got = {}
    for pkg, Pass in ((jfluid, JPass), (tfluid, TPass)):
        main, _, loss = _build(pkg, _mesh(pkg, cpu_mesh8), rules=rules)
        before = _analyze(pkg, main, loss, batch_size=8).counts()
        v0 = main._version
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = Pass(batch_size=8).apply(main)
        assert out is main
        after = _analyze(pkg, main, loss, batch_size=8).counts()
        got[pkg] = (before, after, _constraints(main),
                    getattr(main, "_schedule_stamp", None),
                    Pass(batch_size=8).fingerprint(),
                    main._version != v0, _unit_desc(main, loss, pkg))
    assert got[tfluid] == got[jfluid]
    before, after, _, stamp, _, changed = got[tfluid][:6]
    if rules is CHURN_RULES:
        assert before["all-gather"] == 4 and after["all-gather"] == 3
        assert stamp == "comm_overlap=comm_overlap/bs:8/iter:4/reslot:1"
        assert changed
    else:
        assert before == after and stamp is None and not changed


def test_comm_overlap_noops_like_jax(cpu_mesh8):
    """Planless, constraint-free and post-backward programs come back
    untouched (no version bump, no stamp)."""
    cases = [_build(tfluid, None)[0],
             _build(tfluid, _mesh(tfluid, cpu_mesh8), rules=BASE_RULES)[0],
             _build(tfluid, _mesh(tfluid, cpu_mesh8), rules=CHURN_RULES,
                    train=True)[0]]
    for main in cases:
        v0, ops = main._version, _constraints(main)
        assert passes.get_pass("comm_overlap").apply(main) is main
        assert main._version == v0 and _constraints(main) == ops
        assert not hasattr(main, "_schedule_stamp")


def test_analyzer_read_only_and_default_off(cpu_mesh8):
    """Analysis and what-if suggestions never touch the program: the
    version and the compile-cache unit stay those of a twin."""
    main_a, _, loss_a = _build(tfluid, _mesh(tfluid, cpu_mesh8),
                               rules=BASE_RULES)
    main_b, _, loss_b = _build(tfluid, _mesh(tfluid, cpu_mesh8),
                               rules=BASE_RULES)
    v0 = main_a._version
    rep = _analyze(tfluid, main_a, loss_a, batch_size=8)
    analysis.suggest_constraints(main_a, batch_size=8)
    assert rep.counts() and main_a._version == v0
    assert _unit_desc(main_a, loss_a, tfluid) == \
        _unit_desc(main_b, loss_b, tfluid)


def test_planless_program_is_noop():
    main, _, loss = _build(tfluid, None)
    rep = analysis.analyze_comm(main, fetch_list=[loss.name])
    assert rep.planless and not rep.events and not rep.diagnostics
    assert rep.total_bytes is None
    assert analysis.suggest_constraints(main) == []
    report = analysis.check_program(main, fetch_list=[loss.name],
                                    with_comm=True)
    assert report.ok
    assert "no sharding plan" in str(report)


# ---------------------------------------------------------------------------
# the comm-* lint family
# ---------------------------------------------------------------------------


def test_lint_constraint_transition_error_and_churn(cpu_mesh8):
    got = {}
    for pkg, mod in ((jfluid, janalysis), (tfluid, analysis)):
        main, _, loss = _build(pkg, _mesh(pkg, cpu_mesh8),
                               rules=CHURN_RULES)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got[pkg] = mod.check_program(main, fetch_list=[loss.name],
                                         with_comm=True, assume_batch=8)
    report = got[tfluid]
    assert _diags(report.diagnostics) == _diags(got[jfluid].diagnostics)
    errs = report.by_code("comm-layout-transition")
    assert [d for d in errs if d.is_error], str(report)
    assert report.by_code("comm-resharding-churn")
    main, _, loss = _build(tfluid, _mesh(tfluid, cpu_mesh8),
                           rules=CHURN_RULES)
    quiet = analysis.check_program(main, fetch_list=[loss.name])
    assert quiet.ok and not quiet.diagnostics, str(quiet)
    with pytest.raises(EnforceError):
        main.validate(fetch_list=[loss.name], with_comm=True)
    assert main.validate(fetch_list=[loss.name]).ok


def test_lint_indivisible_replication(cpu_mesh8):
    main, _, loss = _build(tfluid, _mesh(tfluid, cpu_mesh8),
                           rules=BASE_RULES, layers=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        report = analysis.check_program(main, fetch_list=[loss.name],
                                        with_comm=True, assume_batch=8)
    hits = report.by_code("comm-indivisible-replication")
    assert any(d.var == "fc.w_2" for d in hits), str(report)
    assert report.ok  # warning, not error


def test_contraction_gather_is_warning_not_error(cpu_mesh8):
    main, _, loss = _build(tfluid, _mesh(tfluid, cpu_mesh8),
                           rules=BASE_RULES, layers=3)
    rep = _analyze(tfluid, main, loss, batch_size=8)
    assert rep.counts().get("all-gather") == 3  # w_0, w_1, relu.tmp_0
    hits = [d for d in rep.diagnostics
            if d.code == "comm-layout-transition"]
    assert hits and not any(d.is_error for d in hits), rep.diagnostics
    assert not any(d.var.startswith("fc.w_") for d in hits), hits


def test_pass_manager_lint_comm(cpu_mesh8):
    mesh = _mesh(tfluid, cpu_mesh8)
    main, _, _ = _build(tfluid, None)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        piped = passes.PassManager([passes.ShardingPass(mesh)],
                                   lint_comm=True).apply(main)
    assert piped._sharding_stamp  # default rules introduce no comm error
    bad, _, _ = _build(tfluid, None, seed=6)
    with pytest.raises(passes.PassError) as ei:
        passes.PassManager([passes.ShardingPass(mesh, rules=CHURN_RULES)],
                           lint_comm=True).apply(bad)
    assert "comm-layout-transition" in str(ei.value)
    ok, _, _ = _build(tfluid, None, seed=7)
    passes.PassManager([passes.ShardingPass(mesh, rules=CHURN_RULES)]
                       ).apply(ok)


def test_roofline_comm_keys(cpu_mesh8):
    from paddle_tpu.obs import cost as jcost
    from paddle_tpu_torch.obs import cost

    main, _, loss = _build(tfluid, _mesh(tfluid, cpu_mesh8),
                           rules=BASE_RULES)
    crep = cost.report(main, batch_size=8)
    comm = analysis.analyze_comm(main, batch_size=8)
    spans = {"dispatch": 0.5}
    plain = cost.roofline(crep, spans)
    joined = cost.roofline(crep, spans, comm_report=comm)
    keys = ("static_ici_bytes_per_step", "comm_events",
            "comm_unknown_op_types")
    for key in keys:
        assert key not in plain  # absent, not null
        assert key in joined
    assert joined["static_ici_bytes_per_step"] == comm.total_bytes > 0
    assert joined["comm_events"]["all-reduce"] >= 1
    assert set(joined) == set(plain) | set(keys)
    # the JAX package's join of its own report: the same added values
    jmain, _, _ = _build(jfluid, cpu_mesh8, rules=BASE_RULES)
    jjoined = jcost.roofline(jcost.report(jmain, batch_size=8), spans,
                             comm_report=janalysis.analyze_comm(
                                 jmain, batch_size=8))
    assert {k: joined[k] for k in keys} == {k: jjoined[k] for k in keys}


# ---------------------------------------------------------------------------
# registry + counting units
# ---------------------------------------------------------------------------


def test_count_collectives_defining_instructions_only():
    text = "\n".join([
        "  %ag = f32[8,32] all-gather(%p0), replica_groups={}",
        "  %ar.1 = f32[8] all-reduce(%x), to_apply=%sum",
        "  %use = f32[8] add(%ar.1, %ag)  // mentions all-gather",
        "  %cp = f32[4] collective-permute(%y)",
        "  %rs.2 = f32[2] reduce-scatter(%z), dimensions={0}",
        "  ROOT %t = tuple(%use)",
    ])
    got = analysis.count_collectives(text)
    assert got == {"all-gather": 1, "all-reduce": 1,
                   "collective-permute": 1, "reduce-scatter": 1}
    assert got == janalysis.count_collectives(text)


def test_comm_registry_matches_jax():
    from paddle_tpu.analysis import op_registry as jreg
    from paddle_tpu_torch.analysis.op_registry import (TensorType,
                                                       _contract_matmul,
                                                       _contract_mul)

    assert analysis.comm_registered_ops() == janalysis.comm_registered_ops()
    for t in analysis.comm_registered_ops():
        assert analysis.get_comm_signature(t).kind == \
            jreg.get_comm_signature(t).kind, t
    f32 = np.dtype("float32")
    t = lambda s: TensorType(s, f32)  # noqa: E731
    assert _contract_mul(None, [t((8, 16)), t((16, 32))]) == ((1,), (0,))
    assert _contract_mul(None, [t((2, 3, 4)), t((12, 5))]) \
        == ((1, 2), (0,))
    assert _contract_mul(None, [t((8, 16)), t((15, 32))]) is None
    assert _contract_matmul(None, [t((8, 16)), t((16, 32))]) \
        == ((1,), (0,))
    assert _contract_matmul(None, [t((8, 32)), t((8, 32))]) is None
    assert analysis.get_comm_signature("matmul").kind == "contraction"
    assert analysis.get_comm_signature("no_such_op") is None


def test_unknown_op_degrades_not_fabricates(cpu_mesh8):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[-1, 16], dtype="float32",
                               append_batch_size=False)
        h = tfluid.layers.fc(x, size=32)
        sharding.shard_program(main, _mesh(tfluid, cpu_mesh8),
                               rules=BASE_RULES)
    gb = main.global_block()
    out = gb.create_var(name="mystery.out", shape=[8, 32],
                        dtype="float32")
    gb.append_op(type="mystery_op", inputs={"X": [h.name]},
                 outputs={"Out": [out.name]}, fn=None)
    rep = analysis.analyze_comm(main, batch_size=8, fetch_list=[out.name])
    assert "mystery_op" in rep.unknowns and not rep.complete
    assert not [e for e in rep.events if e.reason == "fetch-gather"]


# ---------------------------------------------------------------------------
# self-lint: real models come out comm-clean after suggestions
# ---------------------------------------------------------------------------


def _resnet(cifar):
    def build(pkg):
        from importlib import import_module

        resnet = import_module(pkg.__name__ + ".models.resnet")
        if cifar:
            return resnet.build_train(class_dim=10, depth=20,
                                      image_shape=(3, 32, 32),
                                      cifar=True)[2]
        return resnet.build_train(class_dim=100, depth=50,
                                  image_shape=(3, 224, 224))[2]
    return build


@pytest.mark.parametrize("name,builder", [
    ("resnet_cifar10", _resnet(True)),
    ("resnet_imagenet", _resnet(False)),
    ("transformer_base", _tb),
])
def test_model_self_lint_comm_clean(cpu_mesh8, name, builder):
    """The models under the default plan: after the analyzer's own
    suggestions, no comm error — and the port's report is the JAX
    package's."""
    reps = {}
    for pkg, mod in ((jfluid, janalysis), (tfluid, analysis)):
        main, _, loss = _build(pkg, _mesh(pkg, cpu_mesh8), seed=3,
                               builder=builder)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mod.apply_suggestions(main, mod.suggest_constraints(main))
        reps[pkg] = _analyze(pkg, main, loss)
    rep = reps[tfluid]
    errors = [d for d in rep.diagnostics if d.is_error]
    assert not errors, (name, [str(d) for d in errors])
    assert rep.counts() == reps[jfluid].counts()
    assert rep.total_bytes == reps[jfluid].total_bytes
    assert rep.unknowns == reps[jfluid].unknowns


def _composed(pkg, mesh):
    """tests/test_comm.py's quantize + amp + sharding pipeline in
    ``pkg``: the piped program after its own suggestions, and its
    report."""
    mod = janalysis if pkg is jfluid else analysis
    from importlib import import_module

    pmod = import_module(pkg.__name__ + ".passes")
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = 9
    with _guard(pkg), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[-1, 16], dtype="float32",
                            append_batch_size=False)
        h = pkg.layers.fc(x, size=32, act="relu")
        sim = pkg.layers.matmul(h, h, transpose_y=True)
        pooled = pkg.layers.reduce_mean(sim, dim=1, keep_dim=True)
        joined = pkg.layers.concat([h, pooled], axis=1)
        out = pkg.layers.fc(joined, size=4)
    rng = np.random.RandomState(2)
    feed = {"x": rng.rand(8, 16).astype("float32")}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if pkg is jfluid:
            scope = jfluid.Scope()
            with jfluid.scope_guard(scope):
                exe = jfluid.Executor()
                exe.run(startup)
                exe.run(main, feed=feed, fetch_list=[out.name])
                calib = pmod.calibrate_program(main, [feed], scope=scope)
        else:
            scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup, scope=scope)
            exe.run(main, feed=feed, fetch_list=[out], scope=scope)
            calib = pmod.calibrate_program(main, [feed], scope=scope,
                                           place=tfluid.CPUPlace())
        piped = pmod.PassManager([
            pmod.QuantizePass(calib), pmod.AmpRewritePass(),
            pmod.ShardingPass(mesh)]).apply(main, scope=scope)
        mod.apply_suggestions(piped, mod.suggest_constraints(
            piped, batch_size=8))
        return piped, mod.analyze_comm(piped, batch_size=8,
                                       fetch_list=[out.name])


def test_composed_pipeline_self_lint_comm_clean(cpu_mesh8):
    """Quantize + amp + sharding stays comm-error-free after suggestions,
    with the JAX package's ops, events and unknowns (the int8 product,
    the amp casts)."""
    got = {pkg: _composed(pkg, _mesh(pkg, cpu_mesh8))
           for pkg in (jfluid, tfluid)}
    (tp, rep), (jp, jrep) = got[tfluid], got[jfluid]
    assert [op.type for op in tp.global_block().ops] == \
        [op.type for op in jp.global_block().ops]
    assert "int8_mul_dequant" in [op.type for op in tp.global_block().ops]
    _assert_same_report(rep, jrep)
    errors = [d for d in rep.diagnostics if d.is_error]
    assert not errors, [str(d) for d in errors]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _run(mod, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc = mod.main(argv)
    return (rc, out.getvalue().replace("paddle_tpu_torch", "paddle_tpu"),
            err.getvalue())


def test_cli_shard_comm_matches_jax():
    """``--shard data=2,fsdp=2,tp=2 --comm`` on the demo MLP: rc 0 and
    the JAX CLI's report, line for line."""
    from paddle_tpu.tools import check_program as jcheck
    from paddle_tpu_torch.tools import check_program as tcheck

    argv = ["--model", "mlp", "--shard", "data=2,fsdp=2,tp=2", "--comm"]
    jrc, jout, _ = _run(jcheck, argv)
    trc, tout, _ = _run(tcheck, argv)
    assert trc == jrc == 0
    assert tout == jout
    assert "comm:" in tout and "all-reduce" in tout \
        and "static ICI volume" in tout


def test_cli_comm_error_and_bad_spec(monkeypatch):
    """rc 1 when the plan forces a gather (the churn rules in place of
    the default set), rc 2 on a bad axis spec; the module entry runs
    in a fresh process."""
    from paddle_tpu_torch.sharding import plan
    from paddle_tpu_torch.tools import check_program as tcheck

    monkeypatch.setattr(plan, "default_rules",
                        lambda: [(r"fc\.tmp_\d+$", (("data", "fsdp"),))]
                        + BASE_RULES)
    rc, out, _ = _run(tcheck, ["--model", "mlp", "--shard",
                               "data=2,fsdp=2,tp=2", "--comm"])
    assert rc == 1 and "comm-layout-transition" in out
    monkeypatch.undo()
    for bad in ("data2", "data=x", "pp=2"):
        rc, out, err = _run(tcheck, ["--model", "mlp", "--shard", bad,
                                     "--comm"])
        assert rc == 2 and "--shard" in err and not out, bad
    rc, _, err = _run(tcheck, ["/nonexistent", "--shard", "data=2"])
    assert rc == 2 and "--model" in err
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.check_program",
         "--model", "mlp", "--shard", "data=2,fsdp=2", "--comm"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "comm:" in proc.stdout
