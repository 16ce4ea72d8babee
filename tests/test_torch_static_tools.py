"""paddle_tpu_torch's static tools against the JAX package: the pass
registry, ``tools/check_program.py`` and ``tools/passes.py`` (exit codes
and text, the package name excepted), ``debugger.py``, ``core/memory.py``
and the ``core/passes.py`` shim.

Text is compared after replacing ``paddle_tpu_torch`` by ``paddle_tpu``.
Where a pass's docstring states a fact of the JAX package that the port
does not share (a TPU unit, a jax call, a TPU profile), its summary and
docstring lines are left out of the comparison (``DOC_DIFFERS``, with
the reason); its contract lines — reads, writes, stamp, fingerprint,
scope, target, constructor — are compared all the same. The debugger's
annotated dump differs only by the JAX verifier's false
write-after-write errors on fused views (ROADMAP Queue C 7).
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu import debugger as j_debugger
from paddle_tpu import passes as jpasses
from paddle_tpu.core import memory as j_memory
from paddle_tpu.core import unique_name as j_unique_name
from paddle_tpu.tools import check_program as j_check
from paddle_tpu.tools import passes as j_passes_cli
from paddle_tpu_torch import debugger, passes
from paddle_tpu_torch.core import memory
from paddle_tpu_torch.tools import check_program as t_check
from paddle_tpu_torch.tools import passes as t_passes_cli

torch.set_num_threads(1)

CPU = fluid.CPUPlace()

#: pass -> why its docstring is not the JAX package's word for word
DOC_DIFFERS = {
    "amp_bf16": "the JAX text names docs/AMP.md and XLA's byte identity",
    "cast_params_bf16": "the JAX text names the TPU's MXU",
    "comm_overlap": "not ported (ROADMAP Queue A 9)",
    "sharding": "the JAX text points at its comm analyzer's CLI, which "
                "is not ported (ROADMAP Queue A 9)",
    "host_offload": "the port's staging is a pinned copy and a copy "
                    "stream, the JAX package's a device_put a group ahead",
    "quantize_inference": "the JAX text names lax.dot_general",
    "transpose_eliminate": "the JAX text cites a TPU profile",
}


def _run(mod, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(argv)
    return (rc, out.getvalue().replace("paddle_tpu_torch", "paddle_tpu"),
            err.getvalue().replace("paddle_tpu_torch", "paddle_tpu"))


# --------------------------------------------------------------- registry


def test_registry_is_the_jax_packages_less_sharding():
    """Once the JAX package's registry less ``sharding``; the port now
    registers ``sharding`` too, so the registries are equal."""
    assert passes.list_passes() == jpasses.list_passes()
    for name in ("ptq_int8", "quantize_inference", "host_offload",
                 "memory_optimize", "remat_policy", "comm_overlap",
                 "sharding"):
        t, j = passes.pass_class(name), jpasses.pass_class(name)
        assert (t.name, t.reads, t.writes, t.stamp_attr, t.mutates_scope,
                t.requires_backward) == (j.name, j.reads, j.writes,
                                         j.stamp_attr, j.mutates_scope,
                                         j.requires_backward), name
    for t, j in ((passes.QuantizeInferencePass(bit_length=4),
                  jpasses.QuantizeInferencePass(bit_length=4)),
                 (passes.HostOffloadPass(include_masters=False),
                  jpasses.HostOffloadPass(include_masters=False)),
                 (passes.MemoryOptimizePass(level=1),
                  jpasses.MemoryOptimizePass(level=1))):
        assert t.fingerprint() == j.fingerprint()
    calib = {"x": 0.5, "h": 1.25}
    assert passes.QuantizePass(passes.CalibrationResult(calib),
                               per_channel=False).fingerprint() == \
        jpasses.QuantizePass(jpasses.CalibrationResult(calib),
                             per_channel=False).fingerprint()
    # HostOffloadPass is constructed, not refused
    assert isinstance(passes.get_pass("host_offload"),
                      passes.HostOffloadPass)


def test_memory_optimize_pass_marks_donation_and_stamps():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.fc(input=x, size=4))
        fluid.SGD(learning_rate=0.1).minimize(loss)
    out = passes.apply_passes(["memory_optimize"], main)
    assert out._memory_optimize and not out._memory_optimize_remat
    assert out._passes_stamp == "memory_optimize=memory_optimize/level:0"


def test_legacy_shim_runs_unchecked_and_unstamped():
    from paddle_tpu_torch.core import passes as legacy

    assert fluid.PassManager is legacy.PassManager
    pm = legacy.inference_pass_pipeline(["y"])
    assert [p.name for p in pm.passes] == [
        "transpose_eliminate", "attention_fuse", "fc_act_fuse", "dce"]
    assert (pm.check, pm.stamp) == (False, False)
    main, _ = _fc_program()
    out = legacy.apply_passes(["memory_optimize"], main)
    assert out._memory_optimize
    assert getattr(out, "_passes_stamp", None) is None
    assert legacy.QuantizeInferencePass is passes.QuantizeInferencePass


def _fc_program():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.fc(input=x, size=4, act="relu")
    return main, startup


# -------------------------------------------------------------- the CLIs


@pytest.mark.parametrize("argv", [
    ["--model", "mlp", "--hbm"], ["--model", "mnist"],
    ["--model", "resnet", "--batch", "4"],
    ["--model", "mlp", "--buckets", "1,2,4", "--strict-batch"],
    ["--model", "mlp", "--after-pass", "dce,memory_optimize"],
    ["--model", "mlp", "--after-pass", "nope"], [],
    ["--model", "mlp", "/tmp/x"]], ids=str)
def test_check_program_cli_matches_the_jax_cli(argv):
    jrc, jout, _ = _run(j_check, argv)
    trc, tout, _ = _run(t_check, argv)
    assert trc == jrc
    assert tout == jout


@pytest.mark.parametrize("flag", [["--comm"], ["--shard", "data=2"]])
def test_check_program_comm_and_shard_exit_2_naming_the_queue(flag):
    rc, out, err = _run(t_check, ["--model", "mlp"] + flag)
    assert rc == 2 and "Queue A 9" in err and not out


def _artifact(tmp_path):
    main, startup = _fc_program()
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    d = str(tmp_path / "artifact")
    fluid.io.save_inference_model(
        d, ["x"], [main.global_block().var("relu.tmp_0")], exe,
        main_program=main, scope=scope, export_stablehlo=False)
    return d


def test_check_program_reads_an_artifact(tmp_path):
    d = _artifact(tmp_path)
    rc, out, _ = _run(t_check, [d, "--hbm", "--buckets", "1,8"])
    assert rc == 0 and "== main program" in out
    rc, _, err = _run(t_check, [str(tmp_path / "missing")])
    assert rc == 2 and "__model__.json" in err


def _explain_contract(text):
    """The explain output up to the docstring (the blank line)."""
    return text.split("\n\n", 1)[0]


def test_passes_list_matches_the_jax_cli():
    jrc, jout, _ = _run(j_passes_cli, ["list"])
    trc, tout, _ = _run(t_passes_cli, ["list"])
    assert trc == jrc == 0
    jl, tl = jout.splitlines(), tout.splitlines()
    assert tl[0] == jl[0].replace("%d registered" % len(
        jpasses.list_passes()), "%d registered" % len(passes.list_passes()))
    jrows = {jl[i].split()[0]: (jl[i], jl[i + 1].strip())
             for i in range(1, len(jl), 2)}
    trows = {tl[i].split()[0]: (tl[i], tl[i + 1].strip())
             for i in range(1, len(tl), 2)}
    assert sorted(trows) == sorted(jrows)
    for name, (row, summary) in trows.items():
        # the column widths follow the longest name, which both share
        assert row == jrows[name][0], name
        if name not in DOC_DIFFERS:
            assert summary == jrows[name][1], name


@pytest.mark.parametrize("name", sorted(passes.list_passes()))
def test_passes_explain_matches_the_jax_cli(name):
    jrc, jout, _ = _run(j_passes_cli, ["explain", name])
    trc, tout, _ = _run(t_passes_cli, ["explain", name])
    assert trc == jrc == 0
    if name == "comm_overlap":
        assert "Queue A 9" in tout
        return
    assert _explain_contract(tout) == _explain_contract(jout)
    if name not in DOC_DIFFERS:
        assert tout == jout


@pytest.mark.parametrize("argv", [
    ["run", "dce,memory_optimize", "--model", "mlp"],
    ["run", "remat_policy,host_offload", "--model", "mlp"],
    ["run", "dce", "--model", "mlp", "--no-check"],
    ["run", "nope", "--model", "mlp"], ["run", "", "--model", "mlp"],
    ["run", "dce"], ["explain", "nope"], []], ids=str)
def test_passes_run_matches_the_jax_cli(argv):
    jrc, jout, _ = _run(j_passes_cli, argv)
    trc, tout, _ = _run(t_passes_cli, argv)
    assert trc == jrc
    assert tout == jout


def test_training_only_passes_refuse_an_inference_artifact(tmp_path):
    """tests/test_schedule.py:527-553's seam: rc 2, "inference" named."""
    d = _artifact(tmp_path)
    for p in ("remat_policy", "host_offload"):
        rc, _, err = _run(t_passes_cli, ["run", p, d])
        assert rc == 2 and "inference" in err, p
    rc, out, _ = _run(t_passes_cli, ["run", "dce,memory_optimize", d])
    assert rc == 0 and "composed stamp" in out


def test_cli_modules_run_as_scripts():
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    for argv, rc in (
            (["paddle_tpu_torch.tools.check_program", "--model", "mlp",
              "--hbm"], 0),
            (["paddle_tpu_torch.tools.passes", "run", "dce,memory_optimize",
              "--model", "mlp"], 0),
            (["paddle_tpu_torch.tools.check_program", "--model", "mlp",
              "--comm"], 2)):
        proc = subprocess.run([sys.executable, "-m"] + argv, cwd=repo,
                              env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == rc, (argv, proc.stderr[-2000:])


# ---------------------------------------------------------------- debugger


def _mlp(pkg, un, fuse):
    main, startup = pkg.Program(), pkg.Program()
    with un.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[16], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        h = pkg.layers.fc(x, size=32, act="relu")
        loss = pkg.layers.mean(pkg.layers.square_error_cost(
            pkg.layers.fc(h, size=1), y))
        flags = pkg.core.flags
        flags.set_flags({"fuse_optimizer_state": fuse})
        try:
            pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
        finally:
            flags.set_flags({"fuse_optimizer_state": False})
    return main


def _without_false_errors(text):
    """The JAX dump less Queue C 7's false write-after-write errors on
    the fused views, with the listing's count line lowered to match."""
    lines = [ln for ln in text.splitlines() if "write-after-write" not in ln]
    n = sum("write-after-write" in ln for ln in text.splitlines()
            if ln.startswith("#   "))
    out = []
    for ln in lines:
        if ln.startswith("# check_program: ") and n:
            k = int(ln.split()[2])
            ln = ln.replace("%d error(s)" % k, "%d error(s)" % (k - n))
        out.append(ln)
    return "\n".join(out)


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("annotate", [False, True])
def test_pprint_program_codes_matches_the_jax_dump(fuse, annotate):
    jm = _mlp(jfluid, j_unique_name, fuse)
    tm = _mlp(fluid, fluid.unique_name, fuse)
    want = j_debugger.pprint_program_codes(jm, annotate=annotate)
    got = debugger.pprint_program_codes(tm, annotate=annotate)
    if annotate and fuse:
        assert "write-after-write" in want and \
            "write-after-write" not in got
        want = _without_false_errors(want)
    assert got == want


def test_draw_block_graphviz_matches_the_jax_dot(tmp_path):
    jm = _mlp(jfluid, j_unique_name, False)
    tm = _mlp(fluid, fluid.unique_name, False)
    path = str(tmp_path / "g.dot")
    got = debugger.draw_block_graphviz(program=tm, path=path,
                                       highlights=["fc.w_0"])
    assert got == j_debugger.draw_block_graphviz(program=jm,
                                                 highlights=["fc.w_0"])
    assert open(path).read() == got


# ------------------------------------------------------------------ memory


def test_memory_usage_on_the_cpu_is_the_jax_packages():
    import jax

    want = j_memory.memory_usage(jax.devices("cpu")[0])
    for dev in ("cpu", CPU, torch.device("cpu")):
        got = memory.memory_usage(dev)
        assert (got.bytes_in_use, got.peak_bytes_in_use, got.bytes_limit,
                got.fraction_in_use) == (want.bytes_in_use,
                                         want.peak_bytes_in_use,
                                         want.bytes_limit,
                                         want.fraction_in_use)
        assert got.device == "cpu"
    assert list(memory.DeviceMemoryStats.__dataclass_fields__) == \
        list(j_memory.DeviceMemoryStats.__dataclass_fields__)
    assert memory.__all__ == j_memory.__all__


def test_memory_knobs_check_their_arguments():
    for bad in (0.0, 1.5, -0.1):
        with pytest.raises(fluid.EnforceError, match="fraction"):
            memory.set_memory_fraction(bad)
    with pytest.raises(fluid.EnforceError, match="card"):
        memory.set_memory_fraction(0.5, device="cpu")
    memory.preallocate(True, device="cpu")  # nothing to reserve
    stats = memory.DeviceMemoryStats(10, 20, 40, "cuda:0")
    assert stats.fraction_in_use == 0.25
    if not torch.cuda.is_available():
        # the default device is the card
        with pytest.raises(fluid.EnforceError, match="CUDAPlace"):
            memory.memory_usage()
