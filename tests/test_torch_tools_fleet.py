"""The port's serving CLIs on the CPU, held to the JAX package's:
``tools.generate`` (the same tokens at the same ``--seed``, with the
flags of tests/test_decoding.py's and tests/test_decoding_fleet.py's CLI
smokes) and ``tools.fleet serve|status|drain`` with their exit codes."""

import os
import subprocess
import sys
import time

import pytest
import torch

from paddle_tpu.tools import generate as j_generate
from paddle_tpu_torch import fleet
from paddle_tpu_torch.tools import fleet as fleet_cli
from paddle_tpu_torch.tools import generate

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _tokens(out: str):
    line, = [ln for ln in out.splitlines() if ln.startswith("tokens:")]
    return [int(t) for t in line.split()[1:]]


def test_generate_cli_smoke(capsys):
    """One command drives the port's decode stack end to end (the JAX
    CLI's smoke flags, on the host)."""
    assert generate.main(["--prompt", "3 1 4 1 5", "--max-new-tokens",
                          "4", "--metrics", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "generated 4 token(s)" in out
    assert "tokens_per_sec" in out
    assert len(_tokens(out)) == 4


@pytest.mark.parametrize("extra", [
    [],
    ["--temperature", "0.8", "--top-k", "8", "--top-p", "0.9",
     "--sample-seed", "42"],
    ["--draft-model", "1:16", "--speculate-k", "3", "--prefix-cache",
     "--metrics"],
    ["--kv-dtype", "int8", "--prefix-cache"],
], ids=["greedy", "sampled", "speculative_prefix", "int8"])
def test_generate_matches_the_jax_cli(capsys, extra):
    """At the same ``--seed`` both CLIs build the same model and print
    the same tokens; seeded sampling repeats across invocations."""
    argv = ["--prompt", "3 1 4 1 5", "--max-new-tokens", "4",
            "--seed", "3"] + extra
    assert j_generate.main(argv) == 0
    want = _tokens(capsys.readouterr().out)
    assert generate.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "generated 4 token(s)" in out
    assert _tokens(out) == want
    if "--draft-model" in extra:
        assert "speculative acceptance rate:" in out
        assert "prefix_hit_rate" in out
    if "--sample-seed" in extra:
        assert generate.main(argv + ["--device", "cpu"]) == 0
        assert _tokens(capsys.readouterr().out) == want


def test_generate_cli_usage_errors(capsys):
    assert generate.main(["--prompt", "", "--device", "cpu"]) == 2
    assert generate.main(["--prompt", "99", "--vocab", "64",
                          "--device", "cpu"]) == 2
    assert generate.main(["--draft-model", "x", "--device", "cpu"]) == 2


def _env():
    env = dict(os.environ)
    env.pop("PYTEST_CURRENT_TEST", None)
    env.pop("PDTPU_FAULT_PLAN", None)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + env.get("PYTHONPATH", "").split(os.pathsep))
    return env


def _wait_for(fleet_dir, names, procs, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if set(names) <= {h["name"] for h in fleet.discover(fleet_dir)}:
            return
        for p in procs:
            if p.poll() is not None:
                raise AssertionError(p.stderr.read().decode()[-3000:])
        time.sleep(0.2)
    raise AssertionError("no handshake from %s" % names)


def test_fleet_cli_serve_status_drain(tmp_path, capsys):
    """``serve`` a decode and a prefill replica as processes; ``status``
    finds both live (rc 0); ``drain`` of one leaves it unreachable
    (rc 0), ``status`` still rc 0 with one live; draining the rest gives
    rc 0, then ``status`` and ``drain`` find nothing live (rc 1)."""
    fleet_dir = str(tmp_path / "fleet")
    store = str(tmp_path / "store")
    procs = []
    for name, role in (("r0", "decode"), ("p0", "prefill")):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.tools.fleet",
             "serve", "--name", name, "--role", role, "--fleet-dir",
             fleet_dir, "--store", store, "--device", "cpu"],
            env=_env(), cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    try:
        _wait_for(fleet_dir, ["r0", "p0"], procs)
        hs = {h["name"]: h for h in fleet.discover(fleet_dir)}
        assert hs["r0"]["role"] == "decode"
        assert hs["p0"]["role"] == "prefill"
        h = fleet.RemoteReplica(hs["p0"])
        assert h.prefill([3, 1, 4, 1, 5, 9, 2, 6, 5])["exported"] == 2
        assert fleet_cli.main(["status", "--fleet-dir", fleet_dir]) == 0
        out = capsys.readouterr().out
        assert "2 replica(s), 2 live" in out
        assert fleet_cli.main(["drain", "--fleet-dir", fleet_dir,
                               "--name", "p0"]) == 0
        assert "drained p0" in capsys.readouterr().out
        assert procs[1].wait(timeout=60) == 0
        assert fleet_cli.main(["status", "--fleet-dir", fleet_dir]) == 0
        assert "2 replica(s), 1 live" in capsys.readouterr().out
        assert fleet_cli.main(["drain", "--fleet-dir", fleet_dir,
                               "--name", "r0"]) == 0
        assert procs[0].wait(timeout=60) == 0
        out, _ = procs[0].communicate(timeout=30)
        assert b"drained" in out
        assert fleet_cli.main(["status", "--fleet-dir", fleet_dir,
                               "--timeout", "1"]) == 1
        assert fleet_cli.main(["drain", "--fleet-dir", fleet_dir,
                               "--timeout", "1"]) == 1
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)


def test_fleet_cli_usage_errors(tmp_path, capsys):
    """No subcommand: rc 2; ``serve`` without ``--store`` stops in
    argparse (exit 2) before any handshake; an empty fleet dir: rc 1."""
    assert fleet_cli.main([]) == 2
    with pytest.raises(SystemExit) as e:
        fleet_cli.main(["serve", "--name", "r", "--fleet-dir",
                        str(tmp_path / "f"), "--device", "cpu"])
    assert e.value.code == 2
    assert not os.path.exists(str(tmp_path / "f"))
    assert fleet_cli.main(["status", "--fleet-dir",
                           str(tmp_path / "none")]) == 1
    assert fleet_cli.main(["drain", "--fleet-dir",
                           str(tmp_path / "none")]) == 1


def test_fleet_cli_weights_are_the_jax_clis(tmp_path):
    """``serve``'s seeded model holds the JAX CLI's weights: same names,
    same seeded draws."""
    import argparse

    import numpy as np

    import paddle_tpu_torch as tfluid
    from paddle_tpu.tools import fleet as j_fleet_cli

    args = argparse.Namespace(vocab=23, layers=1, d_model=16, seed=7,
                              device="cpu")
    _, t_scope, _ = fleet_cli._build(args)
    _, j_scope, _ = j_fleet_cli._build(args)
    names = sorted(j_scope.local_var_names())
    assert names == sorted(t_scope.local_var_names())
    for n in names:
        np.testing.assert_array_equal(tfluid.fetch_var(n, t_scope),
                                      np.asarray(j_scope.find_var(n)))
