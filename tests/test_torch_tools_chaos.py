"""The port's ``tools.chaos`` on the CPU, held to the JAX package's CLI:
``list`` prints the same registry, and ``run`` of each of the four
workloads under the same plan gives the same results and injection log
(the counterparts of tests/test_resilience_chaos.py's CLI test and
tests/test_record.py's ``--record`` bundle test).

Only what the plan decides is compared: counts that depend on how a
burst happened to be batched (the decode step count, the health
snapshot's timings) are not part of a chaos result's contract."""

import json

import pytest
import torch

from paddle_tpu.tools import chaos as j_chaos
from paddle_tpu_torch.obs import record
from paddle_tpu_torch.tools import chaos

torch.set_num_threads(1)


def _run(main, argv, capsys):
    assert main(argv) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")][-1]
    return json.loads(line)


def test_chaos_list_is_the_jax_registry(capsys):
    assert chaos.main(["list"]) == 0
    out = capsys.readouterr().out
    assert j_chaos.main(["list"]) == 0
    assert out == capsys.readouterr().out
    assert "fleet.replica_death" in out and "trainer.step" in out


def _plan(site, kind, hits):
    return json.dumps({"seed": 3, "faults": [
        {"site": site, "kind": kind, "hits": hits}]})


# workload -> (plan, the result keys the plan decides)
CASES = {
    "train": (_plan("trainer.step", "raise", [3]),
              ["steps_run", "checkpoint_serial"]),
    "serve": (_plan("serving.step", "raise", [0]),
              ["requests", "ok", "fatal_errors"]),
    # how many requests the breaker sheds after the failed step depends
    # on how submits and steps interleave: ok + retriable is the
    # plan's, the split is the timing's
    "decode": (_plan("decoding.step", "raise", [0]),
               ["requests", "fatal_errors"]),
    "fleet": (_plan("fleet.replica_death", "raise", [1]),
              ["requests", "ok", "bit_identical", "retriable_errors",
               "fatal_errors", "replica_deaths", "live", "status"]),
}


@pytest.mark.parametrize("workload", sorted(CASES))
def test_chaos_run_matches_the_jax_cli(tmp_path, capsys, workload):
    plan, keys = CASES[workload]
    argv = ["run", "--workload", workload, "--steps", "4", "--plan", plan]
    extra = ["--record", str(tmp_path / "rec")] if workload == "train" \
        else []
    want = _run(j_chaos.main, argv, capsys)
    got = _run(chaos.main, argv + extra + ["--device", "cpu"], capsys)
    for k in ["workload", "plan_seed", "rules", "injections",
              "injection_log"] + keys:
        assert got[k] == want[k], (k, got[k], want[k])
    assert set(want) <= set(got)
    assert got["injections"] == {"%s:raise" % json.loads(plan)[
        "faults"][0]["site"]: 1}
    if workload == "train":
        assert len(got["errors"]) == len(want["errors"]) == 1
        assert got["bundles"] and got["bundle_valid"] is True
        for b in got["bundles"]:
            assert record.validate_bundle(b) == []
    if workload == "serve":
        assert got["health"]["breaker"]["state"] == "closed"
    if workload == "decode":
        for r in (got, want):
            assert r["ok"] + r["retriable_errors"] == r["requests"]
    if workload == "fleet":
        assert got["bit_identical"] == got["ok"] == got["requests"]
        assert got["pool_clean"] is True
