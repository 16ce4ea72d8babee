"""paddle_tpu_torch.resilience's supervisor, the Trainer's heartbeat and
the ``tools.ckpt`` CLI, against the JAX package's tests
(tests/test_resilience.py's supervisor state machine,
tests/test_resilience_chaos.py's supervised elastic run,
tests/test_ckpt.py's CLI).

The elastic run: a worker of four gloo ranks on the CPU (data 2 x fsdp 2,
``python -m paddle_tpu_torch.tools.launch``) under the JAX test's fault
plan is killed mid-run and relaunched at two ranks (data 2), which
restore the newest VALID serial (N->M) and finish; its losses are held
to the JAX package's unfaulted one-device oracle (the same build, start
state and feeds) at rtol 1e-4 — the JAX test allows 0.05. A killed
attempt leaves no rank behind: the supervisor kills the launcher's
whole process group.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
import _supervised_worker as sw
from paddle_tpu_torch import ckpt
from paddle_tpu_torch.resilience import (HEARTBEAT_ENV, FaultPlan,
                                         RetryPolicy, Supervisor,
                                         SupervisorGaveUp, plan_env,
                                         read_heartbeat)
from paddle_tpu_torch.tools.ckpt import main as ckpt_cli

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "_torch_supervised_worker.py")
TOTAL_STEPS = 6
# the elastic run's losses against the JAX package's one-device oracle
ORACLE_RTOL = 1e-4


# ---------------------------------------------------------------------------
# the state machine (tests/test_resilience.py:698-770's jax-free workers)
# ---------------------------------------------------------------------------

_WORKER_SRC = r"""
import json, os, sys, time
mode, marker = sys.argv[1], sys.argv[2]
hb = os.environ["PDTPU_HEARTBEAT_FILE"]
def beat(step, **kw):
    rec = {"step": step}
    rec.update(kw)
    tmp = hb + ".t"
    with open(tmp, "w") as f:
        json.dump(rec, f)
    os.replace(tmp, hb)
first = not os.path.exists(marker)
if first:
    open(marker, "w").write("x")
beat(2 if first else 5, resumed_from=0 if first else 2)
if first:
    if mode == "crash":
        os.kill(os.getpid(), 9)
    if mode == "hang":
        time.sleep(600)
sys.exit(0)
"""


def _spec(mode, marker):
    return {"argv": [sys.executable, "-c", _WORKER_SRC, mode, marker],
            "world_size": 1}


def test_supervisor_restarts_after_crash(tmp_path):
    marker = str(tmp_path / "marker")
    sup = Supervisor(lambda a, last: _spec("crash", marker)
                     if a < 3 else None,
                     policy=RetryPolicy(base_delay_s=0.01, jitter=0.0),
                     watchdog_s=30.0, boot_grace_s=30.0, poll_s=0.01)
    report = sup.run()
    assert report["success"] and report["restarts"] == 1
    assert report["crashes"] == 1 and report["hangs"] == 0
    assert report["attempts"][0]["steps"] == 2
    assert report["attempts"][1]["resumed_from"] == 2
    assert report["steps_lost"] == [0]
    assert len(report["recoveries_s"]) == 1


def test_supervisor_kills_and_restarts_hung_worker(tmp_path):
    marker = str(tmp_path / "marker")
    sup = Supervisor(lambda a, last: _spec("hang", marker)
                     if a < 3 else None,
                     policy=RetryPolicy(base_delay_s=0.01, jitter=0.0),
                     watchdog_s=0.5, boot_grace_s=30.0, poll_s=0.01)
    report = sup.run()
    assert report["success"] and report["hangs"] == 1
    assert report["attempts"][0]["reason"] == "hang"


def test_supervisor_gives_up_on_crash_loop(tmp_path):
    always_crash = {"argv": [
        sys.executable, "-c", "import sys; sys.exit(3)"]}
    sup = Supervisor(lambda a, last: dict(always_crash),
                     policy=RetryPolicy(base_delay_s=0.001, jitter=0.0),
                     watchdog_s=None, max_restarts=2, poll_s=0.01)
    with pytest.raises(SupervisorGaveUp) as ei:
        sup.run()
    assert not ei.value.report["success"]
    assert len(ei.value.report["attempts"]) == 3  # 1 + max_restarts


# ---------------------------------------------------------------------------
# no rank outlives its attempt
# ---------------------------------------------------------------------------

_RANK_SRC = r"""
import json, os, sys, time
d = sys.argv[1]
rank = os.environ["PADDLE_TRAINER_ID"]
with open(os.path.join(d, "rank%s.pid" % rank), "w") as f:
    f.write(str(os.getpid()))
if rank == "0":
    hb = os.environ["PDTPU_HEARTBEAT_FILE"]
    with open(hb + ".t", "w") as f:
        json.dump({"step": 1}, f)
    os.replace(hb + ".t", hb)
time.sleep(600)
"""


def _alive(pid):
    """Whether ``pid`` runs (a zombie has ended)."""
    try:
        with open("/proc/%d/stat" % pid) as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
    except OSError:
        return False
    return state not in ("Z", "X")


def _env(extra=None):
    env = {"PYTHONPATH": os.pathsep.join(
        [REPO] + os.environ.get("PYTHONPATH", "").split(os.pathsep)),
        "OMP_NUM_THREADS": "1"}
    env.update(extra or {})
    return env


def test_no_rank_outlives_a_killed_attempt(tmp_path):
    """A launcher of two ranks that stop heartbeating: the watchdog kills
    the attempt's whole process group, the ranks included (the JAX
    supervisor signals its one worker pid), and the next attempt runs."""
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SRC)

    def launch(attempt, last):
        if attempt == 0:
            return {"argv": [sys.executable, "-m",
                             "paddle_tpu_torch.tools.launch", "--nproc",
                             "2", "--backend", "gloo", str(script),
                             str(tmp_path)],
                    "env": _env(), "world_size": 2}
        if attempt == 1:
            return {"argv": [sys.executable, "-c", "pass"],
                    "world_size": 1}
        return None

    sup = Supervisor(launch, watchdog_s=1.0, boot_grace_s=120.0,
                     poll_s=0.05,
                     policy=RetryPolicy(base_delay_s=0.01, jitter=0.0))
    report = sup.run()
    assert report["success"] and report["hangs"] == 1
    pids = [int((tmp_path / ("rank%d.pid" % r)).read_text())
            for r in range(2)]
    deadline = time.time() + 10
    while any(_alive(p) for p in pids) and time.time() < deadline:
        time.sleep(0.05)
    assert not any(_alive(p) for p in pids), pids


# ---------------------------------------------------------------------------
# the supervised elastic run (tests/test_resilience_chaos.py:54-138)
# ---------------------------------------------------------------------------


def _start_state(path):
    """The JAX worker's program's startup values, for the port's ranks."""
    main, startup, _ = sw.build(None)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor().run(startup)
    np.savez(path, **{v.name: np.asarray(scope.find_var(v.name))
                      for v in main.list_vars()
                      if v.persistable and scope.find_var(v.name)
                      is not None})


def _oracle_losses():
    """Un-faulted one-device oracle in the JAX package: the same build,
    start state and feeds, no sharding."""
    main, startup, loss = sw.build(None)
    with jfluid.scope_guard(jfluid.Scope()):
        exe = jfluid.Executor()
        exe.run(startup)
        return [float(np.asarray(exe.run(main, feed=sw.feed(s),
                                         fetch_list=[loss.name])[0]))
                for s in range(TOTAL_STEPS)]


def test_supervised_elastic_chaos(tmp_path):
    """Kill a world of four ranks mid-run (with a corrupted newest
    checkpoint and a delayed publish in the mix), rejoin at two:
    training continues to the un-faulted loss curve. Hits count per
    rank: each rank writes one payload a serial, so ``ckpt.payload``'s
    hit 2 corrupts every rank's payload of serial 2, ``ckpt.publish``'s
    hit 1 delays serial 1, and ``trainer.step``'s hit 3 kills every
    rank before step 3. The newest valid serial is 1 (resume at global
    step 2)."""
    root = str(tmp_path / "ck")
    state = str(tmp_path / "start.npz")
    _start_state(state)
    out = {a: str(tmp_path / f"out_{a}.json") for a in range(4)}
    plan = (FaultPlan(seed=11)
            .rule("ckpt.payload", "corrupt", hits=[2])
            .rule("ckpt.publish", "delay", hits=[1], delay_ms=50)
            .rule("trainer.step", "crash", hits=[3]))

    def launch(attempt, last):
        if attempt >= 4:
            return None
        n = 4 if attempt == 0 else 2
        env = _env(plan_env(plan) if attempt == 0 else None)
        return {"argv": [sys.executable, "-m",
                         "paddle_tpu_torch.tools.launch", "--nproc",
                         str(n), "--backend", "gloo", WORKER, root,
                         str(TOTAL_STEPS), out[attempt], state],
                "env": env, "world_size": n,
                "stdout": str(tmp_path / f"attempt_{attempt}.log")}

    sup = Supervisor(launch, watchdog_s=120.0, boot_grace_s=300.0,
                     max_restarts=3)
    report = sup.run()

    logs = "".join((tmp_path / f"attempt_{a}.log").read_text()[-2000:]
                   for a in range(len(report["attempts"])))
    assert report["success"], (report, logs)
    assert report["restarts"] == 1 and report["crashes"] == 1, report
    assert report["recoveries_s"] and report["recoveries_s"][0] > 0
    assert report["steps_lost"] == [1], report
    assert [a["world_size"] for a in report["attempts"]] == [4, 2]

    with open(out[0]) as f:
        first = json.load(f)
    with open(out[1]) as f:
        second = json.load(f)
    assert not first["done"] and second["done"]
    assert first["start_step"] == 0 and second["start_step"] == 2
    assert first["world_size"] == 4 and second["world_size"] == 2

    oracle = _oracle_losses()
    got = [(first["losses"][str(s)], oracle[s]) for s in range(3)] + \
        [(second["losses"][str(s)], oracle[s])
         for s in range(2, TOTAL_STEPS)]
    gap = max(abs(g - want) / abs(want) for g, want in got)
    assert gap <= ORACLE_RTOL, (gap, got)

    def key(rec):
        return (rec["site"], rec["hit"], rec["rule"])

    realized = first["injection_log"]
    counts = dict(first["hit_counts"])
    assert sorted(plan.schedule(counts), key=key) == sorted(realized,
                                                           key=key)
    counts["trainer.step"] += 1
    assert {"site": "trainer.step", "kind": "crash",
            "hit": 3, "rule": 2} in plan.schedule(counts)
    kinds = {(r["site"], r["kind"]) for r in realized}
    assert ("ckpt.publish", "delay") in kinds
    assert ("ckpt.payload", "corrupt") in kinds

    # the root as the CLI sees it: the resumed world of two wrote serial
    # 2 again into its directory (a multi-process save writes into the
    # serial's directory; one process publishes only a new one), so
    # every serial verifies and the newest is the last step's
    assert ckpt_cli(["verify", "--root", root]) == 0
    assert ckpt.latest_valid_serial(root) == TOTAL_STEPS - 1


# ---------------------------------------------------------------------------
# the Trainer's heartbeat
# ---------------------------------------------------------------------------


def _fit_func():
    x = tfluid.layers.data(name="x", shape=[13], dtype="float32")
    y = tfluid.layers.data(name="y", shape=[1], dtype="float32")
    pred = tfluid.layers.fc(input=x, size=1)
    return tfluid.layers.mean(tfluid.layers.square_error_cost(pred, y))


def _reader(n=4):
    rng = np.random.RandomState(0)
    rows = [(rng.rand(13).astype("float32"), rng.rand(1).astype("float32"))
            for _ in range(8 * n)]

    def reader():
        for i in range(n):
            yield rows[8 * i:8 * i + 8]
    return reader


@pytest.mark.parametrize("beat", [True, False])
def test_trainer_beats_once_a_step(tmp_path, monkeypatch, beat):
    """With ``PDTPU_HEARTBEAT_FILE`` set the Trainer publishes the steps
    done after each step's fault point (the JAX Trainer's ``_tick``);
    without it no file appears."""
    hb = str(tmp_path / "hb.json")
    if beat:
        monkeypatch.setenv(HEARTBEAT_ENV, hb)
    else:
        monkeypatch.delenv(HEARTBEAT_ENV, raising=False)
    seen = []

    def handler(event):
        if isinstance(event, tfluid.EndStepEvent):
            rec = read_heartbeat(hb)
            seen.append(None if rec is None else rec["step"])

    t = tfluid.Trainer(_fit_func,
                       lambda: tfluid.optimizer.SGD(learning_rate=0.05),
                       place=tfluid.CPUPlace())
    t.train(num_epochs=1, reader=_reader(), feed_order=["x", "y"],
            event_handler=handler)
    if beat:
        assert seen == [1, 2, 3, 4]
        assert read_heartbeat(hb)["pid"] == os.getpid()
    else:
        assert seen == [None] * 4 and not os.path.exists(hb)


# ---------------------------------------------------------------------------
# tools.ckpt (tests/test_ckpt.py:423-470)
# ---------------------------------------------------------------------------


def _shard_state(value):
    """One process's state of a 1-process legacy sharded save: the
    whole tensor as its only block."""
    return {"w": value}


def test_ckpt_cli(tmp_path, capsys):
    root = str(tmp_path / "ck")
    ckpt.save_checkpoint(root, {"w": np.ones(4, "f")})        # dense
    ckpt.save_checkpoint_sharded(root, _shard_state(np.ones(4, "f")),
                                 max_num_checkpoints=10)      # sharded
    for i in range(2):                                         # elastic
        ckpt.save_checkpoint_elastic(root, {"w": np.ones(4, "f") * i},
                                     max_num_checkpoints=10)
    assert ckpt_cli(["ls", "--root", root]) == 0
    out = capsys.readouterr().out
    assert "dense" in out and "sharded" in out and "elastic" in out
    assert "4 serial(s)" in out
    assert ckpt_cli(["verify", "--root", root]) == 0
    assert "4 serial(s), 0 bad; newest valid: 3" in capsys.readouterr().out

    # corrupt the newest -> verify flags it, restore falls back
    with open(os.path.join(ckpt.serial_dir(root, 3), "shards_0.npz"),
              "wb") as f:
        f.write(b"junk")
    assert ckpt_cli(["verify", "--root", root]) == 1
    out = capsys.readouterr().out
    assert "BAD checkpoint_3" in out and "newest valid: 2" in out
    assert ckpt_cli(["verify", "--root", root, "--serial", "1"]) == 0
    assert ckpt_cli(["verify", "--root", root, "--serial", "9"]) == 1

    # gc: scroll-delete semantics (keeps the newest valid)
    assert ckpt_cli(["gc", "--root", root, "--keep", "1"]) == 0
    assert 2 in ckpt.list_checkpoints(root)
    assert ckpt.latest_valid_serial(root) == 2
    assert ckpt_cli(["clean", "--root", root]) == 0
    assert ckpt.list_checkpoints(root) == []

    with pytest.raises(SystemExit) as e:
        ckpt_cli(["ls", "--root", str(tmp_path / "missing")])
    assert e.value.code == 2
    assert ckpt_cli([]) == 2


def test_ckpt_cli_matches_the_jax_cli(tmp_path, capsys):
    """One root written by the port, read by both CLIs: the same
    listing (ages aside), verdicts and exit codes."""
    from paddle_tpu.tools.ckpt import main as jcli

    root = str(tmp_path / "ck")
    ckpt.save_checkpoint(root, {"w": np.ones(4, "f")})
    ckpt.save_checkpoint_elastic(root, {"w": np.zeros(3, "f")},
                                 max_num_checkpoints=10)
    for argv in (["ls", "--root", root], ["verify", "--root", root]):
        outs = []
        for cli in (ckpt_cli, jcli):
            assert cli(argv) == 0
            outs.append([line.rsplit(None, 1)[0] if line[:6].strip()
                         .isdigit() else line
                         for line in capsys.readouterr().out.splitlines()])
        assert outs[0] == outs[1], argv


def test_ckpt_cli_module_entry(tmp_path):
    root = str(tmp_path / "ck")
    ckpt.save_checkpoint_elastic(root, {"w": np.ones(4, "f")})
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.ckpt", "verify",
         "--root", root],
        env=dict(os.environ, **_env()), capture_output=True, text=True,
        timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("OK") and "checkpoint_0" in proc.stdout


# ---------------------------------------------------------------------------
# a supervised Trainer(parallel=True) world
# ---------------------------------------------------------------------------

TRAINER_WORKER = os.path.join(HERE, "_torch_trainer_worker.py")


def test_supervised_trainer_world_loses_one_step(tmp_path):
    """A world of two gloo ranks training through ``Trainer(parallel=True)``
    under the JAX chaos test's plan (tests/test_resilience_chaos.py:64-67):
    serial 2 corrupted, serial 1's publish delayed, every rank killed at
    step 3's fault site. The Trainer's heartbeat (rank 0's beat, then a
    barrier of both ranks) has published step 3 before any rank reaches
    that site, and the restart at one rank resumes from serial 1 (step
    2): one step lost."""
    root = str(tmp_path / "ck")
    out = {a: str(tmp_path / f"out_{a}.json") for a in range(3)}
    plan = (FaultPlan(seed=11)
            .rule("ckpt.payload", "corrupt", hits=[2])
            .rule("ckpt.publish", "delay", hits=[1], delay_ms=50)
            .rule("trainer.step", "crash", hits=[3]))

    def launch(attempt, last):
        if attempt >= 3:
            return None
        n = 2 if attempt == 0 else 1
        env = _env(plan_env(plan) if attempt == 0 else None)
        return {"argv": [sys.executable, "-m",
                         "paddle_tpu_torch.tools.launch", "--nproc",
                         str(n), "--backend", "gloo", TRAINER_WORKER, root,
                         str(TOTAL_STEPS), out[attempt]],
                "env": env, "world_size": n,
                "stdout": str(tmp_path / f"attempt_{attempt}.log")}

    sup = Supervisor(launch, watchdog_s=120.0, boot_grace_s=300.0,
                     max_restarts=2)
    report = sup.run()
    logs = "".join((tmp_path / f"attempt_{a}.log").read_text()[-2000:]
                   for a in range(len(report["attempts"])))
    assert report["success"], (report, logs)
    assert report["restarts"] == 1 and report["crashes"] == 1, report
    assert report["steps_lost"] == [1], (report, logs)
    assert [a["world_size"] for a in report["attempts"]] == [2, 1]
    with open(out[0]) as f:
        first = json.load(f)
    with open(out[1]) as f:
        second = json.load(f)
    assert not first["done"] and second["done"]
    assert first["start_step"] == 0 and second["start_step"] == 2
    assert sorted(first["losses"], key=int) == ["0", "1", "2"]
    assert sorted(second["losses"], key=int) == [
        str(s) for s in range(2, TOTAL_STEPS)]
