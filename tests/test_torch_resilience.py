"""paddle_tpu_torch.resilience held to paddle_tpu.resilience on the CPU.

* fault plans: the JSON round trip, the registry, and the injection
  schedule of a seeded plan — the same as the JAX package's for the
  same seed and hit counts (pure simulation and live log alike), the
  four kinds, corruption bytes equal to the JAX package's, and the
  default-off passthrough;
* the retry policy's seeded delays, equal to the JAX package's;
* the breaker's transitions and ``allow()`` answers over one event
  sequence, equal to the JAX package's;
* the degradation ladder's stages, transitions and Retry-After hints
  over one signal sequence, equal to the JAX package's;
* the error taxonomy and the wire form across the two packages;
* the fault sites of the port's checkpoint writers, Trainer and
  DataLoader worker (mirroring tests/test_resilience.py), a corrupt
  serial the JAX package also rejects, and a SIGKILL mid-publish;
* the decode batcher's solo re-step under a ``decoding.step`` raise,
  token-equal to the JAX package's streams.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import paddle_tpu.decoding as jdec
import paddle_tpu_torch as tfluid
import paddle_tpu_torch.decoding as tdec
from paddle_tpu import ckpt as jckpt
from paddle_tpu import resilience as jres
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.serving import errors as jerrors
from paddle_tpu_torch import ckpt as tckpt
from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch.resilience import (CircuitBreaker, FaultPlan,
                                         FaultRule, InjectedFault,
                                         RetryError, RetryPolicy, faults)
from paddle_tpu_torch.serving import errors as terrors

from _torch_port import CACHE, carried_scope, jax_lm, torch_lm

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = tfluid.CPUPlace()


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    """Every test starts and ends with no plan in either package."""
    faults.clear_plan()
    jfaults.clear_plan()
    yield
    faults.clear_plan()
    jfaults.clear_plan()


def _plan(pkg, seed=17):
    return (pkg.FaultPlan(seed=seed)
            .rule("serving.step", "delay", prob=0.4, delay_ms=0, count=3)
            .rule("decoding.step", "raise", prob=0.3)
            .rule("trainer.step", "raise", hits=[2, 5])
            .rule("decoding.prefix_commit", "corrupt", prob=0.5))


# ---------------------------------------------------------------------------
# fault plane
# ---------------------------------------------------------------------------


def test_fault_points_table_is_the_jax_packages():
    assert tres.FAULT_POINTS == jres.FAULT_POINTS


def test_fault_plan_roundtrip_and_registry_warning():
    plan = (FaultPlan(seed=3)
            .rule("trainer.step", "raise", hits=[1, 4])
            .rule("serving.step", "delay", prob=0.5, delay_ms=1))
    clone = FaultPlan.from_dict(json.loads(plan.to_json()))
    assert clone.to_dict() == plan.to_dict()
    # the same builder calls give the same JSON in both packages, and
    # each package reads the other's
    jplan = (jres.FaultPlan(seed=3)
             .rule("trainer.step", "raise", hits=[1, 4])
             .rule("serving.step", "delay", prob=0.5, delay_ms=1))
    assert plan.to_json() == jplan.to_json()
    assert jres.load_plan(plan.to_json()).to_dict() == plan.to_dict()
    with pytest.warns(UserWarning, match="unregistered"):
        FaultPlan(seed=0, faults=[FaultRule("no.such.site", "raise",
                                            hits=[0])])
    with pytest.raises(ValueError):
        FaultRule("trainer.step", "explode", hits=[0])
    with pytest.raises(ValueError):
        FaultRule("trainer.step", "raise")  # neither hits nor prob


@pytest.mark.parametrize("seed", [0, 17, 123])
def test_schedule_equals_the_jax_packages(seed):
    counts = {"serving.step": 40, "decoding.step": 25, "trainer.step": 7,
              "decoding.prefix_commit": 30}
    assert _plan(tres, seed).schedule(counts) == \
        _plan(jres, seed).schedule(counts)


def test_live_log_equals_the_jax_packages_and_its_simulation():
    """Same seed, same hits: the live injection logs of both packages
    are equal, and each equals its plan's pure simulation site by site
    (except a probabilistic corrupt rule given payloads: the live
    corruption draws from the rule's RNG too, in both packages)."""
    logs = {}
    for name, pkg, fmod in (("torch", tres, faults),
                            ("jax", jres, jfaults)):
        plan = _plan(pkg)
        fmod.install_plan(plan)
        for i in range(25):
            for site in ("serving.step", "decoding.step", "trainer.step",
                         "decoding.prefix_commit"):
                try:
                    fmod.fire(site, b"payload-%d" % i)
                except pkg.InjectedFault:
                    pass
        logs[name] = (fmod.injection_log(), fmod.hit_counts(),
                      fmod.injections())
        sim = plan.schedule(fmod.hit_counts())
        for site in set(fmod.hit_counts()) - {"decoding.prefix_commit"}:
            assert [r for r in logs[name][0] if r["site"] == site] == \
                [r for r in sim if r["site"] == site]
        fmod.clear_plan()
    assert logs["torch"] == logs["jax"]
    assert logs["torch"][2]["serving.step:delay"] == 3  # count cap


def test_fault_kinds_raise_delay_corrupt(tmp_path):
    plan = (FaultPlan(seed=1)
            .rule("trainer.step", "raise", hits=[0])
            .rule("serving.step", "delay", hits=[0], delay_ms=30)
            .rule("ckpt.payload", "corrupt", hits=[0, 1, 2, 3]))
    faults.install_plan(plan)
    with pytest.raises(InjectedFault) as ei:
        faults.fire("trainer.step")
    assert ei.value.site == "trainer.step" and ei.value.hit == 0
    t0 = time.perf_counter()
    faults.fire("serving.step")
    assert time.perf_counter() - t0 >= 0.025
    out = faults.fire("ckpt.payload", b"hello world")
    assert out != b"hello world" and len(out) == 11
    p = tmp_path / "payload.bin"
    p.write_bytes(b"A" * 64)
    faults.fire("ckpt.payload", str(p))
    assert p.read_bytes() != b"A" * 64
    d = tmp_path / "entry"
    d.mkdir()
    (d / "config.json").write_bytes(b"B" * 32)
    faults.fire("ckpt.payload", str(d))
    assert (d / "config.json").read_bytes() != b"B" * 32
    arr = np.arange(6, dtype=np.float32)
    bad = faults.fire("ckpt.payload", arr)
    assert np.isinf(bad).sum() == 1 and np.isfinite(arr).all()
    # the corruption draws from the rule's RNG: the JAX package flips
    # the same byte for the same plan
    jfaults.install_plan(jres.FaultPlan.from_dict(plan.to_dict()))
    faults.install_plan(plan)
    assert faults.fire("ckpt.payload", b"0123456789" * 4) == \
        jfaults.fire("ckpt.payload", b"0123456789" * 4)


def test_crash_kind_kills_the_process():
    """``crash`` is SIGKILL: a child process that fires it dies with
    -9 and runs nothing after the site."""
    code = ("from paddle_tpu_torch.resilience import faults\n"
            "faults.install_plan({'seed': 0, 'faults': [{'site': "
            "'trainer.step', 'kind': 'crash', 'hits': [0]}]})\n"
            "faults.fire('trainer.step')\nprint('survived')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=_child_env(), capture_output=True, timeout=300)
    assert r.returncode == -9 and b"survived" not in r.stdout


def test_default_off_passthrough_and_env_and_flag_activation(
        tmp_path, monkeypatch):
    payload = object()
    assert faults.fire("trainer.step", payload) is payload
    assert faults.injections() == {} and faults.injection_log() == []
    assert faults.active_plan() is None
    plan = FaultPlan(seed=2).rule("trainer.step", "raise", hits=[0])
    # the env route (a fresh load sees it; a cleared plan stays cleared)
    monkeypatch.setenv(faults.ENV_VAR, plan.to_json())
    faults._ENV_CHECKED = False
    faults._STATE = None
    assert faults.active_plan() is not None
    with pytest.raises(InjectedFault):
        faults.fire("trainer.step")
    faults.clear_plan()
    assert faults.fire("trainer.step", payload) is payload
    # the flag route, read when the env var is unset
    monkeypatch.delenv(faults.ENV_VAR)
    tfluid.set_flags({"fault_plan": plan.to_json()})
    try:
        faults._ENV_CHECKED = False
        faults._STATE = None
        with pytest.raises(InjectedFault):
            faults.fire("trainer.step")
    finally:
        tfluid.set_flags({"fault_plan": ""})
        faults.clear_plan()
    # the file route
    pf = tmp_path / "plan.json"
    pf.write_text(plan.to_json())
    assert faults.load_plan(str(pf)).to_dict() == plan.to_dict()
    assert faults.plan_env(plan) == {faults.ENV_VAR: plan.to_json()}


def test_injections_and_transitions_emit_spans():
    from paddle_tpu_torch import profiler

    profiler.reset_profiler()
    profiler.start_profiler("CPU")
    try:
        faults.install_plan(FaultPlan(seed=0).rule(
            "serving.step", "delay", hits=[0], delay_ms=1))
        faults.fire("serving.step")
        br = CircuitBreaker(min_samples=1, failure_rate=0.1)
        br.record_failure()
        tres.DegradationManager().force_stage(2)
        counts = profiler.event_counts()
        assert counts.get("resilience/fault.serving.step") == 1
        assert counts.get("resilience/breaker.open") == 1
        assert counts.get("resilience/degrade.preemption") == 1
    finally:
        profiler.stop_profiler(print_report=False)
        profiler.reset_profiler()


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(max_attempts=6, base_delay_s=0.1, max_delay_s=0.5,
         multiplier=2.0, jitter=0.25, seed=4),
    dict(max_attempts=9, base_delay_s=0.01, max_delay_s=2.0,
         multiplier=3.0, jitter=0.5, seed=11),
    dict(max_attempts=2, base_delay_s=0.0, jitter=0.0)])
def test_retry_delays_equal_the_jax_packages(kw):
    p, jp = RetryPolicy(**kw), jres.RetryPolicy(**kw)
    d = p.delays()
    assert d == jp.delays()
    p.reset()
    assert p.delays() == d  # seeded jitter is reproducible
    assert len(d) == kw["max_attempts"] - 1


def test_retry_call_classification_and_exhaustion():
    sleeps = []
    p = RetryPolicy(max_attempts=3, base_delay_s=0.01, jitter=0.0,
                    sleep=sleeps.append)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise terrors.QueueFullError("full")
        return "ok"

    assert p.call(flaky, retriable=terrors.is_retriable) == "ok"
    assert len(calls) == 3 and len(sleeps) == 2

    def fatal():
        raise terrors.ServerClosedError("closed")

    with pytest.raises(terrors.ServerClosedError):
        p.call(fatal, retriable=terrors.is_retriable)

    def always():
        raise terrors.QueueFullError("still full")

    with pytest.raises(RetryError) as ei:
        p.call(always, retriable=terrors.is_retriable)
    assert ei.value.attempts == 3
    assert isinstance(ei.value.__cause__, terrors.QueueFullError)
    assert tres.retry_call(lambda: 5) == 5


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------


def _breaker_trace(pkg, events):
    t = [0.0]
    br = pkg.CircuitBreaker(window=8, min_samples=4, failure_rate=0.5,
                            reset_timeout_s=10.0, half_open_probes=1,
                            queue_trip_after=3, clock=lambda: t[0])
    answers = []
    for ev, arg in events:
        if ev == "t":
            t[0] = arg
        elif ev == "ok":
            br.record_success()
        elif ev == "fail":
            br.record_failure()
        elif ev == "full":
            br.record_pressure(arg)
        elif ev == "allow":
            answers.append(br.allow())
    snap = br.snapshot()
    return ([(r["from"], r["to"], r["reason"]) for r in br.transitions],
            answers, snap["state"], snap["window_samples"])


def test_breaker_transitions_equal_the_jax_packages():
    events = ([("ok", None)] * 2 + [("fail", None)] * 3
              + [("allow", None), ("t", 5.0), ("allow", None),
                 ("t", 11.0), ("allow", None), ("allow", None),
                 ("fail", None), ("t", 22.0), ("allow", None),
                 ("ok", None), ("allow", None)]
              + [("full", True)] * 2 + [("full", False)]
              + [("full", True)] * 3 + [("allow", None), ("t", 33.0),
                                         ("allow", None), ("t", 44.0),
                                         ("allow", None), ("ok", None)])
    got = _breaker_trace(tres, events)
    assert got == _breaker_trace(jres, events)
    assert got[0][:5] == [("closed", "open", "error"),
                          ("open", "half_open", "reset_timeout"),
                          ("half_open", "open", "probe_failure"),
                          ("open", "half_open", "reset_timeout"),
                          ("half_open", "closed", "probe_success")]
    assert ("closed", "open", "queue_depth") in got[0]


def test_breaker_half_open_probe_rearm():
    t = [0.0]
    br = CircuitBreaker(window=4, min_samples=2, failure_rate=0.5,
                        reset_timeout_s=1.0, half_open_probes=1,
                        clock=lambda: t[0])
    br.record_failure()
    br.record_failure()
    assert br.state == "open"
    t[0] = 1.5
    assert br.allow()       # the probe slot — its outcome gets lost
    assert not br.allow()
    t[0] = 2.0
    assert not br.allow()   # still inside the probe's grace window
    t[0] = 3.0
    assert br.allow()       # re-armed: the breaker stays live
    br.record_success()
    assert br.state == "closed"


# ---------------------------------------------------------------------------
# degradation ladder
# ---------------------------------------------------------------------------


def _ladder_trace(pkg, signals):
    t = [0.0]
    mgr = pkg.DegradationManager(
        pkg.DegradationConfig(up_after=2, down_after=3, step_ms_high=50.0,
                              stall_age_s=5.0),
        clock=lambda: t[0])
    stages, hints = [], []
    for i, sig in enumerate(signals):
        t[0] = float(i)
        stages.append(mgr.evaluate(sig))
        hints.append(mgr.retry_after_s())
    return (stages, [(r["from"], r["to"], r["reason"])
                     for r in mgr.transitions], hints, mgr.snapshot())


def test_ladder_stages_equal_the_jax_packages():
    rng = np.random.RandomState(5)
    signals = []
    for i in range(120):
        hot = (i // 30) % 2 == 0
        signals.append({
            "queue_frac": float(rng.uniform(0.6, 1.4) if hot
                                else rng.uniform(0.0, 0.3)),
            "pool_frac": float(rng.uniform(0.0, 1.0)),
            "breaker_open": bool(rng.rand() < 0.1),
            "step_ms_ema": float(rng.uniform(10, 80)),
            "progress_age_s": float(rng.uniform(0, 8))})
    got = _ladder_trace(tres, signals)
    want = _ladder_trace(jres, signals)
    assert got == want
    assert max(got[0]) == 4 and got[0][-1] < 4
    assert tres.STAGE_NAMES == jres.STAGE_NAMES


def test_ladder_predicates_budget_and_hint():
    mgr = tres.DegradationManager(tres.DegradationConfig())
    lo, mid, hi = tres.PRIORITY_LOW, tres.PRIORITY_NORMAL, \
        tres.PRIORITY_HIGH
    assert mgr.may_admit(lo, 100, 0, 100) and mgr.spec_enabled()
    mgr.force_stage(1)
    assert mgr.may_admit(hi, 10, 90, 100)
    assert not mgr.may_admit(mid, 10, 85, 100)
    assert mgr.may_admit(mid, 10, 80, 100)
    assert not mgr.may_admit(lo, 10, 70, 100)
    mgr.force_stage(3)
    assert not mgr.spec_enabled() and mgr.tighten_cache()
    mgr.force_stage(4)
    assert mgr.should_shed(lo) and not mgr.should_shed(mid)
    assert mgr.retry_after_s() > 0.0
    m = tfluid.serving.DecodeMetrics()
    mgr.bind_metrics(m)
    assert m.degradation_stage == 4
    mgr.force_stage(0)
    assert m.degradation_stage == 0
    assert tres.clamp_priority(None) == mid and tres.clamp_priority(9) == lo


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------


def test_error_taxonomy_and_wire_form_across_packages():
    retriable = [terrors.QueueFullError("x"),
                 terrors.DeadlineExceededError("x"),
                 terrors.CircuitOpenError("x"),
                 terrors.OverloadedError("x", retry_after_s=0.25),
                 terrors.GenerationInterruptedError("x", tokens=[3, 4])]
    fatal = [terrors.ServerClosedError("x"),
             terrors.PromptTooLongError("x")]
    assert all(terrors.is_retriable(e) for e in retriable)
    assert not any(terrors.is_retriable(e) for e in fatal)
    assert not terrors.is_retriable(terrors.DraftEngineError("x"))
    assert not terrors.is_retriable(RuntimeError("not ours"))
    for e in retriable + fatal + [terrors.DraftEngineError("d")]:
        wire = e.to_wire()
        # the port's wire form is the JAX package's, both directions
        j = jerrors.from_wire(wire)
        assert type(j).__name__ == type(e).__name__
        assert j.to_wire() == wire
        back = terrors.from_wire(j.to_wire())
        assert type(back) is type(e) and back.to_wire() == wire
        assert terrors.is_retriable(back) == jerrors.is_retriable(j)
    assert terrors.from_wire(retriable[3].to_wire()).retry_after_s == 0.25
    assert terrors.from_wire(retriable[4].to_wire()).tokens == [3, 4]
    unknown = terrors.from_wire({"error": "Nope", "message": "m"})
    assert type(unknown) is RuntimeError and "Nope" in str(unknown)


def test_unported_names_raise_naming_their_item(tmp_path):
    for name in ("Supervisor", "supervise", "note_progress",
                 "SupervisorGaveUp", "read_heartbeat", "HEARTBEAT_ENV"):
        with pytest.raises(NotImplementedError, match="Queue A 10"):
            getattr(tres, name)
    # decode-shape autotune, once refused naming Queue A 8, is ported
    # (tests/test_torch_tuning.py serves through it)
    assert tdec.DecodingConfig(autotune=True).autotune is True
    # the artifact backend is ported: a missing directory is a missing
    # file, and an exported model serves from its directory alone
    with pytest.raises(FileNotFoundError):
        tfluid.serving.BucketedEngine.from_artifact("/nonexistent",
                                                    place=CPU)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        out = tfluid.layers.fc(input=x, size=2, act="softmax")
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    d = str(tmp_path / "model")
    tfluid.io.save_inference_model(d, ["x"], [out], exe, main_program=main,
                                   scope=scope, export_batch_sizes=[1, 2])
    srv = tfluid.serving.serve_program(d, place=CPU, auto_start=False)
    assert srv.engine.buckets == [1, 2] and srv.engine.compile_count == 0
    feed = {"x": np.ones((2, 4), "float32")}
    want, = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    np.testing.assert_array_equal(srv.engine.run(feed)[0], want)
    # breaker= and degrade= are accepted now
    cfg = tdec.DecodingConfig(breaker=CircuitBreaker(),
                              degrade=tres.DegradationConfig())
    assert cfg.breaker is not None and cfg.degrade is not None


# ---------------------------------------------------------------------------
# fault sites of the checkpoint writers, the Trainer, the DataLoader
# ---------------------------------------------------------------------------


def test_ckpt_corrupted_payload_falls_back_to_newest_valid(tmp_path):
    root = str(tmp_path / "ck")
    faults.install_plan(FaultPlan(seed=6).rule("ckpt.payload", "corrupt",
                                               hits=[1]))
    w0 = np.arange(8, dtype=np.float32)
    tckpt.save_checkpoint(root, {"w": w0})            # serial 0: valid
    tckpt.save_checkpoint(root, {"w": w0 + 1})        # serial 1: corrupt
    faults.clear_plan()
    assert tckpt.is_valid(root, 0) and not tckpt.is_valid(root, 1)
    assert tckpt.latest_valid_serial(root) == 0
    # the JAX package rejects the same serial
    assert jckpt.latest_valid_serial(root) == 0
    state, _ = tckpt.load_checkpoint(root)
    np.testing.assert_array_equal(state["w"], w0)


def test_ckpt_elastic_publish_and_payload_sites(tmp_path):
    root = str(tmp_path / "el")
    faults.install_plan(FaultPlan(seed=4)
                        .rule("ckpt.payload", "corrupt", hits=[1])
                        .rule("ckpt.publish", "raise", hits=[2]))
    w = torch.arange(6, dtype=torch.float32)
    assert tckpt.save_checkpoint_elastic(root, {"w": w}) == 0
    assert tckpt.save_checkpoint_elastic(root, {"w": w + 1}) == 1
    with pytest.raises(InjectedFault):
        tckpt.save_checkpoint_elastic(root, {"w": w + 2})
    assert faults.hit_counts() == {"ckpt.payload": 2, "ckpt.publish": 3}
    faults.clear_plan()
    assert tckpt.is_valid(root, 0) and not tckpt.is_valid(root, 1)
    assert tckpt.list_checkpoints(root) == [0, 1]  # the raise published
    assert jckpt.latest_valid_serial(root) == 0    # nothing, no orphan
    assert not [n for n in os.listdir(root) if n.startswith(".ckpt_tmp_")]


def _child_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PYTEST_CURRENT_TEST")}
    env["PYTHONPATH"] = REPO
    return env


def test_ckpt_crashed_mid_publish_is_swept(tmp_path):
    """A real SIGKILL at ``ckpt.publish`` (after the temp dir exists,
    before the rename) leaves one orphan and no serial; the sweep
    reclaims it and the next save works."""
    root = str(tmp_path / "ck")
    plan = FaultPlan(seed=0).rule("ckpt.publish", "crash", hits=[0])
    env = _child_env()
    env[faults.ENV_VAR] = plan.to_json()
    code = ("import numpy as np\n"
            "from paddle_tpu_torch import ckpt\n"
            "ckpt.save_checkpoint(%r, {'w': np.zeros(4, 'float32')})\n"
            % root)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, timeout=300)
    assert r.returncode == -9, r.stderr.decode(errors="replace")[-2000:]
    orphans = [n for n in os.listdir(root) if n.startswith(".ckpt_tmp_")]
    assert len(orphans) == 1
    assert tckpt.list_checkpoints(root) == []
    assert len(tckpt.sweep_orphans(root, max_age_s=0.0)) == 1
    assert os.listdir(root) == []
    serial = tckpt.save_checkpoint(root, {"w": np.ones(4, np.float32)})
    assert tckpt.is_valid(root, serial)


def _train_bits():
    def train_func():
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        y = tfluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = tfluid.layers.fc(input=x, size=1)
        return tfluid.layers.mean(tfluid.layers.square_error_cost(pred, y))

    def reader():
        r = np.random.RandomState(0)
        for _ in range(4):
            xb = r.randn(2, 4).astype("float32")
            yield [(xb[i], xb[i].sum(keepdims=True)) for i in range(2)]

    return train_func, reader


@pytest.mark.parametrize("steps_per_loop", [1, 2])
def test_trainer_step_fault_point(steps_per_loop):
    train_func, reader = _train_bits()
    done = []

    def handler(ev):
        if isinstance(ev, tfluid.EndStepEvent):
            done.append(ev.step)

    t = tfluid.Trainer(train_func=train_func,
                       optimizer_func=lambda: tfluid.SGD(learning_rate=0.1),
                       place=CPU)
    t.train(num_epochs=1, reader=reader, feed_order=["x", "y"],
            event_handler=handler, steps_per_loop=steps_per_loop)
    assert len(done) == 4
    faults.install_plan(FaultPlan(seed=0).rule("trainer.step", "raise",
                                               hits=[1]))
    done.clear()
    t2 = tfluid.Trainer(train_func=train_func,
                        optimizer_func=lambda: tfluid.SGD(
                            learning_rate=0.1), place=CPU)
    with pytest.raises(InjectedFault):
        t2.train(num_epochs=1, reader=reader, feed_order=["x", "y"],
                 event_handler=handler, steps_per_loop=steps_per_loop)
    # the fault fires before the step (group) it guards runs
    assert len(done) == steps_per_loop
    assert faults.hit_counts() == {"trainer.step": 2}


def test_reader_worker_fault_surfaces_in_consumer():
    from paddle_tpu_torch.reader.prefetch import overlap_iter

    faults.install_plan(FaultPlan(seed=0).rule("reader.worker", "raise",
                                               hits=[1]))
    gen, _stop = overlap_iter([1, 2, 3], lambda x: x * 10, 2,
                              "test-reader")
    out = [next(gen)]
    with pytest.raises(InjectedFault):
        for item in gen:
            out.append(item)
    assert out == [10]


def test_dataloader_worker_fault_surfaces_in_the_run():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        y = tfluid.layers.mean(tfluid.layers.fc(input=x, size=2))
    exe = tfluid.Executor(CPU)
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)

    def reader():
        for i in range(4):
            yield [(np.full(4, i, np.float32),), (np.ones(4, np.float32),)]

    loader = tfluid.reader.DataLoader(reader, place=CPU, program=main,
                                      feed_list=["x"])
    faults.install_plan(FaultPlan(seed=0).rule("reader.worker", "delay",
                                               hits=[0], delay_ms=1)
                        .rule("reader.worker", "raise", hits=[2]))
    got = []
    with pytest.raises(InjectedFault):
        while True:
            got.append(exe.run(main, feed=loader, fetch_list=[y],
                               scope=scope)[0])
    assert len(got) == 2
    assert faults.injections() == {"reader.worker:delay": 1,
                                   "reader.worker:raise": 1}


# ---------------------------------------------------------------------------
# decoding: the solo re-step, token-equal to the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm():
    j_main, j_scope, j_logits = jax_lm()
    t_main, _, t_logits = torch_lm()
    return (j_main, j_scope, j_logits, t_main,
            carried_scope(j_main, j_scope, t_main), t_logits)


def _batcher(lm, pkg):
    j_main, j_scope, j_logits, t_main, t_scope, t_logits = lm
    config = pkg.DecodingConfig(cache=pkg.CacheConfig(**CACHE),
                                decode_buckets=(1, 2, 4),
                                max_new_tokens=8, warm_up=False)
    if pkg is tdec:
        engine = tdec.DecodeEngine(t_main, "tokens", t_logits.name,
                                   scope=t_scope, config=config, place=CPU)
    else:
        engine = jdec.DecodeEngine(j_main, "tokens", j_logits.name,
                                   scope=j_scope, config=config)
    return pkg.ContinuousBatcher(engine)


def _run_sync(batcher, pkg, reqs):
    """Admit every request, then step to the end (no worker thread: the
    fault hits line up with the executions)."""
    out = [pkg.GenerationRequest(p, n) for p, n in reqs]
    waiting = list(out)
    batcher.admit_from(waiting)
    assert not waiting
    while batcher.active:
        batcher.step()
    res = []
    for r in out:
        try:
            res.append(r.future.result(timeout=0))
        except Exception as e:  # the class and the partial stream
            res.append((type(e).__name__, list(getattr(e, "tokens", []))))
    return res


REQS = [([3, 1, 4], 6), ([2, 7], 6), ([5, 9, 2, 6], 6)]


@pytest.mark.parametrize("hits", [[0], [0, 1, 2], [2, 3, 4, 6]])
def test_decode_restep_streams_equal_the_jax_packages(lm, hits):
    """A failed batch decode step costs each sequence a solo re-step
    under RetryPolicy(max_attempts=2); a sequence whose solo tries fail
    too gets GenerationInterruptedError with its partial stream. Under
    the same plan both packages give the same streams, errors and
    injection logs."""
    results, logs = {}, {}
    for pkg, fmod in ((tdec, faults), (jdec, jfaults)):
        b = _batcher(lm, pkg)
        clean = _run_sync(b, pkg, REQS)
        # install after the prefills: hit 0 is the first batch step
        res = []
        reqs = [pkg.GenerationRequest(p, n) for p, n in REQS]
        waiting = list(reqs)
        b.admit_from(waiting)
        fmod.install_plan({"seed": 0, "faults": [
            {"site": "decoding.step", "kind": "raise", "hits": hits}]})
        while b.active:
            b.step()
        for r in reqs:
            try:
                res.append(r.future.result(timeout=0))
            except Exception as e:
                res.append((type(e).__name__, list(e.tokens)))
        results[pkg.__name__] = (clean, res, b.metrics.get("retries_total"),
                                 b.metrics.get("sequences_interrupted"))
        logs[pkg.__name__] = fmod.injection_log()
        fmod.clear_plan()
        assert b.kv.reclaimable_blocks == b.kv.config.num_blocks
    t, j = results["paddle_tpu_torch.decoding"], \
        results["paddle_tpu.decoding"]
    assert t == j
    assert logs["paddle_tpu_torch.decoding"] == logs["paddle_tpu.decoding"]
    clean, res = t[0], t[1]
    for got, want in zip(res, clean):
        if isinstance(got, tuple):
            assert got[0] == "GenerationInterruptedError"
            assert want[:len(got[1])] == got[1]
        else:
            assert got == want
    if hits == [0]:
        assert res == clean  # one transient failure costs nothing
