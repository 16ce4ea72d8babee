"""paddle_tpu_torch's observability tooling held to paddle_tpu's on the
CPU: ``obs/{steplog,watch,record}``, the rest of ``profiler``,
``timeline`` and ``tools/{trace,postmortem,top}``.

* **StepStats.** The same ``fit_a_line`` Trainer run in both packages
  (the JAX package's weights carried into the port) writes records
  with the same keys, and losses within rtol 1e-5 (the slice's
  cross-package tolerance: one f32 matmul summed in another order); the
  eager, ``steps_per_loop`` (``run_steps``) and ``DataLoader`` paths
  all write one record a step; a loss held in an async ``FetchHandle``
  is absent (null), never synced.
* **Steplog.** Rotation is atomic, and ``tools.top`` follows it.
* **Watch rules.** Each built-in rule fires and clears on the same
  inputs as the JAX package's (``tests/test_record.py:216-252``).
* **Bundles.** A bundle the port dumps passes both packages'
  ``validate_bundle``; its env pins name torch; a Trainer's and a
  serving worker's unhandled exception and a degradation at the
  configured stage dump one.
* **Unchanged values.** Fingerprints, capture counts and metric values
  are the same with the recorder and tracing on and off.
* **CLIs.** ``tools.trace``, ``tools.postmortem``, ``tools.top`` and
  ``tools.cache`` exit as the JAX package's on the same files; the
  profiler's ``sorted_key`` report, its span ring and ``annotate``.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu.core import unique_name as j_unique_name
from paddle_tpu.obs import record as j_record
from paddle_tpu.obs import watch as j_watch
from paddle_tpu.tools import postmortem as j_postmortem
from paddle_tpu.tools import top as j_top
from paddle_tpu.tools import trace as j_trace_cli
from paddle_tpu_torch import profiler, timeline
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.obs import metrics as obs_metrics
from paddle_tpu_torch.obs import record, steplog, trace, watch
from paddle_tpu_torch.tools import postmortem as t_postmortem
from paddle_tpu_torch.tools import top as t_top
from paddle_tpu_torch.tools import trace as t_trace_cli

torch.set_num_threads(1)

CPU = fluid.CPUPlace()
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
STEPLOG_KEYS = {"epoch", "step", "dt_s", "loss", "fresh_compiles", "t"}


@pytest.fixture(autouse=True)
def _planes_off():
    """Recorder, tracing and the profiler are process-global: every test
    starts and ends with them off."""
    record.disable()
    trace.disable()
    profiler.reset_profiler()
    yield
    record.disable()
    trace.disable()
    profiler.stop_profiler(print_report=False)
    profiler.reset_profiler()


def _enable(tmp_path, **kw):
    kw.setdefault("interval_s", 60.0)  # no ticks mid-test
    kw.setdefault("rolling", False)
    kw.setdefault("install_handlers", False)
    return record.enable(dir=str(tmp_path / "rec"), **kw)


def _rc(fn, argv):
    """A CLI's exit code: its return, or its SystemExit's code."""
    try:
        return fn(argv)
    except SystemExit as e:
        return e.code


# --------------------------------------------------------------- StepStats


def _fit_func(pkg):
    def train_func():
        x = pkg.layers.data(name="x", shape=[13], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        pred = pkg.layers.fc(input=x, size=1, act=None)
        return pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
    return train_func


def _fit_reader(n=6):
    w = np.random.RandomState(0).randn(13, 1).astype(np.float32)

    def reader():
        r = np.random.RandomState(1)
        for _ in range(n):
            xb = r.randn(8, 13).astype(np.float32)
            yb = xb @ w + 0.5
            yield [(xb[i], yb[i]) for i in range(8)]
    return reader


def _sgd(pkg):
    return lambda: pkg.optimizer.SGD(learning_rate=0.05)


def test_steplog_records_match_the_jax_package(tmp_path):
    j_path, t_path = str(tmp_path / "jax.jsonl"), str(tmp_path / "t.jsonl")
    with j_unique_name.guard():
        jt = jfluid.Trainer(_fit_func(jfluid), _sgd(jfluid),
                            place=jfluid.CPUPlace(), steplog=j_path)
    tt = fluid.Trainer(_fit_func(fluid), _sgd(fluid), place=CPU,
                       steplog=t_path)
    fluid.state_from_numpy(
        {n: np.asarray(jt.scope.find_var(n))
         for n in tt.scope.local_var_names()}, tt.scope, CPU,
        program=tt.train_program)
    jt.train(2, reader=_fit_reader(), feed_order=["x", "y"])
    tt.train(2, reader=_fit_reader(), feed_order=["x", "y"])
    jt.stop()
    tt.stop()
    j_recs = list(j_record_steplog(j_path))
    t_recs = list(steplog.read_steplog(t_path))
    assert len(t_recs) == len(j_recs) == 12
    for jr, tr in zip(j_recs, t_recs):
        assert set(tr) == set(jr) == STEPLOG_KEYS
        assert (tr["epoch"], tr["step"]) == (jr["epoch"], jr["step"])
        assert tr["dt_s"] > 0 and tr["fresh_compiles"] == 0
    np.testing.assert_allclose([r["loss"] for r in t_recs],
                               [r["loss"] for r in j_recs], **LOSS_TOL)


def j_record_steplog(path):
    from paddle_tpu.obs.steplog import read_steplog

    return read_steplog(path)


def test_steplog_on_the_run_steps_and_loader_paths(tmp_path):
    from paddle_tpu_torch.reader import DataLoader

    runs = {}
    for name in ("eager", "run_steps", "loader"):
        path = str(tmp_path / (name + ".jsonl"))
        t = fluid.Trainer(_fit_func(fluid), _sgd(fluid), place=CPU,
                          steplog=path)
        if name == "loader":
            t.train(1, reader=DataLoader(
                _fit_reader(), feed_list=["x", "y"], place=CPU,
                program=t.train_program, chunk=1), log_every=2)
        else:
            t.train(1, reader=_fit_reader(), feed_order=["x", "y"],
                    steps_per_loop=3 if name == "run_steps" else 1)
        t.stop()
        runs[name] = list(steplog.read_steplog(path))
    for name, recs in runs.items():
        assert [r["step"] for r in recs] == list(range(6)), name
    eager = [r["loss"] for r in runs["eager"]]
    assert [r["loss"] for r in runs["run_steps"]] == eager
    # the loader's off-boundary steps hold FetchHandles: never synced
    # for the log, so their loss is absent (null)
    loader = [r["loss"] for r in runs["loader"]]
    assert loader[0::2] == [None] * 3
    assert loader[1::2] == eager[1::2]


def test_steplogger_atomic_rotation_and_top_follows_it(tmp_path):
    path = str(tmp_path / "rot.jsonl")
    logger = steplog.StepLogger(path, rotate_bytes=400, max_rotations=2)
    for i in range(30):
        logger.log({"step": i, "v": "x" * 20})
    logger.close()
    assert os.path.exists(path + ".1")
    live = list(steplog.read_steplog(path))
    rolled = list(steplog.read_steplog(path + ".1"))
    assert max(r["step"] for r in live) == 29
    tail = 10
    assert len(live) < tail
    for top in (t_top, j_top):
        records = top.read_records(path, tail)
        assert [r["step"] for r in records] == \
            [r["step"] for r in (rolled + live)[-tail:]]


# ------------------------------------------------------------- watch rules


def _rule_sequence(pkg_watch, steps, ticks, registry_counter):
    """(rule, state) transitions a Watchdogs of the package emits over
    ``steps`` then ``ticks`` (each tick: counter increments, then a
    health view)."""
    w = pkg_watch.Watchdogs(rules=[
        pkg_watch.StepTimeSpike(factor=2.0, warmup_steps=2),
        pkg_watch.LossAnomaly(max_loss=100.0),
        pkg_watch.StallFraction(max_frac=0.5),
        pkg_watch.QueueSaturation(frac=0.9),
        pkg_watch.PrefixHitCollapse(min_rate=0.5, min_events=10),
        pkg_watch.CompileMissStorm(max_misses=3)])
    out = [[(a.rule, a.state) for a in w.observe_step(r)] for r in steps]
    assert w.observe_tick(health={}) == []  # the baseline tick
    for incs, health in ticks:
        for fam, labels, n in incs:
            registry_counter(fam, labels).inc(n)
        out.append([(a.rule, a.state)
                    for a in w.observe_tick(health=health)])
    return out


def test_watch_rules_fire_and_clear_as_the_jax_package():
    from paddle_tpu.obs import metrics as j_metrics

    steps = ([{"dt_s": 0.01, "loss": 1.0, "stall_frac": 0.1}] * 3
             + [{"dt_s": 0.5}]                      # spike
             + [{"loss": float("nan")}]              # loss
             + [{"loss": 1e6, "stall_frac": 0.9}]    # stall (loss firing)
             + [{"dt_s": 0.01, "loss": 1.0}] * 4)    # all clear
    sink = "watchtest-%d" % time.monotonic_ns()
    full = {"sources": {"sess": {"queue_depth": 19, "queue_capacity": 20}}}
    ticks = [([("pdtpu_serving_events_total",
                (("sink", sink), ("event", "prefix_cache_hits_total")), 1),
               ("pdtpu_serving_events_total",
                (("sink", sink), ("event", "prefix_cache_misses_total")),
                19),
               ("pdtpu_compile_cache_total", (("event", "miss"),), 10)],
              full)] + [([], {})] * 3

    def counter_of(module):
        def get(fam, labels):
            names = tuple(k for k, _ in labels)
            return module.REGISTRY.counter(fam, labels=names).labels(
                **dict(labels))
        return get

    got = _rule_sequence(watch, steps, ticks, counter_of(obs_metrics))
    want = _rule_sequence(j_watch, steps, ticks, counter_of(j_metrics))
    assert got == want
    fired = {t for ev in got for t in ev if t[1] == "firing"}
    cleared = {t[0] for ev in got for t in ev if t[1] == "cleared"}
    assert {r for r, _ in fired} == cleared == {
        "step_time_spike", "loss_anomaly", "stall_fraction",
        "queue_saturation", "prefix_hit_collapse", "compile_miss_storm"}
    for m in (obs_metrics, j_metrics):
        m.REGISTRY.counter("pdtpu_serving_events_total",
                           labels=("sink", "event")).remove_matching(
            sink=sink)


def test_default_rules_are_the_jax_set():
    assert [r.name for r in watch.default_rules()] == \
        [r.name for r in j_watch.default_rules()]
    for a, b in zip(watch.default_rules(), j_watch.default_rules()):
        assert (type(a).__name__, a.severity, vars(a)) == \
            (type(b).__name__, b.severity, vars(b))


# ----------------------------------------------------------------- bundles


def test_port_bundle_passes_both_validators(tmp_path):
    rec = _enable(tmp_path)
    trace.enable()
    with trace.root_span("req"):
        with profiler.RecordEvent("inner"):
            pass
    record.note_error(ValueError("boom"), context="unit")
    record.note_degradation(0, 1, "queue_frac=0.55")
    record.note_step({"step": 0, "dt_s": 0.01, "loss": 1.5})
    rec.tick()
    path = record.dump("manual")
    assert record.validate_bundle(path) == []
    assert j_record.validate_bundle(path) == []
    b = record.read_bundle(path)
    assert b == j_record.read_bundle(path)
    man = b["manifest"]
    assert man["env"]["torch"] == torch.__version__
    assert "jax" not in man["env"]
    assert set(man["stamps"]) == {"cache_metrics", "fingerprints"}
    spans = {s["name"]: s for s in b["trace"]}
    assert spans["inner"]["parent_id"] == spans["req"]["span_id"]
    assert b["errors"][0]["type"] == "ValueError"
    assert b["degrade"][0]["to"] == 1
    assert b["steplog"][0]["loss"] == 1.5
    assert b["metrics_history"]
    # tampering is caught by both
    with open(os.path.join(path, "errors.jsonl"), "a") as f:
        f.write("{torn json\n")
    assert record.validate_bundle(path) and j_record.validate_bundle(path)


def test_bundles_carry_capture_and_export_fingerprints(tmp_path):
    from paddle_tpu_torch.compile_cache import runtime

    flags.set_flags({"compile_cache_dir": str(tmp_path / "cc")})
    try:
        fp = runtime.note_capture(
            fluid.Program(), {"x": ((4, 13), torch.float32)}, {}, [],
            "graph", "cpu", {"donate": True})
    finally:
        flags.set_flags({"compile_cache_dir": ""})
    assert fp is not None
    assert runtime.note_capture(fluid.Program(), {}, {}, [], "graph",
                                "cpu") is None  # flag unset: nothing
    _enable(tmp_path)
    b = record.read_bundle(record.dump("manual"))
    stamps = b["manifest"]["stamps"]["fingerprints"]
    assert {"fingerprint": fp, "kind": "graph"} in [
        {k: s[k] for k in ("fingerprint", "kind")} for s in stamps]


def test_trainer_exception_and_degradation_dump_bundles(tmp_path):
    from paddle_tpu_torch.resilience import (DegradationManager,
                                             InjectedFault, faults)

    _enable(tmp_path, dump_at_stage=4)
    faults.install_plan({"seed": 0, "faults": [
        {"site": "trainer.step", "kind": "raise", "hits": [2]}]})
    try:
        t = fluid.Trainer(_fit_func(fluid), _sgd(fluid), place=CPU,
                          steplog=str(tmp_path / "run.jsonl"))
        with pytest.raises(InjectedFault):
            t.train(1, reader=_fit_reader(), feed_order=["x", "y"])
        t.stop()
    finally:
        faults.clear_plan()
    newest = record.latest_bundle(str(tmp_path / "rec"))
    assert newest.endswith("-exception")
    b = record.read_bundle(newest)
    assert b["errors"][-1]["context"] == "trainer.train"
    assert b["faults"]["injections"] == {"trainer.step:raise": 1}
    assert [r["step"] for r in b["steplog"]] == [0, 1]
    mgr = DegradationManager()
    mgr.force_stage(2, "test")
    assert not any(p.endswith("-degrade") for p in
                   record.find_bundles(str(tmp_path / "rec")))
    mgr.force_stage(4, "test")
    degrade = [p for p in record.find_bundles(str(tmp_path / "rec"))
               if p.endswith("-degrade")]
    assert [(r["from"], r["to"]) for r in
            record.read_bundle(degrade[-1])["degrade"]] == [(0, 2), (2, 4)]


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_serving_worker_death_dumps_a_bundle(tmp_path):
    from paddle_tpu_torch.serving import serve_program

    _enable(tmp_path)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        out = fluid.layers.fc(input=x, size=2)
    scope = fluid.Scope()
    fluid.Executor(CPU).run(startup, scope=scope)
    server = serve_program(main, feed_names=["x"], fetch_list=[out],
                           scope=scope, place=CPU)
    server.batcher.next_batch = None  # the loop itself breaks
    server.submit({"x": np.ones((1, 4), "float32")})
    server._worker.join(timeout=30)
    assert not server._worker.is_alive()
    newest = record.latest_bundle(str(tmp_path / "rec"))
    assert newest and newest.endswith("-exception")
    assert j_record.validate_bundle(newest) == []
    assert "InferenceServer.worker" in \
        record.read_bundle(newest)["errors"][-1]["context"]
    server.shutdown(drain=False, timeout=10)


def test_the_recorder_does_not_pin_a_dead_worker(tmp_path):
    """The recorder remembers which exception it dumped by identity, not
    by reference: a dead server (its engine and, on a card, its CUDA
    graphs) is freed at once, without the cyclic collector, while the
    recorder stays enabled. (The thread's own excepthook is replaced:
    pytest's keeps the traceback until the test ends.)"""
    import gc
    import threading
    import weakref

    from paddle_tpu_torch.serving import InferenceServer, serve_program

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        out = fluid.layers.fc(input=x, size=2)
    scope = fluid.Scope()
    fluid.Executor(CPU).run(startup, scope=scope)

    def die():
        first = serve_program(main, feed_names=["x"], fetch_list=[out],
                              scope=scope, place=CPU)
        engine = first.engine
        first.shutdown(drain=True, timeout=10)
        server = InferenceServer(engine, auto_start=False)
        server.start()
        server.batcher.next_batch = None
        server.submit({"x": np.ones((1, 4), "float32")})
        server._worker.join(timeout=30)
        server.shutdown(drain=False, timeout=10)
        return weakref.ref(engine)

    _enable(tmp_path)
    died = []
    hook = threading.excepthook
    threading.excepthook = lambda a: died.append(a.exc_type)
    gc.collect()
    gc.disable()
    try:
        engine = die()
        assert died == [TypeError]
        assert record.latest_bundle(str(tmp_path / "rec")).endswith(
            "-exception")
        assert engine() is None
    finally:
        gc.enable()
        threading.excepthook = hook


def test_values_are_unchanged_with_recorder_and_tracing(tmp_path):
    from paddle_tpu_torch.compile_cache import (CompilationUnit,
                                                cache_metrics)
    from paddle_tpu_torch.serving.metrics import ServingMetrics

    def unit():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), \
                fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            y = fluid.layers.fc(input=x, size=8, act="relu")
        return main, startup, y

    def values():
        main, startup, y = unit()
        fp = CompilationUnit(main, ["x"], [y.name]).fingerprint(
            {"x": ((8, 4), "float32")}, {}, config={}, env={"pin": "t"})
        scope, exe = fluid.Scope(), fluid.Executor(CPU)
        exe.run(startup, scope=scope)
        feed = {"x": np.ones((2, 4), "float32")}
        out = [exe.run(main, feed=feed, fetch_list=[y], scope=scope)[0]
               for _ in range(2)]
        m = ServingMetrics()
        m.inc("requests_total", 3)
        rep = m.report()
        rep.pop("queue_depth")
        return (fp, exe.num_compiled, json.dumps(rep, sort_keys=True),
                cache_metrics(), [o.tolist() for o in out])

    off = values()
    _enable(tmp_path)
    trace.enable()
    on = values()
    record.disable()
    trace.disable()
    assert off == on == values()


# -------------------------------------------------------- profiler, CLIs


def test_profiler_report_ring_and_annotate(tmp_path):
    flags.set_flags({"profiler_max_spans": 50})
    try:
        with profiler.profiler("CPU", "calls",
                               str(tmp_path / "report.txt")):
            assert profiler.is_profiler_enabled()
            for _ in range(100):
                with profiler.RecordEvent("many"):
                    pass
            with profiler.annotate("once"):
                pass
        assert not profiler.is_profiler_enabled()
        assert len(profiler.get_spans()) == 50
        assert profiler.spans_dropped() == 51
        assert profiler.event_counts() == {"many": 100, "once": 1}
        assert profiler.event_totals()["spans_dropped"] == 51
        assert obs_metrics.REGISTRY.gauge(
            "pdtpu_profiler_spans_dropped_total").value == 51
        assert [s[0] for s in profiler.get_spans(tail=2)] == \
            ["many", "once"]
        report = open(tmp_path / "report.txt").read().splitlines()
        rows = [ln.split()[0] for ln in report[3:] if ln.strip()]
        assert rows == ["many", "once"]  # sorted by calls
    finally:
        flags.set_flags({"profiler_max_spans": 1_000_000})
        profiler.reset_profiler()


def test_device_trace_dir_writes_a_valid_chrome_trace(tmp_path):
    d = str(tmp_path / "dev")
    profiler.start_profiler("All", trace_dir=d)
    with profiler.RecordEvent("traced_region"):
        torch.randn(64, 64) @ torch.randn(64, 64)
    profiler.stop_profiler(print_report=False)
    path = profiler.device_trace_path()
    assert path == os.path.join(d, profiler.DEVICE_TRACE_FILE)
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "traced_region" in names
    assert _rc(t_trace_cli.main, ["validate", path]) == 0
    assert _rc(j_trace_cli.main, ["validate", path]) == 0


def test_trace_cli_exits_as_the_jax_cli(tmp_path, capsys):
    trace.enable()
    profiler.start_profiler("CPU")
    with trace.root_span("cli_root"):
        with profiler.RecordEvent("cli_child"):
            pass
    trace.disable()
    good = timeline.export_chrome_trace(str(tmp_path / "good.json"))
    doc = json.load(open(good))
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in spans} == {"cli_root", "cli_child"}
    assert all(e["args"]["trace_id"] for e in spans)
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    for argv, want in ((["validate", good], 0), (["summary", good], 0),
                       (["tree", good], 0), (["validate", str(bad)], 1),
                       (["validate", str(tmp_path / "nope.json")], 2),
                       ([], 2)):
        got = [_rc(cli.main, argv) for cli in (t_trace_cli, j_trace_cli)]
        capsys.readouterr()
        assert got == [want, want], argv


def test_postmortem_cli_exits_as_the_jax_cli(tmp_path, capsys):
    trace.enable()
    _enable(tmp_path)
    with trace.root_span("cli_root"):
        with profiler.RecordEvent("cli_child"):
            pass
    obs_metrics.counter("t_pm_total").inc(1)
    a = record.dump("manual")
    obs_metrics.counter("t_pm_total").inc(5)
    b = record.dump("exception")
    rec_dir = str(tmp_path / "rec")
    empty = tmp_path / "empty"
    empty.mkdir()
    cases = [(["validate", a], 0), (["validate", rec_dir], 0),
             (["summary", b], 0), (["tree", b], 0), (["diff", a, b], 0),
             (["validate", str(tmp_path / "nope")], 2),
             (["validate", str(empty)], 2), ([], 2)]
    for argv, want in cases:
        got = [_rc(cli.main, argv) for cli in (t_postmortem, j_postmortem)]
        capsys.readouterr()
        assert got == [want, want], argv
    t_postmortem.main(["summary", b])
    out = capsys.readouterr().out
    assert "torch=" + torch.__version__ in out
    with open(os.path.join(a, "metrics.json"), "w") as f:
        f.write("{tampered")
    got = [_rc(cli.main, ["validate", a])
           for cli in (t_postmortem, j_postmortem)]
    capsys.readouterr()
    assert got == [1, 1]


def test_top_cli_exits_as_the_jax_cli(tmp_path, capsys):
    log = tmp_path / "run.jsonl"
    log.write_text("\n".join(
        json.dumps({"epoch": 0, "step": i, "dt_s": 0.01,
                    "loss": 1.0 / (i + 1), "spans": {"dispatch": 0.008}})
        for i in range(5)) + "\n")
    empty = tmp_path / "empty.jsonl"
    empty.write_text("not json at all\n")
    for argv, want in (([str(log), "--tail", "3"], 0),
                       ([str(log), "--tail", "3", "--once"], 0),
                       ([str(empty)], 1), ([str(empty), "--once"], 1),
                       ([str(tmp_path / "nope.jsonl")], 2)):
        outs = []
        for cli in (t_top, j_top):
            assert _rc(cli.main, argv) == want, (cli, argv)
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1], argv
    t_top.main([str(log), "--tail", "3", "--once"])
    once = json.loads(capsys.readouterr().out.strip())
    assert [r["step"] for r in once["records"]] == [2, 3, 4]
    assert once["steps_per_sec"] == pytest.approx(100.0)
