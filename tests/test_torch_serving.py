"""paddle_tpu_torch.serving (the bucketed request server) held to
paddle_tpu.serving on the CPU.

One small MLP is built with the same calls in both packages and the
JAX package's initialized parameters are carried into the port. Both
serve it through ``serve_program`` with the same buckets; every fetch
is held to the JAX package's at f32 rtol 1e-5 / atol 1e-6. Mirrors
tests/test_serving.py (less its artifact and predictor tests, which
wait for the native predictor) and the serving half of
tests/test_resilience.py: padding and oversize chunks, a non-batched
fetch, batch timeout, queue-full and deadline errors, drain and
no-drain shutdown, poison isolation under the ``serving.step`` fault,
the breaker opening and recovering, stage-4 shedding, health, and
incompatible shapes.
"""

import concurrent.futures as cf
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import serving as jserving
from paddle_tpu.core import unique_name as j_unique_name
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch.resilience import (PRIORITY_HIGH, PRIORITY_LOW,
                                         CircuitBreaker, DegradationConfig,
                                         DegradationManager, FaultPlan,
                                         InjectedFault, RetryPolicy, faults)
from paddle_tpu_torch.serving import (BucketedEngine, CircuitOpenError,
                                      DeadlineExceededError,
                                      InferenceServer, OverloadedError,
                                      QueueFullError, ServerClosedError,
                                      ServingConfig, is_retriable,
                                      serve_program)

torch.set_num_threads(1)

BUCKETS = [1, 2, 4, 8]
TOL = dict(rtol=1e-5, atol=1e-6)
CPU = tfluid.CPUPlace()


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    faults.clear_plan()
    jfaults.clear_plan()
    yield
    faults.clear_plan()
    jfaults.clear_plan()


def _mlp(pkg, unique_name):
    main, startup = pkg.Program(), pkg.Program()
    with unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[8], dtype="float32")
        h = pkg.layers.fc(input=x, size=16, act="relu")
        out = pkg.layers.fc(input=h, size=4, act="softmax")
    return main, startup, out


@pytest.fixture(scope="module")
def mlp():
    """(jax (main, scope, out), torch (main, scope, out))."""
    j_main, j_startup, j_out = _mlp(jfluid, j_unique_name)
    j_scope = jfluid.Scope()
    with jfluid.scope_guard(j_scope):
        jfluid.Executor(jfluid.CPUPlace()).run(j_startup)
    t_main, _, t_out = _mlp(tfluid, tfluid.unique_name)
    t_scope = tfluid.Scope()
    tfluid.params_from_numpy(
        {p.name: np.asarray(j_scope.find_var(p.name))
         for p in j_main.all_parameters()}, t_scope, CPU, program=t_main)
    return (j_main, j_scope, j_out), (t_main, t_scope, t_out)


def _jax_direct(mlp, x):
    j_main, j_scope, j_out = mlp[0]
    with jfluid.scope_guard(j_scope):
        return jfluid.Executor(jfluid.CPUPlace()).run(
            j_main, feed={"x": x}, fetch_list=[j_out])[0]


def _server(mlp, **kw):
    t_main, t_scope, t_out = mlp[1]
    auto_start = kw.pop("auto_start", True)
    return serve_program(t_main, feed_names=["x"], fetch_list=[t_out],
                         scope=t_scope, config=ServingConfig(**kw),
                         place=CPU, auto_start=auto_start)


def _engine(mlp, fetch=None, **kw):
    t_main, t_scope, t_out = mlp[1]
    return BucketedEngine.from_program(
        t_main, feed_names=["x"], fetch_list=fetch or [t_out],
        scope=t_scope, config=ServingConfig(**kw), place=CPU)


# ---------------------------------------------------------------- engine


def test_engine_pads_odd_batches_and_matches_jax(mlp):
    """Bucket padding round-trips exact rows for batch sizes that are
    not buckets; every fetch matches the JAX package's engine and a
    direct run."""
    j_main, j_scope, j_out = mlp[0]
    eng = _engine(mlp, buckets=BUCKETS)
    jeng = jserving.BucketedEngine.from_program(
        j_main, feed_names=["x"], fetch_list=[j_out], scope=j_scope,
        config=jserving.ServingConfig(buckets=BUCKETS))
    assert eng.buckets == jeng.buckets == BUCKETS
    assert eng.warm_up() == 0  # nothing is captured on the CPU
    rng = np.random.RandomState(0)
    for n in (1, 3, 5, 7, 8):
        x = rng.randn(n, 8).astype("float32")
        got, = eng.run({"x": x})
        assert got.shape == (n, 4)
        np.testing.assert_allclose(got, jeng.run({"x": x})[0], **TOL)
        np.testing.assert_allclose(got, _jax_direct(mlp, x), **TOL)
    rep = eng.metrics.report()
    # 1, 3->4, 5->8, 7->8, 8: 29 executed rows, 5 of them padding
    assert (rep["batched_rows_total"], rep["padded_rows_total"]) == (29, 5)
    assert rep["batch_execute"]["count"] == 5
    assert eng.compile_count == 0


def test_engine_oversize_batch_chunks(mlp):
    eng = _engine(mlp, buckets=BUCKETS)
    x = np.random.RandomState(2).randn(19, 8).astype("float32")
    got, = eng.run({"x": x})
    assert got.shape[0] == 19
    np.testing.assert_allclose(got, _jax_direct(mlp, x), **TOL)
    # 8 + 8 + 3 (padded to 4)
    assert eng.metrics.get("batched_rows_total") == 20


def test_non_batched_fetch_with_bucket_sized_lead(mlp):
    """A fetch whose leading dim equals a bucket (the first fc weight,
    (8, 16), with bucket 8) is not sliced: warm-up calibrates
    batched-ness from two bucket sizes, as in the JAX package."""
    t_main, t_scope, t_out = mlp[1]
    w = [p for p in t_main.global_block().all_parameters()
         if tuple(p.shape) == (8, 16)][0]
    eng = _engine(mlp, fetch=[t_out, w], buckets=[2, 4, 8])
    eng.warm_up()
    assert eng.batched_fetch_mask == [True, False]
    x = np.random.RandomState(6).randn(5, 8).astype("float32")
    got_out, got_w = eng.run({"x": x})
    assert got_out.shape[0] == 5 and got_w.shape == (8, 16)
    np.testing.assert_allclose(got_out, _jax_direct(mlp, x), **TOL)
    np.testing.assert_array_equal(got_w, t_scope.find_var(w.name).numpy())
    got_out19, got_w19 = eng.run(
        {"x": np.random.RandomState(7).randn(19, 8).astype("float32")})
    assert got_out19.shape[0] == 19 and got_w19.shape == (8, 16)


def test_engine_refuses_a_feed_without_a_batch_axis_and_warns_hazards():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4, 8], dtype="float32",
                               append_batch_size=False)
        y = tfluid.layers.fc(input=x, size=2)
        z = tfluid.layers.data(name="z", shape=[-1, -1], dtype="float32",
                               append_batch_size=False)
        s = tfluid.layers.reduce_sum(z)
    with pytest.raises(tfluid.EnforceError, match="leading batch axis"):
        BucketedEngine.from_program(main, ["x"], [y], place=CPU)
    # a dynamic non-batch axis defeats "one graph per bucket": warned
    with pytest.warns(UserWarning, match="serving engine"):
        BucketedEngine.from_program(main, ["z"], [s], place=CPU,
                                    config=ServingConfig(buckets=[2]))


# ---------------------------------------------------------------- server


def test_concurrent_mixed_batches_match_jax_and_coalesce(mlp):
    """36 mixed-size requests from 16 client threads: every reply
    equals the JAX package's server's reply to the same request, the
    batcher coalesced, and the spans are in the profiler table."""
    j_main, j_scope, j_out = mlp[0]
    rng = np.random.RandomState(7)
    feeds = [rng.randn(1 + (i % 7), 8).astype("float32")
             for i in range(36)]
    jsrv = jserving.serve_program(
        j_main, feed_names=["x"], fetch_list=[j_out], scope=j_scope,
        config=jserving.ServingConfig(buckets=BUCKETS))
    try:
        want = [jsrv.infer({"x": f}, timeout=60)[0] for f in feeds]
    finally:
        jsrv.shutdown(drain=True, timeout=60)
    tprofiler.reset_profiler()
    tprofiler.start_profiler("CPU")
    srv = _server(mlp, buckets=BUCKETS, batch_timeout_ms=2.0,
                  queue_capacity=128)
    try:
        with cf.ThreadPoolExecutor(max_workers=16) as pool:
            got = list(pool.map(
                lambda f: srv.infer({"x": f}, timeout=60)[0], feeds))
    finally:
        srv.shutdown(drain=True, timeout=60)
        tprofiler.stop_profiler(print_report=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    assert srv.metrics.get("batches_total") < len(feeds)
    assert srv.metrics.get("responses_total") == len(feeds)
    counts = tprofiler.event_counts()
    tprofiler.reset_profiler()
    assert counts["serving/batcher"] == srv.metrics.get("batches_total")
    assert counts["serving/engine"] >= counts["serving/batcher"]
    rep = srv.metrics.report()
    assert rep["queue_wait"]["count"] == len(feeds)
    assert 0.0 <= rep["padding_overhead"] < 1.0
    assert "--- serving metrics ---" in srv.metrics.render()


def test_batch_timeout_flushes_partial_batch(mlp):
    with _server(mlp, buckets=BUCKETS, batch_timeout_ms=20.0) as srv:
        x = np.ones((3, 8), "float32")
        t0 = time.monotonic()
        got, = srv.infer({"x": x}, timeout=30)
        assert time.monotonic() - t0 < 10.0
        np.testing.assert_allclose(got, _jax_direct(mlp, x), **TOL)
        assert srv.metrics.get("batches_total") == 1


def test_queue_full_rejection_typed_error(mlp):
    srv = _server(mlp, buckets=BUCKETS, queue_capacity=2, warm_up=False,
                  auto_start=False)
    x = np.ones((1, 8), "float32")
    srv.submit({"x": x})
    srv.submit({"x": x})
    with pytest.raises(QueueFullError) as ei:
        srv.submit({"x": x})
    assert is_retriable(ei.value)
    assert srv.metrics.get("queue_full_rejections") == 1
    srv.start()
    srv.shutdown(drain=True, timeout=30)
    assert srv.metrics.get("responses_total") == 2


def test_deadline_expiry_typed_error(mlp):
    srv = _server(mlp, buckets=BUCKETS, warm_up=False, auto_start=False)
    fut = srv.submit({"x": np.ones((2, 8), "float32")}, deadline_ms=1.0)
    time.sleep(0.05)  # expire while queued (no worker yet)
    srv.start()
    with pytest.raises(DeadlineExceededError):
        fut.result(timeout=30)
    assert srv.metrics.get("deadline_expired") == 1
    srv.shutdown()


def test_queue_full_and_deadline_resubmit_through_the_policy(mlp):
    """Queue-full is retriable, and a client resubmit through the shared
    RetryPolicy lands once the worker drains (a slow engine)."""
    srv = _server(mlp, buckets=[1], queue_capacity=1, auto_start=False)
    orig = srv.engine._execute

    def slow(arrays):
        time.sleep(0.2)
        return orig(arrays)

    srv.engine._execute = slow
    srv.start()
    try:
        feed = {"x": np.ones((1, 8), np.float32)}
        futs = [srv.submit(feed)]
        time.sleep(0.05)
        futs.append(srv.submit(feed))
        with pytest.raises(QueueFullError):
            while True:
                futs.append(srv.submit(feed))
        policy = RetryPolicy(max_attempts=8, base_delay_s=0.2,
                             max_delay_s=1.0, jitter=0.0)
        futs.append(policy.call(lambda: srv.submit(feed),
                                retriable=is_retriable))
        for f in futs:
            np.testing.assert_allclose(f.result(timeout=60)[0],
                                       _jax_direct(mlp, feed["x"]), **TOL)
    finally:
        srv.shutdown(drain=True, timeout=60)


def test_shutdown_drains_in_flight_requests(mlp):
    srv = _server(mlp, buckets=BUCKETS, batch_timeout_ms=1.0)
    rng = np.random.RandomState(4)
    feeds = [rng.randn(1 + (i % 4), 8).astype("float32")
             for i in range(12)]
    futs = [srv.submit({"x": f}) for f in feeds]
    srv.shutdown(drain=True, timeout=60)
    for f, fut in zip(feeds, futs):
        np.testing.assert_allclose(fut.result(timeout=0)[0],
                                   _jax_direct(mlp, f), **TOL)
    with pytest.raises(ServerClosedError):
        srv.submit({"x": feeds[0]})
    assert srv.health()["status"] == "shutdown"


def test_shutdown_without_drain_fails_pending(mlp):
    srv = _server(mlp, buckets=BUCKETS, warm_up=False, auto_start=False)
    futs = [srv.submit({"x": np.ones((1, 8), "float32")})
            for _ in range(3)]
    srv.shutdown(drain=False, timeout=30)
    for fut in futs:
        with pytest.raises(ServerClosedError):
            fut.result(timeout=0)


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_poison_request_fails_alone(mlp, pkg):
    """A ``serving.step`` raise on the coalesced batch re-runs its
    requests one by one; the second solo run is hit too, so exactly
    that request fails — the same one in both packages."""
    j_main, j_scope, j_out = mlp[0]
    feeds = [np.full((2, 8), float(i), np.float32) for i in range(3)]
    if pkg == "torch":
        eng = _engine(mlp, buckets=BUCKETS, batch_timeout_ms=200.0)
        srv = InferenceServer(eng, auto_start=False)
        fmod, fault = faults, InjectedFault
    else:
        eng = jserving.BucketedEngine.from_program(
            j_main, feed_names=["x"], fetch_list=[j_out], scope=j_scope,
            config=jserving.ServingConfig(buckets=BUCKETS,
                                          batch_timeout_ms=200.0))
        srv = jserving.InferenceServer(eng, auto_start=False)
        from paddle_tpu.resilience import InjectedFault as fault
        fmod = jfaults
    futs = [srv.submit({"x": f}) for f in feeds]
    fmod.install_plan({"seed": 0, "faults": [
        {"site": "serving.step", "kind": "raise", "hits": [0, 2]}]})
    srv.start()  # all three coalesce into one batch, which fails
    outcome = []
    for f, x in zip(futs, feeds):
        try:
            got, = f.result(timeout=30)
            np.testing.assert_allclose(got, _jax_direct(mlp, x), **TOL)
            outcome.append("ok")
        except fault:
            outcome.append("poison")
    srv.shutdown()
    assert outcome == ["ok", "poison", "ok"]
    assert srv.metrics.get("request_errors") == 1
    assert srv.metrics.get("batches_total") == 1
    assert fmod.injections() == {"serving.step:raise": 2}


def test_incompatible_shapes_batch_separately(mlp):
    from paddle_tpu_torch.serving.batcher import Request, concat_feeds

    a = Request({"x": np.ones((2, 8), "float32")})
    b = Request({"x": np.ones((2, 4), "float32")})
    c = Request({"x": np.zeros((3, 8), "float32")})
    assert a.signature() != b.signature()
    assert a.signature() == c.signature()
    assert concat_feeds([a, c])["x"].shape == (5, 8)
    # in a live server the odd one is carried to a batch of its own,
    # where it fails alone (its rows do not fit the first fc)
    srv = _server(mlp, buckets=BUCKETS, batch_timeout_ms=50.0,
                  warm_up=False, auto_start=False)
    f1 = srv.submit({"x": np.ones((2, 8), "float32")})
    f2 = srv.submit({"x": np.ones((2, 5), "float32")})
    f3 = srv.submit({"x": np.ones((1, 8), "float32")})
    srv.start()
    np.testing.assert_allclose(f1.result(timeout=30)[0],
                               _jax_direct(mlp, np.ones((2, 8), "float32")),
                               **TOL)
    with pytest.raises(Exception):
        f2.result(timeout=30)
    assert f3.result(timeout=30)[0].shape == (1, 4)
    srv.shutdown(drain=True, timeout=30)
    assert srv.metrics.get("batches_total") == 3
    assert srv.metrics.get("request_errors") == 1


# ------------------------------------------------------- resilience wiring


def test_breaker_opens_on_injected_errors_and_recovers(mlp):
    br = CircuitBreaker(window=8, min_samples=2, failure_rate=0.5,
                        reset_timeout_s=0.2, half_open_probes=1)
    srv = _server(mlp, buckets=[1], batch_timeout_ms=0.1, breaker=br)
    try:
        faults.install_plan(FaultPlan(seed=0).rule(
            "serving.step", "raise", hits=list(range(4))))
        feed = {"x": np.ones((1, 8), np.float32)}
        injected, open_seen = 0, None
        for _ in range(6):
            try:
                f = srv.submit(feed)
            except CircuitOpenError as e:
                open_seen = e
                break
            with pytest.raises(InjectedFault):
                f.result(timeout=60)
            injected += 1
        assert injected == 2  # min_samples failures, then the trip
        assert open_seen is not None and is_retriable(open_seen)
        assert br.state == "open"
        assert srv.metrics.get("breaker_rejections") >= 1
        assert srv.metrics.get("breaker_transitions") >= 1
        policy = RetryPolicy(max_attempts=12, base_delay_s=0.1,
                             max_delay_s=0.5, jitter=0.0)
        out = policy.call(
            lambda: srv.submit(feed).result(timeout=60),
            retriable=lambda e: (is_retriable(e)
                                 or isinstance(e, InjectedFault)))
        np.testing.assert_allclose(out[0], _jax_direct(mlp, feed["x"]),
                                   **TOL)
        deadline = time.monotonic() + 10
        while br.state != "closed" and time.monotonic() < deadline:
            time.sleep(0.01)
        assert br.state == "closed"
        health = srv.health()
        assert health["status"] == "serving"
        assert health["breaker"]["state"] == "closed"
        assert health["last_progress_age_s"] is not None
    finally:
        srv.shutdown(drain=True, timeout=60)


def test_health_snapshot_states_and_registration(mlp):
    from paddle_tpu_torch.obs import metrics as obs_metrics

    srv = _server(mlp, buckets=BUCKETS, warm_up=False)
    h = srv.health()
    assert h["status"] == "serving" and h["breaker"] == {
        "state": "disabled"}
    assert h["queue_capacity"] == 256 and h["degradation_stage"] == 0
    assert obs_metrics.health_snapshot()["sources"][
        srv.metrics.sink]["status"] == "serving"
    srv.shutdown(drain=True, timeout=60)
    assert srv.health()["status"] == "shutdown"
    assert srv.metrics.sink not in obs_metrics.health_snapshot()["sources"]


def test_stage4_sheds_the_lowest_class(mlp):
    mgr = DegradationManager(DegradationConfig(down_after=1000))
    srv = _server(mlp, buckets=[1, 2, 4], queue_capacity=16,
                  warm_up=False, degrade=mgr)
    try:
        feed = {"x": np.zeros((2, 8), np.float32)}
        assert srv.infer(feed, timeout=60)
        mgr.force_stage(4, "test")
        with pytest.raises(OverloadedError) as ei:
            srv.submit(feed, priority=PRIORITY_LOW)
        assert is_retriable(ei.value) and ei.value.retry_after_s > 0
        got, = srv.infer(feed, priority=PRIORITY_HIGH, timeout=60)
        np.testing.assert_allclose(got, _jax_direct(mlp, feed["x"]), **TOL)
        assert srv.health()["degradation_stage"] == 4
        assert srv.metrics.get("admissions_rejected_total") == 1
        assert srv.metrics.degradation_stage == 4
    finally:
        srv.shutdown(drain=True, timeout=60)


def test_request_trace_spans_join_across_the_worker(mlp):
    """With tracing on, one request is one trace: the ``serving/enqueue``
    root on the client thread, the batcher and engine spans on the
    worker thread parented into it."""
    from paddle_tpu_torch.obs import trace

    trace.enable()
    tprofiler.reset_profiler()
    try:
        with _server(mlp, buckets=[1, 2], warm_up=False) as srv:
            fut = srv.submit({"x": np.ones((1, 8), np.float32)})
            fut.result(timeout=30)
            ctx = fut.trace_ctx
        spans = tprofiler.get_spans(with_trace=True)
    finally:
        trace.disable()
        tprofiler.reset_profiler()
    by_name = {s[0]: s for s in spans}
    root = by_name["serving/enqueue"]
    assert root[5] == (ctx.trace_id, ctx.span_id, "")
    for name in ("serving/batcher", "serving/engine"):
        rec = by_name[name]
        assert rec[5][0] == ctx.trace_id
        assert rec[4] != root[4]  # recorded on the worker thread
    assert by_name["serving/batcher"][5][2] == ctx.span_id
    assert by_name["serving/engine"][5][2] == by_name["serving/batcher"][5][1]
