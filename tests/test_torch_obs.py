"""paddle_tpu_torch.obs.{metrics,trace} held to paddle_tpu.obs on the CPU.

* the registry: the same calls give the same Prometheus text and the
  same JSON snapshot in both packages; label values escape per the
  exposition format; a kind or label conflict raises;
* the serving metrics live in the registry under the JAX package's
  family names, and DecodeMetrics' report carries both key sets;
* ``/metrics`` and ``/healthz`` over loopback;
* tracing: parent ids chain within a thread, ``attach`` carries a
  context across threads, the env value round-trips, and tracing off
  records nothing; one decode request is one trace across the client,
  worker and streaming threads. Mirrors tests/test_obs.py.
"""

import json
import threading
import urllib.request

import pytest
import torch

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.decoding as tdec
from paddle_tpu.obs import metrics as jmetrics
from paddle_tpu.obs import trace as jtrace
from paddle_tpu_torch import profiler
from paddle_tpu_torch.obs import metrics as obs_metrics
from paddle_tpu_torch.obs import trace

from _torch_port import CACHE, carried_scope, jax_lm, torch_lm

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _trace_off():
    trace.disable()
    yield
    trace.disable()
    profiler.reset_profiler()


def _exercise(mod):
    """The same calls against a fresh registry of either package."""
    reg = mod.Registry()
    c = reg.counter("t_requests_total", "reqs", labels=("route",))
    c.labels(route="a").inc()
    c.labels(route="a").inc(2)
    c.labels(route="b").inc()
    reg.counter("t_plain_total").inc(7)
    g = reg.gauge("t_depth", "queue depth")
    g.set(7)
    g.inc(0.5)
    h = reg.histogram("t_latency_ms", "lat", labels=("sink",))
    for v in (0.0004, 0.003, 1.0, 1.5, 3.0, 30.0, 250.0, 7e5):
        h.labels(sink="s0").observe(v)
    r = reg.histogram("t_rows", "rows", unit="rows",
                      bounds_ms=(1, 2, 4, 8, 16))
    for v in (1, 3, 3, 9, 40):
        r.observe(v)
    esc = reg.counter("t_esc_total", "esc", labels=("path",))
    esc.labels(path='C:\\tmp\n"quoted"').inc()
    return reg


def test_prometheus_text_and_snapshot_equal_the_jax_packages():
    got, want = _exercise(obs_metrics), _exercise(jmetrics)
    assert got.render_prometheus() == want.render_prometheus()
    assert got.snapshot() == want.snapshot()
    h = got.families()[0]
    assert h.name == "t_requests_total"
    lat = [f for f in got.families() if f.name == "t_latency_ms"][0]
    child = lat.labels(sink="s0")
    jlat = [f for f in want.families() if f.name == "t_latency_ms"][0]
    for q in (0, 10, 50, 90, 99, 100):
        assert child.percentile(q) == jlat.labels(sink="s0").percentile(q)
    assert child.snapshot() == jlat.labels(sink="s0").snapshot()


def test_label_values_escape_per_exposition_spec():
    reg = obs_metrics.Registry()
    c = reg.counter("t_esc_total", "esc", labels=("path",))
    c.labels(path='C:\\tmp\n"quoted"').inc()
    assert ('t_esc_total{path="C:\\\\tmp\\n\\"quoted\\""} 1'
            in reg.render_prometheus().splitlines())


def test_registry_kinds_conflicts_and_sink_removal():
    reg = obs_metrics.Registry()
    c = reg.counter("t_requests_total", "reqs", labels=("route",))
    c.labels(route="a").inc(3)
    assert c.labels(route="a").value == 3
    text = reg.render_prometheus()
    assert '# TYPE t_requests_total counter' in text
    assert 't_requests_total{route="a"} 3' in text
    with pytest.raises(ValueError):
        reg.gauge("t_requests_total")
    with pytest.raises(ValueError):
        reg.counter("t_requests_total", labels=("other",))
    s = reg.counter("t_sunk_total", labels=("sink", "event"))
    s.labels(sink="a", event="x").inc()
    s.labels(sink="b", event="x").inc()
    assert reg.remove_sink("a") == 1
    assert [lab for lab, _ in s.children()] == [{"sink": "b", "event": "x"}]


def test_serving_metrics_live_in_the_registry():
    from paddle_tpu.serving.metrics import DecodeMetrics as JDecodeMetrics
    from paddle_tpu_torch.serving.metrics import (DecodeMetrics,
                                                  ServingMetrics)

    m = ServingMetrics()
    m.inc("requests_total", 5)
    m.queue_depth = 3
    assert m.get("requests_total") == 5
    rep = m.report()
    assert rep["requests_total"] == 5 and rep["queue_depth"] == 3
    assert "--- serving metrics ---" in m.render()
    fam = obs_metrics.REGISTRY.counter("pdtpu_serving_events_total",
                                       labels=("sink", "event"))
    assert fam.labels(sink=m.sink, event="requests_total").value == 5
    dm = DecodeMetrics()
    dm.note_decode_step(4, 0.002)
    dm.observe(dm.decode_step, 1.7)
    dm.observe(dm.verify, 2.5)
    dm.note_ttft(12.0)
    assert obs_metrics.REGISTRY.gauge(
        "pdtpu_serving_gauge", labels=("sink", "gauge")).labels(
        sink=dm.sink, gauge="tokens_per_sec").value == pytest.approx(2000)
    rep = dm.report()
    # every counter of the JAX package's DecodeMetrics is there
    assert set(JDecodeMetrics.COUNTERS) <= set(rep)
    assert rep["decode_step"]["count"] == 1 and rep["ttft"]["count"] == 1
    assert rep["decode_step"]["mean_ms"] == rep["decode_step"]["p99_ms"] \
        == 1.7
    assert rep["verify"]["count"] == 1 and rep["extend"]["count"] == 0
    assert rep["ttft_ms"] == 12.0
    assert rep["tokens_generated"] == rep["tokens_generated_total"] == 4
    text = obs_metrics.render_prometheus()
    assert 'pdtpu_serving_decode_step_ms_count{sink="%s"} 1' % dm.sink \
        in text.splitlines()
    dm.retire()
    assert dm.sink not in obs_metrics.render_prometheus()


def test_http_metrics_and_healthz_endpoints():
    obs_metrics.counter("t_http_total", "x").inc(2)
    obs_metrics.register_health("unit", lambda: {"status": "serving",
                                                 "queue_depth": 0})
    try:
        with obs_metrics.start_http_server(port=0) as srv:
            base = "http://127.0.0.1:%d" % srv.port
            body = urllib.request.urlopen(base + "/metrics").read()
            assert b"t_http_total 2" in body
            health = json.loads(
                urllib.request.urlopen(base + "/healthz").read())
            assert health["status"] == "ok"
            assert health["sources"]["unit"]["status"] == "serving"
            assert health["sources"]["metrics_http"]["port"] == srv.port
            assert obs_metrics.http_endpoint() == (srv.addr, srv.port)
            with pytest.raises(Exception):
                urllib.request.urlopen(base + "/nope")
        obs_metrics.register_health("sick", lambda: {"status": "draining"})
        assert obs_metrics.health_snapshot()["status"] == "degraded"
    finally:
        obs_metrics.unregister_health("unit")
        obs_metrics.unregister_health("sick")
    assert obs_metrics.http_endpoint() is None


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------


def test_trace_spans_chain_parent_ids():
    trace.enable()
    profiler.reset_profiler()
    with trace.root_span("request") as ctx:
        with profiler.RecordEvent("outer"):
            with profiler.RecordEvent("inner"):
                pass
    spans = {s[0]: s[5] for s in profiler.get_spans(with_trace=True)}
    assert spans["request"] == (ctx.trace_id, ctx.span_id, "")
    assert spans["outer"][0] == ctx.trace_id
    assert spans["outer"][2] == ctx.span_id
    assert spans["inner"][2] == spans["outer"][1]
    # the default shapes of get_spans stay (name, t0, t1)
    assert all(len(s) == 3 for s in profiler.get_spans())
    assert all(len(s) == 5 for s in profiler.get_spans(with_threads=True))


def test_trace_attach_across_threads():
    trace.enable()
    profiler.reset_profiler()
    with trace.root_span("req") as ctx:
        pass

    def worker():
        with trace.attach(ctx), profiler.RecordEvent("worker_side"):
            pass

    t = threading.Thread(target=worker, name="obs-test-worker")
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    (rec,) = [s for s in profiler.get_spans(with_trace=True)
              if s[0] == "worker_side"]
    assert rec[5][0] == ctx.trace_id and rec[5][2] == ctx.span_id
    assert rec[4] == "obs-test-worker"


def test_trace_off_records_nothing_and_env_value_roundtrip():
    assert not trace.enabled() and trace.current() is None
    profiler.reset_profiler()
    with trace.root_span("never") as ctx:
        assert ctx is None
    with trace.attach(None), profiler.RecordEvent("flat"):
        pass
    assert profiler.get_spans() == []
    trace.enable()
    val = trace.env_value()
    assert val and ":" in val
    ctx = trace.SpanContext.from_env_value(val)
    # the JAX package reads the port's context and back
    jctx = jtrace.SpanContext.from_env_value(val)
    assert (ctx.trace_id, ctx.span_id) == (jctx.trace_id, jctx.span_id)
    assert trace.SpanContext.from_env_value("garbage") is None


def test_decode_request_is_one_trace_across_threads():
    """enqueue (client thread) -> prefill and decode steps (worker) ->
    streamed tokens: one trace over at least two threads, every span
    parented inside it."""
    j_main, j_scope, j_logits = jax_lm()
    t_main, _, t_logits = torch_lm()
    scope = carried_scope(j_main, j_scope, t_main)
    s = tdec.serve_decoding(
        t_main, "tokens", t_logits.name, scope=scope,
        config=tdec.DecodingConfig(cache=tdec.CacheConfig(**CACHE),
                                   decode_buckets=(1, 2), warm_up=False),
        place=tfluid.CPUPlace())
    trace.enable()
    profiler.reset_profiler()
    try:
        fut = s.submit([3, 1, 4], max_new_tokens=4,
                       on_token=lambda t: None)
        fut.result(timeout=120)
    finally:
        s.shutdown(drain=True, timeout=60)
    spans = [sp for sp in profiler.get_spans(with_trace=True)
             if sp[5] is not None and sp[5][0] == fut.trace_ctx.trace_id]
    names = {sp[0] for sp in spans}
    assert {"decoding/enqueue", "decoding/engine.prefill",
            "decoding/engine.decode", "decoding/stream"} <= names
    assert len({sp[3] for sp in spans}) >= 2
    ids = {sp[5][1] for sp in spans}
    for sp in spans:
        if sp[0] != "decoding/enqueue":
            assert sp[5][2] in ids  # parented inside the trace
    assert sum(sp[0] == "decoding/stream" for sp in spans) == 4
