"""The decode tier's fault and overload paths in paddle_tpu_torch, held
to paddle_tpu on the CPU (mirrors tests/test_degrade.py).

The same small causal LM (and the one-layer draft) is built in both
packages with the JAX package's perturbed weights carried into the
port. Every stream the port serves under a fault, a preemption, a draft
fallback, a shed or a chaos storm is token-equal to the JAX package's
stream for the same request (its uninterrupted sequential oracle). The
worker is held at a chosen token by a blocking streaming callback, so
each preemption happens at the same point every run.
"""

import concurrent.futures as cf
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.decoding as jdec
import paddle_tpu_torch as tfluid
import paddle_tpu_torch.decoding as tdec
from paddle_tpu import resilience as jres
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu_torch.obs import metrics as obs_metrics
from paddle_tpu_torch.resilience import (PRIORITY_HIGH, PRIORITY_LOW,
                                         PRIORITY_NORMAL, FAULT_POINTS,
                                         DegradationConfig,
                                         DegradationManager, FaultPlan,
                                         faults)
from paddle_tpu_torch.serving import (DraftEngineError,
                                      GenerationInterruptedError,
                                      OverloadedError, ServerClosedError,
                                      is_retriable)

from _torch_port import (CACHE, DRAFT_LM, VOCAB, carried_scope, jax_lm,
                         torch_lm)

torch.set_num_threads(1)

CPU = tfluid.CPUPlace()
SMALL = dict(num_blocks=6, block_size=4, max_blocks_per_seq=4)
LO, HI = [2, 7, 1, 8, 2], [9, 9, 3, 3, 5, 6]
SP = dict(temperature=0.8, top_k=10, seed=42)


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    faults.clear_plan()
    jfaults.clear_plan()
    yield
    faults.clear_plan()
    jfaults.clear_plan()


@pytest.fixture(scope="module")
def lms():
    j = jax_lm()
    jd = jax_lm(seed=5, lm=DRAFT_LM)
    t_main, _, t_logits = torch_lm()
    td_main, _, td_logits = torch_lm(DRAFT_LM)
    return {"jax": j, "jax_draft": jd,
            "torch": (t_main, carried_scope(j[0], j[1], t_main), t_logits),
            "torch_draft": (td_main, carried_scope(jd[0], jd[1], td_main),
                            td_logits)}


def _config(pkg, cache=None, prefix_cache=True, max_new=8, capacity=256,
            **kw):
    return pkg.DecodingConfig(
        cache=pkg.CacheConfig(prefix_cache=prefix_cache,
                              **(cache or CACHE)),
        decode_buckets=kw.pop("decode_buckets", (1, 2, 4)),
        max_new_tokens=max_new, queue_capacity=capacity, warm_up=False,
        **kw)


def _session(lms, pkg=tdec, draft=False, **kw):
    side = "torch" if pkg is tdec else "jax"
    main, scope, logits = lms[side]
    extra = {}
    if draft:
        d_main, d_scope, d_logits = lms[side + "_draft"]
        extra = dict(draft_program=d_main, draft_logits_name=d_logits.name,
                     draft_scope=d_scope)
    if pkg is tdec:
        extra["place"] = CPU
    return pkg.serve_decoding(main, "tokens", logits.name, scope=scope,
                              config=_config(pkg, **kw), **extra)


def _oracle(lms, reqs, sampling=None, cache=None):
    """The JAX package's uninterrupted sequential streams."""
    s = _session(lms, jdec, prefix_cache=False, cache=cache,
                 sampling=sampling is not None)
    try:
        return [s.generate(p, max_new_tokens=n, timeout=300,
                           sampling=(None if sampling is None
                                     else jdec.SamplingParams(**sampling)))
                for p, n in reqs]
    finally:
        s.shutdown(drain=True, timeout=60)


@pytest.fixture(scope="module")
def oracle(lms):
    """JAX streams of the requests the tests below serve."""
    out = {}
    out["lo_sampled"], = _oracle(lms, [(LO, 8)], sampling=SP, cache=SMALL)
    out["lo"], out["hi"] = _oracle(lms, [(LO, 8), (HI, 8)], cache=SMALL)
    out["pi"], out["543"], out["123"] = _oracle(
        lms, [([3, 1, 4, 1, 5], 8), ([5, 4, 3], 4), ([1, 2, 3], 2)])
    return out


class _Hold:
    """A streaming callback that holds the worker at the ``at``-th token
    of a request until ``release()`` — the preemption then lands at a
    fixed point of the stream."""

    def __init__(self, at=1):
        self.at = at
        self.tokens = []
        self.reached = threading.Event()
        self.go = threading.Event()

    def __call__(self, tok):
        self.tokens.append(tok)
        if len(self.tokens) == self.at:
            self.reached.set()
            assert self.go.wait(timeout=120)

    def release(self):
        self.go.set()


def _pool_clean(s):
    kv = s.kv
    assert kv.live_sequences == 0
    assert kv.reclaimable_blocks == kv.config.num_blocks
    assert kv.cached_blocks == kv.evictable_blocks  # none ref-stuck
    dkv = s.batcher.draft_kv
    assert dkv is None or dkv.reclaimable_blocks == dkv.config.num_blocks


# ------------------------------------------------------------ ladder, KV


def test_ladder_hysteresis_both_directions_and_bounded_walkback():
    mgr = DegradationManager(DegradationConfig(up_after=3, down_after=2))
    jmgr = jres.DegradationManager(jres.DegradationConfig(up_after=3,
                                                          down_after=2))
    hot = {"queue_frac": 3.0, "pool_frac": 1.0}
    cold = {"queue_frac": 0.0, "pool_frac": 0.0}
    mid = {"queue_frac": 0.70, "pool_frac": 0.0}
    seq = [hot, cold] + [hot] * 15 + [mid] * 10 + [cold] * 10
    assert [mgr.evaluate(s) for s in seq] == [jmgr.evaluate(s) for s in seq]
    assert [t["to"] for t in mgr.transitions[:4]] == [1, 2, 3, 4]
    assert mgr.stage == 0 and mgr.snapshot()["transitions"] == 8


def _publish_rows(pkg):
    kv = pkg.KVCacheManager(pkg.CacheConfig(num_blocks=12, block_size=4,
                                            max_blocks_per_seq=3,
                                            prefix_cache=True))
    prompt = [1, 2, 3, 4, 5]
    sid, cached = kv.admit_tokens(prompt, 7)
    assert cached == 0
    kv.commit_prefix(sid)
    resume = prompt + [9, 8, 7]
    assert kv.publish_prefix(sid, resume) == 0
    assert kv.match_prefix(resume) == 4
    rows = [kv.table_row(sid).tolist()]
    kv.release(sid)
    assert kv.reclaimable_blocks == kv.config.num_blocks
    sid2, cached2 = kv.admit_tokens(resume, 4)
    assert cached2 == 4
    rows.append(kv.table_row(sid2).tolist())
    kv.release(sid2)
    sid3, _ = kv.admit_tokens(prompt, 7)
    resume3 = prompt + [4, 4, 4, 4]
    assert kv.publish_prefix(sid3, resume3) >= 1
    assert kv.match_prefix(resume3) == 8
    rows.append(kv.table_row(sid3).tolist())
    kv.release(sid3)
    assert kv.reclaimable_blocks == kv.config.num_blocks
    assert kv.cached_blocks == kv.evictable_blocks
    kv.drop_prefix_cache()
    assert kv.free_blocks == kv.config.num_blocks
    return rows


def test_publish_prefix_shares_written_blocks_and_never_leaks():
    """The preemption-time publish: the same block rows, matches and
    leak invariant in both packages."""
    assert _publish_rows(tdec) == _publish_rows(jdec)


@pytest.mark.parametrize("pkg,fmod", [(tdec, faults), (jdec, jfaults)])
def test_prefix_commit_corruption_degrades_to_private_blocks(pkg, fmod):
    fmod.install_plan({"seed": 3, "faults": [
        {"site": "decoding.prefix_commit", "kind": "corrupt",
         "prob": 1.0}]})
    m = (tfluid.serving.DecodeMetrics() if pkg is tdec else None)
    kv = pkg.KVCacheManager(pkg.CacheConfig(num_blocks=8, block_size=4,
                                            max_blocks_per_seq=4,
                                            prefix_cache=True), metrics=m)
    prompt = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    sid, _ = kv.admit_tokens(prompt, 3)
    kv.commit_prefix(sid)
    assert kv.cached_blocks == 0  # publish dropped, blocks private
    assert kv.publish_prefix(sid, prompt) == 0
    kv.release(sid)
    assert kv.reclaimable_blocks == kv.config.num_blocks
    assert fmod.injections() == {"decoding.prefix_commit:corrupt": 2}
    if m is not None:
        assert m.get("prefix_commits_dropped_total") == 2
    fmod.clear_plan()
    sid2, _ = kv.admit_tokens(prompt, 3)
    kv.commit_prefix(sid2)
    assert kv.cached_blocks == 2  # the clean path publishes again
    kv.release(sid2)


def test_fault_points_registered():
    for site in ("decoding.draft_step", "decoding.verify_step",
                 "decoding.prefix_commit", "serving.admission",
                 "decoding.step", "decoding.prefill"):
        assert site in FAULT_POINTS


# --------------------------------------------------- preemption end-to-end


@pytest.mark.parametrize("sampled", [False, True])
def test_priority_preemption_resumes_token_equal(lms, oracle, sampled):
    """A pool that holds ONE request: a low-class generation held at its
    first token is evicted for a high-class one, resumes through its
    published prefix, and both streams equal the JAX package's
    uninterrupted ones, with no streamed token repeated."""
    mgr = DegradationManager(DegradationConfig(down_after=10 ** 6))
    s = _session(lms, degrade=mgr, sampling=True, cache=SMALL)
    hold = _Hold(at=1)
    try:
        f_lo = s.submit(LO, max_new_tokens=8, priority=PRIORITY_LOW,
                        on_token=hold,
                        sampling=(tdec.SamplingParams(**SP) if sampled
                                  else None))
        assert hold.reached.wait(timeout=120)
        mgr.force_stage(2, "test")
        f_hi = s.submit(HI, max_new_tokens=8, priority=PRIORITY_HIGH)
        hold.release()
        assert f_hi.result(timeout=300) == oracle["hi"]
        want = oracle["lo_sampled"] if sampled else oracle["lo"]
        assert f_lo.result(timeout=300) == want
        assert hold.tokens == want  # streamed once each, in order
        rep = s.metrics.report()
        assert rep["preemptions_total"] == 1
        assert rep["prefix_cache_hits_total"] >= 1  # the resume hit
        assert rep["ttft"]["count"] == 2  # a resume is not a first token
        assert s.health()["degradation_stage"] == 2
    finally:
        hold.release()
        s.shutdown(drain=True, timeout=60)
    _pool_clean(s)


def test_drain_while_degraded_completes_preempted_sequences(lms, oracle):
    mgr = DegradationManager(DegradationConfig(down_after=10 ** 6))
    s = _session(lms, degrade=mgr, cache=SMALL)
    hold = _Hold(at=1)
    try:
        f_lo = s.submit(LO, max_new_tokens=8, priority=PRIORITY_LOW,
                        on_token=hold)
        assert hold.reached.wait(timeout=120)
        mgr.force_stage(4, "test")  # preemption AND shedding active
        f_hi = s.submit(HI, max_new_tokens=8, priority=PRIORITY_HIGH)
        hold.release()
    finally:
        hold.release()
        s.shutdown(drain=True, timeout=300)
    assert f_hi.result(timeout=10) == oracle["hi"]
    assert f_lo.result(timeout=10) == oracle["lo"]
    _pool_clean(s)


def test_abort_fails_preempted_queued_with_partial_stream(lms):
    s = _session(lms)
    try:
        req = tdec.GenerationRequest([1, 2, 3], 8, priority=PRIORITY_LOW)
        req.resume_tokens = [7, 8, 9]  # preempted after 3 tokens
        s._waiting.append(req)
        plain = tdec.GenerationRequest([4, 5], 4)
        s._waiting.append(plain)
        s._fail_pending()
        with pytest.raises(GenerationInterruptedError) as ei:
            req.future.result(timeout=0)
        assert ei.value.tokens == [7, 8, 9] and is_retriable(ei.value)
        with pytest.raises(ServerClosedError):
            plain.future.result(timeout=0)
    finally:
        s.shutdown(drain=True, timeout=60)


def test_leak_invariant_under_abort_preempt_resume_storm(lms):
    small = dict(num_blocks=8, block_size=4, max_blocks_per_seq=4)
    mgr = DegradationManager(DegradationConfig(down_after=10 ** 6))
    s = _session(lms, degrade=mgr, cache=small, capacity=64)
    hold = _Hold(at=2)
    futs = [s.submit([3, 1, 4, 1, 5][:2 + i % 3], max_new_tokens=8,
                     priority=PRIORITY_LOW,
                     on_token=hold if i == 0 else None)
            for i in range(3)]
    assert hold.reached.wait(timeout=120)
    mgr.force_stage(2, "test")
    futs.append(s.submit([9, 9, 3, 3, 5, 6], max_new_tokens=8,
                         priority=PRIORITY_HIGH))
    hold.release()
    time.sleep(0.2)  # let preemption and resumption churn
    s.shutdown(drain=False, timeout=120)
    for f in futs:
        f.exception(timeout=10)  # resolved, one way or the other
    _pool_clean(s)
    s.kv.drop_prefix_cache()
    assert s.kv.free_blocks == s.kv.config.num_blocks


# --------------------------------------------------------- feature shed


def test_spec_sheds_under_pressure_and_resumes(lms, oracle):
    """Stage 3 turns speculation off REVERSIBLY: streams stay equal to
    the JAX package's, verify steps stop while shed and resume after."""
    mgr = DegradationManager(DegradationConfig(down_after=10 ** 6))
    s = _session(lms, draft=True, degrade=mgr, prefix_cache=False,
                 decode_buckets=(1, 2), speculate_k=3)
    p = [3, 1, 4, 1, 5]
    try:
        assert s.generate(p, max_new_tokens=8, timeout=300) == oracle["pi"]
        before = s.metrics.get("verify_steps_total")
        assert before > 0
        mgr.force_stage(3, "test")
        assert s.generate(p, max_new_tokens=8, timeout=300) == oracle["pi"]
        assert s.metrics.get("verify_steps_total") == before
        assert s.metrics.get("spec_disabled_total") == 1
        assert s.health()["speculation"] == "shed"
        mgr.force_stage(0, "test")
        assert s.generate(p, max_new_tokens=8, timeout=300) == oracle["pi"]
        assert s.metrics.get("verify_steps_total") > before
        assert s.health()["speculation"] == "active"
    finally:
        s.shutdown(drain=True, timeout=60)
    _pool_clean(s)


@pytest.mark.parametrize("hit", [0, 2])
def test_draft_fault_permanent_fallback(lms, oracle, hit):
    """``decoding.draft_step`` raise — at the draft's prefill (hit 0) or
    mid-stream (hit 2): the typed DraftEngineError drops the session to
    plain decoding for good, the stream stays equal to the JAX
    package's, the draft pools release, and both packages log the same
    injection."""
    logs = {}
    for pkg, fmod in ((tdec, faults), (jdec, jfaults)):
        fmod.install_plan({"seed": 0, "faults": [
            {"site": "decoding.draft_step", "kind": "raise",
             "hits": [hit]}]})
        s = _session(lms, pkg, draft=True, prefix_cache=False,
                     decode_buckets=(1, 2), speculate_k=3)
        try:
            p = [3, 1, 4, 1, 5]
            assert s.generate(p, max_new_tokens=8,
                              timeout=300) == oracle["pi"]
            assert type(s.batcher.draft_error).__name__ == \
                "DraftEngineError"
            assert s.batcher.draft is None and s.batcher.draft_kv is None
            assert "disabled" in s.health()["speculation"]
            assert s.metrics.get("spec_disabled_total") == 1
            logs[pkg.__name__] = [r for r in fmod.injection_log()
                                  if r["site"] == "decoding.draft_step"]
            fmod.clear_plan()
            assert s.generate(p, max_new_tokens=8,
                              timeout=300) == oracle["pi"]
        finally:
            s.shutdown(drain=True, timeout=60)
        if pkg is tdec:
            assert isinstance(s.batcher.draft_error, DraftEngineError)
            _pool_clean(s)
    assert logs["paddle_tpu_torch.decoding"] == logs["paddle_tpu.decoding"]


def test_verify_step_injection_degrades_to_a_plain_round(lms, oracle):
    logs = {}
    for pkg, fmod in ((tdec, faults), (jdec, jfaults)):
        fmod.install_plan({"seed": 0, "faults": [
            {"site": "decoding.verify_step", "kind": "raise",
             "hits": [1]}]})
        s = _session(lms, pkg, draft=True, prefix_cache=False,
                     decode_buckets=(1, 2), speculate_k=3)
        try:
            assert s.generate([3, 1, 4, 1, 5], max_new_tokens=8,
                              timeout=300) == oracle["pi"]
            logs[pkg.__name__] = fmod.injections()
            # one plain round, then speculation continues
            assert s.batcher.draft is not None
        finally:
            s.shutdown(drain=True, timeout=60)
    assert logs["paddle_tpu_torch.decoding"] == \
        logs["paddle_tpu.decoding"] == {"decoding.verify_step:raise": 1}


# ----------------------------------------------------------- load shed


def test_stage4_sheds_lowest_class_with_typed_retriable_hint(lms, oracle):
    mgr = DegradationManager(DegradationConfig(down_after=1000))
    s = _session(lms, degrade=mgr)
    try:
        mgr.force_stage(4, "test")
        with pytest.raises(OverloadedError) as ei:
            s.submit([1, 2, 3], max_new_tokens=2, priority=PRIORITY_LOW)
        assert is_retriable(ei.value) and ei.value.retry_after_s > 0.0
        assert s.generate([1, 2, 3], max_new_tokens=2,
                          priority=PRIORITY_NORMAL,
                          timeout=300) == oracle["123"]
        assert s.generate([1, 2, 3], max_new_tokens=2,
                          priority=PRIORITY_HIGH,
                          timeout=300) == oracle["123"]
        assert s.metrics.get("admissions_rejected_total") == 1
        fam = obs_metrics.counter(
            "pdtpu_serving_admissions_rejected_total",
            labels=("sink", "class"))
        assert fam.labels(sink=s.metrics.sink,
                          **{"class": str(PRIORITY_LOW)}).value == 1
        assert s.health()["pressure"] == 1.0
    finally:
        s.shutdown(drain=True, timeout=60)


def test_admission_injection_leaves_request_queued_then_served(lms,
                                                              oracle):
    faults.install_plan(FaultPlan(seed=0).rule(
        "serving.admission", "raise", hits=[0, 1]))
    s = _session(lms)
    try:
        assert s.generate([5, 4, 3], max_new_tokens=4,
                          timeout=300) == oracle["543"]
        assert faults.injections() == {"serving.admission:raise": 2}
    finally:
        s.shutdown(drain=True, timeout=60)


def test_prefill_injection_fails_that_request_alone(lms, oracle):
    """``decoding.prefill`` raise on a lone admission: that request gets
    the raw error (it never started), the breaker sees it, and the next
    request is served."""
    from paddle_tpu_torch.resilience import CircuitBreaker, InjectedFault

    br = CircuitBreaker(min_samples=100)
    faults.install_plan(FaultPlan(seed=0).rule(
        "decoding.prefill", "raise", hits=[0]))
    s = _session(lms, breaker=br)
    try:
        with pytest.raises(InjectedFault):
            s.generate([5, 4, 3], max_new_tokens=4, timeout=300)
        assert s.generate([5, 4, 3], max_new_tokens=4,
                          timeout=300) == oracle["543"]
        snap = br.snapshot()
        assert snap["window_failures"] == 1 and snap["state"] == "closed"
        assert s.metrics.get("request_errors") == 1
        assert s.metrics.get("sequences_interrupted") == 0
    finally:
        s.shutdown(drain=True, timeout=60)
    _pool_clean(s)


# --------------------------------------------------- default-off identity


def test_default_off_is_identical(lms, oracle):
    """No plan, breaker or ladder: ``fire`` hands back its payload, the
    derived programs are the same with a ladder exercised or not, and
    priorities are accepted and ignored."""
    payload = object()
    assert faults.fire("decoding.step", payload) is payload
    assert faults.injection_log() == [] and faults.hit_counts() == {}
    mgr = DegradationManager(DegradationConfig())
    s = _session(lms, degrade=mgr, prefix_cache=False)
    s0 = _session(lms, prefix_cache=False)
    try:
        mgr.force_stage(2, "test")
        assert s.generate([1, 2, 3], max_new_tokens=2,
                          timeout=300) == oracle["123"]
        for a, b in ((s.engine.pair.prefill, s0.engine.pair.prefill),
                     (s.engine.pair.decode, s0.engine.pair.decode)):
            assert [op.type for op in a.global_block().ops] == \
                [op.type for op in b.global_block().ops]
        a = s0.generate([1, 2, 3], max_new_tokens=2,
                        priority=PRIORITY_LOW, timeout=300)
        assert a == s0.generate([1, 2, 3], max_new_tokens=2,
                                timeout=300) == oracle["123"]
        h = s0.health()
        assert h["degradation_stage"] == 0
        assert h["breaker"] == {"state": "disabled"}
        assert s0.batcher.breaker is None and s0.batcher.degrade is None
    finally:
        s.shutdown(drain=True, timeout=60)
        s0.shutdown(drain=True, timeout=60)


# ------------------------------------------------------ chaos acceptance


def test_chaos_storm_accepted_streams_equal_the_jax_packages(lms):
    """A seeded plan (draft-step raise, a prefix-commit corruption,
    admission and step delays, two step raises) and a flood at 3x the
    queue's capacity with mixed priorities: the session never crashes,
    every ACCEPTED stream equals the JAX package's sequential stream,
    every rejection is typed retriable, each site's injections equal
    the plan's simulation, and the ladder returns to stage 0."""
    capacity = 6
    rng = np.random.RandomState(7)
    shared = [int(t) for t in rng.randint(1, VOCAB, size=8)]
    # a shared full block, so prefix commits (and their corruption) and
    # prefix hits are in the storm, then a short private suffix
    prompts = [(shared if i % 2 else [])
               + [int(t) for t in rng.randint(1, VOCAB,
                                              size=rng.randint(2, 6))]
               for i in range(3 * capacity)]
    priorities = [(PRIORITY_HIGH, PRIORITY_NORMAL,
                   PRIORITY_LOW)[i % 3] for i in range(len(prompts))]
    want = _oracle(lms, [(p, 6) for p in prompts])

    plan = (FaultPlan(seed=42)
            .rule("decoding.draft_step", "raise", hits=[5])
            .rule("decoding.prefix_commit", "corrupt", hits=[0])
            .rule("decoding.step", "raise", hits=[3, 11])
            .rule("serving.admission", "delay", prob=0.05, delay_ms=2.0)
            .rule("decoding.step", "delay", prob=0.05, delay_ms=2.0))
    faults.install_plan(plan)
    mgr = DegradationManager(DegradationConfig(up_after=1, down_after=4))
    s = _session(lms, draft=True, max_new=6, speculate_k=2,
                 capacity=capacity, degrade=mgr)
    accepted = rejected = 0
    try:
        with cf.ThreadPoolExecutor(max_workers=8) as pool:
            def one(i):
                last = None
                for _ in range(100):
                    try:
                        return i, s.submit(prompts[i], max_new_tokens=6,
                                           priority=priorities[i])
                    except Exception as e:
                        assert is_retriable(e), e
                        last = e
                        time.sleep(0.02)
                return i, last

            handles = list(pool.map(one, range(len(prompts))))
        for i, h in handles:
            if isinstance(h, Exception):
                rejected += 1
                continue
            try:
                got = h.result(timeout=300)
            except Exception as e:
                assert is_retriable(e), e
                rejected += 1
                continue
            accepted += 1
            assert got == want[i], (i, got, want[i])
        assert accepted >= len(prompts) // 2
        assert accepted + rejected == len(prompts)
        assert isinstance(s.batcher.draft_error, DraftEngineError)
        log, counts = faults.injection_log(), faults.hit_counts()
        assert faults.injections()["decoding.prefix_commit:corrupt"] == 1
        assert s.metrics.get("prefix_cache_hits_total") > 0
        assert max(t["to"] for t in mgr.transitions) >= 2
        sim = plan.schedule(counts)
        # per site: the live log interleaves sites by wall clock
        for site in counts:
            assert [r for r in log if r["site"] == site] == \
                [r for r in sim if r["site"] == site], site
        deadline = time.monotonic() + 60
        while mgr.stage > 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert mgr.stage == 0, mgr.snapshot()
        assert s.health()["status"] == "serving"
        faults.clear_plan()
        assert s.generate(prompts[0], max_new_tokens=6,
                          timeout=300) == want[0]
    finally:
        s.shutdown(drain=True, timeout=120)
    _pool_clean(s)
