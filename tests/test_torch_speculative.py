"""Speculative decoding and the sampling heads of paddle_tpu_torch,
held to paddle_tpu on the CPU.

The two-layer target LM and the one-layer draft of
tests/test_decoding_fleet.py are built with the same calls in both
packages; the JAX package's perturbed weights are carried into the
port's scopes (``params_from_numpy``). Then, as that file pins for the
JAX package:

* greedy speculative streams (streamed partials included) equal the JAX
  package's speculative streams and the port's own unspeculated ones;
* a parameter-copied self-draft accepts every proposal;
* speculation composes with prefix caching and seeded sampling: sampled
  streams are equal with and without speculation, and equal to the JAX
  package's;
* ``warm_bucket_count`` covers the verify shapes, as the JAX engine's;
* the draft window ``k_row`` is clamped at the end of the budget: with
  a self-draft (every proposal accepted) the proposal and verify counts
  are the clamped windows' sums, and the streams the JAX package's.

Where a window is accepted whole the port runs one more draft step (the
JAX package's batcher leaves the last draft token's K/V out of the
draft's pool): a self-draft's pools then mirror the target's, and
acceptance counts are not compared with the JAX package's (its streams
are).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.decoding as jdec
import paddle_tpu_torch as tfluid
import paddle_tpu_torch.decoding as tdec
from paddle_tpu.decoding.engine import DecodeEngine as JEngine
from paddle_tpu_torch.decoding.engine import DecodeEngine as TEngine

from _torch_port import (CACHE, DRAFT_LM, carried_scope, jax_lm,
                         torch_lm)

torch.set_num_threads(1)

CPU = tfluid.CPUPlace()
SHARED = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3]
PROMPTS = [SHARED + [t] for t in range(6)] + [[7, 7], SHARED[:9]]
SP = dict(temperature=0.7, top_k=8, top_p=0.9, seed=123)


@pytest.fixture(scope="module")
def models():
    """The JAX target and draft (program, scope, logits) and the port's,
    carrying the same weights."""
    out = {}
    for name, seed, lm in (("target", 11, None), ("draft", 5, DRAFT_LM)):
        kw = {} if lm is None else {"lm": lm}
        j_main, j_scope, j_logits = jax_lm(seed, **kw)
        t_main, _, t_logits = torch_lm(**kw)
        out[name] = ((j_main, j_scope, j_logits),
                     (t_main, carried_scope(j_main, j_scope, t_main),
                      t_logits))
    return out


def _config(pkg, **kw):
    kw.setdefault("decode_buckets", (1, 2))
    kw.setdefault("prompt_buckets", (32,))
    cache = dict(CACHE, prefix_cache=kw.pop("prefix_cache", False))
    return pkg.DecodingConfig(cache=pkg.CacheConfig(**cache),
                              max_new_tokens=12, **kw)


def _params_copy(pkg, scope):
    """A new scope holding ``scope``'s parameters (no KV pools)."""
    out = (jfluid if pkg is jdec else tfluid).Scope()
    for n in scope.local_var_names():
        if not n.startswith("kv_cache@"):
            v = scope.find_var(n)
            out.set_var(n, v.clone() if pkg is tdec else np.asarray(v))
    return out


def _serve(pkg, models, draft=None, fresh=False, **kw):
    """A session of ``pkg`` over the target, with ``draft`` ("draft",
    "self" or None) as its draft model; ``fresh`` gives the target new
    pools (a scope of its own)."""
    j, t = models["target"]
    main, scope, logits = j if pkg is jdec else t
    if fresh:
        scope = _params_copy(pkg, scope)
    extra = {}
    if draft is not None:
        if draft == "self":
            d_main, d_logits = main, logits
            d_scope = _params_copy(pkg, scope)
        else:
            dj, dt = models["draft"]
            d_main, d_scope, d_logits = dj if pkg is jdec else dt
        extra = dict(draft_program=d_main, draft_logits_name=d_logits.name,
                     draft_scope=d_scope)
    if pkg is jdec:
        kw.setdefault("warm_up", False)  # compile only what is used
        return jdec.serve_decoding(main, "tokens", logits.name, scope=scope,
                                   config=_config(jdec, **kw), **extra)
    return tdec.serve_decoding(main, "tokens", logits.name, scope=scope,
                               config=_config(tdec, **kw), place=CPU,
                               **extra)


def _run(session, prompts, max_new=8, sampling=None, stream=False):
    try:
        out = []
        for p in prompts:
            toks = []
            got = session.generate(list(p), max_new_tokens=max_new,
                                   on_token=toks.append, timeout=300,
                                   sampling=sampling)
            if stream:
                assert toks == got  # streamed partials, in order
            out.append(got)
        return out, session.metrics.report()
    finally:
        session.shutdown(drain=True, timeout=60)


def test_speculative_greedy_parity_including_streams(models):
    plain, _ = _run(_serve(tdec, models), PROMPTS)
    spec, rep = _run(_serve(tdec, models, draft="draft", speculate_k=3),
                     PROMPTS, stream=True)
    jspec, jrep = _run(_serve(jdec, models, draft="draft", speculate_k=3),
                       PROMPTS)
    assert spec == plain
    assert spec == jspec
    assert rep["spec_proposed_total"] > 0
    assert rep["verify_steps_total"] > 0
    assert 0.0 <= rep["spec_acceptance_rate"] <= 1.0
    assert 0.0 <= jrep["spec_acceptance_rate"] <= 1.0


def test_speculative_self_draft_accepts_everything(models):
    got, rep = _run(_serve(tdec, models, draft="self", speculate_k=3,
                           decode_buckets=(1, 2)),
                    [[3, 1, 4, 1, 5, 9, 2, 6]], max_new=10)
    assert rep["spec_acceptance_rate"] == 1.0, rep
    # 9 decode-phase tokens (+1 from prefill) in few verify steps
    assert rep["tokens_generated"] == 10
    assert rep["verify_steps_total"] <= 5
    plain, _ = _run(_serve(tdec, models), [[3, 1, 4, 1, 5, 9, 2, 6]],
                    max_new=10)
    assert got == plain


def test_self_draft_pools_mirror_the_target_pools(models):
    """A self-draft writes every position the target writes — the last
    token of a window accepted whole included — with the same K/V (the
    decode and extend programs round differently: 1e-5)."""
    session = _serve(tdec, models, draft="self", fresh=True, speculate_k=3)
    try:
        session.generate([3, 1, 4, 1, 5, 9, 2, 6], max_new_tokens=12,
                         timeout=300)
        rep = session.metrics.report()
        assert rep["spec_acceptance_rate"] == 1.0
        target, draft = session.engine.scope, session.draft_engine.scope
        for name, _, _ in session.engine.pair.pool_specs:
            t, d = target.find_var(name), draft.find_var(name)
            assert bool((t != 0).any())
            np.testing.assert_allclose(d.numpy(), t.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    finally:
        session.shutdown(drain=True, timeout=60)


def test_speculation_composes_with_prefix_cache_and_sampling(models):
    prompts = [SHARED[:12] + [t] for t in range(4)]
    want, _ = _run(_serve(jdec, models, sampling=True), prompts,
                   max_new=6, sampling=jdec.SamplingParams(**SP))
    plain, _ = _run(_serve(tdec, models, sampling=True), prompts,
                    max_new=6, sampling=tdec.SamplingParams(**SP))
    spec, rep = _run(_serve(tdec, models, draft="draft", sampling=True,
                            prefix_cache=True, speculate_k=3),
                     prompts, max_new=6,
                     sampling=tdec.SamplingParams(**SP))
    assert plain == want
    assert spec == want
    assert rep["prefix_cache_hits_total"] >= 3
    assert rep["spec_proposed_total"] > 0


def test_warm_bucket_count_covers_the_verify_shapes(models):
    (j_main, j_scope, j_logits), (t_main, t_scope, t_logits) = \
        models["target"]
    kw = dict(decode_buckets=(1, 2), suffix_buckets=(4, 32),
              prefix_cache=True, sampling=True, speculate_k=2)
    je = JEngine(j_main, "tokens", j_logits.name, scope=jfluid.Scope(),
                 config=_config(jdec, **kw))
    te = TEngine(t_main, "tokens", t_logits.name, scope=tfluid.Scope(),
                 config=_config(tdec, **kw), place=CPU)
    assert te._extend_warm_shapes() == je._extend_warm_shapes()
    assert (1, 3, tdec.STEP_TOKENS) in te._extend_warm_shapes()
    assert (2, 3, tdec.STEP_TOKENS) in te._extend_warm_shapes()
    assert te.warm_bucket_count() == je.warm_bucket_count() == 7
    assert te.config.needs_extend
    assert tdec.DecodingConfig(speculate_k=2).needs_extend
    assert te.pair.extend_feeds == je.pair.extend_feeds


def _clamped_windows(max_new, k):
    """The windows a fully accepting draft proposes: after the prefill's
    token, ``min(k, budget left - 1)`` drafts a step, each step emitting
    its accepted drafts and the target's own token."""
    windows, n = [], 1
    while n < max_new:
        w = max(0, min(k, max_new - n - 1))
        windows.append(w)
        n += w + 1
    return windows


@pytest.mark.parametrize("max_new", [5, 6, 7, 12])
def test_k_row_is_clamped_at_the_end_of_the_budget(models, max_new):
    prompt = [[3, 1, 4, 1, 5, 9, 2, 6]]
    got, rep = _run(_serve(tdec, models, draft="self", speculate_k=3),
                    prompt, max_new=max_new)
    jgot, _ = _run(_serve(jdec, models, draft="self", speculate_k=3),
                   prompt, max_new=max_new)
    assert len(got[0]) == max_new and got == jgot
    windows = _clamped_windows(max_new, 3)
    assert rep["spec_acceptance_rate"] == 1.0
    assert rep["spec_proposed_total"] == rep["spec_accepted_total"] \
        == sum(windows)
    assert rep["verify_steps_total"] == len(windows)
    # no window ever reached past the budget
    assert rep["spec_proposed_total"] <= max_new - 1
