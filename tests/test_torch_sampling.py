"""paddle_tpu_torch.decoding.sampling held to paddle_tpu.decoding.sampling
on the CPU.

Seeded logits (V = 37 and 32000) go through the JAX package's jitted
``_sample_token`` / ``_sample_tokens`` (``vmap``s of ``_sample_one``)
and the port's batched fns, over temperatures {0, 0.7, 1.3} x top-k
{0, 1, 5} x top-p {1.0, 0.9, 0.5}, with random seeds and stream steps.
Tokens must be equal. The keys and the uniforms are bit-equal
(tests/test_torch_prng.py); the logs of the Gumbel noise and the
softmax/cumsum of the top-p filter may round an ulp apart, so a row may
part only where the port's top-2 gap of ``kept + g`` is below
``NEAR_TIE`` (1e-5): such rows are counted and the count is bounded by
``MAX_NEAR_TIES`` per case (none were seen when this was written).
``temp == 0`` and ``top_k == 1`` rows are the exact argmax.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.decoding import sampling as jsamp
from paddle_tpu_torch.decoding import sampling as tsamp

torch.set_num_threads(1)

TEMPS = (0.0, 0.7, 1.3)
TOP_KS = (0, 1, 5)
TOP_PS = (1.0, 0.9, 0.5)
NEAR_TIE = 1e-5
MAX_NEAR_TIES = 1
ROWS = 6


def _args(rng, shape, t, k, p):
    B = shape[0]
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    return (x, np.full(B, t, np.float32), np.full(B, k, np.int32),
            np.full(B, p, np.float32),
            rng.randint(0, 2 ** 31 - 1, B).astype(np.int32),
            rng.randint(0, 65, B).astype(np.int32))


def _torch(args):
    return [torch.from_numpy(a) for a in args]


def _gap(scores: torch.Tensor) -> torch.Tensor:
    top2 = torch.topk(scores, 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


@pytest.mark.parametrize("vocab", [37, 32000])
def test_sample_token_matches_jax(vocab):
    rng = np.random.RandomState(vocab)
    jit = jax.jit(jsamp._sample_token)
    near = 0
    for t, k, p in itertools.product(TEMPS, TOP_KS, TOP_PS):
        args = _args(rng, (ROWS, vocab), t, k, p)
        want = np.asarray(jit(*args))
        got = tsamp._sample_token(*_torch(args)).numpy()
        bad = np.nonzero(got != want)[0]
        if len(bad):
            x, temps, tk, tp, seeds, steps = _torch(args)
            scores = tsamp._sample_scores(
                x, temps, tk, tp, tsamp._row_key(seeds, steps))
            gaps = _gap(scores)[bad]
            assert (gaps < NEAR_TIE).all(), (t, k, p, bad, gaps)
            near += len(bad)
    assert near <= MAX_NEAR_TIES * len(TEMPS) * len(TOP_KS) * len(TOP_PS)


@pytest.mark.parametrize("vocab", [37, 32000])
def test_sample_rows_matches_jax_sample_one(vocab):
    """Row by row: the port's batched rows against ``_sample_one`` with
    the JAX package's own ``_row_key``."""
    rng = np.random.RandomState(vocab + 1)
    one = jax.jit(jsamp._sample_one)
    key = jax.jit(jsamp._row_key)
    for t, k, p in ((0.7, 5, 0.9), (1.3, 0, 0.5), (0.0, 0, 1.0)):
        x, temps, tk, tp, seeds, steps = _args(rng, (ROWS, vocab), t, k, p)
        got = tsamp._sample_rows(
            torch.from_numpy(x), torch.from_numpy(temps),
            torch.from_numpy(tk), torch.from_numpy(tp),
            tsamp._row_key(torch.from_numpy(seeds),
                           torch.from_numpy(steps))).numpy()
        for i in range(ROWS):
            want = int(one(x[i], temps[i], tk[i], tp[i],
                           key(seeds[i], steps[i])))
            assert got[i] == want, (t, k, p, i)


@pytest.mark.parametrize("vocab", [37, 32000])
def test_sample_tokens_window_matches_jax(vocab):
    rng = np.random.RandomState(vocab + 2)
    T = 5
    x = (rng.standard_normal((4, T, vocab)) * 3).astype(np.float32)
    temps = np.asarray([0.0, 0.7, 1.3, 0.9], np.float32)
    top_k = np.asarray([0, 5, 0, 40], np.int32)
    top_p = np.asarray([1.0, 0.9, 0.5, 0.95], np.float32)
    seeds = np.asarray([1, 2, 3, 2 ** 31 - 1], np.int32)
    steps = np.asarray([0, 3, 9, 60], np.int32)
    args = (x, temps, top_k, top_p, seeds, steps)
    want = np.asarray(jax.jit(jsamp._sample_tokens)(*args))
    got = tsamp._sample_tokens(*_torch(args)).numpy()
    assert got.shape == (4, T)
    np.testing.assert_array_equal(got, want)
    # window position t samples stream index steps + t: the plain
    # per-token head at those steps gives the same tokens
    for t in range(T):
        one = tsamp._sample_token(
            torch.from_numpy(x[:, t]), *_torch(args[1:5]),
            torch.from_numpy(steps + t)).numpy()
        np.testing.assert_array_equal(one, got[:, t])
    np.testing.assert_array_equal(
        tsamp._greedy_tokens(torch.from_numpy(x)).numpy(),
        np.asarray(jsamp._greedy_tokens(x)))


@pytest.mark.parametrize("vocab", [37, 32000])
def test_temperature_zero_and_top_k_one_are_exact_argmax(vocab):
    rng = np.random.RandomState(vocab + 3)
    for t, k, p in itertools.product(TEMPS, TOP_KS, TOP_PS):
        if t > 0 and k != 1:
            continue
        x, temps, tk, tp, seeds, steps = _torch(
            _args(rng, (ROWS, vocab), t, k, p))
        got = tsamp._sample_token(x, temps, tk, tp, seeds, steps)
        assert torch.equal(got, torch.argmax(x, -1).to(torch.int32))


def test_feed_arrays_and_params_match_jax():
    params = [tsamp.SamplingParams(0.8, 40, 0.95, 7), None,
              tsamp.GREEDY]
    jparams = [jsamp.SamplingParams(0.8, 40, 0.95, 7), None,
               jsamp.GREEDY]
    got = tsamp.sampling_feed_arrays(params, [3, 0, 5], 4)
    want = jsamp.sampling_feed_arrays(jparams, [3, 0, 5], 4)
    assert tsamp.SAMPLING_FEEDS == jsamp.SAMPLING_FEEDS
    assert sorted(got) == sorted(want)
    for n in want:
        assert got[n].dtype == want[n].dtype
        np.testing.assert_array_equal(got[n], want[n])
    assert tsamp.GREEDY.greedy and not params[0].greedy
    assert params[0] == tsamp.SamplingParams(0.8, 40, 0.95, 7)
    for bad in (dict(temperature=-1.0), dict(top_p=0.0), dict(top_k=-1),
                dict(seed=-2)):
        with pytest.raises(Exception):
            tsamp.SamplingParams(**bad)
