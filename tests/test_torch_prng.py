"""paddle_tpu_torch.core.prng held to jax.random on the CPU.

The torch threefry must give the keys, the 32-bit bits and the
uniforms of ``jax.random`` bit for bit, as jax is set up here (the
config the test asserts first): ``PRNGKey`` for uint32 seeds,
``fold_in`` at stream steps 0-64, ``bits`` and ``uniform`` up to
V = 32000. ``gumbel`` is ``-log(-log(u))`` of a bit-equal ``u``; torch's
``log`` and XLA's CPU ``log`` differ by up to one ulp on some inputs
(measured: at most 1 ulp on each log), so gumbel is held within one ulp
of its magnitude plus 5e-7 (the outer log's one ulp at |g| <= 16.7,
where the inner log's ulp moves g by at most that much).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import prng

torch.set_num_threads(1)

SEEDS = (0, 1, 7, 2 ** 31 - 1)
STEPS = tuple(range(0, 65, 8)) + (1, 63)
TINY = float(np.finfo(np.float32).tiny)


def _words(key):
    return np.asarray(jax.random.key_data(key)
                      if jnp.issubdtype(key.dtype, jax.dtypes.prng_key)
                      else key).astype(np.int64)


def _tkey(seed, step):
    return prng.fold_in(prng.prng_key(torch.tensor([seed])),
                        torch.tensor([step]))


def test_jax_is_set_up_as_assumed():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_high_dynamic_range_gumbel is False


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_are_bit_equal(seed):
    k1, k2 = prng.prng_key(torch.tensor([seed]))
    jk = jax.random.PRNGKey(np.uint32(seed))
    assert _words(jk).tolist() == [int(k1[0]), int(k2[0])]
    # a batch of keys folds a batch of steps at once
    steps = torch.arange(65)
    f1, f2 = prng.fold_in(prng.prng_key(torch.full((65,), seed)), steps)
    want = np.stack([_words(jax.random.fold_in(jk, np.uint32(s)))
                     for s in range(65)])
    assert np.array_equal(np.stack([f1.numpy(), f2.numpy()], 1), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("vocab", [37, 32000])
def test_bits_and_uniform_are_bit_equal(seed, vocab):
    for step in STEPS:
        jk = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)),
                                np.uint32(step))
        tk = _tkey(seed, step)
        bits = np.asarray(jax.random.bits(jk, (vocab,), jnp.uint32))
        assert np.array_equal(bits.astype(np.int64),
                              prng.random_bits(tk, vocab)[0].numpy())
        for lo, hi in ((0.0, 1.0), (TINY, 1.0), (-2.0, 3.0)):
            ju = np.asarray(jax.random.uniform(jk, (vocab,), jnp.float32,
                                               minval=lo, maxval=hi))
            tu = prng.uniform(tk, vocab, minval=lo, maxval=hi)[0].numpy()
            assert np.array_equal(ju.view(np.int32), tu.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_one_ulp_of_the_logs(seed):
    for step in STEPS:
        jk = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)),
                                np.uint32(step))
        jg = np.asarray(jax.random.gumbel(jk, (32000,), jnp.float32))
        tg = prng.gumbel(_tkey(seed, step), 32000)[0].numpy()
        assert np.isfinite(tg).all()
        err = np.abs(jg - tg)
        assert (err <= np.spacing(np.abs(jg)) + 5e-7).all()


def test_a_batch_of_keys_draws_each_rows_own_stream():
    seeds = torch.tensor([0, 7, 0])
    steps = torch.tensor([3, 3, 4])
    bits = prng.random_bits(prng.fold_in(prng.prng_key(seeds), steps), 37)
    for i in range(3):
        one = prng.random_bits(_tkey(int(seeds[i]), int(steps[i])), 37)[0]
        assert torch.equal(bits[i], one)
    assert not torch.equal(bits[0], bits[2])
