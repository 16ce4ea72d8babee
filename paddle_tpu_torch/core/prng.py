"""Threefry-2x32 random numbers in torch, bit-equal to ``jax.random``
with its default setup (``jax_default_prng_impl="threefry2x32"``,
``jax_threefry_partitionable=True``, ``jax_high_dynamic_range_gumbel=
False``): the counterpart of what ``jax.random`` gives the JAX package's
sampling heads and of the masks its training dropout draws.

A key is a pair of uint32 words held as two int64 tensors of any (equal)
batch shape, so a batch of rows carries a batch of keys and one call
draws for all of them. torch has little uint32 arithmetic, so every word
lives in an int64 in ``[0, 2**32)`` and sums and shifts are masked back
to 32 bits. Everything is tensor arithmetic on the keys' device: no host
value is read, so the functions run under CUDA graph capture.

* ``prng_key(seed)`` — ``jax.random.PRNGKey(seed)`` for uint32 seeds:
  the words ``(0, seed)``.
* ``fold_in(key, data)`` — ``jax.random.fold_in``: threefry of the
  counter pair ``(0, data)`` under ``key``.
* ``random_bits(key, n)`` — 32-bit ``jax.random.bits`` of shape
  ``[..., n]`` on the partitionable path: threefry of the counter pairs
  ``(i >> 32, i & 0xffffffff)`` for ``i < n`` (the high and low words
  of a 64-bit iota), then ``bits1 ^ bits2``.
* ``uniform(key, n, minval, maxval)`` — f32 ``jax.random.uniform``: 23
  random mantissa bits under the exponent of 1.0, minus 1, scaled and
  shifted with one rounding, then ``max(minval, .)``.
* ``bernoulli(key, p, shape)`` — ``jax.random.bernoulli(key, p,
  shape)`` for a Python float ``p``: ``uniform(key, shape) < f32(p)``.
  A uniform of shape ``(a, b, c)`` is the uniform of ``a*b*c`` values
  in row-major order, so element ``i`` draws from the counter pair of
  ``i``. The plain version of the dropout kernel (``ops/dropout.py``).
* ``gumbel(key, n)`` — f32 ``jax.random.gumbel`` in its default "low"
  mode: ``-log(-log(uniform(minval=tiny, maxval=1)))``. The bits and the
  uniforms are bit-equal to jax; the two logs are torch's, which may sit
  an ulp from XLA's.
* ``randint(key, n, minval, maxval)`` — int32 ``jax.random.randint``
  for Python int bounds: the bits of the two keys of ``split(key)``
  (the fold-ins of 0 and 1), ``hi % span * (2**32 % span) + lo % span``
  modulo ``span``, in uint32 arithmetic as jax does it (``2**32 %
  span`` is formed as ``(2**16 % span)**2 % span`` in uint32, which
  wraps to 0 for spans above ``2**16``).
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_ONE_BITS = 0x3F800000
_F32_TINY = torch.finfo(torch.float32).tiny


def _u32(x) -> torch.Tensor:
    """An integer tensor's value modulo 2**32, as int64."""
    return x.to(torch.int64) & _MASK


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """The Threefry-2x32 block cipher (20 rounds) of the counter words
    ``(x0, x1)`` under the key words ``(k1, k2)``, broadcast together;
    every input holds uint32 values in int64."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: torch.Tensor):
    """``jax.random.PRNGKey(seed)`` for uint32 seeds (a tensor of any
    shape, one key each): the key words ``(0, seed)``."""
    seed = _u32(seed)
    return torch.zeros_like(seed), seed


def fold_in(key, data: torch.Tensor):
    """``jax.random.fold_in(key, data)``: the threefry of ``(0, data)``
    (``data`` as uint32) under ``key``."""
    k1, k2 = key
    data = _u32(data)
    return threefry2x32(k1, k2, torch.zeros_like(data), data)


def random_bits(key, n: int) -> torch.Tensor:
    """32-bit ``jax.random.bits(key, (n,))`` on the partitionable path,
    for a batch of keys: ``[*key_shape, n]`` uint32 values in int64."""
    k1, k2 = key
    iota = torch.arange(n, dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32(k1[..., None], k2[..., None], iota >> 32,
                          iota & _MASK)
    return b1 ^ b2


def uniform(key, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 ``jax.random.uniform(key, (n,), minval=, maxval=)`` for a
    batch of keys: ``[*key_shape, n]``."""
    bits = random_bits(key, n)
    fbits = (bits >> 9) | _F32_ONE_BITS
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    # the bounds and their difference rounded to f32, as jax converts
    # them; XLA contracts ``floats * span + lo`` into one fused
    # multiply-add, so it is computed in f64 (the product of two f32 is
    # exact there) and rounded to f32 once
    lo, hi = np.float32(minval), np.float32(maxval)
    scaled = (floats.to(torch.float64) * float(hi - lo)
              + float(lo)).to(torch.float32)
    return torch.clamp(scaled, min=float(lo))


def bernoulli(key, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a Python float ``p``,
    for a batch of keys: a bool tensor ``[*key_shape, *shape]``."""
    shape = tuple(int(s) for s in shape)
    u = uniform(key, int(np.prod(shape, dtype=np.int64)))
    keep = u < float(np.float32(p))
    return keep.reshape(tuple(key[0].shape) + shape)


def gumbel(key, n: int) -> torch.Tensor:
    """f32 ``jax.random.gumbel(key, (n,))`` ("low" mode) for a batch of
    keys: ``[*key_shape, n]``."""
    u = uniform(key, n, minval=_F32_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


def randint(key, n: int, minval: int, maxval: int) -> torch.Tensor:
    """int32 ``jax.random.randint(key, (n,), minval, maxval)`` for Python
    int bounds, for a batch of keys: ``[*key_shape, n]`` values in
    int64."""
    k1, k2 = key
    if maxval <= minval:
        return torch.full(tuple(k1.shape) + (n,), minval,
                          dtype=torch.int64, device=k1.device)
    span = maxval - minval
    mult = (((2 ** 16) % span) ** 2 & _MASK) % span
    one = torch.ones_like(_u32(k1))
    hi = random_bits(fold_in(key, torch.zeros_like(one)), n)
    lo = random_bits(fold_in(key, one), n)
    offset = (((hi % span) * mult) & _MASK) + lo % span
    return minval + (offset & _MASK) % span
