"""Sampling suite for the decode path (counterpart of
paddle_tpu/decoding/sampling.py): temperature / top-k / top-p as op
fns, seeded per request so mixed sampling configs share one continuous
batch.

The contract the JAX package pins, kept here:

* **Per-row parameters are runtime data** — the sampling head takes
  ``[B]`` feeds (temperature, top_k, top_p, seed, step), so greedy,
  temperature-0.8 and top-k-5 requests share one bucket's program (on a
  card: one captured graph).
* **Determinism is positional in the STREAM** — the key of the token at
  stream index ``n`` of a request is ``fold_in(PRNGKey(seed), n)``
  (``core/prng.py``, bit-equal to ``jax.random``), whatever batch row,
  bucket or neighbours the request has.
* **temperature == 0 IS greedy** — the lane is the exact ``argmax``.
* **Speculative decoding composes** — window position ``t`` samples
  stream index ``steps[b] + t``, the key plain decoding uses there.

All filtering and sampling math runs in f32. Where the JAX package maps
one row's function over the batch with ``vmap``, the fns here run the
same math batched over ``[B, V]`` (``[B, T, V]`` flattened) with torch
ops: no host value is read, so they run under CUDA graph capture.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import prng
from ..core.enforce import enforce

# wire names of the per-row sampling feeds (the JAX package's)
TEMPERATURE = "kv_temperature"
TOP_K = "kv_top_k"
TOP_P = "kv_top_p"
SEEDS = "kv_seeds"
SAMPLE_STEPS = "kv_sample_steps"

SAMPLING_FEEDS = (TEMPERATURE, TOP_K, TOP_P, SEEDS, SAMPLE_STEPS)


class SamplingParams:
    """One request's sampling config.

    temperature: 0 (default) = greedy argmax; > 0 scales the logits.
    top_k: keep only the k highest-probability tokens (0 = off).
    top_p: nucleus sampling — keep the smallest set of tokens whose
        cumulative probability reaches top_p (1.0 = off).
    seed: the request's RNG seed; the token at stream index n draws
        from ``fold_in(PRNGKey(seed), n)``.
    """

    __slots__ = ("temperature", "top_k", "top_p", "seed")

    def __init__(self, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0):
        enforce(temperature >= 0.0, "temperature must be >= 0")
        enforce(int(top_k) >= 0, "top_k must be >= 0 (0 = off)")
        enforce(0.0 < top_p <= 1.0, "top_p must be in (0, 1]")
        enforce(int(seed) >= 0, "seed must be >= 0")
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    def __repr__(self):
        return (f"SamplingParams(temperature={self.temperature}, "
                f"top_k={self.top_k}, top_p={self.top_p}, "
                f"seed={self.seed})")

    def __eq__(self, other):
        return (isinstance(other, SamplingParams)
                and all(getattr(self, s) == getattr(other, s)
                        for s in self.__slots__))


GREEDY = SamplingParams()


def sampling_feed_arrays(params, steps, bucket: int):
    """The five ``[bucket]`` feed arrays for ``len(params)`` rows
    (padded rows are greedy with seed 0; their outputs are discarded).
    ``steps[i]`` is row i's stream index of the (first) token being
    sampled."""
    n = len(params)
    temps = np.zeros(bucket, np.float32)
    top_k = np.zeros(bucket, np.int32)
    top_p = np.ones(bucket, np.float32)
    seeds = np.zeros(bucket, np.int32)
    st = np.zeros(bucket, np.int32)
    for i, p in enumerate(params):
        p = p or GREEDY
        temps[i] = p.temperature
        top_k[i] = p.top_k
        top_p[i] = p.top_p
        seeds[i] = p.seed
    st[:n] = np.asarray(steps, np.int32)
    return {TEMPERATURE: temps, TOP_K: top_k, TOP_P: top_p,
            SEEDS: seeds, SAMPLE_STEPS: st}


def _sample_scores(lg, temp, top_k, top_p, key):
    """The Gumbel-max scores ``kept + g`` of each row of logits ``[N, V]``
    with per-row parameters ``[N]`` and keys (two ``[N]`` words): the
    JAX package's ``_sample_one`` up to its argmax. Temperature scaling,
    then top-k truncation, then top-p over the surviving mass; filtered
    tokens score -inf."""
    lg = lg.to(torch.float32)
    vocab = lg.shape[-1]
    scaled = lg / torch.clamp(temp, min=1e-6)[:, None]
    neg_inf = torch.full((), float("-inf"), dtype=torch.float32,
                         device=lg.device)
    # top-k: threshold at the k-th largest scaled logit (k <= 0 = off)
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(desc, 1, torch.clamp(top_k.to(torch.int64) - 1, 0,
                                            vocab - 1)[:, None])
    k_thresh = torch.where(top_k[:, None] > 0, kth, neg_inf)
    kept = torch.where(scaled >= k_thresh, scaled, neg_inf)
    # top-p: keep the smallest prefix of the sorted distribution whose
    # cumulative mass reaches top_p (a sorted slot survives while the
    # mass BEFORE it is still < top_p; prob ties keep all members)
    probs = torch.softmax(kept, dim=-1)
    p_desc = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(p_desc, dim=-1)
    keep = (csum - p_desc) < top_p[:, None]
    p_thresh = torch.amin(torch.where(keep, p_desc, -neg_inf), dim=-1,
                          keepdim=True)
    kept = torch.where(probs >= p_thresh, kept, neg_inf)
    return kept + prng.gumbel(key, vocab)


def _sample_rows(lg, temp, top_k, top_p, key):
    """One token from each row of logits ``[N, V]``: the argmax of its
    Gumbel-max scores, or the exact argmax of the logits where
    ``temp == 0``."""
    greedy = torch.argmax(lg.to(torch.float32), dim=-1).to(torch.int32)
    scores = _sample_scores(lg, temp, top_k, top_p, key)
    sampled = torch.argmax(scores, dim=-1).to(torch.int32)
    return torch.where(temp > 0.0, sampled, greedy)


def _row_key(seeds, steps):
    """The stream-positional key of each row: the token's stream index
    folded into the request's seed."""
    return prng.fold_in(prng.prng_key(seeds), steps)


def _sample_token(x, temps, top_k, top_p, seeds, steps):
    """Op ``sample_token``: next-token logits ``[B, V]`` + per-row params
    -> token ids ``[B]`` (int32)."""
    return _sample_rows(x, temps, top_k, top_p, _row_key(seeds, steps))


def _sample_tokens(x, temps, top_k, top_p, seeds, steps):
    """Op ``sample_tokens``: window logits ``[B, T, V]`` + per-row params
    -> token ids ``[B, T]``; window position ``t`` samples stream index
    ``steps[b] + t`` (the speculative-verify surface)."""
    B, T, V = x.shape
    t = torch.arange(T, dtype=torch.int64, device=x.device)[None, :]
    st = steps.to(torch.int64)[:, None] + t                   # [B, T]

    def per_pos(v):
        return v[:, None].expand(B, T).reshape(-1)

    key = _row_key(per_pos(seeds), st.reshape(-1))
    out = _sample_rows(x.reshape(B * T, V), per_pos(temps),
                       per_pos(top_k), per_pos(top_p), key)
    return out.reshape(B, T)


def _greedy_tokens(x):
    """Op ``greedy_tokens``: window logits ``[B, T, V]`` -> argmax ids
    ``[B, T]`` (the non-sampling verify head)."""
    return torch.argmax(x, dim=-1).to(torch.int32)
