"""Graph-level decode rewrite: derive the prefill/decode program pair
(and optionally the EXTEND program) from a built forward Program
(counterpart of paddle_tpu/decoding/rewrite.py).

It takes a causal decoder-only forward — token ids ``[B, T]`` in,
next-token logits ``[B, T, V]`` out — and produces rewritten clones
sharing one set of persistable paged KV-cache pools
``[num_blocks, block_size, heads, head_dim]`` per attention layer
(PagedAttention, Kwon et al., SOSP '23):

* **prefill** — runs the prompt at a bucketed ``[B, T]`` shape. Every
  causal ``fused_attention`` op becomes ``paged_attention_prefill``:
  the same attention math (prefill logits match the original forward)
  plus a write of the per-position K/V into the pools at the slots the
  block table names. Fetches gain the next token: the logits at
  ``seq_len - 1`` and their greedy argmax (or a seeded sample when the
  sampling head is on).
* **decode** — runs ONE token per sequence (``[B, 1]``).
  ``fused_attention`` becomes ``paged_attention_decode``: write the new
  token's K/V at ``positions[b]``, then attend over the sequence's block
  window with the hand-written kernel (ops/paged_attention.py) under the
  ``<= position`` mask. ``pos_encoding`` becomes ``pos_encoding_at``.
* **extend** (``with_extend=True``) — runs a WINDOW of new tokens per
  sequence against an already-populated prefix: token ids ``[B, T]``
  write at absolute positions ``cached_lens[b] + t`` and attend over the
  block window through the kernel under the ``<= cached + t`` mask —
  the prefix-cache suffix prefill. ``pos_encoding`` becomes
  ``pos_encoding_from``; fetches gain ``kv_step_tokens``, the greedy (or
  sampled) token at every window position — the speculative verify
  surface.

The decode and extend ops ALWAYS go through
``ops.paged_window_attention`` — the counterpart of the JAX package with
``pallas_paged_attention`` on.

Int8 KV (``CacheConfig(kv_dtype="int8")``): pools store int8 codes with
per-slot f32 scales in companion ``kv_cache@l<i>.kscale/.vscale`` pools
shaped ``[num_blocks, block_size]``. Writes quantize (absmax/127 per
written position over heads and dims); the kernel dequantizes on
gather. Prefill's own attention still runs over the unquantized fresh
K/V stream, so prefill logits stay exact.

Pool writes are in place: the ops index into the scope's pool tensors
and return the same objects, so no pool is ever copied. Out-of-range
slots (padding rows whose table is ``-1``, prompt positions
``t >= seq_len``, inactive decode rows with ``positions < 0``, padded
extend window slots ``t >= seq_lens[b]``) are dropped, as the JAX
package's scatter drops them, without reading a host value
(``_write_pools``): the programs run under CUDA graph capture.

``sampling=True`` replaces the greedy heads with the seeded per-row
sampling ops (decoding/sampling.py) and adds the five ``[B]`` sampling
feeds to every program; the default builds the greedy programs.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import dtype_utils
from ..core.enforce import enforce
from ..core.program import Deferred, Program
from ..models.transformer import attention, sinusoid_table
from ..ops.paged_attention import paged_window_attention
from .cache import CacheConfig
from .sampling import (SAMPLE_STEPS, SAMPLING_FEEDS, SEEDS, TEMPERATURE,
                       TOP_K, TOP_P, _greedy_tokens, _sample_token,
                       _sample_tokens)

# fixed public feed/fetch names of the derived programs (the JAX
# package's)
BLOCK_TABLES = "kv_block_tables"
SEQ_LENS = "kv_seq_lens"
POSITIONS = "kv_positions"
CACHED_LENS = "kv_cached_lens"
NEXT_TOKENS = "kv_next_tokens"
NEXT_LOGITS = "kv_next_logits"
STEP_TOKENS = "kv_step_tokens"


def pool_name(layer: int, which: str) -> str:
    """Persistable pool var name for attention layer ``layer`` —
    ``which`` in {"k", "v", "kscale", "vscale"}."""
    return f"kv_cache@l{layer}.{which}"


def _quantize_rows(rows):
    """``[N, H, D]`` rows -> (int8 codes, f32 scales ``[N]``): per row,
    scale = absmax/127 over (heads, dims), codes =
    ``clamp(round(x / safe_scale), -127, 127)`` (``torch.round`` rounds
    half to even, as ``jnp.round`` does); an all-zero row keeps scale 0
    and codes 0. The scale is the absmax times the f32 reciprocal of
    127: the JAX package's compiled program computes it so (XLA turns a
    division by a constant into that multiply), and a true division
    differs from it by one ulp on some rows."""
    f32 = rows.to(torch.float32)
    scale = torch.amax(torch.abs(f32), dim=(1, 2)) * (1.0 / 127.0)
    safe = torch.where(scale > 0, scale, torch.ones((), dtype=scale.dtype,
                                                     device=scale.device))
    codes = torch.clamp(torch.round(f32 / safe[:, None, None]), -127, 127)
    return codes.to(torch.int8), scale


def _write_pools(k_cache, v_cache, slots, valid, k_rows, v_rows,
                 k_scale=None, v_scale=None):
    """``pool[slots[valid]] = rows[valid]`` for both pools, over their
    flattened ``[nb * bs, H, D]`` views, in place; writes whose
    ``valid`` is False are dropped (the JAX package's scatter with
    ``mode="drop"``). ``slots``/``valid`` have the leading shape of the
    rows (``[B]`` or ``[B, T]``). With scale pools the rows are quantized
    first and codes and scales land at the same slots, so the pair never
    tears.

    No host value is read (a decode step stays capturable): every write
    is issued, and a dropped one is made a copy of another write of the
    same call — the last kept row's slot and values when there is one,
    else slot 0 and the values it already holds — so the duplicates
    store the bytes that slot ends with anyway, and every other slot is
    untouched. (The last kept row, because where two kept rows share a
    slot the later one wins in the JAX package's scatter and in a
    sequential ``index_copy_``; the engine never issues such a pair.)"""
    valid = valid.reshape(-1)
    slots = slots.reshape(-1).to(torch.int64)
    any_kept = valid.any()
    order = torch.arange(valid.shape[0], device=valid.device)
    last = torch.argmax(torch.where(valid, order, -1)).reshape(1)
    zero = torch.zeros(1, dtype=torch.int64, device=slots.device)
    fill_slot = torch.where(any_kept, slots.index_select(0, last), zero)
    target = torch.where(valid, slots, fill_slot)

    def fill(new, old):
        """Each dropped row's stand-in: the last kept row, or the
        values slot 0 holds."""
        keep = valid.reshape((-1,) + (1,) * (new.dim() - 1))
        stand = torch.where(any_kept, new.index_select(0, last),
                            old.index_select(0, zero))
        return torch.where(keep, new, stand)

    for pool, scale, rows in ((k_cache, k_scale, k_rows),
                              (v_cache, v_scale, v_rows)):
        flat = pool.view(-1, *pool.shape[2:])
        rows = rows.reshape(-1, *pool.shape[2:])
        if scale is None:
            flat.index_copy_(0, target, fill(rows.to(pool.dtype), flat))
        else:
            codes, sc = _quantize_rows(rows)
            sflat = scale.view(-1)
            flat.index_copy_(0, target, fill(codes, flat))
            sflat.index_copy_(0, target, fill(sc, sflat))


def _with_scales(out, k_scale, v_scale):
    """An op's outputs: (out, k pool, v pool) plus the two scale pools
    under int8 KV."""
    return out if k_scale is None else out + (k_scale, v_scale)


def _paged_prefill_attention(q, k, v, k_cache, v_cache, tables, seq_lens,
                             k_scale=None, v_scale=None, *, n_head,
                             block_size):
    """Causal attention over the prompt + paged cache write. The
    attention is the ``fused_attention`` causal math over the fresh
    K/V, so prefill activations match the original forward (also under
    int8 KV: only the writes are quantized)."""
    B, T, _ = q.shape
    D = q.shape[-1] // n_head
    Dv = v.shape[-1] // n_head
    qh = torch.reshape(q, (B, T, n_head, D))
    kh = torch.reshape(k, (B, T, n_head, D))
    vh = torch.reshape(v, (B, T, n_head, Dv))
    out = torch.reshape(attention(qh, kh, vh, causal=True),
                        (B, T, n_head * Dv))

    # position t of row b -> pool slot tables[b, t // bs] * bs + t % bs
    bs = block_size
    mb = tables.shape[1]
    pos = torch.arange(T, device=q.device)[None, :]
    tables = tables.to(torch.int64)
    blk = torch.gather(tables, 1,
                       torch.clamp(pos // bs, max=mb - 1).expand(B, T))
    valid = ((pos < seq_lens.to(torch.int64)[:, None]) & (blk >= 0)
             & (pos < mb * bs))
    _write_pools(k_cache, v_cache, blk * bs + pos % bs, valid, kh, vh,
                 k_scale, v_scale)
    return _with_scales((out, k_cache, v_cache), k_scale, v_scale)


def _paged_decode_attention(q, k, v, k_cache, v_cache, tables, positions,
                            k_scale=None, v_scale=None, *, n_head,
                            block_size):
    """One-token query against the paged cache: write the new K/V at
    ``positions[b]``, then attend over the sequence's block window
    (ordered by logical position) through the kernel — decode is the
    T=1, ``cached == positions`` case of the window attention. Inactive
    rows (``positions < 0``) write nothing."""
    B, T, _ = q.shape  # T == 1
    D = q.shape[-1] // n_head
    Dv = v.shape[-1] // n_head
    bs = block_size
    mb = tables.shape[1]
    S = mb * bs
    pos = positions.to(torch.int64)
    blk = torch.gather(tables.to(torch.int64), 1,
                       torch.clamp(pos[:, None] // bs, 0, mb - 1))[:, 0]
    valid = (pos >= 0) & (pos < S) & (blk >= 0)
    slots = blk * bs + torch.where(pos >= 0, pos, 0) % bs
    _write_pools(k_cache, v_cache, slots, valid,
                 torch.reshape(k, (B, n_head, D)),
                 torch.reshape(v, (B, n_head, Dv)), k_scale, v_scale)

    qh = torch.reshape(q, (B, T, n_head, D))
    ctx = paged_window_attention(qh, k_cache, v_cache,
                                 tables.to(torch.int32).contiguous(),
                                 positions.to(torch.int32).contiguous(),
                                 k_scale=k_scale, v_scale=v_scale)
    return _with_scales((torch.reshape(ctx, (B, T, n_head * Dv)), k_cache,
                         v_cache), k_scale, v_scale)


def _paged_extend_attention(q, k, v, k_cache, v_cache, tables,
                            cached_lens, seq_lens, k_scale=None,
                            v_scale=None, *, n_head, block_size):
    """Window attention against an already-populated prefix: write the
    window's K/V at absolute positions ``cached_lens[b] + t`` (for
    ``t < seq_lens[b]``), then attend over the block window through the
    kernel under the ``<= cached + t`` mask. The window sees its own
    earlier tokens through the pool, so this is the decode op
    generalized to T queries. The kernel takes ``cached_lens``, not
    positions."""
    B, T, _ = q.shape
    D = q.shape[-1] // n_head
    Dv = v.shape[-1] // n_head
    bs = block_size
    mb = tables.shape[1]
    S = mb * bs
    cached = cached_lens.to(torch.int64)
    lens = seq_lens.to(torch.int64)
    off = torch.arange(T, device=q.device)[None, :]
    pos = cached[:, None] + off                        # [B, T] absolute
    blk = torch.gather(tables.to(torch.int64), 1,
                       torch.clamp(pos // bs, 0, mb - 1))
    valid = ((off < lens[:, None]) & (blk >= 0) & (pos >= 0) & (pos < S))
    _write_pools(k_cache, v_cache, blk * bs + pos % bs, valid,
                 torch.reshape(k, (B, T, n_head, D)),
                 torch.reshape(v, (B, T, n_head, Dv)), k_scale, v_scale)

    qh = torch.reshape(q, (B, T, n_head, D))
    ctx = paged_window_attention(qh, k_cache, v_cache,
                                 tables.to(torch.int32).contiguous(),
                                 cached_lens.to(torch.int32).contiguous(),
                                 k_scale=k_scale, v_scale=v_scale)
    return _with_scales((torch.reshape(ctx, (B, T, n_head * Dv)), k_cache,
                         v_cache), k_scale, v_scale)


def _token_lookup(ids, table, *, padding_idx=None):
    """Embedding gather WITHOUT layers.embedding's trailing-dim-1
    squeeze: decode token ids are ``[B, 1]`` by construction, and the
    squeeze would silently drop the time axis."""
    idx = ids.to(torch.int64)
    emb = F.embedding(idx, table)
    if padding_idx is not None:
        pad = padding_idx if padding_idx >= 0 \
            else table.shape[0] + padding_idx
        emb = torch.where((idx == pad)[..., None],
                          torch.zeros((), dtype=emb.dtype,
                                      device=emb.device), emb)
    return emb


def _pos_encoding_at(x, positions):
    """Sinusoid position encoding at each row's absolute position (the
    decode-side replacement for ``pos_encoding``, which starts at 0)."""
    pos = torch.clamp(positions.to(torch.float32), min=0.0)
    pe = sinusoid_table(pos, x.shape[-1])                  # [B, d_model]
    return x + pe[:, None, :].to(x.dtype)


def _pos_encoding_from(x, cached_lens):
    """Sinusoid position encoding for an extend window: slot ``t`` of
    row ``b`` sits at absolute position ``cached_lens[b] + t``."""
    pos = (torch.clamp(cached_lens.to(torch.int64), min=0)[:, None]
           + torch.arange(x.shape[1], device=x.device)[None, :])
    pe = sinusoid_table(pos.to(torch.float32), x.shape[-1])  # [B, T, d]
    return x + pe.to(x.dtype)


def _gather_last_token(logits, seq_lens):
    """logits ``[B, T, V]`` -> the row at ``seq_len - 1`` per sequence
    (``[B, V]``), clamped so padded rows (seq_len 0) read position 0."""
    idx = torch.clamp(seq_lens.to(torch.int64) - 1, 0, logits.shape[1] - 1)
    return logits[torch.arange(logits.shape[0], device=logits.device), idx]


def _last_token_logits(logits):
    """logits ``[B, 1, V]`` -> ``[B, V]`` (the decode-side head)."""
    return logits[:, -1, :]


def _greedy_token(next_logits):
    return torch.argmax(next_logits, dim=-1).to(torch.int32)


def _deferred(fn):
    """An op fn whose result is computed only when read: a suffix
    prefill fetches ``kv_next_tokens`` alone and does not pay for the
    window head's ``[B, T, V]`` pass."""
    def op(*args):
        return Deferred(lambda: fn(*args))
    op.__name__ = fn.__name__
    return op


class DecodePair:
    """Result of :func:`derive_decode_programs`: the rewritten programs
    (``extend`` is None unless derived), the shared pool specs, and the
    wire surface the engine feeds and fetches."""

    def __init__(self, prefill: Program, decode: Program,
                 config: CacheConfig, token_name: str,
                 pool_specs: List[Tuple[str, tuple, np.dtype]],
                 n_layers: int, extend: Optional[Program] = None,
                 sampling: bool = False):
        self.prefill = prefill
        self.decode = decode
        self.extend = extend
        self.config = config
        self.token_name = token_name
        self.pool_specs = pool_specs
        self.n_layers = n_layers
        self.sampling = bool(sampling)
        self.prefill_feeds = [token_name, BLOCK_TABLES, SEQ_LENS]
        self.decode_feeds = [token_name, BLOCK_TABLES, POSITIONS]
        self.extend_feeds = [token_name, BLOCK_TABLES, CACHED_LENS,
                             SEQ_LENS]
        if sampling:
            for feeds in (self.prefill_feeds, self.decode_feeds,
                          self.extend_feeds):
                feeds.extend(SAMPLING_FEEDS)
        self.fetches = [NEXT_TOKENS, NEXT_LOGITS]
        self.extend_fetches = [NEXT_TOKENS, NEXT_LOGITS, STEP_TOKENS]

    @property
    def pool_bytes(self) -> int:
        """Total device memory the KV pools occupy (all layers, the int8
        scale pools included)."""
        return sum(int(np.prod(shape))
                   * dtype_utils.to_torch(dt).itemsize
                   for _, shape, dt in self.pool_specs)

    def init_scope(self, scope, device: torch.device) -> None:
        """Materialize zeroed pools (and scale pools) on ``device`` in
        ``scope`` (idempotent: existing pools of the right shape, dtype
        and device are kept — a warm cache is not wiped by a second
        engine)."""
        for name, shape, dt in self.pool_specs:
            tdt = dtype_utils.to_torch(dt)
            cur = scope.find_var(name)
            if isinstance(cur, torch.Tensor) \
                    and tuple(cur.shape) == tuple(shape) \
                    and cur.dtype == tdt and cur.device == device:
                continue
            scope.set_var(name, torch.zeros(shape, dtype=tdt, device=device))


def _data_var(program: Program, name: str, shape, dtype="int32"):
    gb = program.global_block()
    enforce(gb._find_var_recursive(name) is None,
            "derive_decode_programs: the program already defines %r — "
            "rename that variable; it is part of the decode pair's wire "
            "surface" % name)
    return gb.create_var(name=name, shape=shape, dtype=dtype,
                         is_data=True)


def _sampling_vars(program: Program) -> None:
    """Create the five per-row sampling feeds (sampling head only)."""
    _data_var(program, TEMPERATURE, (-1,), "float32")
    _data_var(program, TOP_K, (-1,))
    _data_var(program, TOP_P, (-1,), "float32")
    _data_var(program, SEEDS, (-1,))
    _data_var(program, SAMPLE_STEPS, (-1,))


def _sampling_inputs(x_name: str):
    return {"X": [x_name], "Temperature": [TEMPERATURE],
            "TopK": [TOP_K], "TopP": [TOP_P], "Seeds": [SEEDS],
            "Steps": [SAMPLE_STEPS]}


def _append_head(program: Program, logits_name: str, prefill: bool,
                 sampling: bool = False) -> None:
    """Append the next-token head: the last real position's logits,
    then the greedy argmax (or the seeded per-row sampler)."""
    gb = program.global_block()
    lv = gb.var(logits_name)
    vocab = lv.shape[-1] if lv.shape else -1
    gb.create_var(name=NEXT_LOGITS, shape=(-1, vocab), dtype=lv.dtype)
    gb.create_var(name=NEXT_TOKENS, shape=(-1,), dtype="int32")
    if prefill:
        gb.append_op(type="gather_last_token",
                     inputs={"X": [logits_name], "SeqLens": [SEQ_LENS]},
                     outputs={"Out": [NEXT_LOGITS]},
                     fn=_gather_last_token)
    else:
        gb.append_op(type="last_token_logits",
                     inputs={"X": [logits_name]},
                     outputs={"Out": [NEXT_LOGITS]},
                     fn=_last_token_logits)
    if sampling:
        gb.append_op(type="sample_token",
                     inputs=_sampling_inputs(NEXT_LOGITS),
                     outputs={"Out": [NEXT_TOKENS]}, fn=_sample_token)
    else:
        gb.append_op(type="greedy_token", inputs={"X": [NEXT_LOGITS]},
                     outputs={"Out": [NEXT_TOKENS]}, fn=_greedy_token)


def _append_window_head(program: Program, logits_name: str,
                        sampling: bool = False) -> None:
    """Append the per-position window head on the extend program: one
    greedy (or sampled) token per window slot (``kv_step_tokens``, the
    speculative verify surface), computed only when fetched."""
    gb = program.global_block()
    gb.create_var(name=STEP_TOKENS, shape=(-1, -1), dtype="int32")
    if sampling:
        gb.append_op(type="sample_tokens",
                     inputs=_sampling_inputs(logits_name),
                     outputs={"Out": [STEP_TOKENS]},
                     fn=_deferred(_sample_tokens))
    else:
        gb.append_op(type="greedy_tokens", inputs={"X": [logits_name]},
                     outputs={"Out": [STEP_TOKENS]},
                     fn=_deferred(_greedy_tokens))


_MODES = {"prefill": ("paged_attention_prefill", _paged_prefill_attention,
                      [SEQ_LENS]),
          "decode": ("paged_attention_decode", _paged_decode_attention,
                     [POSITIONS]),
          "extend": ("paged_attention_extend", _paged_extend_attention,
                     [CACHED_LENS, SEQ_LENS])}
_MODE_SLOTS = {SEQ_LENS: "SeqLens", POSITIONS: "Positions",
               CACHED_LENS: "CachedLens"}


def _rewrite_attention(program: Program, config: CacheConfig,
                       mode: str) -> List[Tuple[str, tuple, np.dtype]]:
    """Swap every causal ``fused_attention`` op for its paged variant
    ("prefill", "decode" or "extend"), creating the layer's persistable
    pool vars (plus per-slot scale pools under int8 KV). Returns pool
    specs in layer order."""
    gb = program.global_block()
    pool_specs: List[Tuple[str, tuple, np.dtype]] = []
    q8 = config.kv_dtype == "int8"
    op_type, fn, mode_feeds = _MODES[mode]
    layer = 0
    for op in gb.ops:
        if op.type != "fused_attention":
            continue
        enforce(bool(op.attrs.get("causal")),
                "derive_decode_programs: found a non-causal "
                "fused_attention op (cross-attention?) — the decode "
                "rewrite supports decoder-only programs, where every "
                "attention op is causal self-attention")
        enforce(not op.input("Mask"),
                "derive_decode_programs: causal attention with an "
                "explicit kv_mask is not supported — prompt ragging is "
                "handled by the pair's seq_lens/block-table masking")
        q_name, = op.input("Q")
        k_name, = op.input("K")
        v_name, = op.input("V")
        out_name, = op.output("Out")
        n_head = int(op.attrs["n_head"])
        kv = gb.var(k_name)
        vv = gb.var(v_name)
        enforce(kv.shape is not None and vv.shape is not None,
                "attention K/V need declared shapes")
        enforce(kv.shape[-1] % n_head == 0 and vv.shape[-1] % n_head == 0,
                "attention feature dim must divide n_head")
        d_k = kv.shape[-1] // n_head
        d_v = vv.shape[-1] // n_head
        kp = pool_name(layer, "k")
        vp = pool_name(layer, "v")
        pool_dt = "int8" if q8 else kv.dtype
        k_shape = (config.num_blocks, config.block_size, n_head, d_k)
        v_shape = (config.num_blocks, config.block_size, n_head, d_v)
        kvar = gb.create_var(name=kp, shape=k_shape, dtype=pool_dt,
                             persistable=True)
        vvar = gb.create_var(name=vp, shape=v_shape, dtype=pool_dt,
                             persistable=True)
        pool_specs.append((kp, k_shape, kvar.dtype))
        pool_specs.append((vp, v_shape, vvar.dtype))
        scale_names = []
        if q8:
            s_shape = (config.num_blocks, config.block_size)
            for which in ("kscale", "vscale"):
                sp = pool_name(layer, which)
                svar = gb.create_var(name=sp, shape=s_shape,
                                     dtype="float32", persistable=True)
                pool_specs.append((sp, s_shape, svar.dtype))
                scale_names.append(sp)
                svar.op = op

        inputs = {"Q": [q_name], "K": [k_name], "V": [v_name],
                  "KCache": [kp], "VCache": [vp],
                  "BlockTables": [BLOCK_TABLES]}
        for feed in mode_feeds:
            inputs[_MODE_SLOTS[feed]] = [feed]
        outputs = {"Out": [out_name], "KCacheOut": [kp],
                   "VCacheOut": [vp]}
        if q8:
            inputs["KScale"], inputs["VScale"] = [scale_names[0]], \
                [scale_names[1]]
            outputs["KScaleOut"], outputs["VScaleOut"] = \
                [scale_names[0]], [scale_names[1]]
        op.type = op_type
        op.inputs = inputs
        op.outputs = outputs
        op.fn = functools.partial(fn, n_head=n_head,
                                  block_size=config.block_size)
        op.attrs = {"n_head": n_head, "causal": True,
                    "block_size": config.block_size, "layer": layer}
        if q8:
            op.attrs["kv_dtype"] = "int8"
        kvar.op = op
        vvar.op = op
        layer += 1
    enforce(layer > 0,
            "derive_decode_programs: the program has no causal "
            "fused_attention op to rewrite — is this a decoder model?")
    program._bump()
    return pool_specs


def _swap_token_lookup(program: Program, token_name: str) -> None:
    """Swap the token embedding's ``lookup_table`` for the no-squeeze
    ``token_lookup``, on every program: decode feeds ``[B, 1]`` always,
    and prefill/extend feed ``[B, 1]`` whenever their buckets contain
    1. For ``T > 1`` the two fns agree."""
    for op in program.global_block().ops:
        if op.type == "lookup_table" and op.input("Ids") == [token_name]:
            op.fn = functools.partial(
                _token_lookup, padding_idx=op.attrs.get("padding_idx"))
            op.type = "token_lookup"
            op.attrs = {"padding_idx": op.attrs.get("padding_idx")}


def _swap_pos_encoding(program: Program, feed: str, slot: str, fn,
                       op_type: str) -> None:
    """Swap ``pos_encoding`` (positions from 0) for its absolute-position
    variant reading ``feed``."""
    for op in program.global_block().ops:
        if op.type == "pos_encoding":
            x_name, = op.input("X")
            op.inputs = {"X": [x_name], slot: [feed]}
            op.fn = fn
            op.type = op_type


def _stamp(config: CacheConfig, which: str, sampling: bool,
           pallas: bool = False) -> str:
    """A derived program's stamp, the JAX package's string
    (``decoding/<digest>/<which>``, ``+sampling`` and ``+pallas`` when
    those are on; int8 KV rides the digest). The port's decode and
    extend programs always run the kernel, so they carry ``+pallas``,
    as the JAX package's do with ``pallas_paged_attention`` on;
    ``io.load_decode_model`` compares stamps without it."""
    s = f"decoding/{config.digest()}/{which}"
    if sampling:
        s += "+sampling"
    if pallas:
        s += "+pallas"
    return s


def derive_decode_programs(program: Program, token_name: str,
                           logits_name: str,
                           config: Optional[CacheConfig] = None,
                           with_extend: bool = False,
                           sampling: bool = False) -> DecodePair:
    """Derive the prefill/decode program pair (plus the EXTEND program
    when ``with_extend``) from a forward Program.

    ``program`` — a built decoder-only forward: ``token_name`` feeds ids
    ``[B, T]``, ``logits_name`` is the ``[B, T, V]`` logits var. The
    input program is not mutated (all outputs are rewritten
    ``clone(for_test=True)``s). ``sampling=True`` replaces the greedy
    heads with the seeded per-row sampling ops and adds the five
    sampling feeds to every program; the default builds the greedy
    programs."""
    config = config or CacheConfig()
    gb = program.global_block()
    enforce(gb._find_var_recursive(token_name) is not None,
            "unknown token feed %r" % token_name)
    enforce(gb._find_var_recursive(logits_name) is not None,
            "unknown logits var %r" % logits_name)

    prefill = program.clone(for_test=True)
    _data_var(prefill, BLOCK_TABLES, (-1, config.max_blocks_per_seq))
    _data_var(prefill, SEQ_LENS, (-1,))
    if sampling:
        _sampling_vars(prefill)
    pool_specs = _rewrite_attention(prefill, config, "prefill")
    _swap_token_lookup(prefill, token_name)
    _append_head(prefill, logits_name, prefill=True, sampling=sampling)
    prefill._decode_stamp = _stamp(config, "prefill", sampling)

    decode = program.clone(for_test=True)
    _data_var(decode, BLOCK_TABLES, (-1, config.max_blocks_per_seq))
    _data_var(decode, POSITIONS, (-1,))
    if sampling:
        _sampling_vars(decode)
    dspecs = _rewrite_attention(decode, config, "decode")
    enforce([s[:2] for s in dspecs] == [s[:2] for s in pool_specs],
            "prefill/decode rewrites disagree on pool layout")
    _swap_pos_encoding(decode, POSITIONS, "Positions", _pos_encoding_at,
                       "pos_encoding_at")
    _swap_token_lookup(decode, token_name)
    # the decode step is one token per sequence, by construction
    decode.global_block().var(token_name).shape = (-1, 1)
    _append_head(decode, logits_name, prefill=False, sampling=sampling)
    decode._decode_stamp = _stamp(config, "decode", sampling, pallas=True)
    decode._bump()

    extend = None
    if with_extend:
        extend = program.clone(for_test=True)
        _data_var(extend, BLOCK_TABLES, (-1, config.max_blocks_per_seq))
        _data_var(extend, CACHED_LENS, (-1,))
        _data_var(extend, SEQ_LENS, (-1,))
        if sampling:
            _sampling_vars(extend)
        especs = _rewrite_attention(extend, config, "extend")
        enforce([s[:2] for s in especs] == [s[:2] for s in pool_specs],
                "prefill/extend rewrites disagree on pool layout")
        _swap_pos_encoding(extend, CACHED_LENS, "CachedLens",
                           _pos_encoding_from, "pos_encoding_from")
        _swap_token_lookup(extend, token_name)
        _append_head(extend, logits_name, prefill=True,
                     sampling=sampling)
        _append_window_head(extend, logits_name, sampling)
        extend._decode_stamp = _stamp(config, "extend", sampling,
                                      pallas=True)
        extend._bump()

    n_layers = len([s for s in pool_specs if s[0].endswith(".k")])
    return DecodePair(prefill, decode, config, token_name, pool_specs,
                      n_layers=n_layers, extend=extend,
                      sampling=sampling)
