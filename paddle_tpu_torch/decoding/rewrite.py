"""Graph-level decode rewrite: derive the prefill/decode program pair
from a built forward Program (counterpart of
paddle_tpu/decoding/rewrite.py, prefill and decode with greedy heads).

It takes a causal decoder-only forward — token ids ``[B, T]`` in,
next-token logits ``[B, T, V]`` out — and produces two rewritten clones
sharing one set of persistable paged KV-cache pools
``[num_blocks, block_size, heads, head_dim]`` per attention layer
(PagedAttention, Kwon et al., SOSP '23):

* **prefill** — runs the prompt at a bucketed ``[B, T]`` shape. Every
  causal ``fused_attention`` op becomes ``paged_attention_prefill``:
  the same attention math (prefill logits match the original forward)
  plus a write of the per-position K/V into the pools at the slots the
  block table names. Fetches gain the next token: the logits at
  ``seq_len - 1`` and their greedy argmax.
* **decode** — runs ONE token per sequence (``[B, 1]``).
  ``fused_attention`` becomes ``paged_attention_decode``: write the new
  token's K/V at ``positions[b]``, then attend over the sequence's block
  window with the hand-written kernel (ops/paged_attention.py) under the
  ``<= position`` mask. ``pos_encoding`` becomes ``pos_encoding_at``.

The decode op ALWAYS goes through ``ops.paged_window_attention`` — the
counterpart of the JAX package with ``pallas_paged_attention`` on.

Pool writes are in place: the ops index into the scope's pool tensors
and return the same objects, so no pool is ever copied. Out-of-range
slots (padding rows whose table is ``-1``, prompt positions
``t >= seq_len``, inactive decode rows with ``positions < 0``) are
filtered out before the write — the JAX package's scatter DROPS them,
where torch indexing would fault or wrap.

Not ported yet: the extend program (prefix-cache suffix prefill and
speculative verify), the sampling heads and int8 pools.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import dtype_utils
from ..core.enforce import enforce
from ..core.program import Program
from ..models.transformer import attention, sinusoid_table
from ..ops.paged_attention import paged_window_attention
from .cache import CacheConfig

# fixed public feed/fetch names of the derived pair (the JAX package's)
BLOCK_TABLES = "kv_block_tables"
SEQ_LENS = "kv_seq_lens"
POSITIONS = "kv_positions"
NEXT_TOKENS = "kv_next_tokens"
NEXT_LOGITS = "kv_next_logits"


def pool_name(layer: int, which: str) -> str:
    """Persistable pool var name for attention layer ``layer``."""
    return f"kv_cache@l{layer}.{which}"


def _write_pools(k_cache, v_cache, slots, valid, k_rows, v_rows):
    """``pool[slots[valid]] = rows[valid]`` for both pools, over their
    flattened ``[nb * bs, H, D]`` views, in place; writes whose
    ``valid`` is False are dropped. ``slots``/``valid`` have the leading
    shape of the rows (``[B]`` or ``[B, T]``). Finding the kept rows
    costs one device->host sync, shared by the two pools."""
    keep = valid.reshape(-1).nonzero().squeeze(1)
    slots = slots.reshape(-1)[keep]
    for pool, rows in ((k_cache, k_rows), (v_cache, v_rows)):
        flat = pool.view(-1, *pool.shape[2:])
        rows = rows.reshape(-1, *pool.shape[2:])[keep]
        flat.index_copy_(0, slots, rows.to(pool.dtype))


def _paged_prefill_attention(q, k, v, k_cache, v_cache, tables, seq_lens,
                             *, n_head, block_size):
    """Causal attention over the prompt + paged cache write. The
    attention is the ``fused_attention`` causal math over the fresh
    K/V, so prefill activations match the original forward."""
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
    _write_pools(k_cache, v_cache, blk * bs + pos % bs, valid, kh, vh)
    return out, k_cache, v_cache


def _paged_decode_attention(q, k, v, k_cache, v_cache, tables, positions,
                            *, n_head, block_size):
    """One-token query against the paged cache: write the new K/V at
    ``positions[b]``, then attend over the sequence's block window
    (ordered by logical position) through the kernel. Inactive rows
    (``positions < 0``) write nothing."""
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
                 torch.reshape(v, (B, n_head, Dv)))

    qh = torch.reshape(q, (B, T, n_head, D))
    ctx = paged_window_attention(qh, k_cache, v_cache,
                                 tables.to(torch.int32).contiguous(),
                                 positions.to(torch.int32).contiguous())
    return torch.reshape(ctx, (B, T, n_head * Dv)), k_cache, v_cache


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


class DecodePair:
    """Result of :func:`derive_decode_programs`: the rewritten programs,
    the shared pool specs, and the wire surface the engine feeds and
    fetches."""

    def __init__(self, prefill: Program, decode: Program,
                 config: CacheConfig, token_name: str,
                 pool_specs: List[Tuple[str, tuple, np.dtype]],
                 n_layers: int):
        self.prefill = prefill
        self.decode = decode
        self.config = config
        self.token_name = token_name
        self.pool_specs = pool_specs
        self.n_layers = n_layers
        self.prefill_feeds = [token_name, BLOCK_TABLES, SEQ_LENS]
        self.decode_feeds = [token_name, BLOCK_TABLES, POSITIONS]
        self.fetches = [NEXT_TOKENS, NEXT_LOGITS]

    @property
    def pool_bytes(self) -> int:
        """Total device memory the KV pools occupy (all layers)."""
        return sum(int(np.prod(shape))
                   * dtype_utils.to_torch(dt).itemsize
                   for _, shape, dt in self.pool_specs)

    def init_scope(self, scope, device: torch.device) -> None:
        """Materialize zeroed pools on ``device`` in ``scope``
        (idempotent: existing pools of the right shape, dtype and device
        are kept — a warm cache is not wiped by a second engine)."""
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


def _append_head(program: Program, logits_name: str, prefill: bool) -> None:
    """Append the next-token head: the last real position's logits,
    then the greedy argmax."""
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
    gb.append_op(type="greedy_token", inputs={"X": [NEXT_LOGITS]},
                 outputs={"Out": [NEXT_TOKENS]}, fn=_greedy_token)


def _rewrite_attention(program: Program, config: CacheConfig,
                       mode: str) -> List[Tuple[str, tuple, np.dtype]]:
    """Swap every causal ``fused_attention`` op for its paged variant
    ("prefill" or "decode"), creating the layer's persistable pool vars.
    Returns pool specs in layer order."""
    gb = program.global_block()
    pool_specs: List[Tuple[str, tuple, np.dtype]] = []
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
        k_shape = (config.num_blocks, config.block_size, n_head, d_k)
        v_shape = (config.num_blocks, config.block_size, n_head, d_v)
        kvar = gb.create_var(name=kp, shape=k_shape, dtype=kv.dtype,
                             persistable=True)
        vvar = gb.create_var(name=vp, shape=v_shape, dtype=kv.dtype,
                             persistable=True)
        pool_specs.append((kp, k_shape, kvar.dtype))
        pool_specs.append((vp, v_shape, vvar.dtype))

        inputs = {"Q": [q_name], "K": [k_name], "V": [v_name],
                  "KCache": [kp], "VCache": [vp],
                  "BlockTables": [BLOCK_TABLES]}
        if mode == "prefill":
            inputs["SeqLens"] = [SEQ_LENS]
            fn = _paged_prefill_attention
            op.type = "paged_attention_prefill"
        else:
            inputs["Positions"] = [POSITIONS]
            fn = _paged_decode_attention
            op.type = "paged_attention_decode"
        op.inputs = inputs
        op.outputs = {"Out": [out_name], "KCacheOut": [kp],
                      "VCacheOut": [vp]}
        op.fn = functools.partial(fn, n_head=n_head,
                                  block_size=config.block_size)
        op.attrs = {"n_head": n_head, "causal": True,
                    "block_size": config.block_size, "layer": layer}
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
    ``token_lookup``, on BOTH halves: decode feeds ``[B, 1]`` always, and
    prefill feeds ``[B, 1]`` whenever the prompt buckets contain 1. For
    ``T > 1`` the two fns agree."""
    for op in program.global_block().ops:
        if op.type == "lookup_table" and op.input("Ids") == [token_name]:
            op.fn = functools.partial(
                _token_lookup, padding_idx=op.attrs.get("padding_idx"))
            op.type = "token_lookup"
            op.attrs = {"padding_idx": op.attrs.get("padding_idx")}


def derive_decode_programs(program: Program, token_name: str,
                           logits_name: str,
                           config: Optional[CacheConfig] = None,
                           with_extend: bool = False,
                           sampling: bool = False) -> DecodePair:
    """Derive the prefill/decode program pair from a forward Program.

    ``program`` — a built decoder-only forward: ``token_name`` feeds ids
    ``[B, T]``, ``logits_name`` is the ``[B, T, V]`` logits var. The
    input program is not mutated (both outputs are rewritten
    ``clone(for_test=True)``s). ``with_extend`` and ``sampling`` are not
    ported yet and raise."""
    if with_extend:
        raise NotImplementedError(
            "derive_decode_programs(with_extend=True): the extend program "
            "(prefix-cache suffix prefill, speculative verify) is not "
            "ported yet")
    if sampling:
        raise NotImplementedError(
            "derive_decode_programs(sampling=True): the sampling heads "
            "are not ported yet")
    config = config or CacheConfig()
    gb = program.global_block()
    enforce(gb._find_var_recursive(token_name) is not None,
            "unknown token feed %r" % token_name)
    enforce(gb._find_var_recursive(logits_name) is not None,
            "unknown logits var %r" % logits_name)

    prefill = program.clone(for_test=True)
    _data_var(prefill, BLOCK_TABLES, (-1, config.max_blocks_per_seq))
    _data_var(prefill, SEQ_LENS, (-1,))
    pool_specs = _rewrite_attention(prefill, config, "prefill")
    _swap_token_lookup(prefill, token_name)
    _append_head(prefill, logits_name, prefill=True)

    decode = program.clone(for_test=True)
    _data_var(decode, BLOCK_TABLES, (-1, config.max_blocks_per_seq))
    _data_var(decode, POSITIONS, (-1,))
    dspecs = _rewrite_attention(decode, config, "decode")
    enforce([s[:2] for s in dspecs] == [s[:2] for s in pool_specs],
            "prefill/decode rewrites disagree on pool layout")
    for op in decode.global_block().ops:
        if op.type == "pos_encoding":
            x_name, = op.input("X")
            op.inputs = {"X": [x_name], "Positions": [POSITIONS]}
            op.fn = _pos_encoding_at
            op.type = "pos_encoding_at"
    _swap_token_lookup(decode, token_name)
    # the decode step is one token per sequence, by construction
    decode.global_block().var(token_name).shape = (-1, 1)
    _append_head(decode, logits_name, prefill=False)
    decode._bump()

    n_layers = len([s for s in pool_specs if s[0].endswith(".k")])
    return DecodePair(prefill, decode, config, token_name, pool_specs,
                      n_layers=n_layers)
