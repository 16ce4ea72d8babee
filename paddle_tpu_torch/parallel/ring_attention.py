"""Ring attention: sequence parallelism over the ``sp`` mesh axis
(counterpart of paddle_tpu/parallel/ring_attention.py).

The queries are split over ``sp``: each rank computes the output of its
block of them against the whole sequence, one key/value block at a time
in the ring's order (step ``i`` takes the block of rank ``idx - i``),
with flash-style running ``(m, l, o)`` accumulators
(:func:`_block_attn`, the JAX package's block math as torch ops).
``zigzag`` (causal) gives each rank a front half-block and its mirrored
back half-block of the queries, so the causal skip saves the same work
on every rank.

As on the JAX side every rank of ``sp`` runs the rest of the program
alike on the whole sequence, so each rank already holds the whole
``q, k, v``: :func:`ring_attention` cuts its query blocks and the ring's
key/value blocks from them locally, and no block is sent around the
ring. The steps and their order are the JAX package's, so the numbers
are its ring's. The ranks' output blocks are all-gathered into the
whole output. Its backward is one autograd function's: the blocks'
gradients through the local graph, the query blocks' gradients
all-gathered, and the key/value gradients (each rank's share of every
block) summed over ``sp`` in one all-reduce, so a replicated producer
upstream gets one device's gradient, not ``sp`` copies of it.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..sharding import comm


def _block_attn(q, k, v, m, l, o, scale, q_start, k_start, causal,
                kv_mask=None):
    """One flash-attention block update with running-softmax state.

    q: [B, Tq, H, D]  k, v: [B, Tk, H, D]; m, l: [B, H, Tq];
    o: [B, Tq, H, D]; kv_mask: [B, Tk] 0/1 (or None); q_start/k_start:
    the blocks' global offsets, for the causal mask."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    ninf = torch.full((), -float("inf"), dtype=s.dtype, device=s.device)
    if causal:
        Tq, Tk = q.shape[1], k.shape[1]
        q_pos = q_start + torch.arange(Tq, device=s.device)[:, None]
        k_pos = k_start + torch.arange(Tk, device=s.device)[None, :]
        s = torch.where(q_pos >= k_pos, s, ninf)
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :] > 0, s, ninf)
    m_blk = s.amax(-1)
    m_new = torch.maximum(m, m_blk)
    # rows masked so far have m_new = -inf: every operand is sanitized
    # before exp, so neither pass makes an inf - inf NaN
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    s_fin = torch.isfinite(s)
    m_fin = torch.isfinite(m_new)
    m_safe = torch.where(m_fin, m_new, zero)
    p = torch.where(s_fin, torch.exp(torch.where(s_fin, s, zero)
                                     - m_safe[..., None]), zero)
    prev_fin = torch.isfinite(m)
    corr = torch.where(prev_fin, torch.exp(torch.where(prev_fin, m, zero)
                                           - m_safe), zero)
    l_new = l * corr + p.sum(-1)
    o_new = o * corr.transpose(1, 2)[..., None] + \
        torch.einsum("bhqk,bkhd->bqhd", p, v)
    return m_new, l_new, o_new


def _zigzag_halves(n, idx):
    """The global half-blocks of the queries rank ``idx`` of ``n`` holds
    in the zigzag layout: ``idx`` (front) and ``2n - 1 - idx`` (back),
    where the JAX package's exchange puts them."""
    return idx, 2 * n - 1 - idx


def _gather_pieces(pieces, group, n, zigzag):
    """The whole sequence from every rank's pieces (its block, or its
    two zigzag halves), in global order."""
    got = comm.all_gather(torch.cat(pieces, dim=1), group, 1)
    if not zigzag:
        return got
    halves = got.chunk(2 * n, dim=1)  # rank j's front, then its back
    return torch.cat([halves[2 * p] if p < n else
                      halves[2 * (2 * n - 1 - p) + 1]
                      for p in range(2 * n)], dim=1)


def _ring_local(pieces, ks, vs, masks, n, idx, causal, scale):
    """The per-rank body on local blocks: ``pieces`` the query pieces
    with their global offsets (one contiguous block, or zigzag's two
    halves), ``ks[i]``/``vs[i]``/``masks[i]`` the key/value block held
    at ring step ``i`` (from rank ``idx - i``). Returns each piece's
    output, in q's dtype."""
    B, plen, H, D = pieces[0][0].shape
    Tk = ks[0].shape[1]
    dev = ks[0].device
    accs = [(torch.full((B, H, plen), -float("inf"), device=dev),
             torch.zeros((B, H, plen), device=dev),
             torch.zeros((B, plen, H, D), device=dev)) for _ in pieces]
    for i in range(n):
        k_start = ((idx - i) % n) * Tk
        kf, vf = ks[i].float(), vs[i].float()
        for j, (qp, q_start) in enumerate(pieces):
            if causal and k_start > q_start + plen - 1:
                continue  # the block lies wholly in this piece's future
            accs[j] = _block_attn(qp.float(), kf, vf, *accs[j], scale,
                                  q_start, k_start, causal, masks[i])
    outs = []
    for (qp, _s), (_m, l, o) in zip(pieces, accs):
        l = torch.clamp(l, min=1e-20)  # fully masked rows give zeros
        outs.append((o / l.transpose(1, 2)[..., None]).to(qp.dtype))
    return outs


class _Ring(torch.autograd.Function):
    """Whole ``q, k, v`` (and mask) in, whole output out; this rank's
    query blocks against the ring's key/value blocks in between (see the
    module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, group, causal, scale, zigzag):
        import torch.distributed as dist

        n, idx = dist.get_world_size(group), dist.get_rank(group)
        Tq, Tk = q.shape[1] // n, k.shape[1] // n
        owners = [(idx - i) % n for i in range(n)]  # ring step i's block
        plen = Tq // 2 if zigzag else Tq
        starts = ([j * plen for j in _zigzag_halves(n, idx)] if zigzag
                  else [idx * Tq])
        ms = [kv_mask.narrow(1, j * Tk, Tk) if kv_mask is not None
              else None for j in owners]
        with torch.enable_grad():
            ql, kl, vl = (x.detach().requires_grad_(True) for x in (q, k, v))
            outs = _ring_local(
                [(ql.narrow(1, s, plen), s) for s in starts],
                [kl.narrow(1, j * Tk, Tk) for j in owners],
                [vl.narrow(1, j * Tk, Tk) for j in owners],
                ms, n, idx, causal, scale)
        ctx.saved = (ql, kl, vl, outs)
        ctx.group, ctx.n, ctx.starts, ctx.zigzag = group, n, starts, zigzag
        return _gather_pieces([o.detach() for o in outs], group, n, zigzag)

    @staticmethod
    def backward(ctx, g):
        ql, kl, vl, outs = ctx.saved
        plen = outs[0].shape[1]
        grads = torch.autograd.grad(
            outs, (ql, kl, vl),
            [g.narrow(1, s, plen).to(o.dtype)
             for s, o in zip(ctx.starts, outs)], allow_unused=True)
        gq, gk, gv = (x if x is not None else torch.zeros_like(y)
                      for x, y in zip(grads, (ql, kl, vl)))
        # this rank's share of every key/value position's gradient,
        # summed over sp; its query pieces' gradients gathered
        gkv = comm.all_reduce(torch.cat([gk, gv], dim=-1), ctx.group)
        D = gk.shape[-1]
        gq = _gather_pieces([gq.narrow(1, s, plen) for s in ctx.starts],
                            ctx.group, ctx.n, ctx.zigzag)
        ctx.saved = None
        return (gq, gkv[..., :D], gkv[..., D:],
                None, None, None, None, None)


def ring_attention(q, k, v, mesh, sp_axis: str = "sp", causal: bool = False,
                   scale: Optional[float] = None, kv_mask=None,
                   zigzag: Optional[bool] = None):
    """Sequence-parallel attention over ``mesh``'s ``sp_axis``.

    ``q, k, v``: ``[batch, seq, heads, head_dim]``, whole on every rank
    of the axis; ``causal``: the autoregressive mask on global
    positions; ``kv_mask``: an optional ``[batch, kv_seq]`` 0/1 padding
    mask; ``zigzag``: the load-balanced causal layout, by default
    (None) on for causal attention when the local block splits evenly.
    Falls back to :func:`_plain_attention` when the mesh lacks the axis
    or it has one rank (or this process is not a rank of the mesh)."""
    if mesh is None or mesh.size(sp_axis) <= 1:
        return _plain_attention(q, k, v, causal, scale, kv_mask)
    sp = mesh.size(sp_axis)
    local_T = q.shape[1] // sp
    if zigzag is None:
        zigzag = causal and local_T % 2 == 0
    if zigzag and (not causal or local_T % 2):
        raise ValueError("zigzag=True needs causal=True and an even "
                         f"local shard length (got T={q.shape[1]} over "
                         f"sp={sp})")
    if not mesh.live:
        return _plain_attention(q, k, v, causal, scale, kv_mask)
    if q.shape[1] % sp or k.shape[1] % sp:
        raise ValueError("ring attention: sequence lengths %d/%d do not "
                         "split over sp=%d" % (q.shape[1], k.shape[1], sp))
    D = q.shape[-1]
    scale = scale if scale is not None else D ** -0.5
    mask = kv_mask.to(torch.float32) if kv_mask is not None else None
    return _Ring.apply(q, k, v, mask, mesh.group(sp_axis), bool(causal),
                       float(scale), bool(zigzag))


def _plain_attention(q, k, v, causal: bool, scale: Optional[float],
                     kv_mask=None):
    """Single-device reference path (also the numerics oracle in
    tests): f32 logits, ``finfo.min`` masking, softmax, cast back."""
    D = q.shape[-1]
    scale = scale if scale is not None else D ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    low = torch.full((), torch.finfo(s.dtype).min, dtype=s.dtype,
                     device=s.device)
    if causal:
        Tq, Tk = q.shape[1], k.shape[1]
        mask = torch.ones((Tq, Tk), dtype=torch.bool,
                          device=s.device).tril()
        s = torch.where(mask, s, low)
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :] > 0, s, low)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)
